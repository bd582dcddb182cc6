"""Single-scene demo: an .off scan in -> boxes, conditioning codes and
every selected proposal's dense occupancy logit grid out.

Counterpart of `rfdnet_tpu/demo.py` (`load_demo_data`, `generate`) up to
mesh extraction, which is not ported yet: `generate` returns the logit
grids that marching cubes would read.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .config import eval_config


def read_off_vertices(path: str) -> np.ndarray:
    """Vertices (V, 3) float64 of an OFF file (faces are not needed)."""
    with open(path) as f:
        tokens = f.read().split()
    idx = 0
    if tokens[0] == "OFF":
        idx = 1
    elif tokens[0].startswith("OFF"):  # "OFF123 ..." glued header
        tokens[0] = tokens[0][3:]
    n_vert = int(tokens[idx])
    idx += 3
    return np.array(tokens[idx:idx + 3 * n_vert], dtype=np.float64).reshape(
        n_vert, 3)


def load_demo_data(path: str, num_points: int = 80_000,
                   use_height: bool = True, device=None) -> dict:
    """.off scan -> {"point_clouds": (1, num_points, 3+height) float32} on
    `device` (the current CUDA card when None). The floor is the
    0.99-percentile z; the subsample is seeded as the reference's."""
    if not path.endswith(".off"):
        raise ValueError(f"unsupported scan format: {path}")
    points = read_off_vertices(path).astype(np.float32)
    if use_height:
        floor = np.percentile(points[:, 2], 0.99)
        points = np.concatenate(
            [points, (points[:, 2] - floor)[:, None]], axis=1)
    rng = np.random.RandomState(10)
    n = points.shape[0]
    choice = rng.choice(n, num_points, replace=n < num_points)
    return {"point_clouds": torch.from_numpy(
        np.ascontiguousarray(points[choice][None])).to(resolve_device(device))}


def generate(cfg: dict, model, point_clouds: torch.Tensor, marks=None):
    """Detection + completion + dense grid decode for one scene, as the
    test config sets it up. Returns (end_points, parsed, gen, grids), grids
    (G, r, r, r) logits with r = `generation.resolution_0`. `marks`: see
    `ISCNet.generate`."""
    gen_cfg = cfg["generation"]
    if gen_cfg["upsampling_steps"] != 0 or gen_cfg["use_sampling"]:
        raise ValueError("only the dense grid (upsampling_steps 0) with the "
                         "prior-mean z (use_sampling false) is ported")
    ec = eval_config(cfg)
    out = model.generate(
        {"point_clouds": point_clouds},
        nms_iou=ec["nms_iou"], use_cls_nms=ec["cls_nms"],
        dump_threshold=gen_cfg["dump_threshold"],
        remove_empty_box=ec["remove_empty_box"],
        decode_grid_res=gen_cfg["resolution_0"], marks=marks,
    )
    return out["end_points"], out["parsed"], out["gen"], out["grids"]

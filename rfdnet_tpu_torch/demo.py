"""Single-scene demo: a raw .off/.ply scan in -> boxes + instance meshes out.

Counterpart of `rfdnet_tpu/demo.py`: load a scan, append the height
feature (floor = 0.99-percentile z), subsample to `num_point`, run
detection -> NMS -> skip propagation -> the occupancy of every selected
proposal (a dense grid, or with `generation.upsampling_steps > 0` an octree
on the card) -> marching cubes on the host, and dump
`proposal_<j>_mesh.ply`, `000000_pc.ply` and the NMS-filtered bbox npz.
`generation.use_sampling` decodes with one prior draw of z a proposal
(`ISCNet.sample_z`) in place of the prior mean. `generate_grids` stops at
the logit grids on the device (what a tester reads before extraction);
`post_processing` refits the boxes to the scan (`eval.refit`).
`save_visualization` also writes `scene.html` (the interactive WebGL view,
`utils/scene_html.py`), and `visualize` writes `pred.png` (a numpy
render of the same view as the JAX package's matplotlib one,
`utils/render.py`).
"""

from __future__ import annotations

import functools
import os
import time

import numpy as np
import torch

from . import resolve_device
from .config import build_model, eval_config
from .eval.box_util import flip_axis_to_depth
from .eval.refit import _box_params_from_corners, fit_meshes_to_scan
from .eval.tester import place_mesh_in_box
from .meshing.generator import Generator3D
from .meshing.mesh import TriMesh, write_ply
from .utils.profiling import span
from .utils.render import TAB20, write_scene_png
from .utils.scene_viz import SceneRender, corners_to_center_vectors


def load_demo_data(path: str, num_points: int = 80_000,
                   use_height: bool = True, device=None) -> dict:
    """.off/.ply scan -> {"point_clouds": (1, num_points, 3+height)
    float32} on `device` (the current CUDA card when None). The floor is
    the 0.99-percentile z; the subsample is seeded as the reference's."""
    dev = resolve_device(device)
    points = np.asarray(TriMesh.load(path).vertices, dtype=np.float32)
    if use_height:
        floor = np.percentile(points[:, 2], 0.99)
        points = np.concatenate(
            [points, (points[:, 2] - floor)[:, None]], axis=1)
    rng = np.random.RandomState(10)
    n = points.shape[0]
    choice = rng.choice(n, num_points, replace=n < num_points)
    return {"point_clouds": torch.from_numpy(
        np.ascontiguousarray(points[choice][None])).to(dev)}


def generate_grids(cfg: dict, model, point_clouds: torch.Tensor):
    """Detection + completion + the occupancy of every selected proposal
    for one scene, all on the device of `point_clouds`. Returns
    (end_points, parsed, gen, grids): grids (G, r, r, r) logits with r =
    `generation.resolution_0` at `upsampling_steps` 0, else the device
    octree's `mise_device.MiseOutput`; for a model in the detection phase
    gen and grids are None. Spans: `ISCNet.generate`'s, and `demo.octree`
    (the device octree's levels)."""
    gen_cfg = cfg["generation"]
    dense = gen_cfg["upsampling_steps"] == 0
    ec = eval_config(cfg)
    out = model.generate(
        {"point_clouds": point_clouds},
        nms_iou=ec["nms_iou"], use_cls_nms=ec["cls_nms"],
        dump_threshold=gen_cfg["dump_threshold"],
        remove_empty_box=ec["remove_empty_box"],
        decode_grid_res=gen_cfg["resolution_0"] if dense else None,
        grid_sample=gen_cfg["use_sampling"],
    )
    grids = out.get("grids")
    if not dense and "gen" in out:
        gen = out["gen"]
        with span("demo.octree"):
            grids = make_generator(cfg, model).run_octree(
                gen["features"], gen["cls_codes"], gen["valid"].reshape(-1))
    return out["end_points"], out["parsed"], out.get("gen"), grids


def make_generator(cfg: dict, model, mise_impl: str = "device",
                   mxu_dtype=None) -> Generator3D:
    """The mesh generator that `cfg` describes over `model`'s decoder, its
    octree (at `upsampling_steps > 0`) on the card (`mise_impl="device"`)
    or on the host (`"host"`). `mxu_dtype`: the operand type of its fused
    decodes (the grids and the octree's levels; the decoder's own when
    None); refine and normals decode through the layer chain in the
    decoder's own."""
    gen_cfg = cfg["generation"]
    sample = bool(gen_cfg["use_sampling"])
    return Generator3D(
        functools.partial(model.decode_occupancy, sample=sample,
                          mxu_dtype=mxu_dtype),
        threshold=cfg["data"]["threshold"],
        resolution0=gen_cfg["resolution_0"],
        upsampling_steps=gen_cfg["upsampling_steps"],
        refinement_step=gen_cfg.get("refinement_step", 0) or 0,
        simplify_nfaces=gen_cfg.get("simplify_nfaces"),
        with_normals=gen_cfg.get("with_normals", False),
        mise_impl=mise_impl,
        bind_fn=functools.partial(model.occupancy_decoder, sample=sample,
                                  mxu_dtype=mxu_dtype),
        grad_bind_fn=functools.partial(model.gradient_decoder, sample=sample),
    )


# inputs of the decoder: they stay on the device (refine and normals decode
# from them there)
_DEVICE_ONLY = ("features", "cls_codes")


def _to_numpy(d: dict) -> dict:
    return {k: v if k in _DEVICE_ONLY else v.cpu().numpy()
            for k, v in d.items()}


def generate(cfg: dict, model, data: dict, post_processing: bool = False,
             generator: Generator3D | None = None):
    """Detection + completion + mesh extraction for one scene. Returns
    (parsed, gen, meshes): numpy dicts (gen's `features` and `cls_codes`
    stay tensors on the device) and one `TriMesh` per slot, empty for an
    invalid slot. With `post_processing` the corners in parsed are those
    of the boxes refit to the scan (`eval.refit.fit_meshes_to_scan`, on
    the device of the scan).

    `generator`: from `make_generator`, kept over scenes. The grids (or,
    with MISE, the device octree's outputs) come from `generator.start`.
    Spans: `ISCNet.generate`'s; `demo.grid_decode` (or with MISE
    `demo.octree`) around `generator.start`; `demo.d2h`, the host's wait
    for the scene's device work and the copies of grids, parsed and gen;
    `demo.mesh`, the extraction."""
    if model.phase != "completion":
        raise ValueError(f"a model in the {model.phase} phase completes no "
                         "shapes: call generate_grids for its detections")
    generator = generator or make_generator(cfg, model)
    ec = eval_config(cfg)
    pc = data["point_clouds"]
    out = model.generate(
        {"point_clouds": pc}, nms_iou=ec["nms_iou"],
        use_cls_nms=ec["cls_nms"],
        dump_threshold=cfg["generation"]["dump_threshold"],
        remove_empty_box=ec["remove_empty_box"],
    )
    gen = out["gen"]
    valid = gen["valid"].reshape(-1)
    with span("demo.grid_decode" if generator.upsampling_steps == 0
              else "demo.octree"):
        download = generator.start(gen["features"], gen["cls_codes"], valid)
    with span("demo.d2h"):
        parsed, gen = _to_numpy(out["parsed"]), _to_numpy(gen)
        host = download.wait()
    with span("demo.mesh"):
        meshes = generator.meshes_from(host, valid=gen["valid"].reshape(-1),
                                       features=gen["features"],
                                       cls_codes=gen["cls_codes"])
    if post_processing:
        parsed = fit_meshes_to_scan(
            parsed, meshes, gen["proposal_ids"], gen["valid"],
            pc.cpu().numpy(), cfg["generation"]["dump_threshold"],
            device=pc.device)
    return parsed, gen, meshes


def _valid_slots(gen: dict):
    """(slot, proposal id) of each valid slot of the scene."""
    return [(g, int(gen["proposal_ids"][0, g, 0]))
            for g in range(gen["proposal_ids"].shape[1])
            if gen["valid"][0, g]]


def save_visualization(data: dict, parsed: dict, gen: dict, meshes,
                       out_dir: str) -> str:
    """The scene's points as `000000_pc.ply`, one `proposal_<j>_mesh.ply`
    per valid slot with a non-empty mesh (placed in its box, scan frame),
    `000000_pred_confident_nms_bbox.npz` (`obbs` (K, 7) [center, size,
    heading] depth-frame boxes and `proposal_map` (K, 1) proposal ids, one
    row per valid slot), and `scene.html`: the scan, the boxes and the
    placed meshes, one color per instance, depth frame."""
    os.makedirs(out_dir, exist_ok=True)
    pc = data["point_clouds"]
    if isinstance(pc, torch.Tensor):
        pc = pc.cpu().numpy()
    pc = np.asarray(pc)[0, :, :3]
    write_ply(os.path.join(out_dir, "000000_pc.ply"), pc,
              np.zeros((0, 3), np.int32))
    corners = parsed["pred_corners_3d_upright_camera"]
    boxes, proposal_map = [], []
    centers, vectors, placed_meshes = [], [], []
    for g, j in _valid_slots(gen):
        c, vec = corners_to_center_vectors(flip_axis_to_depth(corners[0, j]))
        centers.append(c)
        vectors.append(vec)
        if len(meshes[g].vertices):
            placed = place_mesh_in_box(meshes[g], corners[0, j])
            placed.export(os.path.join(out_dir, f"proposal_{j}_mesh.ply"))
            placed_meshes.append((flip_axis_to_depth(
                np.asarray(placed.vertices)), np.asarray(placed.faces)))
        else:
            placed_meshes.append((np.zeros((0, 3)),
                                  np.zeros((0, 3), np.int64)))
        boxes.append(_box_params_from_corners(corners[0, j]))
        proposal_map.append([j])
    np.savez(
        os.path.join(out_dir, "000000_pred_confident_nms_bbox.npz"),
        obbs=np.array(boxes), proposal_map=np.array(proposal_map),
    )
    SceneRender(
        pc, meshes=placed_meshes, centers=centers, vectors=vectors,
        class_ids=[0] * len(centers),
    ).export_html(
        os.path.join(out_dir, "scene.html"),
        title=os.path.basename(out_dir), color_mode="instance",
    )
    return out_dir


def visualize(data: dict, parsed: dict, gen: dict, meshes,
              out_path: str) -> str:
    """`pred.png`: the scan, each valid slot's box edges and placed mesh in
    the slot's tab20 color, from the JAX demo's view (`utils/render.py`)."""
    pc = data["point_clouds"]
    if isinstance(pc, torch.Tensor):
        pc = pc.cpu().numpy()
    corners = parsed["pred_corners_3d_upright_camera"]
    boxes, placed, colors = [], [], []
    for g, j in _valid_slots(gen):
        boxes.append(flip_axis_to_depth(corners[0, j]))
        colors.append(TAB20[g % 20])
        if len(meshes[g].vertices):
            m = place_mesh_in_box(meshes[g], corners[0, j])
            placed.append((m.vertices, m.faces))
        else:
            placed.append((np.zeros((0, 3)), np.zeros((0, 3), np.int64)))
    return write_scene_png(out_path, np.asarray(pc)[0, :, :3], boxes,
                           placed, colors)


def run(cfg: dict, demo_path: str, device=None, log=print) -> str:
    """Load the scan, build the model with the configured weights
    (`cli.restore_weights`), generate, and dump under
    `out/demo/visualization/<scene>` (`save_visualization` and
    `pred.png`). Returns that directory."""
    from .cli import restore_weights

    t0 = time.time()
    data = load_demo_data(
        demo_path, num_points=cfg["data"]["num_point"],
        use_height=not cfg["data"]["no_height"], device=device,
    )
    model = restore_weights(cfg, build_model(cfg, device=device), log=log)
    parsed, gen, meshes = generate(cfg, model, data)
    scene = os.path.splitext(os.path.basename(demo_path))[0]
    out_dir = os.path.join("out/demo", "visualization", scene)
    save_visualization(data, parsed, gen, meshes, out_dir)
    visualize(data, parsed, gen, meshes, os.path.join(out_dir, "pred.png"))
    log(f"Time elapsed: {time.time() - t0:.2f}s -> {out_dir}")
    return out_dir

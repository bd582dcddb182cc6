"""Model and evaluation settings of `configs/iscnet_test.yaml`, held as a
plain dict (the machine with the card has no YAML parser to count on).

Counterparts: `rfdnet_tpu/config/scannet.py:57-76` (dataset metadata) and
`rfdnet_tpu/config/config.py:94-190` (eval settings, `build_model`).
A CPU test holds `TEST_CONFIG` against the YAML and `MEAN_SIZE_ARR`
against `rfdnet_tpu/assets/scannet_means.npz`.
"""

from __future__ import annotations

import numpy as np

from . import resolve_device

NUM_CLASS = 8
NUM_HEADING_BIN = 12
NUM_SIZE_CLUSTER = 8

# per-class mean box sizes (l, w, h), the values of scannet_means.npz
MEAN_SIZE_ARR = np.array([
    [0.7261362268155247, 1.244569951455941, 0.6635363717664928],
    [0.578952660133952, 0.5514682536397799, 0.8494991165247245],
    [0.3379121914770462, 1.0673194664136507, 1.3375976539542236],
    [0.8940570618674515, 1.6924115842489345, 0.7654994570497831],
    [0.27877715956049753, 0.36634102685275055, 0.4559277728397898],
    [0.5665150182604128, 0.9601323793520321, 1.0001800771835718],
    [0.1643819819032661, 0.6067032028821382, 0.4759424743521153],
    [0.5161200946070579, 0.8530538303885332, 0.4392502425548773],
], dtype=np.float64)

# the keys of configs/iscnet_test.yaml (merged over rfdnet_tpu's defaults)
# that the test-time generation path reads
TEST_CONFIG = {
    "data": {
        "num_point": 80000,
        "num_target": 256,
        "vote_factor": 1,
        "cluster_sampling": "seed_fps",
        "no_height": False,
        "use_color_detection": False,
        "use_color_completion": False,
        "hidden_dim": 512,
        "c_dim": 512,
        "z_dim": 32,
        "use_cls_for_completion": False,
        "skip_propagate": True,
        "decoder_bf16": False,
    },
    "test": {
        "phase": "completion",
        "nms_iou": 0.25,
        "use_cls_nms": True,
        "faster_eval": False,
    },
    "generation": {
        "resolution_0": 32,
        "upsampling_steps": 0,
        "use_sampling": False,
        "dump_threshold": 0.5,
    },
}


def eval_config(cfg: dict = TEST_CONFIG, mode: str = "test") -> dict:
    """NMS and empty-box settings (`config/config.py:121-135`)."""
    m = cfg[mode]
    return {
        "nms_iou": m["nms_iou"],
        "cls_nms": m["use_cls_nms"],
        # `config_utils.py:139`: remove_empty_box = not faster_eval
        "remove_empty_box": not m["faster_eval"],
    }


def build_model(cfg: dict = TEST_CONFIG, generate_limit: int = 64,
                device=None, mode: str = "test"):
    """`Config.build_model` for the eval path, on `device` (the current
    CUDA card when None). Weights are uninitialised: load them with
    `weights.from_flax` or `weights.init_seeded`."""
    from .models.iscnet import ISCNet

    dev = resolve_device(device)
    d = cfg["data"]
    feat_dim = int(not d["no_height"])
    model = ISCNet(
        num_class=NUM_CLASS,
        num_heading_bin=NUM_HEADING_BIN,
        num_size_cluster=NUM_SIZE_CLUSTER,
        mean_size_arr=MEAN_SIZE_ARR,
        num_proposal=d["num_target"],
        vote_factor=d["vote_factor"],
        cluster_sampling=d["cluster_sampling"],
        input_feature_dim=int(d["use_color_detection"]) * 3 + feat_dim,
        completion_feature_dim=int(d["use_color_completion"]) * 3 + feat_dim,
        phase=cfg[mode]["phase"],
        skip_propagate=d["skip_propagate"],
        c_dim=d["c_dim"],
        hidden_dim=d["hidden_dim"],
        z_dim=d["z_dim"],
        use_cls_for_completion=d["use_cls_for_completion"],
        generate_limit=generate_limit,
        decoder_bf16=bool(d.get("decoder_bf16")),
    )
    return model.to(dev).eval().requires_grad_(False)

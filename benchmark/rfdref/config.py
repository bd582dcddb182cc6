"""The reference model from a configuration dict (the JSON files of
`benchmark/configs/`, which hold the merged YAML of the run): ISCNet with
the sizes the configuration states, and the dataset's mean box sizes."""

from __future__ import annotations

import numpy as np

from .models.iscnet import ISCNet

NUM_CLASS = 8
NUM_HEADING_BIN = 12
NUM_SIZE_CLUSTER = 8

# per-class mean box sizes (l, w, h) of ScanNet's scannet_means.npz
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


# the settings the reference computes; another value needs a path of its own
SETTINGS = {"decoder_bf16": False, "mlp_bf16": False,
            "cluster_sampling": "seed_fps", "skip_propagate": True}


def build_model(cfg: dict, mode: str, generate_limit: int, device):
    """ISCNet of `cfg` (its `mode` section in the completion phase), on
    `device`, in eval mode without gradients; weights uninitialised."""
    d = cfg["data"]
    wrong = {k: d.get(k) for k, v in SETTINGS.items() if d.get(k) != v}
    if cfg[mode]["phase"] != "completion":
        wrong["phase"] = cfg[mode]["phase"]
    if wrong:
        raise ValueError(f"the reference does not compute {wrong}")
    feat_dim = int(not d["no_height"])
    model = ISCNet(
        num_class=NUM_CLASS, num_heading_bin=NUM_HEADING_BIN,
        num_size_cluster=NUM_SIZE_CLUSTER, mean_size_arr=MEAN_SIZE_ARR,
        num_proposal=d["num_target"], vote_factor=d["vote_factor"],
        input_feature_dim=int(d["use_color_detection"]) * 3 + feat_dim,
        completion_feature_dim=int(d["use_color_completion"]) * 3 + feat_dim,
        c_dim=d["c_dim"], hidden_dim=d["hidden_dim"], z_dim=d["z_dim"],
        use_cls_for_completion=d["use_cls_for_completion"],
        generate_limit=generate_limit,
        completion_limit=d["completion_limit_in_train"])
    return model.to(device).eval().requires_grad_(False)

"""Experiment configuration: the YAML files of `configs/` merged over the
defaults into a plain dict, the dataset constants, and the model factory.

Counterparts: `rfdnet_tpu/config/scannet.py` (dataset metadata: mean
sizes, class names and ids, the heading codec) and
`rfdnet_tpu/config/config.py` (defaults, eval settings, `build_model`).
The machine with the card has no YAML package to count on, so `parse_yaml`
reads the subset of YAML that the files of `configs/` use, and `dump_yaml`
writes it (the protocol run's stage configs). `TEST_CONFIG`
holds the keys of `configs/iscnet_test.yaml` that the generation path
reads, for callers without a file. CPU tests hold `parse_yaml` against
PyYAML on every file of `configs/`, `TEST_CONFIG` against the YAML and
`MEAN_SIZE_ARR` against `rfdnet_tpu/assets/scannet_means.npz`.
"""

from __future__ import annotations

import copy
import re

import numpy as np
import torch

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

# the ShapeNet class index of each detection class, and their names
CLASS_IDS = (1, 7, 8, 13, 20, 31, 34, 43)
CLASS2TYPE = dict(enumerate((
    "table", "chair", "bookshelf", "sofa", "trash_bin", "cabinet", "display",
    "bathtub")))
TYPE2CLASS = {name: c for c, name in CLASS2TYPE.items()}
SHAPENETID2CLASS = {cid: c for c, cid in enumerate(CLASS_IDS)}

# ShapeNet's class names by class index, and the synset id (without its
# leading 0) of each name: what the offline preparation maps a Scan2CAD
# model's category through
SHAPENETCLASSES = (
    "void",
    "table", "jar", "skateboard", "car", "bottle",
    "tower", "chair", "bookshelf", "camera", "airplane",
    "laptop", "basket", "sofa", "knife", "can",
    "rifle", "train", "pillow", "lamp", "trash_bin",
    "mailbox", "watercraft", "motorbike", "dishwasher", "bench",
    "pistol", "rocket", "loudspeaker", "file cabinet", "bag",
    "cabinet", "bed", "birdhouse", "display", "piano",
    "earphone", "telephone", "stove", "microphone", "bus",
    "mug", "remote", "bathtub", "bowl", "keyboard",
    "guitar", "washer", "bicycle", "faucet", "printer",
    "cap", "clock", "helmet", "flowerpot", "microwaves",
)
SHAPENET_ID_MAP = {
    "4379243": "table", "3593526": "jar", "4225987": "skateboard",
    "2958343": "car", "2876657": "bottle", "4460130": "tower",
    "3001627": "chair", "2871439": "bookshelf", "2942699": "camera",
    "2691156": "airplane", "3642806": "laptop", "2801938": "basket",
    "4256520": "sofa", "3624134": "knife", "2946921": "can",
    "4090263": "rifle", "4468005": "train", "3938244": "pillow",
    "3636649": "lamp", "2747177": "trash_bin", "3710193": "mailbox",
    "4530566": "watercraft", "3790512": "motorbike", "3207941": "dishwasher",
    "2828884": "bench", "3948459": "pistol", "4099429": "rocket",
    "3691459": "loudspeaker", "3337140": "file cabinet", "2773838": "bag",
    "2933112": "cabinet", "2818832": "bed", "2843684": "birdhouse",
    "3211117": "display", "3928116": "piano", "3261776": "earphone",
    "4401088": "telephone", "4330267": "stove", "3759954": "microphone",
    "2924116": "bus", "3797390": "mug", "4074963": "remote",
    "2808440": "bathtub", "2880940": "bowl", "3085013": "keyboard",
    "3467517": "guitar", "4554684": "washer", "2834778": "bicycle",
    "3325088": "faucet", "4004475": "printer", "2954340": "cap",
    "3046257": "clock", "3513137": "helmet", "3991062": "flowerpot",
    "3761084": "microwaves",
}


def angle2class(angle):
    """Continuous angle(s) -> (heading bin, residual), as
    `ScannetConfig.angle2class`."""
    angle = angle % (2 * np.pi)
    angle_per_class = 2 * np.pi / float(NUM_HEADING_BIN)
    shifted = (angle + angle_per_class / 2) % (2 * np.pi)
    class_id = np.int16(shifted / angle_per_class)
    residual = shifted - (class_id * angle_per_class + angle_per_class / 2)
    return class_id, residual


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
        "threshold": 0.5,
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
        "refinement_step": 0,
        "simplify_nfaces": None,
        "dump_threshold": 0.5,
    },
}

# the defaults every YAML file is merged over (`config/config.py:32-92`)
DEFAULTS = {
    "method": "ISCNet",
    "resume": False,
    "finetune": False,
    "weight": [],
    "seed": 10,
    "device": {"num_workers": 0},
    "data": {
        "dataset": "scannet",
        "split": "datasets/splits/fullscan",
        "shapenet_path": "datasets/ShapeNetv2_data",
        "num_point": 80000,
        "num_target": 256,
        "vote_factor": 1,
        "cluster_sampling": "vote_fps",
        "ap_iou_thresh": 0.25,
        "no_height": False,
        "use_color_detection": False,
        "use_color_completion": False,
        "points_unpackbits": True,
        "points_subsample": [1024, 1024],
        "hidden_dim": 512,
        "c_dim": 512,
        "z_dim": 32,
        "threshold": 0.5,
        "completion_limit_in_train": 10,
        "use_cls_for_completion": False,
        "skip_propagate": True,
        "decoder_bf16": False,
        "mlp_bf16": False,
    },
    "model": {},
    "optimizer": {
        "method": "Adam", "lr": 1e-3, "betas": [0.9, 0.999],
        "eps": 1e-8, "weight_decay": 0,
    },
    "scheduler": {"patience": 20, "factor": 0.1, "threshold": 0.01},
    "bnscheduler": {
        "bn_decay_step": 20, "bn_decay_rate": 0.5,
        "bn_momentum_init": 0.5, "bn_momentum_max": 0.001,
    },
    "train": {"epochs": 240, "phase": "detection", "freeze": [],
              "batch_size": 8},
    "val": {"phase": "detection", "batch_size": 8},
    "test": {"phase": "completion", "batch_size": 1},
    "demo": {"phase": "completion"},
    "generation": {
        "generate_mesh": True, "resolution_0": 32, "upsampling_steps": 0,
        "use_sampling": False, "refinement_step": 0, "simplify_nfaces": None,
        "dump_threshold": 0.5, "dump_results": False, "decoder_impl": None,
    },
    "log": {"vis_path": "visualization", "save_results": True,
            "vis_step": 100, "print_step": 10, "path": "out/iscnet"},
    "mode": "train",
}

_EVAL_DEFAULTS = {"nms_iou": 0.25, "cls_nms": True, "remove_empty_box": False,
                  "per_class_proposal": True, "conf_thresh": 0.05}

# ------------------------------------------------------------------ YAML
# PyYAML's (YAML 1.1) readings of plain scalars
_NULLS = {"", "~", "null", "Null", "NULL"}
_BOOLS = {**{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE",
                               "on", "On", "ON")},
          **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE",
                                "off", "Off", "OFF")}}
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"([-+]?[0-9][0-9_]*\.[0-9_]*([eE][-+][0-9]+)?"
                    r"|\.[0-9_]+([eE][-+][0-9]+)?)$")
# anchors, tags and block scalars; numbers in other bases, sexagesimals,
# infinities and NaNs
_UNSUPPORTED = re.compile(r"[&*!|>%@`]|[-+]?(0[xXbBoO0-9_]|[0-9_]+:[0-9]"
                          r"|\.(inf|Inf|INF|nan|NaN|NAN)$)")


def _scalar(text: str):
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    if text in _NULLS:
        return None
    if text in _BOOLS:
        return _BOOLS[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _UNSUPPORTED.match(text):
        raise ValueError(f"unsupported YAML value: {text!r}")
    return text


def _split_flow(body: str) -> list[str]:
    """The comma-separated items of a flow collection's inside, commas in
    nested brackets left alone."""
    items, depth, start = [], 0, 0
    for i, ch in enumerate(body):
        if ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == "," and depth == 0:
            items.append(body[start:i])
            start = i + 1
    items.append(body[start:])
    return [it for it in (it.strip() for it in items) if it]


def _value(text: str):
    """A scalar or a flow collection (`[a, b]`, `{k: v}`) on one line."""
    text = text.strip()
    if text.startswith("[") and text.endswith("]"):
        return [_value(it) for it in _split_flow(text[1:-1])]
    if text.startswith("{") and text.endswith("}"):
        out = {}
        for it in _split_flow(text[1:-1]):
            key, sep, val = it.partition(":")
            if not sep:
                raise ValueError(f"unsupported YAML flow map entry: {it!r}")
            out[_scalar(key)] = _value(val)
        return out
    if text[:1] in "[{":
        raise ValueError(f"unsupported YAML (collection over several lines): "
                         f"{text!r}")
    return _scalar(text)


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def parse_yaml(text: str):
    """Read the YAML subset of `configs/*.yaml`: nested block maps, block
    lists of scalars, one-line flow lists and maps, comments, and PyYAML's
    plain scalars (null, booleans, ints, floats such as `5.0e-05` and
    `1.e-3`, strings). Anything else raises `ValueError`."""
    lines = []
    for raw in text.splitlines():
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError("unsupported YAML: tab indentation")
        body = _strip_comment(raw).rstrip()
        if body.strip() and body.strip() != "---":
            lines.append((len(body) - len(body.lstrip()), body.strip()))
    value, end = _block(lines, 0, lines[0][0]) if lines else (None, 0)
    if end != len(lines):
        raise ValueError(f"unsupported YAML near {lines[end][1]!r}")
    return value


def _block(lines, i: int, indent: int):
    """The map or list that starts at line i with `indent`; returns it and
    the index of the first line after it."""
    if lines[i][1].startswith("- ") or lines[i][1] == "-":
        out = []
        while i < len(lines) and lines[i][0] == indent and (
                lines[i][1].startswith("- ") or lines[i][1] == "-"):
            item = lines[i][1][1:].strip()
            if not item or re.match(r"[^\[{'\"][^:]*:(\s|$)", item):
                raise ValueError("unsupported YAML: a list of collections: "
                                 f"{lines[i][1]!r}")
            out.append(_value(item))
            i += 1
        return out, i
    out = {}
    while i < len(lines) and lines[i][0] == indent:
        key, sep, rest = lines[i][1].partition(":")
        if not sep or (rest and not rest.startswith(" ")):
            raise ValueError(f"unsupported YAML line: {lines[i][1]!r}")
        i += 1
        if rest.strip():
            out[_scalar(key)] = _value(rest)
        elif i < len(lines) and (lines[i][0] > indent or (
                lines[i][0] == indent and lines[i][1].startswith("-"))):
            # a nested block; PyYAML lets a list sit at its key's indent
            out[_scalar(key)], i = _block(lines, i, lines[i][0])
        else:
            out[_scalar(key)] = None
    if i < len(lines) and lines[i][0] > indent:
        raise ValueError(f"unsupported YAML indentation at {lines[i][1]!r}")
    return out, i


def _dump_scalar(value) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if value != value or value in (float("inf"), float("-inf")):
            raise ValueError(f"unsupported YAML value: {value!r}")
        text = repr(value).lower()
        # PyYAML's form: 1e-05 -> 1.0e-05 (a float, where 1e-05 is a string)
        return text.replace("e", ".0e", 1) if "." not in text else text
    if isinstance(value, str) and "'" not in value and "\n" not in value:
        return f"'{value}'"
    raise ValueError(f"unsupported YAML value: {value!r}")


def dump_yaml(data: dict, indent: int = 0) -> str:
    """`data` (nested dicts whose leaves are scalars or lists of scalars)
    as the YAML subset that `parse_yaml` reads and PyYAML's `safe_load`
    reads alike: block maps, block lists, `[]` / `{}` when empty, strings
    single-quoted."""
    pad = " " * indent
    lines = []
    for key, value in data.items():
        if isinstance(value, dict) and value:
            lines.append(f"{pad}{key}:\n{dump_yaml(value, indent + 2)}")
        elif isinstance(value, dict):
            lines.append(f"{pad}{key}: {{}}\n")
        elif isinstance(value, (list, tuple)) and value:
            lines.append(f"{pad}{key}:\n" + "".join(
                f"{pad}- {_dump_scalar(v)}\n" for v in value))
        elif isinstance(value, (list, tuple)):
            lines.append(f"{pad}{key}: []\n")
        else:
            lines.append(f"{pad}{key}: {_dump_scalar(value)}\n")
    return "".join(lines)


# ---------------------------------------------------------------- config
def update_recursive(dict1: dict, dict2: dict) -> None:
    """In-place recursive override of dict1 by dict2."""
    for k, v in dict2.items():
        if k not in dict1:
            dict1[k] = {}
        if isinstance(v, dict):
            update_recursive(dict1[k], v)
        else:
            dict1[k] = v


def load_config(config=None, mode: str = "train") -> dict:
    """`Config(config, mode).config`: the YAML file at `config` (or a dict
    of overrides, or nothing) merged over `DEFAULTS`, with `mode` set."""
    cfg = copy.deepcopy(DEFAULTS)
    if isinstance(config, str):
        with open(config) as f:
            update_recursive(cfg, parse_yaml(f.read()) or {})
    elif isinstance(config, dict):
        update_recursive(cfg, config)
    elif config is not None:
        raise TypeError(f"config: a path or a dict, not {type(config)}")
    cfg["mode"] = mode
    return cfg


def _mode(cfg: dict, mode) -> str:
    return mode or cfg.get("mode", "test")


def eval_config(cfg: dict = TEST_CONFIG, mode: str | None = None) -> dict:
    """NMS, empty-box and AP-assembly settings of the mode's section over
    the defaults (`config/config.py:121-135`). `mode`: `cfg["mode"]` when
    None, "test" for a dict without one."""
    m = cfg.get(_mode(cfg, mode), {})
    out = dict(_EVAL_DEFAULTS)
    for src, dst in (("nms_iou", "nms_iou"), ("use_cls_nms", "cls_nms"),
                     ("per_class_proposal", "per_class_proposal"),
                     ("conf_thresh", "conf_thresh")):
        if src in m:
            out[dst] = m[src]
    if "faster_eval" in m:
        out["remove_empty_box"] = not m["faster_eval"]
    return out


def build_model(cfg: dict = TEST_CONFIG, generate_limit: int = 64,
                device=None, mode: str | None = None):
    """`Config.build_model` on `device` (the current CUDA card when None),
    in eval mode and without gradients (a trainer turns both on); the
    phase is that of the mode's section (`mode` as in `eval_config`).
    Weights are uninitialised: load them with `weights.from_flax`,
    `weights.load_npz` or `weights.init_seeded`."""
    from .models.iscnet import ISCNet

    dev = resolve_device(device)
    mode = _mode(cfg, mode)
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
        mlp_dtype=torch.bfloat16 if d.get("mlp_bf16") else None,
        threshold=d["threshold"],
        completion_limit=d.get("completion_limit_in_train", 10),
    )
    return model.to(dev).eval().requires_grad_(False)


def bn_momentum(cfg: dict, epoch: int) -> float:
    """The BN-momentum schedule (`bnscheduler`):
    max(init * rate^(epoch // step), momentum_max)."""
    bs = cfg["bnscheduler"]
    return max(bs["bn_momentum_init"]
               * bs["bn_decay_rate"] ** int(epoch / bs["bn_decay_step"]),
               bs["bn_momentum_max"])

"""The comparisons that decide `correct`: the program's outputs against
the plain reference's on the same inputs and weights.

Each returns the cell's compared numbers, each a "widest gap" that is 0
when the two agree exactly; a cell's limits (`benchmark/limits/`) were
set between the readings of sound runs of the program and those of the
control (the reference in TF32, the precision just below the
configuration's float32), as `PERF.md` records."""

from __future__ import annotations

import torch

# the parsed fields of `ISCNet.generate` that a served request returns
PARSED = ("pred_corners_3d_upright_camera", "obj_prob", "pred_sem_cls",
          "pred_mask")


def served_to_host(out: dict, into: dict | None = None) -> dict:
    """A served request's answer on the host: the parsed boxes of every
    proposal with the NMS mask, the slots' proposal ids and valid flags,
    and the grids. With `into` (host buffers of the same layout, pinned
    on a card), copied there without waiting, then waited for once."""
    dev = {"parsed": {k: out["parsed"][k] for k in PARSED},
           "proposal_ids": out["gen"]["proposal_ids"],
           "valid": out["gen"]["valid"], "grids": out["grids"]}
    if into is None:
        return {k: ({n: t.cpu() for n, t in v.items()}
                    if isinstance(v, dict) else v.cpu())
                for k, v in dev.items()}
    for k, v in dev.items():
        if isinstance(v, dict):
            for n, t in v.items():
                into[k][n].copy_(t, non_blocking=True)
        else:
            into[k].copy_(v, non_blocking=True)
    if dev["grids"].is_cuda:
        torch.cuda.current_stream(dev["grids"].device).synchronize()
    return into


def host_buffers(answer: dict, pin: bool) -> dict:
    """Empty host buffers of `answer`'s layout (pinned with `pin`)."""
    def empty(t):
        b = torch.empty(t.shape, dtype=t.dtype)
        return b.pin_memory() if pin else b
    return {k: ({n: empty(t) for n, t in v.items()}
                if isinstance(v, dict) else empty(v))
            for k, v in answer.items()}


def served(prog: dict, ref: dict) -> dict:
    """`boxes`: the widest gap over every proposal's box corners (metres)
    and objectness, a proposal whose NMS verdict or class differs, and a
    slot whose proposal, GT box, class or valid flag differs, counting
    1.0 each. `grids`: the widest gap of a grid logit, over the
    reference's largest logit (at least 1)."""
    p, r = prog["parsed"], ref["parsed"]
    corners = p["pred_corners_3d_upright_camera"].double()
    e = (corners - r["pred_corners_3d_upright_camera"].double()).abs()
    e = e.amax(dim=(-1, -2))
    e = torch.maximum(e, (p["obj_prob"].double()
                          - r["obj_prob"].double()).abs())
    flips = ((p["pred_mask"] != r["pred_mask"])
             | (p["pred_sem_cls"] != r["pred_sem_cls"]))
    e = torch.where(flips, torch.ones_like(e), e)
    slots = ((prog["proposal_ids"] != ref["proposal_ids"]).any(-1)
             | (prog["valid"] != ref["valid"]))
    boxes = max(float(e.max()), 1.0 if bool(slots.any()) else 0.0)
    scale = max(float(ref["grids"].abs().max()), 1.0)
    grids = float((prog["grids"].double() - ref["grids"].double()).abs()
                  .max()) / scale
    return {"boxes": boxes, "grids": grids}


def leaf_norms(tensors: dict) -> dict:
    """{name: float64 L2 norm}."""
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


def _median(values) -> float:
    v = sorted(values)
    n = len(v)
    return v[n // 2] if n % 2 else 0.5 * (v[n // 2 - 1] + v[n // 2])


def worst_leaf_gap(prog: dict, ref: dict, leaves=None) -> float:
    """The widest gap between the program's and the reference's norm of a
    leaf, over the larger of the reference's norm of that leaf and of
    the median leaf: not the norm of the difference, since some leaves
    are all but zero."""
    leaves = sorted(ref) if leaves is None else leaves
    med = _median([ref[k] for k in leaves])
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in leaves)


def moved_leaves(grad_norms: dict, share: float = 1e-3) -> list:
    """The leaves whose reference gradient is not nought to rounding:
    those above `share` of the median leaf's gradient norm. The rest
    (such as a bias under a softmax or a batch norm) move under Adam by
    round-off alone."""
    med = _median(list(grad_norms.values()))
    return sorted(k for k, v in grad_norms.items() if v > share * med)


def trained(prog: dict, ref: dict) -> dict:
    """`loss`: the first step's total loss, relative gap. `grad`: the
    first step's gradient as the optimizer got it, by the worst leaf.
    `change`: the parameters' change after the checked steps, by the worst
    leaf of those the reference's gradient moves. The later steps' losses
    are not compared: a train step's backward sums with atomic adds, and
    that order's rounding moves later selections (the proposals a step
    completes), so the program read against itself differs there by as
    much as against the reference (`PERF.md`)."""
    loss = abs(prog["losses"][0] - ref["losses"][0]) / max(
        abs(ref["losses"][0]), 1e-30)
    grad = worst_leaf_gap(prog["grad"], ref["grad"])
    change = worst_leaf_gap(prog["change"], ref["change"],
                            moved_leaves(ref["grad"]))
    return {"loss": loss, "grad": grad, "change": change}

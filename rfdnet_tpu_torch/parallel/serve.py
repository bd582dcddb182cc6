"""Batched serving: the test-time generate path (`ISCNet.generate` with
`decode_grid_res`: detection, NMS, completion conditioning, dense
occupancy grids) over a batch of scenes, on one card or over the ranks
of a data group.

Counterpart of `rfdnet_tpu/parallel/serve.py`. The reference serves one
scene at a time; the JAX package jits `generate` with the batch sharded
over its data mesh. Here a batch of B scenes is one `generate` call on
one card (every kernel of the path runs once for the batch: FPS takes
its batch route from 8 scenes, the CBN decoder decodes the B x G
proposals' grids in one launch), or, with a data group, each rank runs
`generate` on its rows and the outputs are gathered back in global batch
order. Scenes do not interact: each scene's NMS, empty-box removal and
top-`generate_limit` selection are its own, so a scene gets what a
batch-1 call gives it. With GT fields in the batch, the eval losses
(`completion_loss`, `gen["mask_loss"]`) are the global batch's.

`grid_dtype`: float32 only. The JAX package's float16 grid transfer is
one of the TPU host link's transfer forms, left out of the port by
design (ROADMAP.md, open items); here the grids stay on the card in f32.
"""

from __future__ import annotations

import torch

from ..collectives import DataGroup, global_sum
from ..models.common import set_data_group
from ..utils.profiling import span
from .mesh import all_gather_rows, shard_batch

# the 0-d outputs of `generate`: the global batch's eval losses, each a
# rank's part of the global term (its numerator over the global
# denominator), so the global value is their sum
LOSS_PARTS = ("completion_loss", "gen/mask_loss")


def _gather(tree, group: DataGroup, path: str = ""):
    """Every tensor of `tree` (dicts of tensors) from all ranks: leading
    axes concatenated in rank order, the loss parts (`LOSS_PARTS`)
    summed. Any other 0-d tensor raises: its reduction over the ranks is
    not known here."""
    if isinstance(tree, dict):
        return {k: _gather(v, group, f"{path}{k}/") for k, v in tree.items()}
    if not torch.is_tensor(tree):
        return tree
    if tree.dim() > 0:
        return all_gather_rows(tree, group)
    if path.rstrip("/") not in LOSS_PARTS:
        raise ValueError(f"serve: a 0-d output {path.rstrip('/')!r} that "
                         "is not a loss part of the global batch")
    return global_sum(tree, group)


def make_sharded_generate(model, group: DataGroup | None = None,
                          **generate_kw):
    """Build serve(batch) -> `ISCNet.generate`'s outputs for the whole
    batch: `generate_kw` goes to `generate` (nms_iou, use_cls_nms,
    dump_threshold, remove_empty_box, decode_grid_res, ...). Without a
    group, one `generate` call on the batch (the one-card path). With
    one, this rank's rows (the batch size a multiple of the world size),
    then every output gathered: `grids`, `parsed`, `gen`, `end_points` in
    global batch order on every rank. The model must be in eval mode.
    Each call is the root span `serve`."""
    grid_dtype = generate_kw.pop("grid_dtype", "float32")
    if grid_dtype not in ("float32", torch.float32):
        raise ValueError(f"grid_dtype {grid_dtype!r}: the port serves "
                         "float32 grids only")

    def serve(batch: dict) -> dict:
        if group is not None:
            n = len(next(iter(batch.values())))
            if n % group.world:
                raise ValueError(f"a batch of {n} scenes over "
                                 f"{group.world} ranks")
        with span("serve"):
            before = model.data_group
            set_data_group(model, group)
            try:
                out = model.generate(shard_batch(batch, group), **generate_kw)
            finally:
                set_data_group(model, before)
            return out if group is None else _gather(out, group)

    return serve

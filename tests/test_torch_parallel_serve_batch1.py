"""The port's batched serving on one card (`rfdnet_tpu_torch/parallel/
serve.py`, no group: one `generate` call on the whole batch) against
batch-1 calls on the same scenes, with `torch_parity.serve_reference`'s
model and the first BATCH of its scenes (on the CPU a full-width scene
takes ~2 s; `chip_smoke.py`'s `serve` phase holds a batch of 8 to 8
calls on the card).

Scenes do not interact: each scene's NMS, empty-box removal and
top-`generate_limit` selection are its own, so a scene of the batch gets
what a batch-1 call gives it: selections equal, the AP table exactly,
the grids within 1e-5.
"""

import numpy as np
import torch

from rfdnet_tpu_torch.parallel.serve import make_sharded_generate
from torch_parity import (SERVE_KW, serve_ap_table, serve_reference,
                          served_numpy, t)


BATCH = 4


def test_one_card_batch_equals_batch_one_calls():
    full, _, port = serve_reference()
    full = {k: v[:BATCH] for k, v in full.items()}
    serve = make_sharded_generate(port, **SERVE_KW)
    with torch.no_grad():
        one_card = served_numpy(serve(
            {"point_clouds": t(full["point_clouds"])}))
        singles = [served_numpy(serve(
            {"point_clouds": t(full["point_clouds"][i:i + 1])}))
            for i in range(BATCH)]

    def stack(part):
        return {k: np.concatenate([s[part][k] for s in singles])
                for k, v in singles[0][part].items() if v.ndim}

    stacked = {"grids": np.concatenate([s["grids"] for s in singles]),
               "parsed": stack("parsed"), "gen": stack("gen")}
    for part in ("parsed", "gen"):
        for k, v in stacked[part].items():
            if v.dtype.kind in "biu":  # masks, selections, indices
                np.testing.assert_array_equal(v, one_card[part][k],
                                              err_msg=k)
    assert serve_ap_table(one_card, full) == serve_ap_table(stacked, full)
    np.testing.assert_allclose(one_card["grids"], stacked["grids"],
                               atol=1e-5, rtol=1e-5)

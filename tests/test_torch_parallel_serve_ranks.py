"""The port's batched serving over a data group (`rfdnet_tpu_torch/
parallel/serve.py` with 4 gloo ranks on the CPU, two scenes a rank, in
spawned processes: `tests/torch_dist.py`) against the JAX package's
`make_sharded_generate` on its 8-device virtual mesh, at
`tests/test_parallel_serve.py`'s sizes (`torch_parity.serve_reference`).

The gathered outputs come back in global batch order on every rank:
their AP table equals JAX's exactly, their grids agree within 5e-3 where
both selected the same proposal into the same slot, and each rank's own
rows sit at their place in the batch.
"""

import numpy as np
import pytest

from rfdnet_tpu_torch import config as tconfig
from torch_parity import (SERVE_KW, SERVE_MODEL_KW, assert_serve_matches,
                          serve_reference)
import torch_dist

WORLD = 4


@pytest.fixture(scope="module")
def setup():
    full, jax_out, port = serve_reference()
    state = {k: v.numpy() for k, v in port.state_dict().items()}
    model_kw = dict(mean_size_arr=tconfig.MEAN_SIZE_ARR, **SERVE_MODEL_KW)
    ranks = torch_dist.run(torch_dist.serve_rank, WORLD, model_kw, state,
                           {"point_clouds": full["point_clouds"]}, SERVE_KW)
    return full, jax_out, port, ranks


def test_ranks_match_jax_sharded(setup):
    full, jax_out, _, ranks = setup
    for r in ranks:
        assert_serve_matches(r, jax_out, full)


def test_ranks_gather_in_global_batch_order(setup):
    """Every rank holds the same gathered outputs: rank k's own rows (its
    `generate` on scenes 2k and 2k + 1) at their place in the batch."""
    _, _, _, ranks = setup

    def leaves(out):
        yield "grids", out["grids"]
        for part in ("parsed", "gen"):
            for name, v in out[part].items():
                if v.ndim:
                    yield f"{part}.{name}", v

    gathered = dict(leaves(ranks[0]))
    for r in ranks:
        for name, v in leaves(r):
            np.testing.assert_array_equal(v, gathered[name], err_msg=name)
    for k, r in enumerate(ranks):
        for name, mine in leaves(r["local"]):
            n = len(mine)
            assert len(gathered[name]) == n * WORLD, name
            np.testing.assert_array_equal(
                gathered[name][k * n:(k + 1) * n], mine, err_msg=name)

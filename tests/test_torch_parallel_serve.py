"""The port's batched serving on one card (`rfdnet_tpu_torch/parallel/
serve.py`, no group: one `generate` call on the whole batch) against the
JAX package's `make_sharded_generate` on its 8-device virtual mesh, at
`tests/test_parallel_serve.py`'s sizes (`torch_parity.serve_reference`:
1024 points, 8^3 grids, `completion_limit=4`, `generate_limit=8`, a
batch of 8 scenes).

The AP table (the Tester's per-scene assembly, then `APCalculator`) must
equal JAX's exactly; the grids agree with JAX's within 5e-3 where both
selected the same proposal into the same slot. `test_torch_parallel_
serve_batch1.py` holds the batch to eight batch-1 calls and
`test_torch_parallel_serve_ranks.py` serves it over 4 gloo ranks. The
gather over ranks sums only the loss parts it names.
"""

import pytest
import torch

from rfdnet_tpu_torch.parallel.serve import make_sharded_generate
from torch_parity import (SERVE_B, SERVE_KW, assert_serve_matches,
                          serve_reference, served_numpy, t)


@pytest.fixture(scope="module")
def setup():
    full, jax_out, port = serve_reference()
    with torch.no_grad():
        one_card = served_numpy(make_sharded_generate(port, **SERVE_KW)(
            {"point_clouds": t(full["point_clouds"])}))
    return full, jax_out, port, one_card


def test_one_card_batch_matches_jax_sharded(setup):
    full, jax_out, _, one_card = setup
    assert one_card["grids"].shape == (SERVE_B * 8, 8, 8, 8)
    assert_serve_matches(one_card, jax_out, full)


def test_grid_dtype_other_than_float32_raises(setup):
    port = setup[2]
    make_sharded_generate(port, grid_dtype="float32", **SERVE_KW)
    with pytest.raises(ValueError, match="float32"):
        make_sharded_generate(port, grid_dtype="float16", **SERVE_KW)


def test_gather_sums_only_the_loss_parts():
    """Over ranks, the gather sums the 0-d loss parts that it names
    (`LOSS_PARTS`) and refuses any other 0-d output, whose reduction over
    the ranks it cannot know (it raises before any collective, so no
    process group is needed here)."""
    from rfdnet_tpu_torch.collectives import DataGroup
    from rfdnet_tpu_torch.parallel import serve

    assert serve.LOSS_PARTS == ("completion_loss", "gen/mask_loss")
    group = DataGroup(None, 0, 2, torch.device("cpu"))
    for tree, name in (({"valid_count": torch.tensor(3.0)}, "valid_count"),
                       ({"gen": {"flag": torch.tensor(True)}}, "gen/flag")):
        with pytest.raises(ValueError, match=name):
            serve._gather(tree, group)

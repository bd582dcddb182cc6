"""One completion-phase step of `rfdnet_tpu_torch.tools.sanity_train`'s
step loop with `--freeze backbone,voting,detection` against the JAX tool's
frozen `make_train_step`, on the CPU (`torch_parity.check_sanity_step`):
a file of its own, so that its JAX compile runs beside the detection
step's (`test_torch_sanity_train.py`) on another worker.
"""

from torch_parity import check_sanity_step


def test_frozen_completion_step_matches_jax():
    check_sanity_step("completion")

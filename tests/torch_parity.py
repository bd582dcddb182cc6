"""Shared set-up of the `test_torch_*` parity tests: one set of flax
variables for both packages, and numpy inputs made from a seed.

The flax variables come from `model.init` plus seeded numpy noise (the
realistic-weights regime of `tests/test_cbn_decoder.py`: at init every
zero-initialised layer is zero and every CBN is the identity). The port
loads them through `weights.from_flax`.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rfdnet_tpu.config.config import Config
from rfdnet_tpu.data.synthetic import synthetic_scene_batch
from rfdnet_tpu.models import ISCNet
from rfdnet_tpu_torch import config as tconfig
from rfdnet_tpu_torch.weights import from_flax

TEST_YAML = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "iscnet_test.yaml")

# f32 module outputs (tests/test_parity_torch.py:41-42)
ATOL, RTOL = 3e-5, 2e-4


def perturb(variables, seed: int, noise: float = 0.02):
    """numpy copy of `variables` with N(0, noise^2) added to every leaf."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda leaf: np.asarray(leaf) + rng.randn(*np.shape(leaf)).astype(
            np.float32) * noise,
        jax.tree_util.tree_map(np.asarray, dict(variables)),
    )


def _jit_arrays(fn, *args):
    """fn(*args) jitted over the array arguments (pytrees of arrays);
    Python scalars and None stay static."""
    traced = [i for i, a in enumerate(args)
              if not isinstance(a, (bool, int, float, type(None)))]

    def call(*arrays):
        full = list(args)
        for i, a in zip(traced, arrays):
            full[i] = a
        return fn(*full)

    return jax.jit(call)(*(args[i] for i in traced))


def init_flax(module, seed: int, *args, noise: float = 0.02, **kwargs):
    """Perturbed numpy variables of a flax module initialised on args."""
    variables = _jit_arrays(
        lambda *a: module.init(jax.random.PRNGKey(seed), *a, **kwargs), *args)
    return perturb(variables, seed, noise)


def apply_flax(module, variables, *args, **kwargs):
    """module.apply(variables, *args, **kwargs), jitted."""
    return _jit_arrays(lambda v, *a: module.apply(v, *a, **kwargs),
                       variables, *args)


def load_port(module: torch.nn.Module, variables) -> torch.nn.Module:
    """Load numpy flax variables into a port module, strictly."""
    module.load_state_dict(from_flax(variables), strict=True)
    return module.eval().requires_grad_(False)


def scene(seed: int, num_points: int = 4096) -> np.ndarray:
    """(1, num_points, 4) synthetic ScanNet-format scene with height."""
    return synthetic_scene_batch(
        np.random.RandomState(seed), batch_size=1, num_points=num_points,
        mean_size_arr=tconfig.MEAN_SIZE_ARR,
    )["point_clouds"]


def iscnet_pair(generate_limit: int = 8, seed: int = 0):
    """(jax model, numpy variables, port model on the CPU) of the test
    config, the variables from `init` through `ISCNet.generate`, which
    creates every parameter of the generation path, and the posterior
    encoder's (which only the completion loss reaches) from an `init` of
    its own, added without moving the others' values."""
    from rfdnet_tpu.models.layers import EncoderLatent

    cfg = Config(TEST_YAML, mode="test", make_dirs=False)
    model = cfg.build_model(generate_limit=generate_limit)
    pc = jnp.asarray(scene(seed))
    variables = jax.jit(lambda pc: model.init(
        jax.random.PRNGKey(seed), {"point_clouds": pc},
        method=ISCNet.generate, decode_grid_res=2,
    ))(pc)
    variables = perturb(variables, seed)
    z_dim, c_dim = cfg.config["data"]["z_dim"], cfg.config["data"]["c_dim"]
    encoder = init_flax(EncoderLatent(z_dim=z_dim), seed + 1000,
                        jnp.zeros((1, 8, 3)), jnp.zeros((1, 8)),
                        jnp.zeros((1, c_dim)))
    variables["params"]["completion"]["encoder_latent"] = encoder["params"]
    port = tconfig.build_model(generate_limit=generate_limit, device="cpu")
    return model, variables, load_port(port, variables)


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def assert_close(got, want, atol=ATOL, rtol=RTOL, what=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol,
                               rtol=rtol, err_msg=what)


def assert_equal(got, want, what=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=what)

"""`Generator3D` with all options on the host-MISE route, in the port
against `rfdnet_tpu`'s, on the CPU: the port runs its own octrees and
decodes, JAX's generator meshes the port's grids (tolerances: see
`test_torch_refine.py`).
"""

from test_torch_refine import check_generator_options, codes, pair  # noqa: F401


def test_generator_options_match_jax_on_host_mise(pair, codes, monkeypatch):
    check_generator_options(pair, codes, monkeypatch, "host_mise")

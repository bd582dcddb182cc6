"""Seeded weights, made on the device in a few large calls.

Every tensor of the model's state follows the init of RfD-Net's
reference code as the JAX package writes it: a `Dense` weight and bias
U(-1/sqrt(fan_in), 1/sqrt(fan_in)), zero where that layer is
zero-initialised (`zero_init`), batch norms the identity (scale 1, bias 0,
running mean 0, running var 1), every CBN affine the identity (gamma bias
1, beta bias 0). Then N(0, noise^2) is added to
every tensor: at init every `fc_1` is zero and every CBN the identity,
which would leave the decoder's products untested.

The draws are one `torch.rand` for all the uniforms and one `torch.randn`
for all the noise, from a generator on the device seeded with the run's
seed, so a seed gives the same weights on every run and to both sides
(the program and the reference)."""

from __future__ import annotations

import torch

NOISE = 0.02


def _class_names(module) -> set:
    return {c.__name__ for c in type(module).__mro__}


def seeded_state(model: torch.nn.Module, seed: int, device,
                 noise: float = NOISE) -> dict:
    """{state_dict key: tensor on `device`} for `model`'s state (its module
    names and shapes; its values are not read)."""
    names = dict(model.named_modules())
    keys = list(model.state_dict().keys())
    shapes = {k: t.shape for k, t in model.state_dict().items()}
    base, uniform = {}, []  # uniform: (key, bound)
    for key in keys:
        owner, leaf = key.rsplit(".", 1)
        m, kinds = names[owner], _class_names(names[owner])
        parent = names.get(owner.rsplit(".", 1)[0]) if "." in owner else None
        in_cbn = parent is not None and "CBatchNorm" in _class_names(parent)
        if "Dense" in kinds:
            if in_cbn and leaf == "bias":
                base[key] = 1.0 if owner.endswith("gamma") else 0.0
            elif leaf == "weight" and m.zero_init:
                base[key] = 0.0
            else:
                uniform.append((key, 1.0 / m.in_features ** 0.5))
        elif leaf in ("weight", "running_var"):
            base[key] = 1.0   # batch-norm scale, running var
        elif leaf in ("bias", "running_mean"):
            base[key] = 0.0
        else:
            raise ValueError(f"seeded_state: no init rule for {key}")
    g = torch.Generator(device=device).manual_seed(int(seed))
    numel = lambda k: shapes[k].numel()
    u = torch.rand(sum(numel(k) for k, _ in uniform), generator=g,
                   device=device)
    z = torch.randn(sum(numel(k) for k in keys), generator=g, device=device)
    out, at = {}, 0
    for key, bound in uniform:
        n = numel(key)
        out[key] = ((u[at:at + n] * 2 - 1) * bound).reshape(shapes[key])
        at += n
    for key, value in base.items():
        out[key] = torch.full(shapes[key], value, device=device)
    at = 0
    for key in keys:
        n = numel(key)
        out[key] = out[key] + noise * z[at:at + n].reshape(shapes[key])
        at += n
    return out


def for_run(ctx, mode: str) -> dict:
    """The run's weights: `seeded_state` over the reference model of the
    run's configuration in `mode`, from the run's seed, on its device."""
    from rfdref import config as refconfig

    skeleton = refconfig.build_model(ctx.config["config"], mode,
                                     ctx.config["generate_limit"], "cpu")
    return seeded_state(skeleton, ctx.seed % 2 ** 63, ctx.device)

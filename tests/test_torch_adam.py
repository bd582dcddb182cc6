"""The port's Adam (`rfdnet_tpu_torch/train/trainer.py`) on the CPU: the
plain multi-leaf update against the per-leaf loop it replaced, bit for
bit; the table that `csrc/adam.cu` reads, followed here in numpy through
its addresses; the state kept in place across steps and loads; what
`Adam.step` refuses. The kernel itself runs only on the card
(`chip_smoke.py`'s `adam` phase holds it to `adam_update_plain` there)."""

import ctypes

import numpy as np
import pytest
import torch
from torch import nn

from rfdnet_tpu_torch.train import trainer as ttrainer


class Toy(nn.Module):
    """Three top-level submodules of mixed leaf shapes (an odd count, a
    matrix, a vector of 1, a 3-D kernel)."""

    def __init__(self):
        super().__init__()
        self.backbone = nn.Sequential(nn.Linear(7, 5), nn.Conv1d(5, 3, 3))
        self.detection = nn.Linear(5, 1)
        self.completion = nn.Sequential(nn.Linear(3, 9), nn.LayerNorm(9))


# model.<submodule>.optimizer overrides, as a config gives them
SPECS = {
    "one": {},
    "two": {"completion": {"optimizer": {"lr": 3e-4, "weight_decay": 1e-2,
                                         "betas": [0.8, 0.99], "eps": 1e-6}}},
}
FROZEN = {"one": (), "two": ("detection",)}
BASE = {"lr": 1e-3, "betas": [0.9, 0.999], "eps": 1e-8, "weight_decay": 0}


def per_leaf_step(params, specs, mu, nu, count, lr):
    """The update as the port wrote it before the kernel: ~22 ops a leaf,
    the bias corrections and -lr recomputed a leaf on its device, new
    moments every step."""
    one = torch.ones((), dtype=torch.float32, device=params[0].device)
    for i, (p, s) in enumerate(zip(params, specs)):
        g = p.grad
        if s.weight_decay:
            g = g + s.weight_decay * p
        b1, b2 = s.betas
        mu[i] = (1 - b1) * g + b1 * mu[i]
        nu[i] = (1 - b2) * g ** 2 + b2 * nu[i]
        corr1 = 1 - (b1 * one) ** count
        corr2 = 1 - (b2 * one) ** count
        u = (mu[i] / corr1) / (torch.sqrt(nu[i] / corr2) + s.eps)
        coef = (-lr * one) * s.lr_scale
        p.add_(coef * u)


def optimizer(case: str, seed: int = 0):
    torch.manual_seed(seed)
    model = Toy()
    spec_of = ttrainer.make_optimizer_with_specs(BASE, SPECS[case])
    return model, ttrainer.Adam(ttrainer.freeze(model, FROZEN[case]),
                                spec_of)


def grads(opt, step: int):
    """Seeded gradients of step `step`, a few of each leaf exactly 0."""
    g = torch.Generator().manual_seed(100 + step)
    out = []
    for p in opt.params:
        x = torch.randn(p.shape, generator=g) * 10.0 ** (step - 2)
        x.view(-1)[::3] = 0.0
        out.append(x)
    return out


def set_grads(opt, gs):
    for p, g in zip(opt.params, gs):
        p.grad = g.clone()


LRS = (1e-3, 1e-3, 2.5e-4)


@pytest.mark.parametrize("case", sorted(SPECS))
def test_plain_update_equals_the_per_leaf_loop(case):
    model, opt = optimizer(case)
    frozen = [p.clone() for n, p in model.named_parameters()
              if n.split(".")[0] in FROZEN[case]]
    params = [p.detach().clone() for p in opt.params]
    specs = [opt.groups[k] for k in opt.spec_index]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    assert len(opt.groups) == (2 if case == "two" else 1)
    for step, lr in enumerate(LRS, 1):
        gs = grads(opt, step)
        set_grads(opt, gs)
        opt.step(lr)
        for p, g in zip(params, gs):
            p.grad = g.clone()
        per_leaf_step(params, specs, mu, nu, step, lr)
        for name, a, b in zip(opt.names, opt.params, params):
            assert torch.equal(a, b), (step, name)
        for a, b in zip(opt.mu + opt.nu, mu + nu):
            assert torch.equal(a, b), step
    assert opt.count == 3
    after = [p for n, p in model.named_parameters()
             if n.split(".")[0] in FROZEN[case]]
    assert all(torch.equal(a, b) for a, b in zip(after, frozen))
    if case == "two":
        decayed = [opt.groups[k].weight_decay for k in opt.spec_index]
        assert 0 < decayed.count(1e-2) < len(decayed)
        assert sorted({opt.groups[k].lr_scale for k in opt.spec_index}) \
            == [pytest.approx(0.3), 1.0]


def _array(address: int, n: int, ctype) -> np.ndarray:
    return np.ctypeslib.as_array((ctype * int(n)).from_address(int(address)))


def follow_table(table: np.ndarray, n_leaves: int, n_specs: int,
                 n_chunks: int, chunk: int) -> None:
    """What `adam_kernel` does, a block at a time, in numpy f32 (each op
    rounded once): each chunk's leaf, its spec's scalars and its elements
    found through the table alone, updated in place at their addresses."""
    leaves = table[:8 * n_leaves].reshape(n_leaves, 8)
    specs = table[8 * n_leaves:8 * n_leaves + 6 * n_specs].view(
        np.float32).reshape(n_specs, 12)
    chunk_leaf = table[8 * n_leaves + 6 * n_specs:].view(np.int32)
    for block in range(n_chunks):
        p_at, g_at, m_at, v_at, n, first, spec, _ = leaves[chunk_leaf[block]]
        wd, omb1, b1, omb2, b2, c1, c2, eps, coef = specs[spec][:9]
        begin = (block - first) * chunk
        end = min(n, begin + chunk)
        P, G, M, V = (_array(a, n, ctypes.c_float)[begin:end]
                      for a in (p_at, g_at, m_at, v_at))
        g = G + wd * P if wd != 0 else G
        M[:] = omb1 * g + b1 * M
        V[:] = omb2 * (g * g) + b2 * V
        P[:] = P + coef * ((M / c1) / (np.sqrt(V / c2) + eps))


@pytest.mark.parametrize("case", sorted(SPECS))
def test_table_drives_the_kernel_arithmetic(case):
    """Chunks of 4 elements, so leaves span several chunks and end in
    short ones."""
    _, opt = optimizer(case)
    _, ref = optimizer(case)
    for step, lr in enumerate(LRS, 1):
        gs = grads(opt, step)
        set_grads(opt, gs)
        set_grads(ref, gs)
        table, n_chunks = ttrainer.adam_table(
            opt.params, [p.grad for p in opt.params], opt.mu, opt.nu,
            opt.spec_index, opt.groups, step, lr, chunk=4)
        assert table.dtype == torch.int64
        assert n_chunks == sum(-(-p.numel() // 4) for p in opt.params)
        with torch.no_grad():
            follow_table(table.numpy(), len(opt.params), len(opt.groups),
                         n_chunks, 4)
        ref.step(lr)
        for a, b in zip(opt.params + opt.mu + opt.nu,
                        ref.params + ref.mu + ref.nu):
            assert torch.equal(a, b), step


@pytest.mark.parametrize("resume_after", [1, 2])
def test_state_round_trip_and_moments_in_place(resume_after):
    """`state_dict` -> numpy (as a checkpoint holds it) -> another
    optimizer's `load_state_dict` -> steps equals the uninterrupted run;
    `mu` / `nu` stay the same tensors across steps and loads."""
    _, straight = optimizer("two")
    _, first = optimizer("two")
    moments = [(id(t), t.data_ptr()) for t in straight.mu + straight.nu]
    for step, lr in enumerate(LRS, 1):
        set_grads(straight, grads(straight, step))
        straight.step(lr)
        if step <= resume_after:
            set_grads(first, grads(first, step))
            first.step(lr)
    assert [(id(t), t.data_ptr()) for t in straight.mu + straight.nu] \
        == moments
    saved = {k: np.array(v.detach()) if torch.is_tensor(v) else np.asarray(v)
             for k, v in first.state_dict().items()}
    params = {n: p.detach().clone() for n, p in zip(first.names,
                                                    first.params)}
    model, resumed = optimizer("two", seed=1)  # other weights, overwritten
    with torch.no_grad():
        for n, p in zip(resumed.names, resumed.params):
            p.copy_(params[n])
    kept = [(id(t), t.data_ptr()) for t in resumed.mu + resumed.nu]
    resumed.load_state_dict(saved)
    assert [(id(t), t.data_ptr()) for t in resumed.mu + resumed.nu] == kept
    assert resumed.count == resume_after
    for step, lr in enumerate(LRS[resume_after:], resume_after + 1):
        set_grads(resumed, grads(resumed, step))
        resumed.step(lr)
    assert [(id(t), t.data_ptr()) for t in resumed.mu + resumed.nu] == kept
    for a, b in zip(resumed.params + resumed.mu + resumed.nu,
                    straight.params + straight.mu + straight.nu):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="shape"):
        resumed.load_state_dict({**saved, f"mu/{resumed.names[0]}":
                                 np.zeros(3, np.float32)})


def _double(opt):
    opt.params[1].data = opt.params[1].data.double()
    opt.params[1].grad = torch.ones_like(opt.params[1])


def _transposed(opt):
    opt.params[0].data = opt.params[0].data.t().contiguous().t()
    opt.params[0].grad = torch.ones_like(opt.params[0])


def _no_grad(opt):
    opt.params[2].grad = None


def _grad_shape(opt):
    opt.params[0].data = opt.params[0].data.reshape(-1)


@pytest.mark.parametrize("fault, message", [
    (_double, "dtype torch.float64, expected torch.float32"),
    (_transposed, "must be contiguous"),
    (_no_grad, "has no gradient"),
    (_grad_shape, r"\.grad: shape"),
])
def test_step_refuses_what_the_kernel_does_not_take(fault, message):
    _, opt = optimizer("one")
    set_grads(opt, grads(opt, 1))
    before = [p.detach().clone() for p in opt.params]
    fault(opt)
    with pytest.raises(ValueError, match=message):
        opt.step(1e-3)
    assert opt.count == 0
    untouched = [i for i, (p, b) in enumerate(zip(opt.params, before))
                 if p.dtype == b.dtype and torch.equal(p, b)]
    assert len(untouched) >= len(before) - 1  # the check comes first

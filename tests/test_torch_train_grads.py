"""The backward of each module in train mode, the port against
`rfdnet_tpu`, on the CPU: the gradient of a fixed random linear function of
a module's train-mode outputs with respect to its parameters, from the same
flax variables (`torch_parity.init_flax`) and numpy inputs made from a seed.

Tolerance: each parameter's gradient within a relative L2 error of 1e-2
(GRAD_RTOL; PointSeg and skip propagation GRAD_RTOL_POOLED: their STN heads
batch-normalise a max-pooled feature over 8 groups, whose mean dwarfs its
spread, so the f32 variance mean_sq - mean^2 keeps few digits in either
package), for the parameters whose gradient is not rounding noise (a
gradient under NOISE_FLOOR times the largest of its module is zero in exact
arithmetic: the bias of a layer that a train-mode batch norm follows, a
shift the next batch norm removes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rfdnet_tpu.models import common as jcommon
from rfdnet_tpu.models import layers as jlayers
from rfdnet_tpu.models import pointseg as jpointseg
from rfdnet_tpu.models import proposal as jproposal
from rfdnet_tpu.models import skip_propagation as jskip
from rfdnet_tpu.models import voting as jvoting
from rfdnet_tpu_torch.models import common as tcommon
from rfdnet_tpu_torch.models import layers as tlayers
from rfdnet_tpu_torch.models import pointseg as tpointseg
from rfdnet_tpu_torch.models import proposal as tproposal
from rfdnet_tpu_torch.models import skip_propagation as tskip
from rfdnet_tpu_torch.models import voting as tvoting
from rfdnet_tpu_torch.weights import from_flax
from torch_parity import grid_batch, init_flax, rel_l2, t

GRAD_RTOL, NOISE_FLOOR = 1e-2, 1e-3
# modules whose train-mode batch norms see a global max-pooled feature over
# few samples (mean >> spread, so var = mean_sq - mean^2 cancels)
GRAD_RTOL_POOLED = {"pointseg": 5e-2, "skip_propagation": 0.25}


def _module_cases():
    rng = np.random.RandomState(5)
    xyz = rng.uniform(-2, 2, (2, 128, 3)).astype(np.float32)
    feat = rng.randn(2, 128, 256).astype(np.float32)
    cases = {}
    cases["shared_mlp"] = (
        jcommon.SharedMLP([16, 32]), tcommon.SharedMLP(8, [16, 32]),
        (rng.randn(2, 64, 16, 8).astype(np.float32),), {})
    cases["voting"] = (jvoting.VotingModule(), tvoting.VotingModule(),
                       (xyz, feat), {})
    for sampling in ("seed_fps", "vote_fps"):
        cases[f"proposal_{sampling}"] = (
            jproposal.ProposalModule(num_proposal=16, sampling=sampling),
            tproposal.ProposalModule(num_proposal=16, sampling=sampling),
            (xyz, feat, {"seed_xyz": xyz}), {})
    cases["pointseg"] = (jpointseg.PointSeg(channel=4),
                         tpointseg.PointSeg(channel=4),
                         (rng.randn(8, 256, 4).astype(np.float32),), {})
    b = grid_batch(6, num_points=1024)
    P = 4
    centers = (b["center_label"][:, :P]
               + rng.randn(2, P, 3) * 0.05).astype(np.float32)
    cases["skip_propagation"] = (
        jskip.SkipPropagation(c_dim=64, hidden_dim=64),
        tskip.SkipPropagation(c_dim=64, hidden_dim=64),
        (centers, rng.uniform(-3, 3, (2, P)).astype(np.float32),
         rng.randn(2, P, 128).astype(np.float32), b["point_clouds"],
         b["point_instance_labels"], b["object_instance_labels"][:, :P]), {})
    c = rng.randn(6, 64).astype(np.float32)
    cases["decoder"] = (
        jlayers.DecoderCBatchNorm(z_dim=8),
        tlayers.DecoderCBatchNorm(c_dim=64, z_dim=8),
        (rng.uniform(-0.55, 0.55, (6, 100, 3)).astype(np.float32),
         rng.randn(6, 8).astype(np.float32), c), {})
    return cases


@pytest.mark.parametrize("name", sorted(_module_cases()))
def test_module_gradients_in_train_mode(name):
    """The gradient of a fixed random linear function of a module's
    train-mode outputs with respect to its parameters."""
    jm, tm, args, _ = _module_cases()[name]
    jargs = [jax.tree_util.tree_map(jnp.asarray, a) for a in args]
    variables = init_flax(jm, 7, *jargs, False)
    rng = np.random.RandomState(8)

    def outputs_j(params):
        out, _ = jm.apply({"params": params,
                           "batch_stats": variables["batch_stats"]},
                          *jargs, True, 0.5, mutable=["batch_stats"])
        if isinstance(out, tuple) and isinstance(out[0], dict):
            out = (out[0]["center"], out[0]["objectness_scores"], out[1])
        return [o for o in (out if isinstance(out, tuple) else (out,))
                if o is not None and jnp.ndim(o) > 0] + (
            [out[1]] if name == "skip_propagation" else [])

    shapes = [np.shape(o) for o in outputs_j(variables["params"])]
    weights = [np.asarray(rng.randn(*s), np.float32) for s in shapes]

    def loss_j(params):
        return sum(jnp.sum(o * w) for o, w in
                   zip(outputs_j(params), weights))

    want = from_flax({"params": jax.jit(jax.grad(loss_j))(
        variables["params"])})
    tm.load_state_dict(from_flax(variables))
    tm.train()
    tcommon.set_bn_momentum(tm, 0.5)
    targs = [{k: t(v) for k, v in a.items()} if isinstance(a, dict) else t(a)
             for a in args]
    out = tm(*targs)
    if isinstance(out, tuple) and isinstance(out[0], dict):
        out = (out[0]["center"], out[0]["objectness_scores"], out[1])
    outs = [o for o in (out if isinstance(out, tuple) else (out,))
            if o is not None and o.dim() > 0] + (
        [out[1]] if name == "skip_propagation" else [])
    sum((o * t(w)).sum() for o, w in zip(outs, weights)).backward()
    grads = dict(tm.named_parameters())
    floor = NOISE_FLOOR * max(np.linalg.norm(want[n]) for n in grads)
    checked = 0
    for n, p in grads.items():
        if np.linalg.norm(want[n]) > floor:
            assert rel_l2(p.grad, want[n]) <= GRAD_RTOL_POOLED.get(
                name, GRAD_RTOL), n
            checked += 1
    assert checked >= len(grads) // 2

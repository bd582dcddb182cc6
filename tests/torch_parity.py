"""Shared set-up of the `test_torch_*` parity tests: one set of flax
variables for both packages, numpy inputs made from a seed, and the
training tests' configs, batches and one-step check.

The flax variables come from `model.init` plus seeded numpy noise (the
realistic-weights regime of `tests/test_cbn_decoder.py`: at init every
zero-initialised layer is zero and every CBN is the identity). The port
loads them through `weights.from_flax`.
"""

from __future__ import annotations

import fcntl
import functools
import hashlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rfdnet_tpu.config.config import Config, update_recursive
from rfdnet_tpu.data.synthetic import synthetic_scene_batch
from rfdnet_tpu.models import ISCNet
from rfdnet_tpu_torch import config as tconfig
from rfdnet_tpu_torch.weights import from_flax

# the suite runs several test processes at once (xdist workers): torch's
# default of one intra-op thread a core would oversubscribe the cores
torch.set_num_threads(max(1, (os.cpu_count() or 1) // 4))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST_YAML = os.path.join(ROOT, "configs", "iscnet_test.yaml")
# set-up shared by the test processes of a run (and later runs): computed
# once under a lock, then read (beside JAX's compilation cache)
CACHE_DIR = os.path.join(ROOT, ".jax_cache", "torch_parity")
# what a cached set-up depends on besides its arguments
_CACHE_SOURCES = ("rfdnet_tpu/models", "rfdnet_tpu/config",
                  "rfdnet_tpu/data/synthetic.py", "rfdnet_tpu/ops",
                  "rfdnet_tpu/parallel", "rfdnet_tpu/train",
                  "configs/iscnet_test.yaml", "configs/iscnet.yaml",
                  "configs/iscnet_detection.yaml",
                  "configs/iscnet_completion.yaml", "tests/torch_parity.py")

# f32 module outputs (tests/test_parity_torch.py:41-42)
ATOL, RTOL = 3e-5, 2e-4


def perturb(variables, seed: int, noise: float = 0.02):
    """numpy copy of `variables` with N(0, noise^2) added to every leaf."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda leaf: np.asarray(leaf) + np.asarray(
            rng.randn(*np.shape(leaf)), np.float32) * noise,
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


def _source_digest(extra=()) -> str:
    h = hashlib.sha1(jax.__version__.encode())
    for rel in (*_CACHE_SOURCES, *extra):
        path = os.path.join(ROOT, rel)
        files = ([os.path.join(d, f) for d, _, fs in os.walk(path)
                  for f in fs if f.endswith(".py")]
                 if os.path.isdir(path) else [path])
        for f in sorted(files):
            h.update(f.encode())
            with open(f, "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()


def cached_tree(key: str, compute, sources=()):
    """compute() (a nested dict of numpy arrays), stored in CACHE_DIR under
    `key` and a digest of the sources it depends on (and of `sources`, the
    paths of further files, such as the test that defines the inputs):
    the first process computes it under a file lock, the others wait and
    read the file."""
    os.makedirs(CACHE_DIR, exist_ok=True)
    path = os.path.join(CACHE_DIR,
                        f"{key}-{_source_digest(sources)[:16]}.npz")
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not os.path.exists(path):
                flat = {"/".join(k): np.asarray(v) for k, v in
                        _flatten(compute())}
                tmp = path + f".{os.getpid()}.tmp.npz"
                np.savez(tmp, **flat)
                os.replace(tmp, path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    tree = {}
    with np.load(path) as npz:
        for key_path in npz.files:
            node = tree
            *parents, leaf = key_path.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = npz[key_path]
    return tree


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def iscnet_pair(generate_limit: int = 8, seed: int = 0):
    """(jax model, numpy variables, port model on the CPU) of the test
    config, the variables from `init` through `ISCNet.generate`, which
    creates every parameter of the generation path, and the posterior
    encoder's (which only the completion loss reaches) from an `init` of
    its own, added without moving the others' values."""
    from rfdnet_tpu.models.layers import EncoderLatent

    cfg = Config(TEST_YAML, mode="test", make_dirs=False)
    model = cfg.build_model(generate_limit=generate_limit)

    def init():
        pc = jnp.asarray(scene(seed))
        variables = jax.jit(lambda pc: model.init(
            jax.random.PRNGKey(seed), {"point_clouds": pc},
            method=ISCNet.generate, decode_grid_res=2,
        ))(pc)
        variables = perturb(variables, seed)
        z_dim = cfg.config["data"]["z_dim"]
        c_dim = cfg.config["data"]["c_dim"]
        encoder = init_flax(EncoderLatent(z_dim=z_dim), seed + 1000,
                            jnp.zeros((1, 8, 3)), jnp.zeros((1, 8)),
                            jnp.zeros((1, c_dim)))
        variables["params"]["completion"]["encoder_latent"] = (
            encoder["params"])
        return variables

    variables = cached_tree(f"iscnet_pair-{generate_limit}-{seed}", init)
    port = tconfig.build_model(generate_limit=generate_limit, device="cpu")
    return model, variables, load_port(port, variables)


def iscnet_decoder_pair(generate_limit: int = 8, seed: int = 0):
    """`iscnet_pair`'s values for the occupancy decoder alone, without
    compiling `ISCNet.generate`: (jax model, the variables that
    `decode_occupancy` reaches, port model on the CPU with them loaded
    into its completion module). Flax draws a parameter from its module's
    path, so an init through `decode_occupancy` gives the whole model's
    decoder values; `perturb`'s noise is drawn over the whole model's
    leaves (their shapes from `jax.eval_shape`) and the decoder's kept."""
    cfg = Config(TEST_YAML, mode="test", make_dirs=False)
    model = cfg.build_model(generate_limit=generate_limit)
    shapes = jax.eval_shape(lambda pc: model.init(
        jax.random.PRNGKey(seed), {"point_clouds": pc},
        method=ISCNet.generate, decode_grid_res=2), jnp.asarray(scene(seed)))
    noise = perturb(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes), seed)
    n, c_dim = generate_limit, cfg.config["data"]["c_dim"]
    decoder = _jit_arrays(lambda *a: model.init(
        jax.random.PRNGKey(seed), *a, method=ISCNet.decode_occupancy),
        jnp.zeros((n, c_dim)), jnp.zeros((n, model.num_class)),
        jnp.zeros((n, 8, 3)))
    variables = {k: {"completion": jax.tree_util.tree_map(
        lambda v, e: np.asarray(v) + e, decoder[k]["completion"],
        noise[k]["completion"])} for k in decoder}
    port = tconfig.build_model(generate_limit=generate_limit, device="cpu")
    for name in variables["params"]["completion"]:
        load_port(getattr(port.completion, name),
                  {k: v["completion"].get(name, {})
                   for k, v in variables.items()})
    return model, variables, port.eval()


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


# ------------------------------------------------------------- training
# Shared by `test_torch_train*.py`. `check_train_step` holds one train step
# of a stage against `rfdnet_tpu.train.trainer.make_train_step`. The scene
# points sit on a 1/128 grid (`grid_batch`), so that every distance between
# them is exact in f32 and FPS, ball query and three-NN see the same numbers
# in both packages. What stays apart is the f32 rounding of the batch
# statistics: XLA's reductions on the CPU and torch's sum in other orders
# (the port lands 3-8x nearer a float64 run of itself than the JAX package
# does), and through ~20 train-mode batch norms that reaches ~5e-4 at the
# heads. There it moves discrete choices whose margin is smaller: a ReLU
# input near 0, the argmax of PointSeg's two nearly equal logits (random
# weights), a point on a ball's radius. So the step's gradients (Adam's
# first moment) are held per top-level module to a relative L2 error of
# STEP_GRAD_RTOL, the updated parameters to Adam's bound (no parameter moves
# by more than lr x its LR scale, so two updates differ by at most twice
# that) and exactly to optax's Adam on the port's own gradients, and the
# running statistics to STEP_STATS_ATOL / STEP_STATS_RTOL. The batches'
# seeds are ones whose losses keep f32's tolerance: at other seeds a point
# on the radius of a proposal's 1 m ball moves the mask loss by ~1e-3.
STEP_GRAD_RTOL = 0.3
STEP_STATS_ATOL, STEP_STATS_RTOL = 0.05, 2e-2
# the training configs at a CPU size: every width the configs set, cut
SMALL = {"data": {"num_point": 1024, "num_target": 32, "c_dim": 64,
                  "hidden_dim": 64, "z_dim": 8,
                  "completion_limit_in_train": 4}}
STAGES = {
    "stage1_detection": ("iscnet_detection.yaml", {}, 1),
    "stage2_completion_frozen": ("iscnet_completion.yaml", {}, 4),
    "stage3_joint": ("iscnet.yaml", {
        "optimizer": {"weight_decay": 1e-4},
        "model": {"detection": {"optimizer": {"lr": 1e-5,
                                              "weight_decay": 0}}}}, 4),
}


def on_grid(scene: dict) -> dict:
    """`scene` with its points (and heights) on `grid_batch`'s 1/128 grid."""
    scene = dict(scene)
    pc = scene["point_clouds"].copy()
    pc[..., :3] = np.round(pc[..., :3] * 128) / 128
    floor = np.percentile(pc[..., 2], 0.99, axis=1)[:, None]
    pc[..., 3] = np.round((pc[..., 2] - floor) * 128) / 128
    scene["point_clouds"] = pc
    return scene


def grid_batch(seed: int, batch_size: int = 2, num_points: int = 1024):
    """A synthetic batch whose scene points (and heights) lie on a 1/128
    grid."""
    return on_grid(synthetic_scene_batch(
        np.random.RandomState(seed), batch_size=batch_size,
        num_points=num_points, mean_size_arr=tconfig.MEAN_SIZE_ARR))


def torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def rel_l2(got, want) -> float:
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def train_configs(stage: str):
    """(JAX Config, port config dict) of a training stage at SMALL's widths."""
    name, extra, _ = STAGES[stage]
    path = os.path.join(ROOT, "configs", name)
    over = {**extra, "data": SMALL["data"]}
    jcfg = Config(path, mode="train", make_dirs=False)
    update_recursive(jcfg.config, over)
    cfg = tconfig.load_config(path, mode="train")
    tconfig.update_recursive(cfg, over)
    return jcfg, cfg


@functools.cache
def step_variables(phase: str):
    """Perturbed flax variables of the small detection model (`phase`
    "detection") or of the small completion model ("completion", which
    stages 2 and 3 share)."""
    stage = {"detection": "stage1_detection",
             "completion": "stage3_joint"}[phase]
    jcfg, _ = train_configs(stage)
    model = jcfg.build_model()

    def init():
        b = {k: jnp.asarray(v) for k, v in grid_batch(0).items()}
        variables = jax.jit(lambda b: model.init(
            jax.random.PRNGKey(0), b, train=False,
            rng=jax.random.PRNGKey(1)))(b)
        return perturb(variables, 0)

    return cached_tree(f"step_variables-{phase}", init)


def _adam_first_moments(opt_state) -> dict:
    """{port parameter name: mu} of an optax state (chained or
    partitioned)."""
    import optax

    out = {}
    adam = optax.ScaleByAdamState
    for s in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: isinstance(x, adam)):
        if not isinstance(s, adam):
            continue
        out.update(from_flax({"params": _drop_masked(s.mu)}))
    return out


def _drop_masked(tree):
    import optax

    if isinstance(tree, optax.MaskedNode):
        return None
    if hasattr(tree, "items"):
        kept = {k: _drop_masked(v) for k, v in tree.items()}
        return {k: v for k, v in kept.items()
                if v is not None and not (isinstance(v, dict) and not v)}
    return tree


def check_train_step(stage: str) -> None:
    """One Adam step of a training stage from the same weights, batch and
    posterior noise: FPS indices and selected proposals exact, losses at
    f32's tolerance, gradients, parameters and running statistics as the
    comment over this section states; frozen modules keep their
    parameters. The body of each stage's `test_train_step_matches_jax`
    (`tests/test_torch_train_step_stage*.py`, a file a stage, so that the
    three JAX train-step compiles run on different workers)."""
    from rfdnet_tpu.train import trainer as jtrainer
    from rfdnet_tpu_torch.models import common as tcommon
    from rfdnet_tpu_torch.train import trainer as ttrainer
    from rfdnet_tpu_torch.train.loop import Trainer

    jcfg, cfg = train_configs(stage)
    model = jcfg.build_model()
    variables = step_variables(model.phase)
    seed = STAGES[stage][2]
    batch = grid_batch(seed)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(seed)
    lr = float(jcfg.config["optimizer"]["lr"])
    bnm = jcfg.bn_momentum(0)
    assert bnm == tconfig.bn_momentum(cfg, 0) == 0.5
    frozen = tuple(jcfg.config["train"]["freeze"])
    weight = jcfg.config["model"]["completion"]["weight"]
    tx, scale_tree = jtrainer.make_optimizer_with_specs(
        jcfg.config["optimizer"], jcfg.config["model"])
    # the JAX CLI never sets ISCNet.frozen: frozen modules still train
    # their batch norms, and only their updates are masked
    step = jax.jit(jtrainer.make_train_step(
        model, jcfg.dataset_config, tx, completion_weight=weight,
        frozen=frozen, lr_scale_tree=scale_tree, jit=False))
    state = jtrainer.TrainState(
        step=jnp.int32(0), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]))
    new, want = step(state, jb, key, jnp.float32(lr), jnp.float32(bnm))
    (ep, _, _, jpids), _ = jax.jit(lambda v, b: model.apply(
        v, b, train=True, bn_momentum=bnm, rng=key,
        mutable=["batch_stats"]))(variables, jb)

    port = tconfig.build_model(cfg, device="cpu", mode="train")
    port.load_state_dict(from_flax(variables), strict=True)
    trainer = Trainer(cfg, port)
    assert trainer.frozen == frozen
    tcommon.set_bn_momentum(port, bnm)
    eps = None
    if model.phase == "completion":
        P = cfg["data"]["completion_limit_in_train"]
        eps = t(jax.random.normal(jax.random.split(key)[1],
                                  (2 * P, cfg["data"]["z_dim"])))
    before = {k: v.clone() for k, v in port.state_dict().items()}
    tb = torch_batch(batch)
    with torch.no_grad():
        port_probe = tconfig.build_model(cfg, device="cpu", mode="train")
        port_probe.load_state_dict(before)
        port_probe.train()
        tcommon.set_bn_momentum(port_probe, bnm)
        tep, _, _, tpids = port_probe(tb, eps=eps)
    for k in ("sa1_inds", "sa2_inds", "fp2_inds", "aggregated_vote_inds"):
        assert_equal(tep[k], ep[k], what=k)
    if model.phase == "completion":
        assert_equal(tpids, jpids, what="proposal_ids")

    got = ttrainer.train_step(port, trainer.optimizer, tb, lr,
                              trainer.completion_weight, eps=eps)
    spec_of = ttrainer.make_optimizer_with_specs(cfg["optimizer"],
                                                 cfg["model"])
    assert_step_matches(port, trainer.optimizer, spec_of, before, got, want,
                        new, frozen, lr)


def assert_step_matches(port, optimizer, spec_of, before: dict, got: dict,
                        want: dict, new, frozen, lr: float) -> None:
    """The port's step (`port` after it, its `optimizer`, the `before`
    state dict, the loss terms `got`) against the JAX step's loss terms
    `want` and new `TrainState`, as `check_train_step` holds them (see
    the comment over this section); `spec_of`: the port's per-module
    `AdamSpec`s."""
    import optax

    assert set(got) == set(want)
    for k in want:
        assert_close(got[k], want[k], what=k)

    # gradients, as Adam's first moments (1 - b1) (g + wd p)
    jmu = _adam_first_moments(new.opt_state)
    mods = {}
    for name, mu in zip(optimizer.names, optimizer.mu):
        mods.setdefault(name.split(".")[0], []).append(
            (mu.numpy().ravel(), np.asarray(jmu[name]).ravel()))
    assert set(mods) == {n for n, _ in port.named_children()} - set(frozen)
    for mod, pairs in mods.items():
        got_g = np.concatenate([g for g, _ in pairs])
        want_g = np.concatenate([w for _, w in pairs])
        assert rel_l2(got_g, want_g) <= STEP_GRAD_RTOL, mod

    # parameters: optax's Adam on the port's own gradients, and the bound
    after = port.state_dict()
    jafter = from_flax({"params": new.params, "batch_stats": new.batch_stats})
    for name, p in port.named_parameters():
        root = name.split(".")[0]
        if root in frozen:
            assert p.grad is None
            assert torch.equal(after[name], before[name]), name
            assert_equal(jafter[name], before[name], what=name)
            continue
        s = spec_of(root)
        g = p.grad.numpy()
        adam = optax.chain(optax.add_decayed_weights(s.weight_decay),
                           optax.scale_by_adam(*s.betas, eps=s.eps))
        p0 = before[name].numpy()
        u, _ = adam.update(g, adam.init(p0), p0)
        expect = p0 + np.float32(-lr * s.lr_scale) * np.asarray(u)
        assert_close(after[name], expect, atol=1e-7, rtol=1e-6, what=name)
        bound = 2 * lr * s.lr_scale * (1 + 1e-3) + 1e-7
        assert np.abs(after[name].numpy() - jafter[name].numpy()).max() \
            <= bound, name
    for name in after:
        if "running" in name:
            assert_close(after[name], jafter[name], atol=STEP_STATS_ATOL,
                         rtol=STEP_STATS_RTOL, what=name)
            assert not torch.equal(after[name], before[name]), name


# the sanity tool's step checks: its model at SMALL's widths, its scenes at
# 2048 points, batch 2, the stage-2 freeze list. The scenes' generator is
# seeded as the step tests' batches are (see above), at the first seed
# whose batch keeps the tolerances: from RandomState(0), (1) and (3) one
# vote lies on the 0.3 m radius of a proposal's aggregation ball (the two
# packages' votes differ by ~8e-5, their f32 sums), which moves that
# proposal's head outputs by up to 0.45 and the box loss by ~3e-3; from
# (2) skip propagation's STN gradients are 0.56 (relative L2) from JAX's;
# from (4) a point on a 1 m ball's radius moves the mask loss by 4.3e-4.
# The scene and batch-order test and `main`'s use the tool's RandomState(0).
SANITY_WIDTHS = {k: SMALL["data"][k] for k in ("c_dim", "hidden_dim",
                                                "z_dim")}
SANITY_POINTS, SANITY_BATCH, SANITY_SEED = 2048, 2, 5
SANITY_FROZEN = ("backbone", "voting", "detection")


def check_sanity_step(phase: str) -> None:
    """One step of `rfdnet_tpu_torch.tools.sanity_train`'s step loop
    (`train`; in the completion phase with `SANITY_FROZEN` frozen) against
    the JAX tool's `make_train_step(frozen=...)` on the same batch (the
    tool's first two scenes, on the 1/128 grid, in
    the JAX loop's order), from the same `from_flax` variables, with the
    JAX step's posterior noise injected; held as `check_train_step`
    holds a step (`assert_step_matches`). The scenes come from
    `RandomState(SANITY_SEED)`, see there."""
    from rfdnet_tpu.config.scannet import ScannetConfig
    from rfdnet_tpu.train import trainer as jtrainer
    from rfdnet_tpu_torch.tools import sanity_train as st
    from rfdnet_tpu_torch.train.trainer import make_optimizer_with_specs

    dc = ScannetConfig()
    frozen = SANITY_FROZEN if phase == "completion" else ()
    model = ISCNet(mean_size_arr=dc.mean_size_arr, phase=phase,
                   completion_limit=st.COMPLETION_LIMIT,
                   generate_limit=st.GENERATE_LIMIT, **SANITY_WIDTHS)
    variables = step_variables(phase)
    rng = np.random.RandomState(SANITY_SEED)
    train, _ = st.make_scenes(rng, SANITY_BATCH, SANITY_POINTS)
    train = [on_grid(s) for s in train]
    # the JAX tool's loop, on a copy of the generator's state
    jrng = np.random.RandomState(0)
    jrng.set_state(rng.get_state())
    order = np.arange(SANITY_BATCH)
    jrng.shuffle(order)
    sel = order[:SANITY_BATCH]
    jb = {k: jnp.asarray(np.concatenate([train[i][k] for i in sel]))
          for k in train[0]}
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    lr = 1e-3
    tx = jtrainer.make_optimizer()
    step = jax.jit(jtrainer.make_train_step(model, dc, tx, frozen=frozen,
                                            jit=False))
    state = jtrainer.TrainState(
        step=jnp.int32(0), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]))
    new, want = step(state, jb, key, jnp.float32(lr),
                     jnp.float32(st.BN_MOMENTUM))

    port = st.build_model(phase, "cpu", **SANITY_WIDTHS)
    port.load_state_dict(from_flax(variables), strict=True)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    optimizer = st.make_optimizer(port, frozen)
    eps = None
    if phase == "completion":
        eps = t(jax.random.normal(
            jax.random.split(key)[1],
            (SANITY_BATCH * st.COMPLETION_LIMIT, SANITY_WIDTHS["z_dim"])))
    steps = []

    def noise(it):
        steps.append(it)
        return eps

    history = st.train(port, optimizer, train, rng, 1, SANITY_BATCH, lr,
                       noise=noise, log=lambda _: None)
    assert steps == [0] and len(history) == 1
    got = {k: torch.tensor(v) for k, v in history[0].items()}
    assert_step_matches(port, optimizer, make_optimizer_with_specs({}, {}),
                        before, got, want, new, frozen, lr)


# -------------------------------------------------------------- serving
# Shared by `test_torch_parallel_serve*.py`: `tests/test_parallel_serve.py`'s
# model and batch (full width, 1024 points, 8^3 grids, a batch of 8) and
# the JAX package's `make_sharded_generate` on its 8-device mesh.
SERVE_B = 8
SERVE_MODEL_KW = dict(phase="completion", completion_limit=4,
                      generate_limit=8)
SERVE_KW = dict(nms_iou=0.25, use_cls_nms=True, dump_threshold=0.05,
                remove_empty_box=True, decode_grid_res=8)
_GT_KEYS = ("center_label", "heading_class_label", "heading_residual_label",
            "size_class_label", "size_residual_label", "box_label_mask",
            "sem_cls_label")


def serve_reference():
    """(numpy batch of SERVE_B scenes with their GT, JAX's sharded
    `grids` / `parsed` / `gen` as numpy, port ISCNet on the CPU with the
    same variables)."""
    from rfdnet_tpu.config.scannet import ScannetConfig
    from rfdnet_tpu.parallel.mesh import make_mesh
    from rfdnet_tpu.parallel.serve import make_sharded_generate
    from rfdnet_tpu_torch.models import ISCNet as TISCNet

    dc = ScannetConfig()
    model = ISCNet(mean_size_arr=dc.mean_size_arr, **SERVE_MODEL_KW)
    full = synthetic_scene_batch(np.random.RandomState(3),
                                 batch_size=SERVE_B, num_points=1024,
                                 mean_size_arr=dc.mean_size_arr)

    def compute():
        init_batch = synthetic_scene_batch(
            np.random.RandomState(0), batch_size=2, num_points=1024,
            mean_size_arr=dc.mean_size_arr)
        variables = jax.jit(lambda b: model.init(
            jax.random.PRNGKey(0), b, train=False,
            rng=jax.random.PRNGKey(1)))(
            {k: jnp.asarray(v) for k, v in init_batch.items()})
        serve = make_sharded_generate(model, variables,
                                      make_mesh(jax.devices()[:8]),
                                      **SERVE_KW)
        out = serve({"point_clouds": jnp.asarray(full["point_clouds"])})
        return {"variables": variables, "grids": out["grids"],
                "parsed": out["parsed"], "gen": out["gen"]}

    tree = cached_tree("parallel_serve", compute)
    port = load_port(TISCNet(mean_size_arr=tconfig.MEAN_SIZE_ARR,
                             **SERVE_MODEL_KW), tree.pop("variables"))
    return full, tree, port


def serve_ap_table(out, full, jax_helpers: bool = False) -> dict:
    """The Tester's protocol on served outputs (numpy): each scene's
    confident per-class proposals and its GT boxes, one scene a step,
    then the metrics, with the JAX package's helpers or the port's."""
    from rfdnet_tpu.config.scannet import ScannetConfig
    from rfdnet_tpu.eval import ap_helper as jap
    from rfdnet_tpu_torch.eval import ap_helper as tap

    dc = ScannetConfig()
    calc = (jap.APCalculator(0.25, dc.class2type) if jax_helpers
            else tap.APCalculator(0.25, tconfig.CLASS2TYPE))
    for i in range(full["point_clouds"].shape[0]):
        p_i = {k: v[i:i + 1] for k, v in out["parsed"].items()}
        b_i = {k: full[k][i:i + 1] for k in _GT_KEYS}
        ids = out["gen"]["proposal_ids"][i:i + 1]
        if jax_helpers:
            pred = jap.assembly_pred_map_cls(
                p_i, dc, conf_thresh=0.05, per_class_proposal=True,
                proposal_ids=ids)
            gt = jap.assembly_gt_map_cls(jap.parse_groundtruths(b_i, dc))
        else:
            pred = tap.assembly_pred_map_cls(
                p_i, conf_thresh=0.05, per_class_proposal=True,
                proposal_ids=ids)
            gt = tap.assembly_gt_map_cls(tap.parse_groundtruths(b_i))
        calc.step(pred, gt)
    return calc.compute_metrics(parallel=False)


def assert_serve_matches(got, want, full, grid_atol: float = 5e-3):
    """The port's served outputs (numpy) against JAX's: the AP tables
    equal exactly; the grids within `grid_atol` where both selected the
    same proposal (and GT box and class) into the same valid slot, which
    most slots are."""
    table = serve_ap_table(got, full)
    want_table = serve_ap_table(want, full, jax_helpers=True)
    assert set(table) == set(want_table)
    for k in want_table:
        assert table[k] == want_table[k], (k, table[k], want_table[k])
    v_g = got["gen"]["valid"].reshape(-1)
    v_w = want["gen"]["valid"].reshape(-1)
    same = v_g & v_w & (got["gen"]["proposal_ids"].reshape(-1, 3)
                        == want["gen"]["proposal_ids"].reshape(-1, 3)
                        ).all(axis=1)
    assert same.mean() > 0.9, same.mean()
    np.testing.assert_allclose(got["grids"][same], want["grids"][same],
                               atol=grid_atol)


def served_numpy(out) -> dict:
    """`grids`, `parsed` and `gen` of a served output, as numpy."""
    return {"grids": out["grids"].numpy(),
            "parsed": {k: v.numpy() for k, v in out["parsed"].items()},
            "gen": {k: v.numpy() for k, v in out["gen"].items()}}


# -------------------------------------------------------- data parallel
# Shared by `test_torch_dp_train*.py`: the JAX package's train step with
# the batch sharded over its 8-device mesh, and the port's numpy state.
DP_BATCH = 8


def port_state(variables) -> dict:
    """The port's numpy state_dict of flax variables."""
    return {k: v.numpy() for k, v in from_flax(variables).items()}


def running_stats(state: dict) -> dict:
    return {k: v for k, v in state.items() if "running" in k}


def jax_sharded_step(model, dc, tx, variables, batch, key, lr, bnm, **kw):
    """JAX's train step with the batch sharded over 8 devices: (new
    state, losses)."""
    from rfdnet_tpu.parallel.mesh import make_mesh, replicated, shard_batch
    from rfdnet_tpu.train import trainer as jtrainer

    step = jtrainer.make_train_step(model, dc, tx, donate=False, **kw)
    state = jtrainer.TrainState(
        step=jnp.int32(0), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]))
    mesh = make_mesh(jax.devices()[:8])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return step(jax.device_put(state, replicated(mesh)),
                shard_batch(jb, mesh), key, jnp.float32(lr),
                jnp.float32(bnm))


DP_DETECTION_SEED = 1


def dp_detection_spec():
    """The port's step spec (`torch_dist.train_step_rank`) of the small
    detection model on `grid_batch(DP_DETECTION_SEED)` at batch 8."""
    jcfg, cfg = train_configs("stage1_detection")
    return dict(cfg=cfg, state=port_state(step_variables("detection")),
                batch=grid_batch(DP_DETECTION_SEED, batch_size=DP_BATCH),
                lr=float(jcfg.config["optimizer"]["lr"]),
                bn_momentum=jcfg.bn_momentum(0))


def dp_detection_jax() -> dict:
    """JAX's sharded step of `dp_detection_spec`'s model and batch: its
    loss terms and the running statistics after it (computed once, see
    `cached_tree`)."""
    from rfdnet_tpu.train import trainer as jtrainer

    def compute():
        jcfg, _ = train_configs("stage1_detection")
        tx, scale_tree = jtrainer.make_optimizer_with_specs(
            jcfg.config["optimizer"], jcfg.config["model"])
        new, losses = jax_sharded_step(
            jcfg.build_model(), jcfg.dataset_config, tx,
            step_variables("detection"),
            grid_batch(DP_DETECTION_SEED, batch_size=DP_BATCH),
            jax.random.PRNGKey(DP_DETECTION_SEED),
            float(jcfg.config["optimizer"]["lr"]), jcfg.bn_momentum(0),
            lr_scale_tree=scale_tree,
            frozen=tuple(jcfg.config["train"]["freeze"]))
        return dict(losses=dict(losses), stats=running_stats(port_state(
            {"params": new.params, "batch_stats": new.batch_stats})))

    out = cached_tree("dp_detection_jax", compute)
    return dict(losses={k: float(v) for k, v in out["losses"].items()},
                stats=out["stats"])


def assert_dp_matches_one_process(res: list, one: dict, what: str = "",
                                  stats_atol: float = 1e-3,
                                  stats_rtol: float = 1e-2) -> None:
    """Every rank's loss terms within 1e-3 relative of the one-process
    step's and its running statistics within the given tolerances
    (`tests/test_train.py`'s data-parallel ones), and every rank's state
    equal to rank 0's (Adam ran the same update on each)."""
    for r in res:
        assert set(r["losses"]) == set(one["losses"])
        for k, v in one["losses"].items():
            assert abs(r["losses"][k] - v) <= 1e-3 * abs(v) + 1e-6, (
                what, k, r["losses"][k], v)
        for name, s in running_stats(one["state"]).items():
            assert_close(r["state"][name], s, atol=stats_atol,
                         rtol=stats_rtol, what=f"{what}: {name}")
        for name, p in r["state"].items():
            assert_equal(p, res[0]["state"][name], what=f"{what}: {name}")


def assert_dp_matches_jax(r: dict, jax_out: dict, what: str = "") -> None:
    """A rank's detection-step loss terms at f32's tolerances of JAX's
    sharded step's and its running statistics at the port's one-process
    step tolerances (STEP_STATS_ATOL / STEP_STATS_RTOL)."""
    assert set(r["losses"]) == set(jax_out["losses"])
    for k, v in jax_out["losses"].items():
        assert_close(r["losses"][k], v, what=f"{what}: {k}")
    for name, s in jax_out["stats"].items():
        assert_close(r["state"][name], s, atol=STEP_STATS_ATOL,
                     rtol=STEP_STATS_RTOL, what=f"{what}: {name}")

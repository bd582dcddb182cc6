"""The port's `DataLoader` routes against each other and against
`rfdnet_tpu`'s process route, on the CPU: 4 synthetic scenes of 2048
points, 2 workers, shuffled train-mode items (augmentation on) over two
epochs.

Tolerance: batches identical (same keys, dtypes and values), in the same
order.
"""

import os
import pickle

import numpy as np
import pytest

from rfdnet_tpu.data import scannet as jscannet
from rfdnet_tpu_torch.data import scannet, synthetic
from torch_parity import assert_equal


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    out = synthetic.write_scannet_scenes(
        str(tmp_path_factory.mktemp("scannet")), 4, seed=5, num_points=2048,
        num_objects=3)
    return os.path.join(out["split"], "scannetv2_train.json")


def _passes(module, split, worker_type, epochs=(0, 1)):
    ds = module.ScanNetDataset(split, mode="train", phase="detection",
                               num_points=2048, seed=3, cache_scans=2)
    loader = module.DataLoader(ds, batch_size=2, shuffle=True, num_workers=2,
                               seed=3, worker_type=worker_type)
    assert loader.worker_type == worker_type
    out = []
    try:
        for e in epochs:
            loader.set_epoch(e)
            out.append(list(loader))
    finally:
        if hasattr(loader, "close"):
            loader.close()
    return out


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for ga, wa in zip(got, want):
        assert len(ga) == len(wa) == 2
        for a, b in zip(ga, wa):
            assert sorted(a) == sorted(b)
            for k in b:
                if isinstance(b[k], list):
                    assert a[k] == b[k], k
                else:
                    assert a[k].dtype == b[k].dtype, k
                    assert_equal(a[k], b[k], what=k)


def test_process_route_matches_threads_and_jax(split):
    """The process route (one pool kept over both epochs) gives the thread
    route's batches and the JAX package's process route's; the epochs
    differ."""
    processes = _passes(scannet, split, "process")
    _assert_batches_equal(processes, _passes(scannet, split, "thread"))
    _assert_batches_equal(processes, _passes(jscannet, split, "process"))
    assert not np.array_equal(processes[0][0]["point_clouds"],
                              processes[1][0]["point_clouds"])


def test_auto_route_and_refusals(split):
    ds = scannet.ScanNetDataset(split, mode="train", num_points=2048)
    assert scannet.DataLoader(ds, 2, num_workers=1).worker_type == "thread"
    cores = os.cpu_count() or 1
    assert scannet.DataLoader(ds, 2, num_workers=2).worker_type == (
        "process" if cores > 1 else "thread")
    with pytest.raises(ValueError, match="worker_type"):
        scannet.DataLoader(ds, 2, worker_type="fiber")


def test_dataset_pickles_without_its_caches(split):
    ds = scannet.ScanNetDataset(split, mode="train", num_points=2048,
                                cache_scans=4)
    first = ds[0]
    assert len(ds._scan_cache) == 1
    copy = pickle.loads(pickle.dumps(ds))
    assert len(copy._scan_cache) == 0 and copy.epoch == ds.epoch
    again = copy[0]
    for k in first:
        if not isinstance(first[k], list):
            assert_equal(again[k], first[k], what=k)


@pytest.mark.parametrize("route", [None, "thread", "process", "auto"])
def test_cli_loaders_take_the_configured_route(split, route):
    """The CLI's loaders read `device.worker_type`; threads by default."""
    from rfdnet_tpu_torch import cli, config

    device = {"num_workers": 2}
    if route is not None:
        device["worker_type"] = route
    cfg = config.load_config(os.path.join(os.path.dirname(__file__), "..",
                                          "configs", "iscnet.yaml"),
                             mode="train")
    cfg["device"].update(device)
    cfg["data"]["split"] = os.path.dirname(split)
    loaders = cli._build_loaders(cfg, ["train", "val"])
    want = scannet.DataLoader(loaders["train"].dataset, 2, num_workers=2,
                              worker_type=route or "thread").worker_type
    assert [d.worker_type for d in loaders.values()] == [want, want]

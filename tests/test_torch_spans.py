"""The port's spans and counters (`rfdnet_tpu_torch/utils/profiling.py`)
on the CPU: off they record nothing; `recording()` keeps names, parents,
units, host times and self times, per thread; counters sum numbers and
tensors without reading a tensor back; under `torch.profiler` the spans
are ranges of the trace and go to `profiled()`; and the model's
generation and the train step open their stages once a call. The models
are the demo test's small width (2048 points, c_dim 64, 8 slots, 6^3
grids) with seeded weights."""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from rfdnet_tpu_torch import config as tconfig, weights
from rfdnet_tpu_torch.config import MEAN_SIZE_ARR
from rfdnet_tpu_torch.data.synthetic import synthetic_scene_batch
from rfdnet_tpu_torch.utils import profiling

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")

WIDTHS = {"c_dim": 64, "hidden_dim": 64, "z_dim": 8}
ISCNET_SPANS = ("iscnet.generate", "iscnet.backbone",
                "iscnet.voting_proposal", "iscnet.nms",
                "iscnet.skip_propagation", "iscnet.grid_decode")


def _by_name(rec):
    return {s.name: s for s in rec.spans()}


def test_off_a_span_is_the_shared_no_op(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("tracing is off: nothing may be made")

    monkeypatch.setattr(profiling, "Span", refuse)
    monkeypatch.setattr(profiling, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    before = profiling.profiled().table()
    with profiling.span("off") as s:
        assert profiling.count("off.counter", torch.ones(3)) is None
    assert s is profiling.NO_SPAN and profiling.span("again") is s
    assert s.unit is None and s.host_ms is None and s.device_ms() is None
    assert profiling.profiled().table() == before


def test_recording_keeps_names_parents_units_and_self_time():
    with profiling.recording() as rec:
        with profiling.span("root") as root:
            time.sleep(0.004)
            with profiling.span("child") as child:
                with profiling.span("leaf"):
                    time.sleep(0.002)
                time.sleep(0.002)
        with profiling.span("root") as second:
            pass
    assert profiling.span("after") is profiling.NO_SPAN
    spans = rec.spans()
    # in the order they ended
    assert [s.name for s in spans] == ["leaf", "child", "root", "root"]
    assert [s.parent for s in spans] == ["child", "root", None, None]
    assert spans[0].parent_id == child.id and child.parent_id == root.id
    assert {s.unit for s in spans[:3]} == {root.unit}
    assert second.unit != root.unit
    assert all(s.device_ms() is None for s in spans)  # no card
    table = rec.table()["spans"]
    assert table["root"]["calls"] == 2 and table["leaf"]["calls"] == 1
    assert table["leaf"]["host_ms"] >= 2.0
    assert table["child"]["host_ms"] >= 4.0
    assert table["root"]["host_samples"][0] >= 8.0
    assert table["child"]["self_host_ms"] == pytest.approx(
        child.host_ms - spans[0].host_ms)
    assert table["root"]["self_host_ms"] == pytest.approx(
        root.host_ms + second.host_ms - child.host_ms)
    assert table["root"]["device_ms"] is None
    assert table["root"]["device_samples"] == []


def test_threads_keep_their_own_stacks_and_a_handed_unit_holds():
    both_open = threading.Barrier(2)

    def worker(tag):
        with profiling.span(f"{tag}.outer"):
            both_open.wait()  # each thread inside its own outer span
            with profiling.span(f"{tag}.inner"):
                both_open.wait()

    with profiling.recording() as rec:
        threads = [threading.Thread(target=worker, args=(tag,))
                   for tag in ("a", "b")]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        with profiling.span("scene") as scene:
            with profiling.span("scene.dispatch"):
                pass

        def consume():
            with profiling.span("scene", unit=scene.unit):
                with profiling.span("scene.step"):
                    pass

        th = threading.Thread(target=consume)
        th.start()
        th.join()
    spans = _by_name(rec)
    for tag in ("a", "b"):
        assert spans[f"{tag}.inner"].parent == f"{tag}.outer"
        assert spans[f"{tag}.outer"].parent is None
        assert spans[f"{tag}.inner"].unit == spans[f"{tag}.outer"].unit
    assert spans["a.outer"].unit != spans["b.outer"].unit
    halves = [s for s in rec.spans() if s.name == "scene"]
    assert len(halves) == 2 and {s.unit for s in halves} == {scene.unit}
    assert all(s.parent is None for s in halves)
    assert spans["scene.step"].unit == scene.unit
    assert spans["scene.step"].parent == "scene"


def test_many_threads_lose_no_span_and_no_count():
    workers, rounds = 4 * (os.cpu_count() or 1), 200
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording() as rec:
            def work(i):
                for _ in range(rounds):
                    with profiling.span(f"t{i}"):
                        with profiling.span("inner"):
                            profiling.count("n")
                            profiling.count("t", torch.ones(2))

            threads = [threading.Thread(target=work, args=(i,))
                       for i in range(workers)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120)
            assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(switch)
    spans = rec.spans()
    assert len(spans) == 2 * workers * rounds
    assert rec.counter("n") == workers * rounds
    assert rec.counter("t") == 2 * workers * rounds
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.name == "inner":
            parent = by_id[s.parent_id]
            assert parent.name == s.parent and parent.unit == s.unit


def test_counters_sum_numbers_and_tensors_without_reading_back(monkeypatch):
    reads = []
    item = torch.Tensor.item

    def counted_item(self):
        reads.append(self)
        return item(self)

    monkeypatch.setattr(torch.Tensor, "item", counted_item)
    with profiling.recording() as rec:
        profiling.count("n")
        profiling.count("n", 4)
        profiling.count("mask", torch.tensor([[True, False], [True, True]]))
        profiling.count("mask", torch.tensor([True, False]))
        profiling.count("x", 0.5)
        profiling.count("x", torch.tensor([1.5, 2.0]))
    assert reads == []
    counters = rec.table()["counters"]
    assert counters == {"n": 5, "mask": 4, "x": 4.0}
    assert rec.counter("mask") == 4 and rec.counter("never") == 0
    # one read a device counter, at the table
    assert 0 < len(reads) <= 4


def test_nested_recordings_each_get_every_span():
    with profiling.recording() as outer:
        profiling.count("c", 1)
        with profiling.recording() as inner:
            with profiling.span("s"):
                profiling.count("c", 2)
        with profiling.recording(inner):  # opened again
            with profiling.span("s"):
                pass
    assert [s.name for s in outer.spans()] == ["s", "s"]
    assert [s.name for s in inner.spans()] == ["s", "s"]
    assert outer.counter("c") == 3 and inner.counter("c") == 2
    # once closed, neither gets more
    with profiling.span("late"):
        pass
    assert len(outer.spans()) == 2


def test_a_span_ends_on_an_exception():
    with profiling.recording() as rec:
        with pytest.raises(ValueError):
            with profiling.span("fails"):
                raise ValueError("stage failed")
        with profiling.span("next") as nxt:
            pass
    assert nxt.parent is None
    assert [s.name for s in rec.spans()] == ["fails", "next"]


def test_profiler_trace_holds_spans_and_profiled_keeps_them():
    from torch.profiler import ProfilerActivity, profile

    profiling.profiled().clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("traced.outer"):
            with profiling.span("traced.inner"):
                torch.ones(32, 32) @ torch.ones(32, 32)
            profiling.count("traced.counter", 3)
    ranges = {e.name: e for e in prof.events()
              if e.name.startswith("traced.")}
    assert set(ranges) == {"traced.outer", "traced.inner"}
    assert any(e.name == "aten::mm" for e in prof.events())
    table = profiling.profiled().table()
    assert table["spans"]["traced.inner"]["calls"] == 1
    assert table["counters"] == {"traced.counter": 3}
    assert [s.parent for s in profiling.profiled().spans()] == [
        "traced.outer", None]
    # the profiler is off again: so are the spans
    assert profiling.span("traced.outer") is profiling.NO_SPAN
    profiling.profiled().clear()
    assert profiling.profiled().table() == {"spans": {}, "counters": {}}


@pytest.fixture(scope="module")
def tiny_model():
    torch.set_num_threads(4)
    cfg = tconfig.load_config(f"{CONFIGS}/iscnet_test.yaml", mode="test")
    cfg["data"].update(num_point=2048, **WIDTHS)
    model = tconfig.build_model(cfg, generate_limit=8, device="cpu",
                                mode="test")
    return weights.init_seeded(model, 0)


def test_generate_opens_each_stage_once_and_counts_the_slots(tiny_model):
    batch = synthetic_scene_batch(
        np.random.RandomState(3), batch_size=2, num_points=2048,
        num_objects=4, mean_size_arr=MEAN_SIZE_ARR)
    pc = torch.from_numpy(batch["point_clouds"])
    with profiling.recording() as rec:
        out = tiny_model.generate({"point_clouds": pc}, dump_threshold=0.5,
                                  decode_grid_res=6)
    spans = rec.spans()
    assert sorted(s.name for s in spans) == sorted(ISCNET_SPANS)
    root = _by_name(rec)["iscnet.generate"]
    assert root.parent is None
    assert all(s.parent == "iscnet.generate" and s.unit == root.unit
               for s in spans if s is not root)
    counters = rec.table()["counters"]
    assert counters["iscnet.slots_decoded"] == 2 * 8
    assert counters["iscnet.slots_valid"] == int(out["gen"]["valid"].sum())
    # the children add up to no more than the call
    children = sum(s.host_ms for s in spans if s is not root)
    assert children <= root.host_ms


def test_train_step_opens_its_four_stages_under_the_step():
    from rfdnet_tpu_torch.tools.profile_train import Stages

    torch.set_num_threads(4)
    step = Stages(torch.device("cpu"), batch=1, points=2048,
                  widths=WIDTHS).call("full_step")
    with profiling.recording() as rec:
        step()
    spans = _by_name(rec)
    stages = ("train.forward", "train.loss", "train.backward", "train.adam")
    names = [s.name for s in rec.spans() if s.name.startswith("train.")]
    assert sorted(names) == sorted(stages + ("train.step",))
    assert spans["train.step"].parent is None
    assert all(spans[n].parent == "train.step"
               and spans[n].unit == spans["train.step"].unit for n in stages)
    # the model's stages sit inside the forward
    assert spans["iscnet.backbone"].parent == "train.forward"
    assert spans["iscnet.skip_propagation"].parent == "train.forward"
    order = [spans[n].start_ns for n in stages]
    assert order == sorted(order)

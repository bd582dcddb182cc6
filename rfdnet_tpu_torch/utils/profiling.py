"""Tracing, spans and counters.

`trace(log_dir)` wraps a region in a `torch.profiler` trace (CPU activity,
and CUDA activity where a card is present) written as a Chrome trace
(`trace.json`, readable in Perfetto or chrome://tracing) under `log_dir`:
the CLI's `--profile DIR`.

`span(name)` names one stage of the port where its work happens (the
model's stages, the train step's, the Tester's); `count(name, value)`
adds into a named counter. Tracing is on while a `torch.profiler`
profile runs or a `recording()` is open, and off otherwise; off, a span
is one check of two module flags that returns the shared `NO_SPAN`, and
a count returns at the same check. On, a span
- is a `record_function` range while a profiler runs, so that it sits in
  the profiler's trace on the device's clock (and names the idle gaps
  that the host spends inside it);
- records its name, its enclosing span on the same thread (`parent`),
  the `unit` of its root span (one request, step or scene; a root span
  may be handed the unit of another thread's span, `unit=`), its host
  clock (`time.perf_counter_ns`) and, once CUDA is initialised, a timed
  CUDA event pair on the current stream at entry and exit;
- goes, when it ends, to every open recorder, and while a profiler runs
  also to the process-wide `profiled()` one.

A span's device time is its event pair's elapsed time: the part of the
stream's timeline the stage took, its launch gaps included; its self
time is that minus its children's. The events are read without a sync
(`Event.query`) once a recorder holds `DRAIN_AT` pending spans, or when
its table is read (which waits), and go back to a pool: the events alive
are those of the spans still in flight on the card.

A counter's value may be a device tensor: it is summed on the device and
read once, by `Recorder.table`, so that counting never waits for the
card.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import deque

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = "trace.json"
# pending spans a recorder holds before it reads those that have finished
DRAIN_AT = 256


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed region; its Chrome trace lands in
    `<log_dir>/trace.json` when the region ends (also on an exception)."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


# the open recorders, each once (replaced whole, read without a lock)
_active: tuple = ()
_opened: dict = {}          # recorder -> how often it is open
_lock = threading.Lock()    # `_opened`, the event pool, event reads
_units = itertools.count(1)
_ids = itertools.count(1)
_local = threading.local()  # `stack`: this thread's open spans
_pool: dict = {}            # device index -> free (start, end) event pairs


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _targets() -> tuple:
    if _autograd_profiler._is_profiler_enabled:
        return _active + (_PROFILED,)
    return _active


def _take_events():
    index = torch.cuda.current_device()
    with _lock:
        free = _pool.setdefault(index, [])
        pair = free.pop() if free else None
    if pair is None:
        pair = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True), index)
    return pair


class _NoSpan:
    """What `span` gives with tracing off: records nothing."""

    __slots__ = ()
    unit = host_ms = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def device_ms(self):
        return None


NO_SPAN = _NoSpan()


class Span:
    """One stage's record: `name`, `id`, `parent` / `parent_id` (the
    enclosing span on the thread that opened it, None for a root),
    `unit`, `start_ns` / `end_ns` (host clock), `host_ms`, and
    `device_ms()` (None without a card)."""

    __slots__ = ("name", "id", "parent", "parent_id", "unit", "start_ns",
                 "end_ns", "_events", "_device_ms", "_targets", "_rf")

    def __init__(self, name: str, unit, targets: tuple):
        self.name, self.unit, self._targets = name, unit, targets
        self.id = next(_ids)
        self.parent = self.parent_id = self.end_ns = None
        self._events = self._device_ms = self._rf = None

    def __enter__(self):
        stack = _stack()
        if stack:
            top = stack[-1]
            self.parent, self.parent_id = top.name, top.id
            if self.unit is None:
                self.unit = top.unit
        elif self.unit is None:
            self.unit = next(_units)
        if _autograd_profiler._is_profiler_enabled:
            self._rf = record_function(self.name)
            self._rf.__enter__()
        if torch.cuda.is_initialized():
            self._events = _take_events()
            self._events[0].record()
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self._events is not None:
            self._events[1].record()
        _stack().pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        targets, self._targets = self._targets, ()
        for rec in targets:
            rec._add(self)
        return False

    @property
    def host_ms(self):
        if self.end_ns is None:
            return None
        return (self.end_ns - self.start_ns) / 1e6

    def done(self) -> bool:
        """Ended, and its events (if any) completed on the card."""
        ev = self._events
        return self.end_ns is not None and (
            ev is None or (ev[0].query() and ev[1].query()))

    def device_ms(self):
        """The device time of the ended span, in ms (waits for its events);
        None without a card."""
        ev = self._events
        if ev is None or self.end_ns is None:
            return self._device_ms
        if not (ev[0].query() and ev[1].query()):
            ev[1].synchronize()
            ev[0].synchronize()
        with _lock:
            if self._events is not None:
                self._device_ms = ev[0].elapsed_time(ev[1])
                self._events = None
                _pool[ev[2]].append(ev)
        return self._device_ms


class Recorder:
    """Finished spans and counters while it is open (`recording`)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pending = deque()
        self._done: list = []
        self._counts: dict = {}
        self._device_counts: dict = {}

    def _add(self, s: Span) -> None:
        with self._lock:
            self._pending.append(s)
            if len(self._pending) >= DRAIN_AT:
                self._drain(wait=False)

    def _drain(self, wait: bool) -> None:
        pending = self._pending
        while pending:
            s = pending[0]
            if not wait and not s.done():
                break
            s.device_ms()
            self._done.append(pending.popleft())

    def _count(self, name: str, value) -> None:
        if isinstance(value, torch.Tensor):
            value = value.detach().sum()
            with self._lock:
                acc = self._device_counts.get(name)
                self._device_counts[name] = (value if acc is None
                                             else acc + value)
        else:
            with self._lock:
                self._counts[name] = self._counts.get(name, 0) + value

    def spans(self) -> list:
        """The spans finished so far, in the order they ended (waits for
        those in flight)."""
        with self._lock:
            self._drain(wait=True)
            return list(self._done)

    def counter(self, name: str):
        """One counter's sum so far (0 when never counted); reads a
        device part."""
        with self._lock:
            total = self._counts.get(name, 0)
            acc = self._device_counts.get(name)
        return total if acc is None else total + acc.item()

    def table(self) -> dict:
        """{"spans": {name: {calls, host_ms, self_host_ms, device_ms,
        self_device_ms (sums; the device's None without a card),
        host_samples, device_samples (one a call)}}, "counters": {name:
        sum}}."""
        spans = self.spans()
        child_host, child_dev = {}, {}
        for s in spans:
            if s.parent_id is not None:
                child_host[s.parent_id] = (child_host.get(s.parent_id, 0.0)
                                           + s.host_ms)
                d = s.device_ms()
                if d is not None:
                    child_dev[s.parent_id] = child_dev.get(s.parent_id,
                                                           0.0) + d
        out = {}
        for s in spans:
            row = out.setdefault(s.name, {
                "calls": 0, "host_ms": 0.0, "self_host_ms": 0.0,
                "device_ms": None, "self_device_ms": None,
                "host_samples": [], "device_samples": []})
            row["calls"] += 1
            row["host_ms"] += s.host_ms
            row["self_host_ms"] += s.host_ms - child_host.get(s.id, 0.0)
            row["host_samples"].append(s.host_ms)
            d = s.device_ms()
            if d is not None:
                row["device_ms"] = (row["device_ms"] or 0.0) + d
                row["self_device_ms"] = ((row["self_device_ms"] or 0.0) + d
                                         - child_dev.get(s.id, 0.0))
                row["device_samples"].append(d)
        with self._lock:
            names = set(self._counts) | set(self._device_counts)
        return {"spans": out,
                "counters": {name: self.counter(name) for name in names}}

    def clear(self) -> None:
        with self._lock:
            self._drain(wait=True)
            self._done.clear()
            self._counts.clear()
            self._device_counts.clear()


_PROFILED = Recorder()


def profiled() -> Recorder:
    """The recorder of every span and count made while a `torch.profiler`
    profile ran in this process (since its start, or its last
    `clear()`)."""
    return _PROFILED


def _set_open(recorder: Recorder, delta: int) -> None:
    global _active
    with _lock:
        n = _opened.get(recorder, 0) + delta
        if n:
            _opened[recorder] = n
        else:
            _opened.pop(recorder, None)
        _active = tuple(_opened)


@contextlib.contextmanager
def recording(recorder: Recorder | None = None):
    """Turn tracing on for the enclosed region: every span and count goes
    to `recorder` (a new one when None), which is yielded. Several may be
    open at once, from several threads; each gets every span."""
    rec = Recorder() if recorder is None else recorder
    _set_open(rec, 1)
    try:
        yield rec
    finally:
        _set_open(rec, -1)


def span(name: str, unit=None):
    """A named stage: `with span("iscnet.nms"): ...` (see the module
    docstring). `unit`: the unit id a root span takes (that of another
    thread's span, `Span.unit`), a new one when None."""
    if not (_active or _autograd_profiler._is_profiler_enabled):
        return NO_SPAN
    return Span(name, unit, _targets())


def count(name: str, value=1) -> None:
    """Add `value` (a number, or a tensor summed on its device) to the
    counter `name` of every recorder that is on."""
    if not (_active or _autograd_profiler._is_profiler_enabled):
        return
    for rec in _targets():
        rec._count(name, value)

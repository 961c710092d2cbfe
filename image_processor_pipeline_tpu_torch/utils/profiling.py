"""Per-stage metrics and tracing (port of
image_processor_pipeline_tpu/utils/profiling.py).

  - StageMetrics: structured per-stage wall-clock, item counts, items/sec
    and the host/device time split and the device→host bytes of
    transforms that shrink their output, attached to every ProcessingStep
    run and included in the JSON run report.
  - Timer: scoped wall-clock accumulator, thread-safe (the engine's
    per-stage times).
  - span(), count(), RECORDER, recording(): the process's spans and
    counters inside the program (the chain's host phases), kept by one
    Recorder, a Timer that also knows which spans nest and which call
    they belong to.  Off unless a caller turns it on (``recording``) or a
    torch.profiler session collects: off, ``span`` is a shared no-op
    context and ``count`` returns at once.
  - warmed_profile(): a torch.profiler session whose window opens after
    a warm-up of the card's activity collection, and device_events(), the
    card's activities in its window; every profiler session of the port
    and of chip_smoke.py goes through it.
  - device_trace(): context manager around warmed_profile that writes a
    Chrome trace (TensorBoard's profiler plugin and Perfetto read it);
    ``ProcessingStep(trace_dir=...)`` runs its step inside one.

The JAX module's ``enable_compilation_cache`` has no counterpart: nothing
here is compiled per process but the CUDA kernels, which ``kernels.py``
builds once into ``_build/``.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Union


@dataclass
class StageMetrics:
    name: str = ""
    items: int = 0
    wall_seconds: float = 0.0
    host_load_seconds: float = 0.0
    device_seconds: float = 0.0
    host_save_seconds: float = 0.0
    batches: int = 0
    output_collisions: int = 0
    #: device→host bytes: full-output size vs actually fetched after the
    #: shrink_output hook (0/0 when the transform doesn't shrink)
    d2h_bytes_full: int = 0
    d2h_bytes_fetched: int = 0

    @property
    def items_per_second(self) -> float:
        return self.items / self.wall_seconds if self.wall_seconds > 0 else 0.0

    def as_dict(self) -> Dict:
        return {
            "name": self.name,
            "items": self.items,
            "wall_seconds": round(self.wall_seconds, 4),
            "items_per_second": round(self.items_per_second, 2),
            "host_load_seconds": round(self.host_load_seconds, 4),
            "device_seconds": round(self.device_seconds, 4),
            "host_save_seconds": round(self.host_save_seconds, 4),
            "batches": self.batches,
            "output_collisions": self.output_collisions,
            "d2h_bytes_full": self.d2h_bytes_full,
            "d2h_bytes_fetched": self.d2h_bytes_fetched,
        }


class Timer:
    """Scoped wall-clock accumulator: ``with timer.measure('load'): ...``
    adds the block's seconds to ``totals['load']`` and one to
    ``counts['load']``, from any thread."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._lock = threading.Lock()

    def add(self, key: str, seconds: float) -> None:
        with self._lock:
            self.totals[key] = self.totals.get(key, 0.0) + seconds
            self.counts[key] = self.counts.get(key, 0) + 1

    @contextlib.contextmanager
    def measure(self, key: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(key, time.perf_counter() - t0)


class SpanRecord(NamedTuple):
    """One closed span: ``start_ns``/``end_ns`` on ``time.perf_counter_ns``
    (``time.perf_counter``'s clock), the name of the span that was open
    around it on its thread (None for an outermost span), and ``call``,
    the sequence number of the outermost span it lies in, which every
    span nested in that one shares."""
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[str]
    call: int


class Recorder(Timer):
    """The process's spans and counters (``span``, ``count``).

    While ``on``, and while a torch.profiler session of the process
    collects (the active steps of its schedule, so that a profiled stretch
    holds the program's phases unasked): each span adds its seconds and
    one to ``totals`` and ``counts`` under its name, each ``count`` adds
    to ``counters``; while a
    ``capture`` is open every closed span is also kept as a SpanRecord;
    while ``ranges`` is set each span is also a ``record_function`` range
    of the running torch.profiler session.  Nothing is written anywhere:
    callers read the totals, counters and records when they like."""

    def __init__(self):
        super().__init__()
        self.on = False
        self.ranges = False
        self.counters: Dict[str, int] = {}
        self.records: Optional[List[SpanRecord]] = None
        self._calls = itertools.count()
        self._open = threading.local()

    def reset(self) -> None:
        """Zero the totals and counters; outermost spans number from 0."""
        with self._lock:
            self.totals, self.counts, self.counters = {}, {}, {}
            self._calls = itertools.count()

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def _stack(self) -> list:
        """The spans open on the calling thread, outermost first."""
        try:
            return self._open.stack
        except AttributeError:
            self._open.stack = []
            return self._open.stack

    @contextlib.contextmanager
    def capture(self):
        """Keep every span closed in the block; yields the list of its
        SpanRecords (filled as they close)."""
        records, prev = [], self.records
        self.records = records
        try:
            yield records
        finally:
            self.records = prev


class _Span:
    """A span of the recorder (a class, not a generator context: the span
    sits on the chain's critical path, a few times a call)."""

    __slots__ = ("rec", "name", "parent", "call", "range", "t0")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        stack = self.rec._stack()
        if stack:
            self.parent, self.call = stack[-1].name, stack[-1].call
        else:
            self.parent, self.call = None, next(self.rec._calls)
        stack.append(self)
        self.range = None
        if self.rec.ranges:
            import torch

            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        self.rec._stack().pop()
        self.rec.add(self.name, (t1 - self.t0) / 1e9)
        records = self.rec.records
        if records is not None:
            records.append(SpanRecord(self.name, self.t0, t1, self.parent,
                                      self.call))
        return False


#: the process's recorder
RECORDER = Recorder()
_OFF = contextlib.nullcontext()
#: torch's "is a profiler session collecting" (bound on first use)
_profiler_enabled = None


def _profiled() -> bool:
    """Whether a torch.profiler session of the process collects now."""
    global _profiler_enabled
    if _profiler_enabled is None:
        import torch

        _profiler_enabled = torch._C._autograd._profiler_enabled
    return _profiler_enabled()


def span(name: str):
    """``with span('chain.h2d'): ...``: a span of the process's recorder,
    or a shared no-op context while the recorder is off and no profiler
    session collects."""
    if RECORDER.on or _profiled():
        return _Span(RECORDER, name)
    return _OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the recorder's counter ``name`` (nothing while it is
    off and no profiler session collects)."""
    if RECORDER.on or _profiled():
        RECORDER.count(name, n)


@contextlib.contextmanager
def recording(ranges: bool = False):
    """The process's recorder on for the block, and with ``ranges`` its
    spans also profiler ranges; both as they were afterwards.  Yields the
    recorder."""
    prev = RECORDER.on, RECORDER.ranges
    RECORDER.on, RECORDER.ranges = True, ranges or RECORDER.ranges
    try:
        yield RECORDER
    finally:
        RECORDER.on, RECORDER.ranges = prev


#: small launches made while the profiler warms up (see warmed_profile)
WARMUP_LAUNCHES = 4096
#: the kernel the warm-up launches (torch.cuda._sleep's), which
#: ``device_events`` leaves out of a window
WARMUP_KERNEL = "spin_kernel"
#: seconds the host waits after the window opens, before the block runs,
#: and again after the block, before the window closes
WINDOW_GUARD_S = 0.25


def warm_up_profiler() -> None:
    """``WARMUP_LAUNCHES`` launches of a one-cycle spin kernel, then a
    synchronisation: run with CUDA activity collection on and the trace's
    window shut (``warmed_profile``)."""
    import torch

    for _ in range(WARMUP_LAUNCHES):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()


@contextlib.contextmanager
def warmed_profile(activities=None, on_trace_ready=None):
    """A torch.profiler session whose window opens on the block after a
    warm-up; yields the profiler, whose ``events()`` and
    ``key_averages()`` then hold the block's activity.

    ``activities`` default to the CPU's and, when a card is there, the
    card's.  On a card the profiler warms up first: CUDA activity
    collection is on but the window not yet open while
    ``warm_up_profiler`` runs; then the window opens, the host waits
    ``WINDOW_GUARD_S``, the block runs, the card is synchronised, and the
    host waits ``WINDOW_GUARD_S`` again before the window closes.

    The waits keep the card's records inside the window.  The profiler
    keeps a card's record only when its times, moved from the card's
    clock to the host's, fall in the window, and now and then (some 10 s
    apart) whole windows of records go missing, as if that move were off
    by more than a short window is long.  On an H100, in one process
    after a 50,000-launch session, 200 one-launch windows of each kind in
    turns: with no wait, 10 lost every record and 4 more some records;
    with waits of 0.05 s on both sides, 1 lost every record; with 0.25 s,
    none lost any.  A traced step that lost its first 25 of 100 records,
    the rotation kernel among them, fits the same picture.  The warm-up's
    last records may show at the window's start: ``device_events`` drops
    them."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    cuda = torch.cuda.is_available()
    if activities is None:
        activities = [ProfilerActivity.CPU]
        if cuda:
            activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=on_trace_ready) as prof:
        if cuda:
            warm_up_profiler()
        prof.step()
        if cuda:
            time.sleep(WINDOW_GUARD_S)
        yield prof
        if cuda:
            torch.cuda.synchronize()
            time.sleep(WINDOW_GUARD_S)


def device_events(prof) -> list:
    """The device activities (kernels, copies, memsets) of a
    ``warmed_profile`` window, its warm-up's spin kernels left out."""
    import torch

    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and WARMUP_KERNEL not in e.name]


@contextlib.contextmanager
def device_trace(log_dir: Optional[Union[str, Path]]):
    """torch.profiler trace of the block when ``log_dir`` is set (host
    activity, and the CUDA kernels when a card is there); no-op
    otherwise.  The trace lands in ``log_dir`` as
    ``<host>_<pid>.<time>.pt.trace.json``; its window opens after the
    profiler's warm-up (``warmed_profile``).  The recorder is on inside
    it, its spans (``chain.*``) ranges of the trace: the profiler mirrors
    each range onto the card's timeline, so the trace is for reading, and
    a count of the card's busy time must leave the mirrors out."""
    if not log_dir:
        yield
        return
    from torch.profiler import tensorboard_trace_handler

    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with warmed_profile(
            on_trace_ready=tensorboard_trace_handler(str(log_dir))), \
            recording(ranges=True):
        yield

"""What every cell shares: finding a cell's files by name, the card check,
the profiled segment of a traced run and its reduction to a device trace,
the breakdown, the check of loaded modules and the result line.

Nothing here imports the system under test at module level, nor JAX.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
#: top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "image_processor_pipeline_tpu")
#: the prefix of the profiler range that marks a profiled segment
SPAN = "pb:"
#: profiler warm-up: spin-kernel launches made with collection on and the
#: window shut, and the host's wait on each side of the window (records
#: of a short window can fall outside it without them)
WARMUP_LAUNCHES = 4096
WARMUP_KERNEL = "spin_kernel"
GUARD_S = 0.25


class BenchError(RuntimeError):
    """A run that must end without a result."""


@dataclass
class Cell:
    """One cell as BENCHMARK.json and its files define it."""
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def _applies(metric, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, spec_file: Optional[Path] = None) -> Cell:
    """The cell ``name`` of the checkout's BENCHMARK.json (or of
    ``spec_file``, a file in its layout such as ``held_back.json``): its
    configuration file, its traffic file ``workloads/<name>.json`` beside
    this module and the metrics that apply to it (a held-back cell's from
    both files)."""
    root = BENCH_DIR.parent
    main = root / "BENCHMARK.json"
    spec_file = spec_file or main
    spec = json.loads(spec_file.read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise BenchError(f"no workload {name!r} in {spec_file.name}; have "
                         f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    cfg = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((BENCH_DIR / "workloads" / f"{name}.json")
                         .read_text())
    if traffic.get("config") != w["config"]:
        raise BenchError(f"workloads/{name}.json is for config "
                         f"{traffic.get('config')!r}, not {w['config']!r}")
    # a held-back cell also reports BENCHMARK.json's metrics for every cell
    specs = [spec] if spec_file == main else [json.loads(main.read_text()),
                                              spec]
    return Cell(name, int(w["chips"]), cfg, traffic,
                [m for s in specs for m in s["end_to_end"]
                 if _applies(m, name)],
                [m for s in specs for m in s["per_layer"]
                 if _applies(m, name)])


def driver(kind: str):
    """The runner of a configuration's kind: port_bench/drivers/<kind>.py."""
    return importlib.import_module(f"port_bench.drivers.{kind}")


def generator(name: str):
    """The traffic generator a traffic file names: port_bench/traffic/<name>.py."""
    return importlib.import_module(f"port_bench.traffic.{name}")


def metric_reader(name: str) -> Callable:
    """``read`` of port_bench/metrics/<name>.py (names may hold dots)."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"port_bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def require_cards(n: int):
    """The name of card 0; raises unless CUDA holds ``n`` cards or more."""
    import torch

    if not torch.cuda.is_available():
        raise BenchError("no CUDA device: this benchmark measures the card")
    if torch.cuda.device_count() < n:
        raise BenchError(f"the cell needs {n} cards, CUDA has "
                         f"{torch.cuda.device_count()}")
    return torch.cuda.get_device_name(0)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is in FORBIDDEN (whole names:
    ``image_processor_pipeline_tpu_torch`` is not ``..._tpu``)."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


# -- spans ----------------------------------------------------------------

class Spans:
    """The harness's spans around calls into the program, on the host's
    clock and from any thread: with ``timed``, each span adds its seconds
    to ``seconds[name]``; while ``events`` is a list (a profiled segment
    records), each span appends (name, start, end) to it."""

    def __init__(self):
        self.seconds: Dict[str, List[float]] = {}
        self.timed = False
        self.events: Optional[List[tuple]] = None

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            if self.timed:
                self.seconds.setdefault(name, []).append(t1 - t0)
            if self.events is not None:
                self.events.append((name, t0, t1))

    def wrap(self, owner, attr: str, name: str):
        """Put a span around ``owner.attr`` (a function or bound method);
        returns a callable that puts the original back."""
        orig = getattr(owner, attr)

        def wrapped(*a, **k):
            with self.span(name):
                return orig(*a, **k)

        setattr(owner, attr, wrapped)
        return lambda: setattr(owner, attr, orig)


# -- the profiled segment --------------------------------------------------

@dataclass
class Trace:
    """What a profiled segment recorded, times in microseconds on the
    profiler's clock."""
    device: List[tuple] = field(default_factory=list)   # (name, t0, t1)
    spans: List[tuple] = field(default_factory=list)    # (name, t0, t1)
    window: tuple = (0.0, 0.0)
    launches: Dict[str, List[int]] = field(default_factory=dict)
    #: the CUDA runtime's calls in the window that put work on the card
    #: (kernel launches, copies, memsets): (t0, t1, the index in
    #: ``device`` of the record the work left, None where none came, and
    #: whether a torch operation of the profiled thread made the call)
    calls: List[tuple] = field(default_factory=list)
    #: indices in ``device`` of records that no call in ``calls`` made
    unlaunched: List[int] = field(default_factory=list)


def profiled(run: Callable[[], Any], launches: Dict[str, List[int]],
             spans: Spans):
    """Run ``run()`` in a torch.profiler window that opens after a warm-up
    of the card's activity collection, with GUARD_S of host wait on both
    sides; ``launches`` maps a kernel's name to the bytes of each launch
    that ``run`` made of it (filled by the caller's wrappers); ``spans``
    records the harness's spans of every thread meanwhile (the profiler
    keeps host ranges of the main thread only), put on the profiler's
    clock by the window's own range.  Returns (Trace, run's result).
    Raises when the trace holds fewer records of a kernel than it was
    launched: such a window lost records.

    The records are read as the profiler holds them (``reduce_events``):
    building its tree of ``FunctionEvent``s for a pass of some 10**5 host
    operations takes tens of seconds."""
    import warnings

    import torch
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)

    warnings.filterwarnings("ignore", message=".*clears events at the end")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        for _ in range(WARMUP_LAUNCHES):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        prof.step()
        time.sleep(GUARD_S)
        spans.events = []
        t_open = time.perf_counter()
        with record_function(SPAN + "window"):
            try:
                result = run()
                torch.cuda.synchronize()
            finally:
                events, spans.events = spans.events, None
        time.sleep(GUARD_S)
    results = prof.profiler.kineto_results
    trace = reduce_events(results.events(), results.trace_start_ns(),
                          torch.autograd.DeviceType.CUDA)
    trace.launches = {k: list(v) for k, v in launches.items()}
    shift = trace.window[0] - 1e6 * t_open
    trace.spans = [(n, 1e6 * a + shift, 1e6 * b + shift)
                   for n, a, b in events]
    for kernel, sizes in trace.launches.items():
        got = sum(1 for d in trace.device if kernel in d[0])
        if got < len(sizes):
            raise BenchError(f"the profiled window holds {got} records of "
                             f"{kernel} for {len(sizes)} launches: records "
                             "were lost, so no share is reported")
    return trace, result


def _runtime_call(name: str) -> bool:
    """A CUDA runtime or driver call that puts work on the card."""
    return name.startswith("cu") and any(
        w in name for w in ("Launch", "Memcpy", "Memset"))


def reduce_events(events, base_ns: int, cuda) -> Trace:
    """A Trace of the profiler's records (``_KinetoEvent``s; ``cuda`` is
    the device type of the card's records), times in microseconds from
    ``base_ns``: the card's records in the window of the ``SPAN +
    "window"`` range (the warm-up's kernel and the card's copies of host
    ranges left out), and the runtime's calls in that window, each tied
    to the card's record it made by the correlation id.  A call belongs
    to the profiled thread where the torch operation it is linked to ran
    on the window range's thread: the profiler records the operations of
    that thread only."""
    trace = Trace()
    device, corr = [], []
    calls, ops = [], {}
    thread = None
    for e in events:
        hidden = getattr(e, "is_hidden_event", None)
        if hidden is not None and hidden():
            continue
        name = e.name()
        t0 = (e.start_ns() - base_ns) / 1e3
        t1 = t0 + e.duration_ns() / 1e3
        if e.device_type() == cuda:
            # the profiler mirrors each host span on the card's timeline
            # as an annotation that covers the work launched inside it:
            # no operation of its own
            if WARMUP_KERNEL not in name and not name.startswith(SPAN):
                device.append((name, t0, t1))
                corr.append(e.correlation_id())
        elif name == SPAN + "window":
            trace.window = (t0, t1)
            thread = e.start_thread_id()
        elif _runtime_call(name):
            calls.append((t0, t1, e.correlation_id(),
                          e.linked_correlation_id()))
        elif not name.startswith("cu") and e.linked_correlation_id() == 0:
            ops[e.correlation_id()] = e.start_thread_id()
    lo, hi = trace.window
    kept = [i for i, d in enumerate(device) if d[2] > lo and d[1] < hi]
    trace.device = [device[i] for i in kept]
    index = {corr[i]: j for j, i in enumerate(kept)}
    made = set()
    for t0, t1, c, linked in calls:
        if not lo <= t0 < hi:
            continue
        d = index.get(c)
        own = linked > 0 and thread is not None and ops.get(linked) == thread
        trace.calls.append((t0, t1, d, own))
        if d is not None:
            made.add(d)
    trace.unlaunched = [j for j in range(len(trace.device)) if j not in made]
    return trace


def union(intervals) -> List[tuple]:
    """Sorted, merged (t0, t1) intervals."""
    out: List[list] = []
    for t0, t1 in sorted(intervals):
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return [tuple(x) for x in out]


def _overlap(a, b) -> float:
    """Total length of the intersection of two merged interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def busy_seconds(trace: Trace) -> float:
    """Seconds in the window in which some operation ran on the card."""
    lo, hi = trace.window
    return sum(min(t1, hi) - max(t0, lo)
               for t0, t1 in union((d[1], d[2]) for d in trace.device)) / 1e6


def window_seconds(trace: Trace) -> float:
    return (trace.window[1] - trace.window[0]) / 1e6


def breakdown(trace: Trace, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the card's idle
    time by what the host was doing: for each span name, the idle seconds
    during which a span of that name was open ("none": no span open)."""
    by_op: Dict[str, float] = {}
    for name, t0, t1 in trace.device:
        key = name[:96]
        by_op[key] = by_op.get(key, 0.0) + (t1 - t0) / 1e6
    lo, hi = trace.window
    busy = union((d[1], d[2]) for d in trace.device)
    idle, edge = [], lo
    for t0, t1 in busy:
        if t0 > edge:
            idle.append((edge, min(t0, hi)))
        edge = max(edge, t1)
    if edge < hi:
        idle.append((edge, hi))
    gaps: Dict[str, float] = {}
    names = sorted({s[0] for s in trace.spans})
    for name in names:
        spans = union((t0, t1) for n, t0, t1 in trace.spans if n == name)
        gaps[name] = _overlap(idle, spans) / 1e6
    any_span = union((t0, t1) for _, t0, t1 in trace.spans)
    gaps["none"] = (sum(t1 - t0 for t0, t1 in idle)
                    - _overlap(idle, any_span)) / 1e6
    order = lambda d: sorted(([k, v] for k, v in d.items() if v > 0),
                             key=lambda kv: -kv[1])[:top]
    return {"device_ops": order(by_op), "idle_gaps": order(gaps)}


# -- the result -------------------------------------------------------------

@dataclass
class Check:
    """One number compared with the reference, and its limit (the run is
    correct where every value is at most its limit)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, Dict[str, Any]], device: Dict[str, Any],
                checks: List[Check], breakdown_: Optional[dict] = None) -> str:
    """The run's last line of standard output; ``checks`` comes last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown_ is not None:
        out["breakdown"] = breakdown_
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in checks}
    return json.dumps(out)


def check_lines(checks: List[Check]) -> str:
    return "\n".join(f"check {c.name}: {c.value} (limit {c.limit}) "
                     f"{'ok' if c.ok else 'FAILED'}" for c in checks)

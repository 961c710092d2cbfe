"""The component labelling's share of its roofline in the profiled pass:
the least time its calls could take, the bytes every labelling must
move (``ccl_bytes``) over the card's peak bandwidth, over the time the
profiler gives the kernels (copies and memsets left out) that the
labelling launched: those of the runtime's calls made inside the
harness's spans around ``ops/ccl.py:label_components`` by torch
operations of the profiled thread, the thread that runs the labelling.
Kernels that other threads launch meanwhile (the savers' fetches) are
not counted.

Nothing is reported where records were lost: a call in a span whose
record on the card is missing, or a record on the card starting in a
span that no recorded call made, or a span holding no call of the
profiled thread (the labelling then ran elsewhere)."""

import bisect

from port_bench import counts
from port_bench.drivers.engine import CCL_SPAN

#: device records that are no kernel
NOT_KERNELS = ("Memcpy", "Memset")


def ccl_bytes(B: int, H: int, W: int) -> int:
    """The least traffic of labelling B masks of H x W, whatever the
    algorithm: the bool mask read once and the int32 labels written
    once."""
    return B * H * W * (1 + 4)


def _span_of(spans, starts, t) -> int:
    """Index of the span holding time ``t``, or -1."""
    i = bisect.bisect_right(starts, t) - 1
    return i if i >= 0 and t < spans[i][1] else -1


def read(records):
    trace, calls = records.get("trace"), records.get("ccl")
    peak = counts.peak_bytes_per_s(records.get("kind"))
    if trace is None or not calls or peak is None:
        return None
    spans = sorted((t0, t1) for name, t0, t1 in trace.spans
                   if name == CCL_SPAN)
    if len(spans) != len(calls):
        return None
    starts = [t0 for t0, _ in spans]
    own = [0] * len(spans)
    busy = 0.0
    for t0, _, d, mine in trace.calls:
        i = _span_of(spans, starts, t0)
        if i < 0 or not mine:
            continue
        if d is None:
            return None
        own[i] += 1
        name, k0, k1 = trace.device[d]
        if not name.startswith(NOT_KERNELS):
            busy += k1 - k0
    if any(_span_of(spans, starts, trace.device[j][1]) >= 0
           for j in trace.unlaunched):
        return None
    if busy <= 0 or not all(own):
        return None
    bound_us = 1e6 * sum(ccl_bytes(*c["shape"]) for c in calls) / peak
    return 100.0 * bound_us / busy

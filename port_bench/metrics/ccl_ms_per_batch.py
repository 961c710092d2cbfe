"""Milliseconds a component labelling takes in the profiled pass: the
harness's spans around ``ops/ccl.py:label_components`` (one a batch of
the cleanup), each opened once the card had finished the work queued
before it, their mean."""

from port_bench.drivers.engine import CCL_SPAN


def read(records):
    trace = records.get("trace")
    spans = [t1 - t0 for name, t0, t1 in trace.spans if name == CCL_SPAN] \
        if trace else []
    return 1e-3 * sum(spans) / len(spans) if spans else None

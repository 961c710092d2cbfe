"""Share of one whole profiled pass of the engine in which no operation
ran on the card: 1 - busy / wall."""

from port_bench.harness import busy_seconds, window_seconds


def read(records):
    trace = records.get("trace")
    if trace is None or not trace.device or not window_seconds(trace):
        return None
    return 100.0 * (1.0 - busy_seconds(trace) / window_seconds(trace))

"""Share of the device-to-host bytes the transforms fetched, of those
their full outputs hold: summed ``d2h_bytes_fetched`` over summed
``d2h_bytes_full`` of the window's steps (StageMetrics counters)."""


def read(records):
    steps = records.get("steps") or []
    full = sum(s["d2h_bytes_full"] for s in steps)
    if not full:
        return None
    return 100.0 * sum(s["d2h_bytes_fetched"] for s in steps) / full

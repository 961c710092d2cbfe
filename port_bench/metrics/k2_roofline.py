"""K2's (csrc/shear_rotate.cu) share of its roofline in the profiled
pass: the least time its launches could take, their bytes
(counts.rotate_bytes of the shapes handed to ops/rotate.py's launcher)
over the card's peak bandwidth, over the time the profiler gives its
``shear_tile_kernel`` records."""

from port_bench import counts
from port_bench.drivers.engine import K2


def read(records):
    trace = records.get("trace")
    sizes = trace.launches.get(K2) if trace else None
    times = [t1 - t0 for name, t0, t1 in trace.device if K2 in name] \
        if trace else []
    peak = counts.peak_bytes_per_s(records.get("kind"))
    if not sizes or not times or peak is None:
        return None
    bound_us = 1e6 * sum(sizes) / peak
    return 100.0 * bound_us / sum(times)

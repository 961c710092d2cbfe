"""K1's (csrc/augment_full.cu) share of its roofline in the profiled
calls: the least time its launches could take, their bytes
(counts.chain_bytes) over the card's peak bandwidth, over the time the
profiler gives its ``chain_cluster_kernel`` records."""

from port_bench import counts
from port_bench.drivers.chain import K1


def read(records):
    trace = records.get("trace")
    sizes = trace.launches.get(K1) if trace else None
    times = [t1 - t0 for name, t0, t1 in trace.device if K1 in name] \
        if trace else []
    peak = counts.peak_bytes_per_s(records.get("kind"))
    if not sizes or not times or peak is None:
        return None
    bound_us = 1e6 * sum(sizes) / peak
    return 100.0 * bound_us / sum(times)

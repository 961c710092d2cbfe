"""Arrays a chain call copies from the host to the card.
The program's counter ``chain.h2d_copies`` over the traced run's
profiled calls, divided by their calls (``chain.call``); None where the
program has no such counter (``port_bench/recorder.py``)."""

from port_bench.recorder import count_a_call


def read(records):
    return count_a_call(records, "chain.h2d_copies")

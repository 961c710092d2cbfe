"""Chain calls whose shear factors the native pass computed. The
program's counter ``chain.factors_native`` (one for each ``augment_chain``
call whose quarter turns and shear angles came from one native pass, with
only ``tan`` and ``sin`` left to torch) over the traced run's profiled
calls, divided by their calls (``chain.call``); None where the program
has no such counter (``port_bench/recorder.py``)."""

from port_bench.recorder import count_a_call


def read(records):
    return count_a_call(records, "chain.factors_native")

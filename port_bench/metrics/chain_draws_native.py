"""Draw functions of a chain call that the native pass served. The
program's counter ``chain.draws_native`` (one for each of
``_crop_params`` and ``_flip_and_params`` that made its draws in one
native call) over the traced run's profiled calls, divided by their calls
(``chain.call``); None where the program has no such counter
(``port_bench/recorder.py``)."""

from port_bench.recorder import count_a_call


def read(records):
    return count_a_call(records, "chain.draws_native")

"""Chain calls that the packed path served. The program's counter
``chain.packed`` (one for each ``augment_chain`` call whose item rows,
enhance rows and shift vectors went to the card packed in one buffer)
over the traced run's profiled calls, divided by their calls
(``chain.call``); None where the program has no such counter
(``port_bench/recorder.py``)."""

from port_bench.recorder import count_a_call


def read(records):
    return count_a_call(records, "chain.packed")

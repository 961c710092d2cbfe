"""Host milliseconds a chain call spends on its shift vectors
(``geometry.shear_params``, torch on the host over [B, crop]).
The program's span ``chain.shifts`` over the traced run's profiled
calls, divided by their calls (``chain.call``); None where the program
has no such span (``port_bench/recorder.py``)."""

from port_bench.recorder import ms_a_call


def read(records):
    return ms_a_call(records, "chain.shifts")

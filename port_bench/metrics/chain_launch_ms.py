"""Host milliseconds a chain call spends in its mode's launcher (for
``cuda_full``, ``augment_fused_full`` to the return of
``ipp_augment_full``).
The program's span ``chain.launch`` over the traced run's profiled
calls, divided by their calls (``chain.call``); None where the program
has no such span (``port_bench/recorder.py``)."""

from port_bench.recorder import ms_a_call


def read(records):
    return ms_a_call(records, "chain.launch")

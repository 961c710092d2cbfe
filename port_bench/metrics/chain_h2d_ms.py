"""Host milliseconds a chain call spends copying its drawn parameters and
shift vectors to the card (``torch.as_tensor(..., device=dev)``).
The program's span ``chain.h2d`` over the traced run's profiled calls,
divided by their calls (``chain.call``); None where the program has no
such span (``port_bench/recorder.py``)."""

from port_bench.recorder import ms_a_call


def read(records):
    return ms_a_call(records, "chain.h2d")

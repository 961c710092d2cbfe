"""Host milliseconds a chain call spends in its draws: the harness's
spans around ``models/chains.py``'s ``_crop_params`` and
``_flip_and_params`` in the traced run's window, summed over the window
and divided by its calls."""


def read(records):
    return records.get("chain_draw_ms")

"""Sweeps a component labelling runs in the profiled pass: of each
``ops/ccl.py:label_components`` call, its items' largest sweep count
(``return_iters=True``) rounded up to the host's look at the flag every
``CHECK_EVERY`` sweeps, as the loop runs them; their mean."""


def read(records):
    calls = records.get("ccl")
    return sum(c["sweeps"] for c in calls) / len(calls) if calls else None

"""The 95th percentile of the chain's calls in the traced run's window,
each timed on the host's clock from the previous call's end (the window's
start for the first) to its own end after ``torch.cuda.synchronize()``,
in milliseconds."""


def read(records):
    return records.get("chain_batch_ms_p95")

"""CPU milliseconds an image written: the process's user plus system CPU
seconds over the window (``resource.getrusage(RUSAGE_SELF)`` at its start
and at the end of its last pass: every thread, so decode, dispatch and
the savers) over the image files its passes saved.  Steadier than the
rate where the host's cores slow down: it counts the work, not the wait."""


def read(records):
    cpu, images = records.get("window_cpu_s"), records.get("images")
    if cpu is None or not images:
        return None
    return 1e3 * (cpu[1] - cpu[0]) / images

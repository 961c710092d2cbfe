"""Saver milliseconds an image written: the window's summed
``host_save_seconds`` (StageMetrics) over the image files its passes
saved."""


def read(records):
    steps, images = records.get("steps") or [], records.get("images")
    if not steps or not images:
        return None
    return 1e3 * sum(s["host_save_seconds"] for s in steps) / images

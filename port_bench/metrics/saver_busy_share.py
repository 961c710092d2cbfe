"""Share of the saver threads' time spent saving: the engine's
``host_save_seconds`` over ``workers`` x the step's wall, summed over
every step of the window's passes (StageMetrics)."""


def read(records):
    steps = records.get("steps") or []
    wall = sum(s["workers"] * s["wall_seconds"] for s in steps)
    if not wall:
        return None
    return 100.0 * sum(s["host_save_seconds"] for s in steps) / wall

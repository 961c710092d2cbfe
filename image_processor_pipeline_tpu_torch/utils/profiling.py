"""Per-stage metrics and tracing (port of
image_processor_pipeline_tpu/utils/profiling.py).

  - StageMetrics: structured per-stage wall-clock, item counts, items/sec
    and the host/device time split and the device→host bytes of
    transforms that shrink their output, attached to every ProcessingStep
    run and included in the JSON run report.
  - Timer: scoped wall-clock accumulator.
  - device_trace(): context manager around torch.profiler that writes a
    Chrome trace (TensorBoard's profiler plugin and Perfetto read it);
    ``ProcessingStep(trace_dir=...)`` runs its step inside one.

The JAX module's ``enable_compilation_cache`` has no counterpart: nothing
here is compiled per process but the CUDA kernels, which ``kernels.py``
builds once into ``_build/``.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Union


@dataclass
class StageMetrics:
    name: str = ""
    items: int = 0
    wall_seconds: float = 0.0
    host_load_seconds: float = 0.0
    device_seconds: float = 0.0
    host_save_seconds: float = 0.0
    batches: int = 0
    compiles: int = 0
    output_collisions: int = 0
    #: device→host bytes: full-output size vs actually fetched after the
    #: shrink_output hook (0/0 when the transform doesn't shrink)
    d2h_bytes_full: int = 0
    d2h_bytes_fetched: int = 0

    @property
    def items_per_second(self) -> float:
        return self.items / self.wall_seconds if self.wall_seconds > 0 else 0.0

    def as_dict(self) -> Dict:
        return {
            "name": self.name,
            "items": self.items,
            "wall_seconds": round(self.wall_seconds, 4),
            "items_per_second": round(self.items_per_second, 2),
            "host_load_seconds": round(self.host_load_seconds, 4),
            "device_seconds": round(self.device_seconds, 4),
            "host_save_seconds": round(self.host_save_seconds, 4),
            "batches": self.batches,
            "output_collisions": self.output_collisions,
            "d2h_bytes_full": self.d2h_bytes_full,
            "d2h_bytes_fetched": self.d2h_bytes_fetched,
        }


class Timer:
    """Scoped wall-clock accumulator: ``with timer.measure('load'): ...``"""

    def __init__(self):
        self.totals: Dict[str, float] = {}

    @contextlib.contextmanager
    def measure(self, key: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[key] = self.totals.get(key, 0.0) + (
                time.perf_counter() - t0
            )


#: small launches made while the profiler warms up (see device_trace)
WARMUP_LAUNCHES = 4096


@contextlib.contextmanager
def device_trace(log_dir: Optional[Union[str, Path]]):
    """torch.profiler trace of the block when ``log_dir`` is set (host
    activity, and the CUDA kernels when a card is there); no-op
    otherwise.  The trace lands in ``log_dir`` as
    ``<host>_<pid>.<time>.pt.trace.json``.

    On a card the profiler warms up first: CUDA activity collection is on
    but the trace's window not yet open while ``WARMUP_LAUNCHES`` small
    launches run, then the window opens on the block, and the card is
    synchronised before it closes.  In a process that has traced before,
    the first GPU records of a new session can be lost (on an H100, the
    first 25 of a traced step's 100: its copies and first kernels, the
    rotation kernel among them); records made in the warm-up take
    those places, and the window leaves them out of the trace (a few of
    the last may show at its start, the card's clock and the host's
    being some tenths of a millisecond apart)."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import (ProfilerActivity, profile, schedule,
                                tensorboard_trace_handler)

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))
                 ) as prof:
        if cuda:
            x = torch.zeros(1, device="cuda")
            for _ in range(WARMUP_LAUNCHES):
                x.add_(1)
            torch.cuda.synchronize()
        prof.step()
        yield
        if cuda:
            torch.cuda.synchronize()

"""Per-stage metrics (port of StageMetrics and Timer,
image_processor_pipeline_tpu/utils/profiling.py:23-75).

  - StageMetrics: structured per-stage wall-clock, item counts, items/sec
    and the host/device time split and the device→host bytes of
    transforms that shrink their output, attached to every ProcessingStep
    run and included in the JSON run report.
  - Timer: scoped wall-clock accumulator.

``device_trace`` and ``enable_compilation_cache`` of the JAX module are not
ported yet; a step given ``trace_dir`` raises NotImplementedError.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Dict


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

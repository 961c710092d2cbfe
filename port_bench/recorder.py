"""The program's own spans and counters in a traced run, as the per-layer
readers of the chain's host phases take them: the port's recorder
(``utils/profiling.py``: ``RECORDER``) keeps the program's spans while a
torch.profiler session collects, so after the traced run's profiled
segment it holds that segment's calls, and nothing else of the run.

A program without the recorder, or a run without a profiled segment or
without a chain call in it, gives None."""

from __future__ import annotations

from typing import Optional

#: the span of one whole ``augment_chain`` call
CALL = "chain.call"


def _recorder(records):
    if records.get("trace") is None:
        return None
    try:
        from image_processor_pipeline_tpu_torch.utils import profiling
    except ImportError:
        return None
    rec = getattr(profiling, "RECORDER", None)
    if rec is None or not getattr(rec, "counts", {}).get(CALL):
        return None
    return rec


def ms_a_call(records, name: str) -> Optional[float]:
    """Milliseconds of the span ``name`` a chain call."""
    rec = _recorder(records)
    if rec is None or name not in rec.totals:
        return None
    return 1e3 * rec.totals[name] / rec.counts[CALL]


def count_a_call(records, name: str) -> Optional[float]:
    """The counter ``name`` a chain call."""
    rec = _recorder(records)
    if rec is None or name not in rec.counters:
        return None
    return rec.counters[name] / rec.counts[CALL]

"""Input-pairing engine: builds the iterator of per-call input tuples
(the port's own copy of image_processor_pipeline_tpu/pairing.py; stdlib
only).

Parity target: reference pipeline.py:148-235 (_generate_processing_inputs)
with its five modes (MODES at pipeline.py:12) and the sample_k
pre-subsampling (pipeline.py:174-176).  Fixed here: the sample_k
index-out-of-range defect for unequal list lengths (SURVEY.md §2.7 #11) —
we sample aligned indices from the *shortest* list.

Unlike the reference's module-global `random`, pairing draws come from an
explicit `random.Random(seed)` so runs are reproducible when a seed is set.
"""

from __future__ import annotations

import random
from pathlib import Path
from typing import Callable, Iterator, List, Optional, Tuple

MODES = ("one_input", "zip", "modulo", "sample", "custom")

SAMPLE_RATE = 0.3  # reference pipeline.py:209-225: two independent 30% draws


def pair_zip(file_lists: List[List[Path]]) -> Iterator[Tuple]:
    """Reusable custom pairing function: positional zip (stops at the
    shortest list) — referenceable from configs as
    ``image_processor_pipeline_tpu_torch.pairing:pair_zip``."""
    return zip(*file_lists)


def generate_processing_inputs(
    file_lists: List[List[Path]],
    pairing_method: str = "one_input",
    pairing_function: Optional[Callable] = None,
    sample_k: Optional[int] = None,
    rng: Optional[random.Random] = None,
) -> Tuple[Iterator[Tuple], Optional[int]]:
    """Return (iterator of per-call input tuples, total item count).

    ``total`` is None only when a custom pairing function hides the length.
    """
    if pairing_method not in MODES:
        raise ValueError(
            f"pairing_method must be one of {MODES}, got {pairing_method!r}"
        )
    rng = rng or random.Random()

    if sample_k is not None:
        n = min(len(fl) for fl in file_lists)
        k = min(sample_k, n)
        idx = rng.sample(range(n), k)
        file_lists = [[fl[i] for i in idx] for fl in file_lists]

    if pairing_method == "one_input":
        if len(file_lists) != 1:
            raise ValueError("one_input pairing requires exactly 1 input dir")
        files = file_lists[0]
        return ((f,) for f in files), len(files)

    if pairing_method == "zip":
        if len(file_lists) < 2:
            raise ValueError("zip pairing requires at least 2 input dirs")
        total = min(len(fl) for fl in file_lists)
        return zip(*file_lists), total

    if pairing_method == "modulo":
        if len(file_lists) != 2:
            raise ValueError("modulo pairing requires exactly 2 input dirs")
        firsts, seconds = file_lists[0], list(file_lists[1])
        rng.shuffle(seconds)

        def gen():
            for i, f in enumerate(firsts):
                yield (f, seconds[i % len(seconds)])

        return gen(), len(firsts)

    if pairing_method == "sample":
        if len(file_lists) != 1:
            raise ValueError("sample pairing requires exactly 1 input dir")
        files = file_lists[0]
        n = len(files)
        k = int(SAMPLE_RATE * n)
        blur_idx = set(rng.sample(range(n), k))
        rgb_idx = set(rng.sample(range(n), k))

        def gen():
            for i, f in enumerate(files):
                yield (f, i in blur_idx, i in rgb_idx)

        return gen(), n

    # custom
    if pairing_function is None:
        raise ValueError("custom pairing requires a pairing_function")
    it = pairing_function(file_lists)
    total = None
    if hasattr(it, "__len__"):
        total = len(it)
        it = iter(it)
    return it, total

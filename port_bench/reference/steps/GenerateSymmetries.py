"""Reference of the dihedral symmetries: of the pool o (identity), h
(mirror the columns), v (mirror the rows) and hv (both), ``choose_random``
drawn without replacement by Python's ``random.Random(seed).sample``,
with 'o' added when ``include_original``; each written as a q95 JPEG
named ``{stem}_{sym}{suffix}``."""

from __future__ import annotations

import random
from pathlib import Path

import torch

from port_bench.reference.images import decode, encode_jpeg

ALL_SYMS = ("o", "h", "v", "hv")
_FLIP = {"o": lambda a: a, "h": lambda a: a[:, ::-1],
         "v": lambda a: a[::-1], "hv": lambda a: a[::-1, ::-1]}


def _chosen(seed, options):
    pool = list(options.get("pool") or ALL_SYMS)
    k = options.get("choose_random")
    k = len(pool) if k is None else min(int(k), len(pool))
    chosen = random.Random(seed).sample(pool, k) if seed is not None \
        else list(pool)
    if options.get("include_original", True) and "o" not in chosen:
        chosen.append("o")
    return chosen


def outputs(names, options, seed=None):
    """(output dir index, file name) of what an item writes (every file
    the pool can give when no seed is given)."""
    p = Path(names[0])
    return [(0, f"{p.stem}_{s}{p.suffix}") for s in _chosen(seed, options)]


def apply(inputs, seed: int, options, dtype=torch.float32):
    """{(dir, name): bytes} for one item; ``inputs``: [(name, bytes)]."""
    (name, data), = inputs
    if Path(name).suffix.lower() not in (".jpg", ".jpeg"):
        raise ValueError("the reference holds JPEG inputs only")
    arr = decode(data)
    p = Path(name)
    return {(0, f"{p.stem}_{s}{p.suffix}"): encode_jpeg(_FLIP[s](arr), 95)
            for s in _chosen(seed, options)}

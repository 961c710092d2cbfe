"""Fused rotations → symmetries: eval config 2 as ONE step (fan-out N×S;
port of image_processor_pipeline_tpu/transforms/rotsym.py).

The reference runs the pair as two disk-materialized stages
(rotations.py:88-119 writes every rotation, symmetry.py:92-134 re-decodes
each one and writes its flips).  This transform composes them: decode the
input once, rotate N times in one batched call (with ``method="shear"``
one launch of the rotation kernel a batch on a card), and encode each
rotation's symmetries directly — the N intermediate encodes *and* the N
intermediate decodes disappear.  Flips never materialize either: save_item
hands numpy flip views of each rotated crop to the encoder.

Byte parity with the unfused pair (rotations with ``output_format='png'``,
then symmetry over its files):

- the rotations half inherits RandomRotations wholesale — same per-item
  seed tree, same device function — so the rotated pixels are the ones
  the standalone step would have encoded;
- the elided intermediate is PNG: lossless, so the standalone symmetry
  step would have decoded exactly those pixels back;
- symmetry's per-item randomness is DEGENERATE when ``choose_random`` is
  None or >= len(pool) (reference symmetry.py:122-126 then selects the
  whole pool; ``include_original`` appends 'o'): the saved SET is
  deterministic, so no RNG tree needs replicating;
- flips re-encode via ``encode_image`` exactly as GenerateSymmetries does
  (the intermediate's ``.png`` suffix rides through to the outputs,
  symmetry.py:133-134).

Option names: the two source steps both have ``include_original``, so the
fused step renames them ``rot_include_original`` (save the un-rotated
original's symmetries under ``original_key``) and ``sym_include_original``
(append 'o' when the pool misses it).  Everything else keeps the
RandomRotations / GenerateSymmetries names.

Direct users may set ``choose_random < len(pool)``: each rotation then
samples its own subset from a per-(item, rotation) tree (``select_syms``)
— equally distributed but not byte-comparable to any standalone run,
since the standalone symmetry step seeds per *intermediate file* index.
The JAX class's zero-copy native flip views wait for the port's native
codec.
"""

from __future__ import annotations

import random
from pathlib import Path
from typing import Dict, List, Optional, Sequence
from warnings import warn

import numpy as np

from image_processor_pipeline_tpu_torch.transforms.rotations import RandomRotations
from image_processor_pipeline_tpu_torch.transforms.symmetry import ALL_SYMS
from image_processor_pipeline_tpu_torch.io.images import encode_image

#: numpy flip views — pure strides, no copy until the encoder reads them
_VIEW = {
    "o": lambda a: a,
    "h": lambda a: a[:, ::-1],
    "v": lambda a: a[::-1],
    "hv": lambda a: a[::-1, ::-1],
}


def select_syms(syms, sym_sample, item_seed: int, slot: int):
    """The dihedral selection for one fan-out slot — the ONE sampling
    convention every fused fan-out composite shares (this module's
    docstring defines it; RotSymChain / RotationsChainSymmetries /
    SymmetriesChain ride it so the same seeds select the same subsets
    everywhere).

    ``sym_sample is None`` (the byte tier) returns the static ``syms``
    selection unchanged.  Otherwise ``sym_sample = (pool, k,
    include_original)`` draws ``k`` of ``pool`` from the per-(item, slot)
    tree ``random.Random((item_seed << 16) ^ slot)`` and appends 'o' when
    ``include_original`` is set and the draw missed it — equally
    DISTRIBUTED but not byte-comparable to a standalone run, which seeds
    per intermediate-file index.  Changing this tree changes rng-tier
    fused outputs."""
    if sym_sample is None:
        return syms
    pool, k, include_original = sym_sample
    rng = random.Random((int(item_seed) << 16) ^ slot)
    selected = rng.sample(list(pool), k)
    if include_original and "o" not in set(selected):
        selected.append("o")
    return selected


def pool_selection(options: Dict, include_original: bool, item_seed: int):
    """GenerateSymmetries' pool rules (reference symmetry.py:122-126; its
    crash on ``choose_random > len(pool)`` fixed: warn and clamp) over a
    fused step's ``pool`` and ``choose_random`` options.  Returns
    ``selection(slot)``: the whole pool, 'o' appended when
    ``include_original`` is set and the pool misses it (deterministic, the
    byte tier), or, for ``choose_random < len(pool)``, the subset
    ``select_syms`` draws from the per-(item, slot) tree."""
    pool = list(options.get("pool") or ALL_SYMS)
    invalid = [s for s in pool if s not in ALL_SYMS]
    if invalid:
        raise ValueError(f"pool contains invalid symmetries: {invalid}")
    choose_random = options.get("choose_random")
    choose_random = len(pool) if choose_random is None else choose_random
    if choose_random > len(pool):
        warn(f"choose_random={choose_random} exceeds pool size "
             f"{len(pool)}; clamping")
        choose_random = len(pool)
    elif choose_random < 0:
        raise ValueError(f"choose_random ({choose_random}) must be >= 0")

    def selection(slot: int) -> List[str]:
        if choose_random >= len(pool):
            selected = list(pool)
            if include_original and "o" not in set(selected):
                selected.append("o")
            return selected
        return select_syms(None, (pool, choose_random, include_original),
                           item_seed, slot)

    return selection


def emit_views(img: np.ndarray, syms, path_of, saved: List[Path]) -> None:
    """Write each dihedral ``sym`` of ``syms`` of ``img`` to ``path_of(sym)``
    as a numpy flip view, appending each written path to ``saved``; through
    ``encode_image``, GenerateSymmetries' encoder (even the 'o' copy is a
    re-encode, reference symmetry.py:133).  A failed encode is tolerated
    per sym with a warning, as GenerateSymmetries does."""
    for sym in syms:
        p = path_of(sym)
        try:
            encode_image(_VIEW[sym](img), p)
            saved.append(p)
        except Exception as e:  # noqa: BLE001 — per-sym tolerance
            warn(f"failed to save symmetry {sym!r} for {p.name}: {e}")


class RotationsSymmetries(RandomRotations):
    """RandomRotations ∘ GenerateSymmetries in one step.

    Compute (load/probe/device_fn) is inherited unchanged from
    RandomRotations; only the save half changes: instead of writing each
    rotation, it writes each rotation's selected symmetries, named
    ``{stem}_{rotation_key}_{sym}.png`` — exactly the name the standalone
    symmetry step gives the standalone rotation output.
    """

    def shrink_output(self, out_dev, chunk, options):
        """Outputs are always ``.png`` (the symmetry half keeps the
        lossless intermediate suffix), so the inherited ``.jpg``
        coefficient-transport shrink — whose output protocol this
        save_item doesn't speak — must never run, even if a direct user
        passes ``output_format='jpeg'``."""
        self.start_host_copy(out_dev)
        return out_dev

    def save_item(
        self,
        out: Dict[str, np.ndarray],
        item: Dict,
        output_dirs: Sequence[Path],
        options: Dict,
    ) -> Optional[List[Path]]:
        if not output_dirs:
            print("[rotsym] no output dir provided")
            return None
        target = Path(output_dirs[0])
        path = Path(item["_args"][0])
        stem = path.stem

        if "include_original" in options:
            warn(
                "RotationsSymmetries ignores 'include_original' — use "
                "'rot_include_original' (save the un-rotated original's "
                "symmetries) and/or 'sym_include_original' (append 'o' "
                "when the pool misses it)"
            )
        selection = pool_selection(
            options, options.get("sym_include_original", True),
            item["_seed"])
        output_prefix = options.get("output_prefix", "r")
        original_key = options.get("original_key", "r000")
        key_format = options.get("rotation_key_format", "{prefix}{index:03d}")

        saved: List[Path] = []

        def emit(base: np.ndarray, rotation_key: str, rotation_index: int):
            emit_views(base, selection(rotation_index),
                       lambda sym: target / f"{stem}_{rotation_key}_{sym}.png",
                       saved)

        if options.get("rot_include_original", True):
            try:
                h, w = (int(x) for x in item["size"])
                emit(item["image"][:h, :w], original_key, 0)
            except Exception as e:  # noqa: BLE001 — continue past original
                print(f"[rotsym] failed original of {path.name}: {e}")

        n = out["heights"].shape[0]
        for i in range(n):
            bh, bw = int(out["heights"][i]), int(out["widths"][i])
            if bh <= 0 or bw <= 0:
                # the standalone rotations step would not have written
                # this rotation (rotations.py save parity), so the
                # standalone symmetry step would never have seen it
                print(f"[rotsym] empty bbox for rotation {i + 1} of "
                      f"{path.name}; skipping")
                continue
            rotation_key = key_format.format(
                prefix=output_prefix, index=i + 1)
            emit(out["images"][i][:bh, :bw], rotation_key, i + 1)

        if not saved:
            return None
        return saved

"""Fused symmetries → chain tail: dihedral fan-out at the HEAD, one step
(fan-out 1→S through deterministic stages; port of
image_processor_pipeline_tpu/transforms/symchain.py).

The reference runs the pair as disk-materialized stages
(symmetry.py:92-134 writes every flip; filtres_liste.py:41-149 /
pixels_isolés.py:8-81 / recadrages.py:63-82 then re-decode each one).
This transform decodes the input ONCE, applies every selected dihedral on
the device, pushes all B × S variants through the stage tail as one batch,
and encodes only the final results.

Byte parity (entirely draw-free):

- the symmetry selection is the DETERMINISTIC byte-tier set (whole pool,
  ``include_original`` appending 'o' — reference symmetry.py:122-126;
  ``auto_fuse="rng"`` fuses sub-pool sampling via ``sym_sample``), and the
  flips are pure valid-region pixel permutations (ops/geometry.py:
  dihedral) of exactly the pixels the standalone step decoded;
- the head inputs must be lossless 8-bit RGBA ``.png`` (enforced by the
  fuser via _png_input_ok);
- the tail stages (ColorMask with ``input_alpha='replace'``, Cleanup,
  FitCrop) are DETERMINISTIC and consume no draws;
- naming rides through: the final files are ``{stem}_{sym}.png``, encoded
  with the LAST stage's reference anchor (rotchain.tail_encoder).

One status per INPUT item; a sym slot whose tail empties is skipped with a
warning.  The JAX class's ``native_fn`` and ``shrink_output`` wait for the
port's native codec.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from image_processor_pipeline_tpu_torch import random as jrandom
from image_processor_pipeline_tpu_torch.transforms.fused import (
    Enhance,
    Flip,
    FusedChain,
    Rotate,
)
from image_processor_pipeline_tpu_torch.transforms.rotchain import (
    emit_slot,
    tail_encoder,
)
from image_processor_pipeline_tpu_torch.transforms.rotsym import select_syms
from image_processor_pipeline_tpu_torch.transforms.symmetry import ALL_SYMS
from image_processor_pipeline_tpu_torch.ops import geometry


def check_syms(syms, sym_sample, tail: bool = False) -> Tuple[str, ...]:
    """Validate a fan-out's static selection and its ``(pool, k,
    include_original)`` sampling spec (``tail``: the trailing fan-out's,
    named so in the errors); returns ``syms`` as a tuple."""
    pre = "tail_" if tail else ""
    syms = tuple(syms)
    invalid = [s for s in syms if s not in ALL_SYMS]
    if invalid:
        raise ValueError(
            f"invalid {'tail ' if tail else ''}symmetries: {invalid}")
    if not syms:
        raise ValueError(f"{pre}syms must be non-empty")
    if sym_sample is not None:
        pool, k, _ = sym_sample
        missing = [s for s in pool if s not in syms]
        if missing or not 0 <= int(k) <= len(pool):
            raise ValueError(
                f"{'tail' if tail else 'sym'}_sample pool {pool}/k={k} "
                f"outside {pre}syms superset {syms}")
    return syms


def sym_fanout_tail(stages, syms, img, h, w, keys):
    """Every dihedral of ``syms`` of each canvas, through the stage tail as
    one batch: img [n, H, W, C], h, w [n] on one device, keys [n, 2] the
    canvases' tail keys → images [n, K, H, W, C'], heights and widths
    [n, K].  Stage i of variant j draws from fold_in(fold_in(key,
    1000 + j), i) (the JAX tree; the tails the fuser builds draw nothing)."""
    n, H, W, _ = img.shape
    K = len(syms)
    im = torch.stack([geometry.dihedral(img, h, w, s) for s in syms],
                     dim=1).reshape(n * K, H, W, -1)
    hh, ww = h.repeat_interleave(K), w.repeat_interleave(K)
    kj = jrandom.fold_in(np.asarray(keys)[:, None],
                         1000 + np.arange(K)).reshape(n * K, 2)
    for i, stage in enumerate(stages):
        im, hh, ww = stage.apply(im, hh, ww,
                                 stage.draw(jrandom.fold_in(kj, i)))
    return (im.reshape(n, K, H, W, im.shape[-1]), hh.reshape(n, K),
            ww.reshape(n, K))


class SymmetriesChain(FusedChain):
    """GenerateSymmetries ∘ deterministic FusedChain tail in one step.

    ``syms`` is the STATIC selection the standalone symmetry step would
    save (computed by the fuser; direct users pass it).  Only draw-free
    tails are representable, so Rotate/Flip/Enhance stages raise.

    ``sym_sample=(pool, k, include_original)`` (the ``auto_fuse="rng"``
    tier): the device still computes the full ``syms`` superset, and
    save_item emits the subset drawn from the shared per-item tree
    (rotsym.select_syms at slot 0).  Distribution-equal, never byte-equal.
    """

    max_batch = 8  # S output canvases per item

    def __init__(self, stages: Sequence, syms: Sequence[str],
                 sym_sample: Optional[Tuple] = None):
        FusedChain.__init__(self, stages)
        if any(isinstance(s, (Rotate, Flip, Enhance)) for s in self.stages):
            raise ValueError(
                "SymmetriesChain tails must be draw-free "
                "(no Rotate/Flip/Enhance)")
        self.syms = check_syms(syms, sym_sample)
        self.sym_sample = sym_sample
        self._sym_index = {s: j for j, s in enumerate(self.syms)}

    def static_args(self, options: Dict, key: Tuple) -> Tuple:
        return FusedChain.static_args(self, options, key) + self.syms

    def device_fn(self, batch, static):
        size = batch["size"]
        images, heights, widths = sym_fanout_tail(
            self.stages, self.syms, batch["image"], size[:, 0], size[:, 1],
            self.keys_from_seeds(batch["seed"]))
        return {"images": images, "heights": heights, "widths": widths}

    def shrink_output(self, out_dev, chunk, options):
        """Multi-slot output ([B, S, H, W, 4]) — the inherited 1→1
        valid-region shrink and the ``.jpg`` coefficient transport don't
        apply (outputs are always ``.png``)."""
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
            print("[symchain] no output dir provided")
            return None
        target = Path(output_dirs[0])
        stem = Path(item["_args"][0]).stem
        bands = options.get("output_bands")
        encoder = tail_encoder(self.stages)

        saved: List[Path] = []
        for sym in select_syms(self.syms, self.sym_sample,
                               item["_seed"], 0):
            j = self._sym_index[sym]
            emit_slot(encoder, out["images"][j],
                      int(out["heights"][j]), int(out["widths"][j]),
                      bands, target / f"{stem}_{sym}.png", saved)
        if not saved:
            return None
        return saved

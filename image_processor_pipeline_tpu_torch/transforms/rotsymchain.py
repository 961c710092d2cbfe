"""Fused rotations → symmetries → chain tail: (N+1)×S fan-out, ONE step
(port of image_processor_pipeline_tpu/transforms/rotsymchain.py).

The reference runs rotations.py:88-119, symmetry.py:92-134 and the tail
(filtres_liste.py:41-149 / pixels_isolés.py:8-81 / recadrages.py:63-82) as
disk-materialized stages.  This transform decodes once, rotates N times
(with ``method="shear"`` one launch of the rotation kernel a batch on a
card), applies every selected dihedral to each slot on the device, pushes
all B × (N+1) × S variants through the stage tail as one batch, and
encodes only the final results.

Byte parity (the rotsym + rotchain arguments composed):

- the rotations half inherits RandomRotations wholesale (same seed tree
  over the same inventory);
- the symmetry selection is the DETERMINISTIC byte-tier set (whole pool,
  ``include_original`` appending 'o'; ``auto_fuse="rng"`` fuses sub-pool
  sampling via ``sym_sample``), and the flips are pure valid-region pixel
  permutations (ops/geometry.py:dihedral) of the exact pixels the
  standalone symmetry step would have re-decoded;
- the tail stages are DETERMINISTIC and consume no draws, so each fused
  (rotation, sym) slot computes exactly what the standalone tail computed
  from the file ``{stem}_{rotkey}_{sym}.png``;
- naming rides through, and the final encoder is the last stage's
  reference anchor (rotchain.tail_encoder).

One status per INPUT item; a (rotation, sym) slot whose tail empties is
skipped with a warning.  Stage i of (slot, sym j) draws from
fold_in(fold_in(fold_in(PRNGKey(seed), _TAIL_SALT + slot), 1000 + j), i),
the JAX tree, though the tail draws nothing.  The JAX class's
``native_fn`` waits for the port's native codec.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from image_processor_pipeline_tpu_torch.transforms.fused import Enhance, Flip
from image_processor_pipeline_tpu_torch.transforms.rotchain import (
    RotationsChain,
    emit_slot,
    tail_encoder,
)
from image_processor_pipeline_tpu_torch.transforms.rotsym import select_syms
from image_processor_pipeline_tpu_torch.transforms.symchain import (
    check_syms,
    sym_fanout_tail,
)


class RotSymChain(RotationsChain):
    """RandomRotations ∘ dihedral fan-out ∘ deterministic FusedChain tail.

    ``syms`` is the STATIC selection the standalone symmetry step would
    save (computed by the fuser; direct users pass it).  Only draw-free
    tails are representable, so Rotate/Flip/Enhance stages raise.
    ``sym_sample=(pool, k, include_original)`` (the ``auto_fuse="rng"``
    tier): the device computes the full ``syms`` superset per slot and
    save_item emits the subset the shared per-(item, rotation) tree draws
    (rotsym.select_syms).
    """

    max_batch = 4  # (N+1) x S output canvases per item

    def __init__(self, stages: Sequence, syms: Sequence[str],
                 sym_sample: Optional[Tuple] = None):
        RotationsChain.__init__(self, stages)
        if any(isinstance(s, (Flip, Enhance)) for s in self.stages):
            raise ValueError(
                "RotSymChain tails must be draw-free (no Flip/Enhance)")
        self.syms = check_syms(syms, sym_sample)
        self.sym_sample = sym_sample
        self._sym_index = {s: j for j, s in enumerate(self.syms)}

    def static_args(self, options: Dict, key: Tuple) -> Tuple:
        return RotationsChain.static_args(self, options, key) + self.syms

    def device_fn(self, batch, static):
        imgs, hs, ws, keys = self.rotated_slots(batch, static)
        B, S, H, W, C = imgs.shape
        images, heights, widths = sym_fanout_tail(
            self.stages, self.syms, imgs.reshape(B * S, H, W, C),
            hs.reshape(-1), ws.reshape(-1), keys.reshape(B * S, 2))
        K = len(self.syms)
        return {"images": images.reshape(B, S, K, H, W, images.shape[-1]),
                "heights": heights.reshape(B, S, K),
                "widths": widths.reshape(B, S, K),
                "pre_heights": hs, "pre_widths": ws}

    def save_item(
        self,
        out: Dict[str, np.ndarray],
        item: Dict,
        output_dirs: Sequence[Path],
        options: Dict,
    ) -> Optional[List[Path]]:
        if not output_dirs:
            print("[rotsymchain] no output dir provided")
            return None
        target = Path(output_dirs[0])
        stem = Path(item["_args"][0]).stem
        bands = options.get("output_bands")
        encoder = tail_encoder(self.stages)

        saved: List[Path] = []
        for slot, rkey in self._slot_keys(out, options):
            for sym in select_syms(self.syms, self.sym_sample,
                                   item["_seed"], slot):
                j = self._sym_index[sym]
                emit_slot(encoder, out["images"][slot][j],
                          int(out["heights"][slot][j]),
                          int(out["widths"][slot][j]), bands,
                          target / f"{stem}_{rkey}_{sym}.png", saved)
        if not saved:
            return None
        return saved

"""Fused rotations → chain tail → symmetries: (N+1)×S fan-out with the
dihedral fan-out at the END, one step (port of
image_processor_pipeline_tpu/transforms/rotchainsym.py).

The reference runs rotations.py:88-119 → {filtres_liste.py:41-149 /
pixels_isolés.py:8-81 / recadrages.py:63-82}+ → symmetry.py:92-134, all
disk-materialized.  The compute here is the port's RotationsChain (with
``method="shear"`` one launch of the rotation kernel a batch on a card);
the save half writes each kept slot's tail result as numpy flip views.

Byte parity (the rotchain + chainsym arguments composed):

- the rotations half and the deterministic tail are RotationsChain
  unchanged (same seed tree over the same inventory, lossless elided
  ``.png`` intermediates);
- the symmetry selection is the DETERMINISTIC byte-tier set (whole pool,
  ``include_original`` appending 'o'), and the flips are views of each
  slot's tail result — exactly the pixels the standalone symmetry step
  would have re-decoded from ``{stem}_{rotkey}.png``;
- the standalone symmetry step writes ``{stem}_{rotkey}_{sym}.png`` with
  ``encode_image`` (symmetry.py:133-134) regardless of the tail's anchor.

One status per INPUT item; a rotation slot whose tail empties is skipped
with a warning.  Under ``auto_fuse="rng"`` the tail may END with an
Enhance stage (``output_bands=3`` strips alpha before the band-agnostic
flips) and ``sym_sample`` draws each slot's subset from the shared
per-(item, rotation) tree (rotsym.select_syms).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple
from warnings import warn

import numpy as np

from image_processor_pipeline_tpu_torch.transforms.rotchain import RotationsChain
from image_processor_pipeline_tpu_torch.transforms.rotsym import (
    emit_views,
    select_syms,
)
from image_processor_pipeline_tpu_torch.transforms.symchain import check_syms


class RotationsChainSymmetries(RotationsChain):
    """RotationsChain ∘ symmetry fan-out save ((N+1)×S files).

    Compute is inherited from RotationsChain unchanged; each surviving
    slot's tail result is written once per selected dihedral, named
    ``{stem}_{rotkey}_{sym}.png``.  ``sym_sample=(pool, k,
    include_original)`` makes the per-slot selection a draw from the
    shared per-(item, rotation) tree; ``syms`` must then be the superset
    the draws can reach.
    """

    max_batch = 8

    def __init__(self, stages: Sequence, syms: Sequence[str],
                 sym_sample: Optional[Tuple] = None):
        RotationsChain.__init__(self, stages)
        self.syms = check_syms(syms, sym_sample)
        self.sym_sample = sym_sample

    def static_args(self, options: Dict, key: Tuple) -> Tuple:
        return RotationsChain.static_args(self, options, key) + self.syms

    def save_item(
        self,
        out: Dict[str, np.ndarray],
        item: Dict,
        output_dirs: Sequence[Path],
        options: Dict,
    ) -> Optional[List[Path]]:
        if not output_dirs:
            print("[rotchainsym] no output dir provided")
            return None
        target = Path(output_dirs[0])
        stem = Path(item["_args"][0]).stem
        bands = options.get("output_bands")

        saved: List[Path] = []
        for slot, rkey in self._slot_keys(out, options):
            bh = int(out["heights"][slot])
            bw = int(out["widths"][slot])
            if bh <= 0 or bw <= 0:
                # the standalone tail error'd this one file and wrote
                # nothing, so the standalone symmetry step never saw it
                warn(f"chain tail produced empty content for "
                     f"{stem}_{rkey}; skipping")
                continue
            img = out["images"][slot][:bh, :bw]
            if bands:
                img = img[..., :int(bands)]
            emit_views(img, select_syms(self.syms, self.sym_sample,
                                        item["_seed"], slot),
                       lambda sym: target / f"{stem}_{rkey}_{sym}.png", saved)
        if not saved:
            return None
        return saved

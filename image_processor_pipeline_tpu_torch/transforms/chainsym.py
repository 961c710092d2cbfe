"""Fused chain → symmetries: deterministic stages with a dihedral fan-out
at the END, one step (fan-out 1→S; port of
image_processor_pipeline_tpu/transforms/chainsym.py).

The reference runs the tail pair as separate disk-materialized stages
(e.g. filtres_liste.py:41-149 / pixels_isolés.py:8-81 write every
intermediate; symmetry.py:92-134 then re-decodes each final file and
writes its flips).  This transform runs the chain ONCE per item and
encodes the selected dihedrals directly as numpy flip views of the chain
result.

Byte parity with chain → symmetries:

- the chain half is ``FusedChain`` unchanged: the fuser only emits
  DETERMINISTIC translated stages (ColorMask with
  ``input_alpha='replace'``, Cleanup, FitCrop), and the head rules
  guarantee lossless ``.png`` elided intermediates — so the chain result
  holds exactly the pixels the standalone symmetry step would have
  re-decoded from the chain's final ``.png``;
- the symmetry selection is DEGENERATE when ``choose_random`` is None or
  >= len(pool) (reference symmetry.py:122-126 then selects the whole pool;
  ``include_original`` appends 'o'): the saved SET is deterministic;
- naming rides through: the fused outputs are ``{stem}_{sym}.png``,
  encoded with ``encode_image``, GenerateSymmetries' own encoder (even the
  'o' copy is a re-encode in the reference, symmetry.py:133).

An empty chain result raises (the standalone chain step would have error'd
that item); a single failed symmetry encode is tolerated per-sym with a
warning, like GenerateSymmetries.  ``choose_random < len(pool)`` (direct
use or ``auto_fuse="rng"``) samples each item's subset from the shared
``select_syms`` tree at slot 0 — equally distributed, not byte-comparable
to a standalone run.  With a final Enhance the fuser sets
``output_bands=3``: flips are band-agnostic, so the banding commutes with
the fan-out.  The JAX class's ``shrink_output`` waits for the port's
native codec.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from image_processor_pipeline_tpu_torch.transforms.fused import FusedChain
from image_processor_pipeline_tpu_torch.transforms.rotsym import (
    emit_views,
    pool_selection,
)
from image_processor_pipeline_tpu_torch.utils.utils import validate_dirs


class ChainSymmetries(FusedChain):
    """FusedChain ∘ GenerateSymmetries in one step.

    Compute is inherited from FusedChain unchanged; only the save half
    changes: it writes each selected symmetry of the chain result as a
    flip view, named ``{stem}_{sym}.png``.

    options (on top of FusedChain's): ``pool`` / ``choose_random`` /
    ``include_original`` with GenerateSymmetries semantics;
    ``output_bands=3`` strips alpha before the flips.  ``output_suffix``
    is fixed at ``.png`` by the fused semantics and ignored here.
    """

    def shrink_output(self, out_dev, chunk, options):
        """Outputs are always ``.png`` (the symmetry half keeps the
        lossless intermediate suffix) — run the inherited valid-region
        shrink but never the ``.jpg`` coefficient transport, whose output
        protocol this save_item doesn't speak, even if a direct user
        passes ``output_suffix='.jpg'`` + ``device_encode``."""
        opts = dict(options)
        opts["output_suffix"] = ".png"
        return FusedChain.shrink_output(self, out_dev, chunk, opts)

    def save_item(
        self,
        out: Dict[str, np.ndarray],
        item: Dict,
        output_dirs: Sequence[Path],
        options: Dict,
    ) -> Optional[List[Path]]:
        target = validate_dirs(output_dirs, 1)
        path = Path(item["_args"][0])
        h, w = int(out["h"]), int(out["w"])
        if h <= 0 or w <= 0:
            raise RuntimeError(
                f"chain produced empty content for {path.name}")
        img = out["image"][:h, :w]
        bands = options.get("output_bands")
        if bands:
            img = img[..., :int(bands)]

        # sub-pool sampling draws at slot 0 (the item's only fan-out)
        selected = pool_selection(
            options, bool(options.get("include_original", True)),
            item["_seed"])(0)

        saved: List[Path] = []
        emit_views(img, selected,
                   lambda sym: Path(target) / f"{path.stem}_{sym}.png", saved)
        if not saved:
            return None
        return saved

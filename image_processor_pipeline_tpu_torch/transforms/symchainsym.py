"""Fused symmetries → chain tail → symmetries: the dihedral fan-out at
BOTH ends of one deterministic run, one step (fan-out 1→S1×S2; port of
image_processor_pipeline_tpu/transforms/symchainsym.py).

The reference shape is a symmetry stage (symmetry.py:92-134), a
deterministic suffix (filtres_liste.py:41-149 / pixels_isolés.py:8-81 /
recadrages.py:63-82), then ANOTHER symmetry stage over the results —
every stage disk-materialized.  This transform decodes once, fans out the
head dihedrals on the device, pushes each through the tail, and encodes
each surviving slot once per TAIL dihedral as a numpy flip view.

Byte parity (the symchain + chainsym arguments composed):

- the head half is SymmetriesChain unchanged;
- the tail selection is the DETERMINISTIC byte-tier set (whole pool,
  ``include_original`` appending 'o'), and the flips are pure pixel
  permutations of exactly the pixels the standalone trailing step would
  have re-decoded from the chain's ``{stem}_{s1}.png``;
- the trailing step writes ``{stem}_{s1}_{s2}.png`` with ``encode_image``
  (symmetry.py:133 — even the 'o' copy is a re-encode) regardless of the
  chain's own encoder anchor (that encode was on the ELIDED intermediate).

One status per INPUT item; a head slot whose tail empties is skipped with
a warning.  Sub-pool sampling (``auto_fuse="rng"``) composes at either
end: ``sym_sample`` draws the HEAD subset at slot 0 and ``tail_sample``
draws each head slot's TAIL subset at slot ``_TAIL_SYM_SALT | j`` (j =
the head sym's superset index).  Distribution-equal, never byte-equal.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple
from warnings import warn

import numpy as np

from image_processor_pipeline_tpu_torch.transforms.symchain import (
    SymmetriesChain,
    check_syms,
)
from image_processor_pipeline_tpu_torch.transforms.rotsym import (
    emit_views,
    select_syms,
)

#: disambiguates tail-selection tree slots from head/rotation slots (head
#: draws at slot 0; rotation fan-outs draw at slot 0..N).  Part of the
#: rng-tier convention: changing it changes rng-tier fused outputs.
_TAIL_SYM_SALT = 0x8000


class SymmetriesChainSymmetries(SymmetriesChain):
    """SymmetriesChain ∘ trailing symmetry fan-out save (S1×S2 files).

    Compute is inherited from SymmetriesChain unchanged; each surviving
    head slot's tail result is written once per selected TAIL dihedral,
    named ``{stem}_{head_sym}_{tail_sym}.png``.
    """

    max_batch = 4  # S1 canvases per item, S1 x S2 encodes

    def __init__(self, stages: Sequence, syms: Sequence[str],
                 tail_syms: Sequence[str],
                 sym_sample: Optional[Tuple] = None,
                 tail_sample: Optional[Tuple] = None):
        SymmetriesChain.__init__(self, stages, syms, sym_sample)
        self.tail_syms = check_syms(tail_syms, tail_sample, tail=True)
        self.tail_sample = tail_sample

    def static_args(self, options: Dict, key: Tuple) -> Tuple:
        return (SymmetriesChain.static_args(self, options, key)
                + self.tail_syms)

    def save_item(
        self,
        out: Dict[str, np.ndarray],
        item: Dict,
        output_dirs: Sequence[Path],
        options: Dict,
    ) -> Optional[List[Path]]:
        if not output_dirs:
            print("[symchainsym] no output dir provided")
            return None
        target = Path(output_dirs[0])
        stem = Path(item["_args"][0]).stem
        bands = options.get("output_bands")
        seed = item["_seed"]

        saved: List[Path] = []
        for s1 in select_syms(self.syms, self.sym_sample, seed, 0):
            j = self._sym_index[s1]
            bh = int(out["heights"][j])
            bw = int(out["widths"][j])
            if bh <= 0 or bw <= 0:
                # the standalone tail error'd this one file and wrote
                # nothing, so the trailing symmetry step never saw it
                warn(f"chain tail produced empty content for "
                     f"{stem}_{s1}; skipping")
                continue
            img = out["images"][j][:bh, :bw]
            if bands:
                img = img[..., :int(bands)]
            emit_views(img, select_syms(self.tail_syms, self.tail_sample,
                                        seed, _TAIL_SYM_SALT | j),
                       lambda s2: target / f"{stem}_{s1}_{s2}.png", saved)
        if not saved:
            return None
        return saved

"""Fused rotations → chain tail: N+1 fan-out through FusedChain stages
(port of image_processor_pipeline_tpu/transforms/rotchain.py).

The reference runs rotations and every downstream transform as separate
disk-materialized stages (rotations.py:88-119 writes each rotation;
filtres_liste.py:41-149 / pixels_isolés.py:8-81 / recadrages.py:63-82
then re-decode every file).  This transform composes them: decode the
input once, rotate N times in one batched call (with ``method="shear"``
one launch of the rotation kernel a batch on a card), push the original
and every rotation through the stage tail on the device, and encode only
the final results.

Byte parity with rotations → a run of DETERMINISTIC steps:

- the rotations half inherits RandomRotations wholesale — same per-item
  seed tree, same device function — so the rotated pixels are the ones
  the standalone step would have encoded;
- the elided intermediates are PNG: lossless, so each standalone
  downstream step would have decoded exactly those pixels back;
- the tail stages ColorMask with ``input_alpha='replace'``, Cleanup and
  FitCrop are DETERMINISTIC given their input pixels;
- naming rides through: every standalone tail step keeps its input's
  name, so the final files are ``{stem}_{rotation_key}.png`` exactly as
  the unfused run produces.

Per-slot statuses coarsen (the chain-fusion contract): a slot whose tail
empties is skipped with a warning and the item still counts Success if any
slot saved.

RNG tail stages (Enhance, Flip) draw from a per-(item, slot, stage) tree —
fold_in(fold_in(PRNGKey(item seed), _TAIL_SALT + slot), stage index) — on
the host, as every draw of the port; equally distributed but not
byte-comparable to a standalone run, which seeds per intermediate-file
index.  The JAX class's native twin (``native_fn``) and its
``shrink_output`` wait for the port's native codec.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple
from warnings import warn

import numpy as np
import torch

from image_processor_pipeline_tpu_torch import random as jrandom
from image_processor_pipeline_tpu_torch.transforms.rotations import (
    RandomRotations,
)
from image_processor_pipeline_tpu_torch.transforms.fused import Rotate
from image_processor_pipeline_tpu_torch.io.images import (
    encode_image,
    encode_image_pil,
)

#: disambiguates the per-slot tail keys from the direct uses of the item
#: key (the rotation half draws its angles from PRNGKey(seed) itself)
_TAIL_SALT = 101


def tail_encoder(stages):
    """The final file follows the LAST stage's reference encoder anchor
    (FusedChain.save_item's rule): PIL Image.save for enhance/fit-crop
    tails, cv2.imwrite (q95) for mask/cleanup/border."""
    return (encode_image
            if stages and not stages[-1].pil_anchored
            else encode_image_pil)


def emit_slot(encoder, img, bh: int, bw: int, bands, p: Path,
              saved: List[Path]) -> None:
    """Write one tail output with the shared per-slot tolerance: an
    empty tail result means the standalone step error'd that ONE file
    (e.g. cleanup's 'no opaque pixels') and wrote nothing."""
    if bh <= 0 or bw <= 0:
        warn(f"chain tail produced empty content for {p.name}; "
             f"skipping")
        return
    img = img[:bh, :bw]
    if bands:
        img = img[..., :int(bands)]
    try:
        encoder(img, p)
        saved.append(p)
    except Exception as e:  # noqa: BLE001 — per-slot tolerance
        warn(f"failed to save {p.name}: {e}")


def tail_keys(seeds, n_slots: int):
    """Each (item, slot)'s tail key, fold_in(PRNGKey(seed), _TAIL_SALT +
    slot): [B, n_slots, 2] uint32 for uint32 ``seeds`` [B]."""
    keys = jrandom.PRNGKey(np.asarray(seeds, np.uint32))[:, None]
    return jrandom.fold_in(keys, _TAIL_SALT + np.arange(n_slots))


class RotationsChain(RandomRotations):
    """RandomRotations ∘ FusedChain-stage tail in one step (fan-out N+1).

    Compute: the inherited rotations produce the N rotations; the original
    and every rotation then run the ``stages`` tail on the device as one
    batch of B × (N+1) slots (slot 0 = original, slots 1..N = rotations).

    Options are RandomRotations' names (``include_original`` saves the
    tail-processed ORIGINAL as ``{stem}_{original_key}.png`` — exactly
    the file the standalone tail produces from the rotations step's
    original copy).  Outputs are always ``.png``; ``output_bands=3``
    strips alpha at encode (the EnhanceImage standalone step writes
    3-channel files — reference tranfo.py:9-55).
    """

    max_batch = 8
    # the original slot is tail-processed on the device; save never
    # touches item["image"], so the hybrid device decode stays available
    save_needs_image = False

    def __init__(self, stages: Sequence):
        self.stages = list(stages)
        if any(isinstance(s, Rotate) for s in self.stages):
            # the rotation half IS this transform; a tail Rotate would
            # need its own diag re-expansion mid-chain
            raise ValueError("RotationsChain tails may not contain Rotate")

    def static_args(self, options: Dict, key: Tuple) -> Tuple:
        return RandomRotations.static_args(self, options, key) + tuple(
            (type(s).__name__, s.config()) for s in self.stages
        )

    def rotated_slots(self, batch, static):
        """The inherited rotations with the original in front: images
        [B, N+1, H, W, C] and extents hs, ws [B, N+1] (slot 0 = original),
        and each (item, slot)'s tail key [B, N+1, 2]."""
        rot = RandomRotations.device_fn(self, batch, static[:5])
        img, size = batch["image"], batch["size"]
        imgs = torch.cat([img[:, None], rot["images"]], dim=1)
        hs = torch.cat([size[:, :1], rot["heights"].to(size.dtype)], dim=1)
        ws = torch.cat([size[:, 1:], rot["widths"].to(size.dtype)], dim=1)
        return imgs, hs, ws, tail_keys(batch["seed"], imgs.shape[1])

    def device_fn(self, batch, static):
        imgs, hs, ws, keys = self.rotated_slots(batch, static)
        B, S, H, W, C = imgs.shape
        keys = keys.reshape(B * S, 2)
        im, h, w = imgs.reshape(B * S, H, W, C), hs.reshape(-1), \
            ws.reshape(-1)
        for i, stage in enumerate(self.stages):
            draws = stage.draw(jrandom.fold_in(keys, i))
            im, h, w = stage.apply(im, h, w, draws)
        return {"images": im.reshape(B, S, H, W, C),
                "heights": h.reshape(B, S), "widths": w.reshape(B, S),
                "pre_heights": hs, "pre_widths": ws}

    # -- save ---------------------------------------------------------------

    def _slot_keys(self, out: Dict, options: Dict):
        """Yield (slot, rotation_key) for every slot the standalone
        rotations step would have saved (a rotation whose pre-tail bbox
        was empty was never written, so no downstream step saw it;
        ``include_original`` gates slot 0)."""
        include_original = options.get("include_original", True)
        output_prefix = options.get("output_prefix", "r")
        original_key = options.get("original_key", "r000")
        key_format = options.get("rotation_key_format",
                                 "{prefix}{index:03d}")
        for slot in range(out["heights"].shape[0]):
            if slot == 0 and not include_original:
                continue
            if (int(out["pre_heights"][slot]) <= 0
                    or int(out["pre_widths"][slot]) <= 0):
                continue
            yield slot, (original_key if slot == 0
                         else key_format.format(prefix=output_prefix,
                                                index=slot))

    def shrink_output(self, out_dev, chunk, options):
        """Outputs are always ``.png``, so the inherited ``.jpg``
        coefficient-transport shrink (whose output protocol this
        save_item doesn't speak) must never run."""
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
            print("[rotchain] no output dir provided")
            return None
        target = Path(output_dirs[0])
        stem = Path(item["_args"][0]).stem
        bands = options.get("output_bands")
        encoder = tail_encoder(self.stages)

        saved: List[Path] = []
        for slot, key in self._slot_keys(out, options):
            emit_slot(encoder, out["images"][slot],
                      int(out["heights"][slot]), int(out["widths"][slot]),
                      bands, target / f"{stem}_{key}.png", saved)
        if not saved:
            return None
        return saved

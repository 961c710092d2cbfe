"""Dihedral symmetries — batched device transform (port of the pixel path
of image_processor_pipeline_tpu/transforms/symmetry.py).

Behavior parity with reference symmetry.py:11-149 (generate_symmetries):
  - generators o/h/v/hv = identity / cv2.flip(1) / flip(0) / flip(-1)
    (symmetry.py:114-119)
  - extension validated against YOLO IMG_FORMATS (symmetry.py:92-94)
  - ``choose_random`` unique symmetries sampled from ``pool`` (default all
    four); ``include_original`` force-appends 'o' (symmetry.py:122-126)
  - naming ``{stem}_{sym}{input suffix}`` into output_dirs[0]
    (symmetry.py:133-134)
  - the reference's choose_random > len(pool) crash is fixed: warn and
    clamp.

The flips present in the step's pool are computed in one batched device
call (a flip is bandwidth-trivial); the host saves only the per-item
sampled subset, keeping per-item randomness independent of batch
composition.  Flips outside the pool are never computed.  The JAX class's
coefficient transport (device JPEG decode and encode) and its native flip
views are not ported yet.
"""

from __future__ import annotations

import random
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple
from warnings import warn

import numpy as np

from image_processor_pipeline_tpu_torch.transforms.base import BatchTransform
from image_processor_pipeline_tpu_torch.ops import geometry
from image_processor_pipeline_tpu_torch.io.images import (
    decode_image,
    encode_image,
    probe_bands,
)
from image_processor_pipeline_tpu_torch.io.batching import canvas_for, pad_to_canvas
from image_processor_pipeline_tpu_torch.utils.utils import IMG_FORMATS

ALL_SYMS = ("o", "h", "v", "hv")


_FLIP_FNS = {
    "h": geometry.flip_h,
    "v": geometry.flip_v,
    "hv": geometry.flip_hv,
}


def _syms(img, h, w, which=("h", "v", "hv")):
    """The flips ``which`` of a batch: img [B, H, W, C], h, w [B]."""
    return {s: _FLIP_FNS[s](img, h, w) for s in which}


class GenerateSymmetries(BatchTransform):
    max_batch = 32

    def static_args(self, options: Dict, key: Tuple) -> Tuple:
        # only the flips the step's pool can ever select are computed
        pool = options.get("pool") or ALL_SYMS
        return tuple(s for s in ("h", "v", "hv") if s in set(pool))

    @staticmethod
    def _check_format(path: Path) -> None:
        if path.suffix.lower()[1:] not in IMG_FORMATS:
            raise ValueError(
                f"{path.name} is not an accepted YOLO image format"
            )

    def load_item(self, inputs: Tuple, options: Dict) -> Dict[str, Any]:
        path = Path(inputs[0])
        self._check_format(path)
        arr = decode_image(path)  # native bands (IMREAD_UNCHANGED parity)
        h, w = arr.shape[:2]
        canvas = canvas_for(h, w)
        return {
            "canvas": canvas,
            "image": pad_to_canvas(arr, canvas),
            "size": np.asarray([h, w], np.int32),
            "_orig": arr,
        }

    def probe_item(self, inputs: Tuple, options: Dict):
        """Metadata-only load so whole buckets decode into one stacked
        array.  Only band-safe files take this path (3-component JPEG,
        8-bit RGB/RGBA PNG); gray, palette, 16-bit and tRNS inputs return
        None and keep the exact per-item path."""
        path = Path(inputs[0])
        self._check_format(path)
        meta = probe_bands(path)
        if meta is None or meta[2] not in (3, 4):
            return None
        h, w, kind = meta
        canvas = canvas_for(h, w)
        return {
            "canvas": canvas,
            "size": np.asarray([h, w], np.int32),
            "_nch": kind,
            "_decode": (str(path), "RGB" if kind == 3 else "RGBA", False),
        }

    def bucket_key(self, item: Dict, options: Dict) -> Tuple:
        nch = item["image"].shape[-1] if "image" in item else item["_nch"]
        return (*item["canvas"], nch)

    def device_fn(self, batch, static):
        return _syms(batch["image"], batch["size"][:, 0],
                     batch["size"][:, 1], static)

    def save_item(
        self,
        out: Dict[str, np.ndarray],
        item: Dict,
        output_dirs: Sequence[Path],
        options: Dict,
    ) -> Optional[List[Path]]:
        if not output_dirs:
            raise ValueError("no output dir provided")
        target = Path(output_dirs[0])
        path = Path(item["_args"][0])
        h, w = (int(x) for x in item["size"])

        pool = list(options.get("pool") or ALL_SYMS)
        invalid = [s for s in pool if s not in ALL_SYMS]
        if invalid:
            raise ValueError(f"pool contains invalid symmetries: {invalid}")
        choose_random = options.get("choose_random")
        choose_random = len(pool) if choose_random is None else choose_random
        if choose_random > len(pool):
            warn(
                f"choose_random={choose_random} exceeds pool size "
                f"{len(pool)}; clamping"
            )
            choose_random = len(pool)
        elif choose_random < 0:
            raise ValueError(f"choose_random ({choose_random}) must be >= 0")

        rng = random.Random(item["_seed"])
        selected = rng.sample(pool, choose_random)
        if options.get("include_original", True) and "o" not in set(selected):
            selected.append("o")

        saved: List[Path] = []
        for sym in selected:
            p = target / path.with_stem(f"{path.stem}_{sym}").name
            try:
                if sym == "o":
                    arr = item["_orig"] if "_orig" in item \
                        else item["image"][:h, :w]
                else:
                    arr = out[sym][:h, :w]
                encode_image(arr, p)
                saved.append(p)
            except Exception as e:  # noqa: BLE001 — per-sym tolerance
                warn(f"failed to save symmetry {sym!r} for {path.name}: {e}")
        return saved

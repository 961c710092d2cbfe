"""Border crop and fit-crop — batched device transforms (port of
image_processor_pipeline_tpu/transforms/recadrages.py).

Behavior parity:
  - crop_from_border (reference recadrages.py:13-61): margins given as
    fractions (< 1) of the side or absolute pixels (>= 1), computed per side
    (recadrages.py:7-10); JPG-only gate; errors on over-large margins;
    output keeps the input name in output_dirs[0].
  - fit_crop (reference recadrages.py:63-82): PIL getbbox tight crop
    (whole image when empty); same-name output.

The JAX classes' host fast paths (``native_fn``) are not ported yet.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np

from image_processor_pipeline_tpu_torch.transforms.base import BatchTransform
from image_processor_pipeline_tpu_torch.ops import geometry
from image_processor_pipeline_tpu_torch.io.images import (
    decode_image,
    encode_image,
    encode_image_pil,
    probe_bands,
)
from image_processor_pipeline_tpu_torch.io.batching import canvas_for, pad_to_canvas


def compute_crop_px(value, total_length: int) -> int:
    """Fraction (< 1) of the side, or absolute pixels (>= 1).

    Parity: reference recadrages.py:7-10 (_compute_crop).
    """
    if value < 0:
        raise ValueError("crop margins cannot be negative")
    return int(total_length * value) if 0 <= value < 1 else int(value)


def _band_bucket_key(item: Dict) -> Tuple:
    """Canvas and band count: items of one batch share both."""
    nch = item["image"].shape[-1] if "image" in item else item["_nch"]
    return (*item["canvas"], nch)


class BorderCrop(BatchTransform):
    max_batch = 32

    @staticmethod
    def _margins(options: Dict, h: int, w: int, name: str) -> np.ndarray:
        """Per-side margin pixels + validity checks — the ONE place the
        fraction-vs-pixels semantics live, shared by load_item and
        probe_item so probed and fallback items can never diverge."""
        top, bottom, left, right = options.get("crop_margins", (0, 0, 0, 0))
        tp = compute_crop_px(top, h)
        bp = compute_crop_px(bottom, h)
        lp = compute_crop_px(left, w)
        rp = compute_crop_px(right, w)
        if tp + bp >= h or lp + rp >= w:
            raise ValueError(f"crop margins too large for image {name}")
        return np.asarray([tp, bp, lp, rp], np.int32)

    @staticmethod
    def _check_format(path: Path) -> None:
        if path.suffix.lower() not in (".jpg", ".jpeg"):
            raise ValueError(f"file {path.name} is not a JPG")

    def load_item(self, inputs: Tuple, options: Dict) -> Dict[str, Any]:
        path = Path(inputs[0])
        self._check_format(path)
        arr = decode_image(path)
        h, w = arr.shape[:2]
        margins = self._margins(options, h, w, path.name)
        canvas = canvas_for(h, w)
        return {
            "canvas": canvas,
            "image": pad_to_canvas(arr, canvas),
            "size": np.asarray([h, w], np.int32),
            "margins": margins,
        }

    def probe_item(self, inputs: Tuple, options: Dict):
        """Metadata-only load: whole buckets decode into one stacked array.
        Only band-safe 3-component JPEGs take this path (pixel-identical
        to load_item's decode); others fall back per-item."""
        path = Path(inputs[0])
        self._check_format(path)
        meta = probe_bands(path)
        if meta is None or meta[2] != 3:
            return None
        h, w, _ = meta
        margins = self._margins(options, h, w, path.name)
        canvas = canvas_for(h, w)
        return {
            "canvas": canvas,
            "size": np.asarray([h, w], np.int32),
            "margins": margins,
            "_nch": 3,
            "_decode": (str(path), "RGB", False),
        }

    def bucket_key(self, item: Dict, options: Dict) -> Tuple:
        return _band_bucket_key(item)

    def device_fn(self, batch, static):
        size, m = batch["size"], batch["margins"]
        out, ch, cw = geometry.border_crop(
            batch["image"], size[:, 0], size[:, 1],
            m[:, 0], m[:, 1], m[:, 2], m[:, 3])
        return {"image": out, "ch": ch, "cw": cw}

    def save_item(self, out, item, output_dirs, options) -> Optional[Path]:
        path = Path(item["_args"][0])
        ch, cw = int(out["ch"]), int(out["cw"])
        p = Path(output_dirs[0]) / path.name
        encode_image(out["image"][:ch, :cw], p)
        return p


def crop_to_alpha_bounding_box(image_path: Path, **options) -> np.ndarray:
    """Compute-only alpha-bbox crop (staging parity:
    reference add_saving/recadrage_transparent.py:5-58).

    Errors on non-PNG, missing alpha, or fully transparent images; returns
    the cropped ndarray without saving (the missing save step is what kept
    it in the reference's staging area).
    """
    path = Path(image_path)
    if path.suffix.lower() != ".png":
        raise ValueError(f"file {path.name} is not a PNG")
    arr = decode_image(path)
    if arr.shape[2] != 4:
        raise AttributeError(f"image {path.name} has no alpha channel")
    if not (arr[..., 3] > 0).any():
        raise ValueError(f"image {path.name} is fully transparent")
    ys, xs = np.nonzero(arr[..., 3] > 0)
    return arr[ys.min():ys.max() + 1, xs.min():xs.max() + 1]


class FitCrop(BatchTransform):
    max_batch = 32

    def load_item(self, inputs: Tuple, options: Dict) -> Dict[str, Any]:
        path = Path(inputs[0])
        arr = decode_image(path)
        h, w = arr.shape[:2]
        canvas = canvas_for(h, w)
        return {
            "canvas": canvas,
            "image": pad_to_canvas(arr, canvas),
            "size": np.asarray([h, w], np.int32),
            "_orig": arr,
        }

    def probe_item(self, inputs: Tuple, options: Dict):
        """Metadata-only load: whole buckets decode into one stacked array.
        Band-safe 3/4-component files only (pixel-identical to load_item's
        native-bands decode); others fall back per-item."""
        path = Path(inputs[0])
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
        return _band_bucket_key(item)

    def device_fn(self, batch, static):
        size = batch["size"]
        out, bh, bw = geometry.fit_crop(batch["image"], size[:, 0],
                                        size[:, 1])
        return {"image": out, "bh": bh, "bw": bw}

    def save_item(self, out, item, output_dirs, options) -> Optional[Path]:
        path = Path(item["_args"][0])
        bh, bw = int(out["bh"]), int(out["bw"])
        p = Path(output_dirs[0]) / path.name
        if bh <= 0 or bw <= 0:
            # degenerate 0-extent input: save the original decoded pixels
            # (reference recadrages.py:74-76 copies the un-recadrée image)
            h, w = (int(x) for x in item["size"])
            arr = item["_orig"] if "_orig" in item else out["image"][:h, :w]
            encode_image_pil(arr, p)
        else:
            # reference recadrages.py:80 (fit crop) saves via PIL -> q75
            encode_image_pil(out["image"][:bh, :bw], p)
        return p

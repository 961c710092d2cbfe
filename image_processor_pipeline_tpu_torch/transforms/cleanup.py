"""Isolated-pixel cleanup — batched device transform (connected components;
port of image_processor_pipeline_tpu/transforms/cleanup.py).

Behavior parity with reference pixels_isolés.py:8-81 (keep_largest_component):
  - PNG-only gate; requires an alpha channel (AttributeError otherwise)
  - binarize alpha > 1; 8-connected components; the observable reference
    behavior keeps ONLY the largest component (its small-parasite loop is
    dead code — see ops/ccl.py docstring); ``keep_large_components=True``
    opts into the documented intent instead
  - alpha-bbox tight crop (_crop_fit, pixels_isolés.py:74-81)
  - same-name output into output_dirs[0]

The JAX class's native C++ twin (``native_fn``) is not ported yet.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np

from image_processor_pipeline_tpu_torch.transforms.base import BatchTransform
from image_processor_pipeline_tpu_torch.ops import ccl
from image_processor_pipeline_tpu_torch.io.images import (
    decode_image,
    encode_image,
    probe_bands,
)
from image_processor_pipeline_tpu_torch.io.batching import canvas_for, pad_to_canvas
from image_processor_pipeline_tpu_torch.utils.utils import validate_dirs


class KeepLargestComponent(BatchTransform):
    max_batch = 8  # CCL iterates to fixpoint; keep batches small

    def load_item(self, inputs: Tuple, options: Dict) -> Dict[str, Any]:
        path = Path(inputs[0])
        if path.suffix.lower() != ".png":
            raise ValueError(f"file {path.name} is not a PNG")
        arr = decode_image(path)
        if arr.shape[2] != 4:
            raise AttributeError(
                f"image {path.name} has no alpha channel; skipping"
            )
        h, w = arr.shape[:2]
        canvas = canvas_for(h, w)
        return {
            "canvas": canvas,
            "image": pad_to_canvas(arr, canvas, channels=4),
            "size": np.asarray([h, w], np.int32),
        }

    def probe_item(self, inputs: Tuple, options: Dict):
        """Metadata-only load so whole buckets decode into one stacked
        array.  Only band-safe RGBA PNGs take this path; RGB inputs raise
        the same no-alpha error load_item would; anything else (gray,
        palette, 16-bit, tRNS) returns None and keeps the exact per-item
        path."""
        path = Path(inputs[0])
        if path.suffix.lower() != ".png":
            raise ValueError(f"file {path.name} is not a PNG")
        meta = probe_bands(path)
        if meta is None:
            return None
        h, w, kind = meta
        if kind == 3:
            raise AttributeError(
                f"image {path.name} has no alpha channel; skipping"
            )
        if kind != 4:
            return None
        canvas = canvas_for(h, w)
        return {
            "canvas": canvas,
            "size": np.asarray([h, w], np.int32),
            "_decode": (str(path), "RGBA", False),
        }

    def static_args(self, options: Dict, key: Tuple) -> Tuple:
        return (
            int(options.get("min_component_size", 500)),
            bool(options.get("keep_large_components", False)),
        )

    def device_fn(self, batch, static):
        min_size, keep_large = static
        size = batch["size"]
        out, bh, bw = ccl.cleanup_and_fit(
            batch["image"], size[:, 0], size[:, 1], min_size,
            keep_large_components=keep_large)
        return {"image": out, "bh": bh, "bw": bw}

    def save_item(self, out, item, output_dirs, options) -> Optional[Path]:
        target = validate_dirs(output_dirs, 1)
        path = Path(item["_args"][0])
        bh, bw = int(out["bh"]), int(out["bw"])
        if bh <= 0 or bw <= 0:
            raise RuntimeError(
                f"no opaque pixels remain in {path.name} after cleanup"
            )
        p = Path(target) / path.name
        encode_image(out["image"][:bh, :bw], p)
        return p

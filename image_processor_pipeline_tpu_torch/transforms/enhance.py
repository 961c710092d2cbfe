"""Photometric enhancement — batched device transform ('sample' pairing
consumer; port of image_processor_pipeline_tpu/transforms/enhance.py).

Behavior parity with reference tranfo.py:9-55 (enhance_image):
  - Brightness, Contrast, Color each scaled by uniform(0.7, 1.3)
  - GaussianBlur(radius=uniform(0.5, 3)) when the 30% 'apply_blur' flag is set
  - per-channel RGB gain uniform(0.75, 1.25) when 'apply_rgb' is set —
    implemented as the intended one-gain-per-channel (the reference's
    per-LUT-entry redraw at tranfo.py:48-50 is a defect, SURVEY.md §2.7 #12)
  - output: same file name into output_dirs[0]

The factors are drawn on the host in numpy (``draw_factors``).  On
all-.jpg buckets with ``device_encode`` on, the JPEG front half runs on the
device and only sparse coefficients come back (``shrink_output``).  The JAX
class's native C++ twin is not ported yet.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from image_processor_pipeline_tpu_torch import random as jrandom
from image_processor_pipeline_tpu_torch.transforms.base import (
    BatchTransform,
    to_device,
)
from image_processor_pipeline_tpu_torch.ops import jpeg as djpeg
from image_processor_pipeline_tpu_torch.ops import photometric
from image_processor_pipeline_tpu_torch.io.images import (
    decode_padded,
    encode_image_pil,
    probe_padded,
)
from image_processor_pipeline_tpu_torch.utils.utils import validate_dirs


def draw_factors(seeds):
    """Per-item factor draws (reference tranfo.py:20-27 ranges) for uint32
    seeds [B]: (b, c, col, sigma [B], gains [B, 3]) float32, the JAX
    package's ``_draw_factors`` tree (split(PRNGKey(seed), 5))."""
    k = jrandom.split(BatchTransform.keys_from_seeds(seeds), 5)
    b = jrandom.uniform(k[:, 0], (), 0.7, 1.3)
    c = jrandom.uniform(k[:, 1], (), 0.7, 1.3)
    col = jrandom.uniform(k[:, 2], (), 0.7, 1.3)
    sigma = jrandom.uniform(k[:, 3], (), 0.5, 3.0)
    gains = jrandom.uniform(k[:, 4], (3,), 0.75, 1.25)
    return b, c, col, sigma, gains


def _flags(inputs: Tuple) -> Dict[str, np.bool_]:
    """The 'sample' pairing's (path, apply_blur, apply_rgb) flags."""
    return {
        "apply_blur": np.bool_(bool(inputs[1]) if len(inputs) > 1 else False),
        "apply_rgb": np.bool_(bool(inputs[2]) if len(inputs) > 2 else False),
    }


class EnhanceImage(BatchTransform):
    max_batch = 16

    def load_item(self, inputs: Tuple, options: Dict) -> Dict[str, Any]:
        path = Path(inputs[0])
        buf, h, w, canvas = decode_padded(path, mode="RGB")
        return {
            "canvas": canvas,
            "image": buf,
            "size": np.asarray([h, w], np.int32),
            **_flags(inputs),
        }

    def probe_item(self, inputs: Tuple, options: Dict):
        path = Path(inputs[0])
        meta = probe_padded(path, mode="RGB")
        if meta is None:
            return None
        h, w, canvas = meta
        return {
            "canvas": canvas,
            "size": np.asarray([h, w], np.int32),
            **_flags(inputs),
            "_decode": (str(path), "RGB", False),
        }

    def device_fn(self, batch, static):
        img = batch["image"]
        b, c, col, sigma, gains = draw_factors(batch["seed"])
        b, c, col, gains = (to_device(v, img.device)
                            for v in (b, c, col, gains))
        size = batch["size"]
        return {"image": photometric.enhance(
            img, size[:, 0], size[:, 1], b, c, col, sigma,
            batch["apply_blur"], gains, batch["apply_rgb"],
            blur_max_radius=photometric.box_radius_bound(3.0),
            blur_sigma_max=3.0)}  # sigma is drawn in [0.5, 3.0]

    # -- hybrid device JPEG encode (D2H ships coefficients, not pixels) ----
    # Enhance writes <input name> at the PIL-anchored q75; with
    # device_encode on and an all-.jpg bucket the JPEG front half runs on
    # the device (ops/jpeg.py:encode_shrink) and only sparse quantized
    # coefficients come back.  Byte-identical to the pixel path.
    shrinks_output = True

    def shrink_output(self, out_dev, chunk, options):
        if djpeg.device_encode_enabled(
                options, self, out_dev["image"].device) and chunk and all(
                Path(it["_args"][0]).suffix.lower() in (".jpg", ".jpeg")
                for it in chunk):
            out = self._shrink_encode(out_dev, chunk, options)
            if out is not None:
                return out
        self.start_host_copy(out_dev)
        return out_dev

    def _shrink_encode(self, out_dev, chunk, options):
        img = out_dev["image"]
        sizes = np.stack([np.asarray(it["size"]) for it in chunk])
        h_np = sizes[:, 0].astype(np.int32)
        w_np = sizes[:, 1].astype(np.int32)
        # hysteresis counts only the chunk's real items (pad rows are
        # duplicates and would skew the dense ratio)
        out = djpeg.shrink_transport(
            self, img, to_device(h_np, img.device),
            to_device(w_np, img.device), h_np, w_np,
            75,  # PIL q75 (tranfo.py:53)
            options, len({id(it) for it in chunk}))
        if out is not None:
            self.start_host_copy(out)
        return out

    def materialize_batch(self, out_dev, n: int):
        if "jpeg_idx" not in out_dev:
            return BatchTransform.materialize_batch(out_dev, n)
        return djpeg.materialize_jpeg_batch(out_dev, n)

    def save_item(
        self,
        out: Dict[str, np.ndarray],
        item: Dict,
        output_dirs: Sequence[Path],
        options: Dict,
    ) -> Optional[List[Path]]:
        target = validate_dirs(output_dirs, 1)
        path = Path(item["_args"][0])
        h, w = (int(x) for x in item["size"])
        p = Path(target) / path.name
        if "jpeg_meta" in out:
            djpeg.write_sparse_item(p, out, h, w)
            return p
        # reference tranfo.py:53 saves via PIL -> JPEG quality 75
        encode_image_pil(out["image"][:h, :w], p)
        return p

"""Random rotations — batched device transform (1 → N+1 fan-out; port of
image_processor_pipeline_tpu/transforms/rotations.py).

Behavior parity with reference rotations.py:6-133 (process_rotations):
  - load as RGBA (rotations.py:55)
  - optional original saved as ``{stem}_{original_key}.{fmt}`` (default
    ``_r000``, rotations.py:77-82)
  - ``num_rotations`` (default 10) rotations at uniform random angles in
    [angle_min=1, angle_max=359], expand=True with transparent fill,
    nearest resampling (rotations.py:88-96)
  - tight crop to the content bbox (PIL getbbox, rotations.py:99-109)
  - names ``{stem}_{rotation_key_format(prefix, i+1)}.{fmt}`` with
    rotation_key_format default ``{prefix}{index:03d}`` and prefix ``r``
    (rotations.py:14-17, 113-116); ``.jpeg`` format maps to ``.jpg``
  - returns None when nothing could be saved (rotations.py:128-130)

All B × N rotations of a batch run as one call: ``method='shear'`` rotates
the B × N RGBA canvases with ``ops/rotate.py:rotate_square_shear_batch``,
which on a CUDA card launches the hand-written kernel of
``csrc/shear_rotate.cu`` (or raises) and on the CPU runs its plain twin;
``method='nearest'`` inverse-maps with a gather, sampling nearest or, with
``interpolation='bilinear'``, PIL's bilinear in float32.  The angles are
drawn on the host, and the shear method's shift vectors are computed there
too (``host_shifts``), so that a run on the card and a run on the CPU write
the same files: the card's float32 tan and sin differ from the CPU's by
ulps.
The JAX class's PIL-exact ``native_fn`` and its device JPEG encode are not
ported yet.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from image_processor_pipeline_tpu_torch import random as jrandom
from image_processor_pipeline_tpu_torch.transforms.base import (
    BatchTransform,
    to_device,
)
from image_processor_pipeline_tpu_torch.ops import geometry
from image_processor_pipeline_tpu_torch.ops import rotate as rotate_ops
from image_processor_pipeline_tpu_torch.io.images import (
    decode_padded,
    encode_image_pil,
    probe_padded,
)

METHODS = ("nearest", "shear")


def draw_angles(seeds, num_rotations: int, angle_min: float,
                angle_max: float) -> np.ndarray:
    """Each item's rotation angles [B, N] float32, drawn on the host:
    ``jax.random.uniform(PRNGKey(seed), (N,), angle_min, angle_max)``."""
    return jrandom.uniform(BatchTransform.keys_from_seeds(seeds),
                           (num_rotations,), angle_min, angle_max)


def host_shifts(angles: np.ndarray, H: int, device):
    """``geometry.shear_params`` of host ``angles`` (any shape; flattened)
    for an H×H canvas, computed on the CPU and copied to ``device``:
    (quad [n], sh1 [n, H], sh2 [n, H]) int32."""
    flat = torch.from_numpy(np.array(angles, np.float32))
    return tuple(to_device(t, device)
                 for t in geometry.shear_params(flat.reshape(-1), H))


def _rotate(img, h, w, angles, method: str,
            interpolation: str = "nearest", shifts=None):
    """All rotations of a batch: img [B, H, W, 4] uint8, h, w [B] int32 and
    angles [B, N] float32 on one device → images [B, N, H, W, 4] with
    heights and widths [B, N].

    method 'nearest' follows PIL's inverse-map sampling (the parity path);
    'shear' uses the Paeth 3-shear permutation (same footprint, ±1 px
    sampling jitter) — the content is centered on the square diagonal canvas
    first so the shears rotate about the right point, then tight-cropped as
    usual.  ``shifts``: the shear method's (quad, sh1, sh2) for the B × N
    rotations, to use instead of ``geometry.shear_params``' own.

    Empty-bbox (fully transparent input) fallback: the nearest path emits
    the reference's uncropped rotate-expand extents (h2, w2); the shear
    path emits its own working extent, the square diagonal canvas.  Both
    outputs are fully transparent; only the saved dimensions of an
    invisible image differ.
    """
    if method not in METHODS:
        raise ValueError(f"unknown rotation method {method!r}; "
                         f"choose from {METHODS}")
    B, H, W, C = img.shape
    N = angles.shape[1]
    flat_angles = angles.reshape(B * N)
    if method == "shear":
        cy = torch.div(H - h, 2, rounding_mode="floor")
        cx = torch.div(H - w, 2, rounding_mode="floor")
        centered = geometry.roll2(img, cy, cx)
        out = rotate_ops.rotate_square_shear_batch(
            centered.repeat_interleave(N, dim=0), flat_angles, shifts=shifts)
        out, bh, bw = geometry.fit_crop(out, H, H)
    else:
        out, h2, w2 = geometry.rotate_expand(
            img.repeat_interleave(N, dim=0), h.repeat_interleave(N),
            w.repeat_interleave(N), flat_angles, interpolation)
        out, bh, bw = geometry.fit_crop(out, h2, w2)
    return {"images": out.reshape(B, N, H, W, C), "heights": bh.reshape(B, N),
            "widths": bw.reshape(B, N), "angles": angles}


class RandomRotations(BatchTransform):
    max_batch = 8  # N rotations per item amplify the per-item footprint

    def load_item(self, inputs: Tuple, options: Dict) -> Dict[str, Any]:
        path = Path(inputs[0])
        buf, h, w, canvas = decode_padded(path, mode="RGBA", diag=True)
        return {
            "canvas": canvas,
            "image": buf,
            "size": np.asarray([h, w], np.int32),
        }

    def probe_item(self, inputs: Tuple, options: Dict) -> Optional[Dict[str, Any]]:
        path = Path(inputs[0])
        meta = probe_padded(path, mode="RGBA", diag=True)
        if meta is None:
            return None
        h, w, canvas = meta
        return {
            "canvas": canvas,
            "size": np.asarray([h, w], np.int32),
            "_decode": (str(path), "RGBA", True),
        }

    def static_args(self, options: Dict, key: Tuple) -> Tuple:
        return (
            int(options.get("num_rotations", 10)),
            float(options.get("angle_min", 1.0)),
            float(options.get("angle_max", 359.0)),
            str(options.get("method", "nearest")),
            str(options.get("interpolation", "nearest")),
        )

    def device_fn(self, batch, static):
        num_rotations, angle_min, angle_max, method, interpolation = static
        img = batch["image"]
        angles = draw_angles(batch["seed"], num_rotations, angle_min,
                             angle_max)
        shifts = host_shifts(angles, img.shape[1], img.device) \
            if method == "shear" else None
        return _rotate(img, batch["size"][:, 0], batch["size"][:, 1],
                       to_device(angles, img.device), method, interpolation,
                       shifts=shifts)

    def save_item(
        self,
        out: Dict[str, np.ndarray],
        item: Dict,
        output_dirs: Sequence[Path],
        options: Dict,
    ) -> Optional[List[Path]]:
        if not output_dirs:
            print("[rotations] no output dir provided")
            return None
        target = Path(output_dirs[0])
        path = Path(item["_args"][0])
        stem = path.stem

        output_format = options.get("output_format", "png")
        output_prefix = options.get("output_prefix", "r")
        original_key = options.get("original_key", "r000")
        key_format = options.get("rotation_key_format", "{prefix}{index:03d}")
        include_original = options.get("include_original", True)
        suffix = ".jpg" if output_format.lower() == "jpeg" \
            else f".{output_format.lower()}"

        saved: List[Path] = []
        if include_original:
            p = target / f"{stem}_{original_key}{suffix}"
            try:
                h, w = (int(x) for x in item["size"])
                # reference rotations.py:81 saves via PIL -> JPEG q75
                encode_image_pil(item["image"][:h, :w], p)
                saved.append(p)
            except Exception as e:  # noqa: BLE001 — continue past original
                print(f"[rotations] failed to save original {p.name}: {e}")

        n = out["heights"].shape[0]
        for i in range(n):
            bh, bw = int(out["heights"][i]), int(out["widths"][i])
            if bh <= 0 or bw <= 0:
                print(f"[rotations] empty bbox for rotation {i + 1} of "
                      f"{path.name}; skipping")
                continue
            key = key_format.format(prefix=output_prefix, index=i + 1)
            p = target / f"{stem}_{key}{suffix}"
            try:
                encode_image_pil(out["images"][i][:bh, :bw], p)
                saved.append(p)
            except Exception as e:  # noqa: BLE001 — per-rotation tolerance
                print(f"[rotations] failed rotation {i + 1} of {path.name}: {e}")

        if not saved:
            return None
        return saved

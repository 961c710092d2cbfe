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
ulps.  With ``output_format="jpeg"`` and ``device_encode`` on, the JPEG
front half of every rotation runs on the device and only sparse
coefficients come back (``shrink_output``).
The JAX class's PIL-exact ``native_fn`` is not ported yet.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from image_processor_pipeline_tpu_torch import random as jrandom
from image_processor_pipeline_tpu_torch.transforms.base import (
    BatchTransform,
    host_arrays,
    to_device,
)
from image_processor_pipeline_tpu_torch.ops import geometry
from image_processor_pipeline_tpu_torch.ops import jpeg as djpeg
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

    # save_item re-encodes the decoded input as the `include_original`
    # copy (reference rotations.py:77-82), so the engine must keep host
    # pixel decoding on (device_decode would leave item["image"] unset)
    save_needs_image = True

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

    # -- hybrid device JPEG encode (D2H ships coefficients, not pixels) ----
    # The rotations step has the engine's largest D2H payload (R canvases
    # per input); with output_format='jpeg' and device_encode on, the JPEG
    # front half runs on the device (ops/jpeg.py:encode_shrink at the
    # PIL-anchored q75) over the B x R rows flattened, sparse quantized
    # coefficients come back, and save_item entropy-encodes only.
    # Byte-identical to the pixel path.
    shrinks_output = True

    def shrink_output(self, out_dev, chunk, options):
        fmt = str(options.get("output_format", "png")).lower()
        if fmt in ("jpeg", "jpg") and djpeg.device_encode_enabled(
                options, self, out_dev["images"].device):
            out = self._shrink_encode(
                out_dev, options, n_valid=len({id(it) for it in chunk}))
            if out is not None:
                return out
        self.start_host_copy(out_dev)
        return out_dev

    def _shrink_encode(self, out_dev, options, n_valid=None):
        imgs = out_dev["images"]
        B, R = int(imgs.shape[0]), int(imgs.shape[1])
        flat = imgs.reshape((B * R,) + tuple(imgs.shape[2:]))
        h_dev = out_dev["heights"].reshape(B * R).to(torch.int32)
        w_dev = out_dev["widths"].reshape(B * R).to(torch.int32)
        # small wait on this batch's own sizes (saver-thread context)
        h_np, w_np = djpeg.fetch([h_dev, w_dev])
        # hysteresis counts only the chunk's real items' rows (pad items
        # duplicate the tail and would skew the dense ratio); each item
        # contributes R flattened rows
        out = djpeg.shrink_transport(
            self, flat, h_dev, w_dev, h_np, w_np,
            75,  # PIL q75 (rotations.py:119)
            options, B * R if n_valid is None else n_valid * R)
        if out is None:
            return None
        out.update(jpeg_R=R, heights=h_np.reshape(B, R),
                   widths=w_np.reshape(B, R))
        self.start_host_copy(out)
        return out

    def materialize_batch(self, out_dev, n: int):
        if "jpeg_idx" not in out_dev:
            return BatchTransform.materialize_batch(out_dev, n)
        R = out_dev["jpeg_R"]
        pixels = out_dev["jpeg_pixels"]
        fetch = host_arrays(out_dev)
        items = []
        for i in range(n):
            lo = i * R
            items.append({
                "jpeg_idx": fetch["jpeg_idx"][lo:lo + R],
                "jpeg_val": fetch["jpeg_val"][lo:lo + R],
                "jpeg_nnz": out_dev["jpeg_nnz"][lo:lo + R],
                "jpeg_meta": out_dev["jpeg_meta"],
                "jpeg_pixels": {
                    j - lo: px for j, px in pixels.items()
                    if lo <= j < lo + R},
                "heights": out_dev["heights"][i],
                "widths": out_dev["widths"][i],
            })
        return items

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

        jpeg_mode = "jpeg_meta" in out
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
                if jpeg_mode and i not in out["jpeg_pixels"]:
                    # device_encode transport: entropy-encode the device-
                    # quantized sparse coefficients (bytes identical)
                    djpeg.write_sparse_item(p, {
                        "jpeg_idx": out["jpeg_idx"][i],
                        "jpeg_val": out["jpeg_val"][i],
                        "jpeg_nnz": out["jpeg_nnz"][i],
                        "jpeg_meta": out["jpeg_meta"],
                    }, bh, bw)
                else:
                    img = (out["jpeg_pixels"][i] if jpeg_mode
                           else out["images"][i])[:bh, :bw]
                    encode_image_pil(img, p)
                saved.append(p)
            except Exception as e:  # noqa: BLE001 — per-rotation tolerance
                print(f"[rotations] failed rotation {i + 1} of {path.name}: {e}")

        if not saved:
            return None
        return saved

"""Overlay alpha-compositing + YOLO label synthesis — batched device
transform (port of image_processor_pipeline_tpu/transforms/overlays.py).

Behavior parity with reference overlays.py:24-187
(paste_overlay_onto_background, the current non-deprecated variant):
  - overlay → RGBA, background → RGB (overlays.py:83-88)
  - target overlay diagonal = uniform(scale_min=0.15, scale_max=0.30) ×
    background diagonal, capped so the overlay fits at its aspect ratio
    (overlays.py:104-121); final dims via int() truncation of
    h = sqrt(d²/(ar²+1)), w = int(ar·h) (overlays.py:125-126)
  - LANCZOS resize (overlays.py:129)
  - uniform random placement, inclusive randint bounds (overlays.py:133-134)
  - PIL alpha paste (overlays.py:138-139)
  - one YOLO label line for the paste bbox, class ``yolo_class_id``
    (overlays.py:141-149); label has NO trailing newline (overlays.py:172-173)
  - outputs ``{overlay_stem}{background_suffix}`` and ``{overlay_stem}.txt``
    (overlays.py:165-166); partial outputs removed on save failure
    (overlays.py:182-187)

The paste geometry is drawn on the host in numpy (``draw_geometry``: the
jitted JAX ``_draw_geometry``'s float32 values, sizes, positions and
labels); the pixels are computed on the step's device: premultiply,
Pillow's fixed-point LANCZOS resize (``geometry.resize``), unpremultiply,
Paste.c's blend (``compose.alpha_paste``).  That is the Pillow composite
byte for byte, as the JAX package's native twin computes it.  When every
background in a bucket is .jpg and ``device_encode`` is on, the JPEG front
half of the composites runs on the device and only sparse coefficients
come back (``shrink_output``).  The JAX class's ``native_fn`` is not
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
from image_processor_pipeline_tpu_torch.ops import compose, geometry
from image_processor_pipeline_tpu_torch.ops import jpeg as djpeg
from image_processor_pipeline_tpu_torch.io.images import (
    decode_padded,
    encode_image_pil,
    probe_padded,
)
from image_processor_pipeline_tpu_torch.utils.utils import validate_dirs


def draw_geometry(seeds, ov_h, ov_w, bg_h, bg_w, scale_min, scale_max):
    """Each item's random paste geometry (sizing math of reference
    overlays.py:104-134), on the host: (new_h, new_w, py, px [B] int32,
    ok [B] bool, xywhn [B, 4] float32) for uint32 ``seeds`` [B] and the
    items' integer sizes.

    The jitted JAX ``_draw_geometry``'s values: its float32 operations in
    the order XLA runs them, which rewrites ``bw / (ow / oh)`` as
    ``(bw * oh) / ow`` and contracts ``aspect * aspect + 1`` into one
    fused multiply-add (``random._fma_f32``)."""
    f32 = np.float32
    keys = jrandom.split(jrandom.PRNGKey(np.asarray(seeds, np.uint32)), 3)
    bg_h, bg_w = (np.asarray(v, np.int32) for v in (bg_h, bg_w))
    bhf, bwf, ohf, owf = (np.asarray(v).astype(f32)
                          for v in (bg_h, bg_w, ov_h, ov_w))
    with np.errstate(divide="ignore", invalid="ignore"):
        bg_diag = np.sqrt(bwf * bwf + bhf * bhf)
        ratio = jrandom.uniform(keys[:, 0], (), scale_min, scale_max)
        target_diag = bg_diag * ratio
        aspect = owf / ohf
        h_max = np.minimum((bwf * ohf) / owf, bhf)
        ah = aspect * h_max
        max_diag = np.sqrt(ah * ah + h_max * h_max)
        diag = np.minimum(target_diag, max_diag)
        new_h = np.floor(np.sqrt(
            diag * diag / jrandom._fma_f32(aspect, aspect, f32(1.0))))
        new_w = np.floor(aspect * new_h)
    new_hi, new_wi = new_h.astype(np.int32), new_w.astype(np.int32)
    ok = (new_hi > 0) & (new_wi > 0)
    px = jrandom.randint(keys[:, 1], (), 0, np.maximum(bg_w - new_wi, 0) + 1)
    py = jrandom.randint(keys[:, 2], (), 0, np.maximum(bg_h - new_hi, 0) + 1)
    x1, y1, x2, y2 = (v.astype(f32) for v in (px, py, px + new_wi,
                                              py + new_hi))
    xywhn = np.stack([((x1 + x2) * f32(0.5)) / bwf,
                      ((y1 + y2) * f32(0.5)) / bhf,
                      (x2 - x1) / bwf, (y2 - y1) / bhf], axis=-1)
    return new_hi, new_wi, py, px, ok, xywhn


def _muldiv255(v, a):
    """Pillow MULDIV255: round(v*a/255) as ((v*a+128)>>8 + v*a+128)>>8."""
    t = v.to(torch.int32) * a.to(torch.int32) + 128
    return (t + (t >> 8)) >> 8


def paste_overlays(ov, ov_h, ov_w, bg, bg_h, bg_w, new_h, new_w, py, px):
    """The composites of a batch, as Pillow makes them: uint8 overlay
    canvases [B, Ho, Wo, 4] and background canvases [B, Hb, Wb, 3] on one
    device, the sizes and the drawn geometry one host integer an item.
    Returns [B, Hb, Wb, 3] uint8.

    Image.resize on RGBA resamples premultiplied alpha (RGBA → RGBa with
    MULDIV255, resample, back with (255*v)//a, alpha 0 and 255 passing
    through, clipped at 255); a resize to the same size is a plain copy
    (Image.resize returns early), so those items skip the round trip."""
    B, Hb, Wb = bg.shape[:3]
    same = (np.asarray(new_h) == np.asarray(ov_h)) \
        & (np.asarray(new_w) == np.asarray(ov_w))
    same_t = to_device(same, ov.device).view(B, 1, 1, 1)
    a0 = ov[..., 3:4]
    pre = torch.cat([_muldiv255(ov[..., :3], a0).to(torch.uint8), a0], -1)
    pre = torch.where(same_t, ov, pre)
    resized = geometry.resize(pre, ov_h, ov_w, new_h, new_w, "lanczos",
                              out_canvas=(Hb, Wb))
    ra = resized[..., 3:4].to(torch.int32)
    rv = resized[..., :3].to(torch.int32)
    unp = torch.minimum(torch.div(255 * rv, torch.clamp(ra, min=1),
                                  rounding_mode="floor"),
                        torch.full_like(rv, 255))
    rgb = torch.where((ra == 0) | (ra == 255) | same_t, rv, unp)
    resized = torch.cat([rgb, ra], dim=-1).to(torch.uint8)
    return compose.alpha_paste(
        bg, *(to_device(np.asarray(v, np.int32), bg.device)
              for v in (bg_h, bg_w)),
        resized, *(to_device(np.asarray(v, np.int32), bg.device)
                   for v in (new_h, new_w, py, px)))


class PasteOverlayOntoBackground(BatchTransform):
    max_batch = 16
    #: the sizes feed the host's geometry draws
    host_fields = ("seed", "ov_size", "bg_size")

    def load_item(self, inputs: Tuple, options: Dict) -> Dict[str, Any]:
        ov_path, bg_path = Path(inputs[0]), Path(inputs[1])
        ov, ov_h, ov_w, ov_canvas = decode_padded(ov_path, mode="RGBA")
        bg, bg_h, bg_w, bg_canvas = decode_padded(bg_path, mode="RGB")
        if ov_h == 0:
            raise ValueError(f"overlay {ov_path.name} has invalid dimensions")
        return {
            "canvas": (*ov_canvas, *bg_canvas),
            "overlay": ov,
            "ov_size": np.asarray([ov_h, ov_w], np.int32),
            "background": bg,
            "bg_size": np.asarray([bg_h, bg_w], np.int32),
        }

    def probe_item(self, inputs: Tuple, options: Dict) -> Optional[Dict]:
        """Metadata-only load: a bucket of n items then decodes its
        overlays (RGBA) and backgrounds (RGB) into one stacked array each
        (io/images.py:_fill_pending_multi)."""
        ov_path, bg_path = Path(inputs[0]), Path(inputs[1])
        ov_meta = probe_padded(ov_path, mode="RGBA")
        bg_meta = probe_padded(bg_path, mode="RGB")
        if ov_meta is None or bg_meta is None:
            return None
        ov_h, ov_w, ov_canvas = ov_meta
        bg_h, bg_w, bg_canvas = bg_meta
        if ov_h == 0:
            raise ValueError(f"overlay {ov_path.name} has invalid dimensions")
        return {
            "canvas": (*ov_canvas, *bg_canvas),
            "ov_size": np.asarray([ov_h, ov_w], np.int32),
            "bg_size": np.asarray([bg_h, bg_w], np.int32),
            "_pending": {
                "overlay": (
                    str(ov_path), "RGBA", False, ov_canvas, ov_h, ov_w),
                "background": (
                    str(bg_path), "RGB", False, bg_canvas, bg_h, bg_w),
            },
        }

    def static_args(self, options: Dict, key: Tuple) -> Tuple:
        return (
            float(options.get("scale_min", 0.15)),
            float(options.get("scale_max", 0.30)),
        )

    def device_fn(self, batch, static):
        scale_min, scale_max = static
        ovs, bgs = batch["ov_size"], batch["bg_size"]
        new_h, new_w, py, px, ok, xywhn = draw_geometry(
            batch["seed"], ovs[:, 0], ovs[:, 1], bgs[:, 0], bgs[:, 1],
            scale_min, scale_max)
        image = paste_overlays(batch["overlay"], ovs[:, 0], ovs[:, 1],
                               batch["background"], bgs[:, 0], bgs[:, 1],
                               new_h, new_w, py, px)
        return {
            "image": image,
            "xywhn": torch.from_numpy(xywhn),
            "ok": torch.from_numpy(ok),
            "pos": torch.from_numpy(np.stack([py, px], axis=1)),
            "new_size": torch.from_numpy(np.stack([new_h, new_w], axis=1)),
        }

    # -- hybrid device JPEG encode (D2H ships coefficients, not pixels) ----
    # Composites are background-sized (the step's largest payload); when
    # every background in the bucket is .jpg the JPEG front half runs on
    # the device at the PIL-anchored q75 (ops/jpeg.py:encode_shrink) and
    # only sparse quantized coefficients come back.  Byte-identical to the
    # pixel path.
    shrinks_output = True

    def shrink_output(self, out_dev, chunk, options):
        if chunk and all(
                Path(it["_args"][1]).suffix.lower() in (".jpg", ".jpeg")
                for it in chunk) and djpeg.device_encode_enabled(
                    options, self, out_dev["image"].device):
            out = self._shrink_encode(
                out_dev, chunk, options,
                n_valid=len({id(it) for it in chunk}))
            if out is not None:
                return out
        self.start_host_copy(out_dev)
        return out_dev

    def _shrink_encode(self, out_dev, chunk, options, n_valid):
        img = out_dev["image"]
        sizes = np.stack([np.asarray(it["bg_size"]) for it in chunk])
        h_np = sizes[:, 0].astype(np.int32)
        w_np = sizes[:, 1].astype(np.int32)
        out = djpeg.shrink_transport(
            self, img, to_device(h_np, img.device),
            to_device(w_np, img.device), h_np, w_np,
            75,  # PIL q75 (reference overlays.py:169)
            options, n_valid)
        if out is None:
            return None
        out.update(xywhn=out_dev["xywhn"], ok=out_dev["ok"])
        self.start_host_copy(out)
        return out

    def materialize_batch(self, out_dev, n: int):
        if "jpeg_idx" not in out_dev:
            return BatchTransform.materialize_batch(out_dev, n)
        return djpeg.materialize_jpeg_batch(out_dev, n,
                                            per_item_keys=("xywhn", "ok"))

    def save_item(
        self,
        out: Dict[str, np.ndarray],
        item: Dict,
        output_dirs: Sequence[Path],
        options: Dict,
    ) -> Optional[List[Path]]:
        img_dir, lbl_dir = validate_dirs(output_dirs, 2)
        ov_path = Path(item["_args"][0])
        bg_path = Path(item["_args"][1])
        if not bool(out["ok"]):
            print(f"[overlays] degenerate overlay size for {ov_path.name}")
            return None
        bh, bw = (int(x) for x in item["bg_size"])
        cx, cy, wn, hn = (float(x) for x in out["xywhn"])
        cls_id = options.get("yolo_class_id", 0)
        label_line = f"{cls_id} {cx:.6f} {cy:.6f} {wn:.6f} {hn:.6f}"

        img_out = Path(img_dir) / f"{ov_path.stem}{bg_path.suffix}"
        lbl_out = Path(lbl_dir) / f"{ov_path.stem}.txt"
        saved: List[Path] = []
        try:
            if "jpeg_meta" in out:
                # device_encode transport: entropy-encode the device-
                # quantized sparse coefficients (bytes identical)
                djpeg.write_sparse_item(img_out, out, bh, bw)
            else:
                # reference overlays.py:169 saves via PIL -> JPEG q75
                encode_image_pil(out["image"][:bh, :bw], img_out)
            saved.append(img_out)
            lbl_out.write_text(label_line)
            saved.append(lbl_out)
            return saved
        except Exception as e:  # noqa: BLE001 — rollback partial outputs
            print(f"[overlays] save failed for {ov_path.name}: {e}")
            for p in saved:
                try:
                    if p.exists():
                        p.unlink()
                except OSError:
                    print(f"[overlays] could not clean up partial file {p}")
            return None

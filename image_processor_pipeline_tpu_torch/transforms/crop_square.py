"""Square crop around YOLO bboxes — batched device transform (port of
image_processor_pipeline_tpu/transforms/crop_square.py).

Behavior parity with reference crop_square.py:104-224
(process_square_crop_around_bbox):
  - crop side = min(H, W) (crop_square.py:172)
  - placement bounds: x0 ∈ [max(0, int(x_max - s)), min(int(x_min), W - s)],
    same for y (crop_square.py:179-182, int() truncation kept)
  - uniform random integer offset, inclusive bounds (crop_square.py:192-193)
  - bboxes shifted, clipped to the crop, kept only if strictly non-degenerate
    (crop_square.py:201-210; the reference's ambiguous-truth bug is fixed to
    the intended elementwise test)
  - errors when no valid placement exists (crop_square.py:185-189) or no
    bbox survives (crop_square.py:211-212)
  - outputs: <out_imgs>/<image name>, <out_labels>/<label name>
    (crop_square.py:220-222), label lines 'cls cx cy w h' 6-decimal

The placement draw and the bbox recalibration are O(B) scalars and run on
the host (``_geom``); the crop (a roll by each item's own offsets, then a
mask) runs on the device over the whole batch; the host decodes, stacks,
and re-encodes.  On all-.jpg buckets with ``device_encode`` on, the JPEG
front half runs on the device too and only sparse coefficients come back
(``shrink_output``).  The JAX class's ``native_fn`` is not ported yet.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple
from warnings import warn

import numpy as np
import torch

from image_processor_pipeline_tpu_torch import random as jrandom
from image_processor_pipeline_tpu_torch.transforms.base import (
    BatchTransform,
    to_device,
)
from image_processor_pipeline_tpu_torch.ops import jpeg as djpeg
from image_processor_pipeline_tpu_torch.ops import bbox as bbox_ops
from image_processor_pipeline_tpu_torch.ops import geometry
from image_processor_pipeline_tpu_torch.io.images import (
    decode_padded,
    encode_image,
    probe_padded,
)
from image_processor_pipeline_tpu_torch.io.labels import read_yolo_labels, write_yolo_labels
from image_processor_pipeline_tpu_torch.utils.utils import validate_dirs

MAX_BOXES = 64


def _geom(h, w, classes, xywhn, nbox, seed) -> Dict[str, torch.Tensor]:
    """Per-item placement draw + bbox recalibration for a batch (no image
    math), on the host: h, w, nbox [B] int32, classes [B, MAX_BOXES] int32,
    xywhn [B, MAX_BOXES, 4] float32, seed [B] uint32, as numpy arrays or
    CPU tensors.  Returns CPU tensors with a leading batch axis; the draws
    are ``jax.random``'s for the same seeds."""
    h, w, classes, xywhn, nbox = (torch.as_tensor(np.asarray(a))
                                  for a in (h, w, classes, xywhn, nbox))
    h, w, nbox = h.to(torch.int32), w.to(torch.int32), nbox.to(torch.int32)
    keys = jrandom.split(BatchTransform.keys_from_seeds(seed))
    kx, ky = keys[:, 0], keys[:, 1]

    box_mask = torch.arange(MAX_BOXES, dtype=torch.int32)[None, :] \
        < nbox[:, None]
    wf, hf = w.to(torch.float32), h.to(torch.float32)
    xyxy = bbox_ops.xywhn2xyxy(xywhn, wf[:, None], hf[:, None])
    union = bbox_ops.union_box(xyxy, box_mask)
    x_min, y_min, x_max, y_max = union.unbind(-1)

    s = torch.minimum(h, w)
    sf = s.to(torch.float32)
    # int() truncation like the reference, then bound clamping
    lo_x = (x_max - sf).to(torch.int32).clamp(min=0)
    hi_x = torch.minimum(x_min.to(torch.int32), w - s)
    lo_y = (y_max - sf).to(torch.int32).clamp(min=0)
    hi_y = torch.minimum(y_min.to(torch.int32), h - s)
    placement_ok = (lo_x <= hi_x) & (lo_y <= hi_y) & (nbox > 0)

    # inclusive-bounds randint; an empty range draws its lower bound
    x0 = torch.from_numpy(jrandom.randint(
        kx, (), lo_x.numpy(), torch.maximum(hi_x, lo_x).numpy() + 1))
    y0 = torch.from_numpy(jrandom.randint(
        ky, (), lo_y.numpy(), torch.maximum(hi_y, lo_y).numpy() + 1))

    shifted = bbox_ops.shift_boxes(xyxy, x0.to(torch.float32),
                                   y0.to(torch.float32))
    clipped = bbox_ops.clip_boxes(shifted, (sf[:, None], sf[:, None]))
    valid = (
        (clipped[..., 0] < clipped[..., 2]) & (clipped[..., 1] < clipped[..., 3])
        & box_mask
    )
    new_xywhn = bbox_ops.xyxy2xywhn(clipped, sf[:, None], sf[:, None])
    return {
        "crop_size": s,
        "x0": x0,
        "y0": y0,
        "placement_ok": placement_ok,
        "xywhn": new_xywhn,
        "classes": classes,
        "valid": valid,
    }


def _crop(img, h, w, classes, xywhn, nbox, seed):
    """The batch's computation: ``_geom`` on the host, then each item's
    crop moved to the origin of its canvas on ``img``'s device."""
    out = _geom(h, w, classes, xywhn, nbox, seed)
    y0, x0, s = (to_device(out[k], img.device)
                 for k in ("y0", "x0", "crop_size"))
    out["image"] = geometry.crop(img, y0, x0, s, s)
    return out


class SquareCropAroundBBox(BatchTransform):
    """Batched square-crop-around-bbox (input pairing: zip of imgs+labels)."""

    def probe_item(self, inputs: Tuple, options: Dict) -> Optional[Dict[str, Any]]:
        img_path = Path(inputs[0])
        meta = probe_padded(img_path, mode="RGB")
        if meta is None:
            return None
        h, w, canvas = meta
        item = self._label_fields(inputs)
        item.update({
            "canvas": canvas,
            "size": np.asarray([h, w], np.int32),
            "_decode": (str(img_path), "RGB", False),
        })
        return item

    def _label_fields(self, inputs: Tuple) -> Dict[str, Any]:
        img_path, lbl_path = Path(inputs[0]), Path(inputs[1])
        if img_path.stem != lbl_path.stem:
            warn(
                f"[crop_square] image ({img_path.name}) and label "
                f"({lbl_path.name}) stems differ; processing anyway"
            )
        classes, xywhn = read_yolo_labels(lbl_path)
        if len(classes) > MAX_BOXES:
            warn(
                f"[crop_square] {lbl_path.name} has {len(classes)} boxes; "
                f"only the first {MAX_BOXES} constrain the crop placement"
            )
        n = min(len(classes), MAX_BOXES)
        cls_pad = np.zeros((MAX_BOXES,), np.int32)
        box_pad = np.zeros((MAX_BOXES, 4), np.float32)
        cls_pad[:n] = classes[:n]
        box_pad[:n] = xywhn[:n]
        return {"classes": cls_pad, "xywhn": box_pad, "nbox": np.int32(n)}

    def load_item(self, inputs: Tuple, options: Dict) -> Dict[str, Any]:
        img_path = Path(inputs[0])
        buf, h, w, canvas = decode_padded(img_path, mode="RGB")
        item = self._label_fields(inputs)
        item.update({
            "canvas": canvas,
            "image": buf,
            "size": np.asarray([h, w], np.int32),
        })
        return item

    # the label fields feed the host's draws: only the image goes to the
    # device
    host_fields = ("seed", "size", "classes", "xywhn", "nbox")

    def device_fn(self, batch, static):
        size = np.asarray(batch["size"])
        return _crop(
            batch["image"],
            size[:, 0],
            size[:, 1],
            batch["classes"],
            batch["xywhn"],
            batch["nbox"],
            batch["seed"],
        )

    # -- hybrid device JPEG encode (D2H ships coefficients, not pixels) ----
    # Crops keep the input suffix and save at the cv2-anchored q95
    # (reference crop_square.py saves via cv2.imwrite); on all-.jpg
    # buckets the JPEG front half runs on the device and only sparse
    # quantized coefficients come back.  Byte-identical to the pixel path.
    shrinks_output = True

    def shrink_output(self, out_dev, chunk, options):
        if chunk and all(
                Path(it["_args"][0]).suffix.lower() in (".jpg", ".jpeg")
                for it in chunk):
            if djpeg.device_encode_enabled(options, self,
                                           out_dev["image"].device):
                out = self._shrink_encode(
                    out_dev, options,
                    n_valid=len({id(it) for it in chunk}))
                if out is not None:
                    return out
        self.start_host_copy(out_dev)
        return out_dev

    _GEO_KEYS = ("crop_size", "placement_ok", "valid", "classes", "xywhn")

    def _shrink_encode(self, out_dev, options, n_valid):
        img = out_dev["image"]
        s_np = np.asarray(out_dev["crop_size"], np.int32)
        s_dev = to_device(s_np, img.device)
        out = djpeg.shrink_transport(
            self, img, s_dev, s_dev, s_np, s_np, 95, options, n_valid)
        if out is None:
            return None
        out.update({k: out_dev[k] for k in self._GEO_KEYS})
        self.start_host_copy(out)
        return out

    def materialize_batch(self, out_dev, n: int):
        if "jpeg_idx" not in out_dev:
            return BatchTransform.materialize_batch(out_dev, n)
        return djpeg.materialize_jpeg_batch(out_dev, n,
                                            per_item_keys=self._GEO_KEYS)

    def save_item(
        self,
        out: Dict[str, np.ndarray],
        item: Dict,
        output_dirs: Sequence[Path],
        options: Dict,
    ) -> Optional[List[Path]]:
        img_dir, lbl_dir = validate_dirs(output_dirs, 2)
        img_path, lbl_path = Path(item["_args"][0]), Path(item["_args"][1])
        if not bool(out["placement_ok"]):
            raise RuntimeError(
                f"no valid square-crop placement for {img_path.name}"
            )
        valid = out["valid"].astype(bool)
        if not valid.any():
            raise RuntimeError(f"no bbox survives the crop for {img_path.name}")
        s = int(out["crop_size"])
        classes = out["classes"][valid]
        xywhn = out["xywhn"][valid]
        img_out = Path(img_dir) / img_path.name
        lbl_out = Path(lbl_dir) / lbl_path.name
        if "jpeg_meta" in out:
            # device_encode transport: entropy-encode the device-quantized
            # sparse coefficients (bytes identical to the q95 pixel path)
            djpeg.write_sparse_item(img_out, out, s, s)
        else:
            encode_image(out["image"][:s, :s], img_out)
        write_yolo_labels(lbl_out, classes, xywhn)
        return [img_out, lbl_out]

"""Fused overlay compositing → border crop (eval config 4's pair; port of
image_processor_pipeline_tpu/transforms/ovlborder.py).

The reference runs them as two disk-materialized stages: overlays.py:138-187
pastes and saves the composite as ``.jpg`` (PIL q75) plus a YOLO label,
then recadrages.py:13-61 re-decodes every composite and saves the
border-cropped image (cv2 q95).  This transform composes them: paste, then
SLICE the borders off the composite, and encode exactly once.

Geometry and labels equal the unfused run's (the paste draws ride the
overlays step's seed tree over the same pairing inventory, and the border
crop never touches labels).  The final pixels are not the unfused run's:
that run's composite goes through a JPEG q75 encode and re-decode before
the crop re-encodes at q95; the fused image skips that lossy generation.

One status per (overlay, background) pair.  The standalone border crop's
failure modes are replicated per item AFTER the label is written — margins
too large or a non-JPG composite name raise, leaving the label on disk and
the image missing, exactly the unfused run's final state.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from image_processor_pipeline_tpu_torch.transforms.overlays import (
    PasteOverlayOntoBackground,
)
from image_processor_pipeline_tpu_torch.transforms.recadrages import BorderCrop
from image_processor_pipeline_tpu_torch.io.images import encode_image
from image_processor_pipeline_tpu_torch.utils.utils import validate_dirs


class OverlaysBorderCrop(PasteOverlayOntoBackground):
    """PasteOverlayOntoBackground ∘ BorderCrop in one step.

    The compute half (paste geometry draws, premultiplied LANCZOS resize,
    alpha paste) is inherited unchanged; the border crop is a slice of the
    composite at save time, before the single encode.  Options are the
    union: overlays' ``scale_min``/``scale_max``/``yolo_class_id`` plus
    border crop's ``crop_margins`` (fractions < 1 of the side or absolute
    pixels — recadrages.py:7-10 semantics via BorderCrop._margins).

    The final image encodes at q95 (the standalone chain's last stage
    writes via cv2.imwrite — reference recadrages.py:57), named
    ``{overlay_stem}{background_suffix}``; the label is the overlays
    stage's line."""

    def shrink_output(self, out_dev, chunk, options):
        """The inherited hybrid JPEG shrink encodes the UNCROPPED
        composite at the overlays anchor (PIL q75) — wrong on both counts
        for the fused step (cropped content, cv2 q95), so the transport
        is always the pixel fetch here."""
        self.start_host_copy(out_dev)
        return out_dev

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
            print(f"[ovlborder] degenerate overlay size for {ov_path.name}")
            return None
        bh, bw = (int(x) for x in item["bg_size"])
        cx, cy, wn, hn = (float(x) for x in out["xywhn"])
        cls_id = options.get("yolo_class_id", 0)

        # label first: the unfused overlays stage writes it before the
        # standalone crop can fail, so a margins error must leave it
        lbl_out = Path(lbl_dir) / f"{ov_path.stem}.txt"
        lbl_out.write_text(f"{cls_id} {cx:.6f} {cy:.6f} {wn:.6f} {hn:.6f}")

        # the standalone border crop's per-file gates, replicated on the
        # name the intermediate WOULD have had ({stem}{bg_suffix})
        img_name = f"{ov_path.stem}{bg_path.suffix}"
        if bg_path.suffix.lower() not in (".jpg", ".jpeg"):
            raise ValueError(f"file {img_name} is not a JPG")
        tp, bp, lp, rp = (
            int(x) for x in BorderCrop._margins(options, bh, bw, img_name))

        img_out = Path(img_dir) / img_name
        encode_image(out["image"][tp:bh - bp, lp:bw - rp], img_out)
        return [img_out, lbl_out]

"""HSV color-mask → transparency — batched device transform (port of
image_processor_pipeline_tpu/transforms/filters.py).

Behavior parity with reference filtres_liste.py:41-149
(process_images_with_color_masks):
  - per filter: HSV inRange AND a margin-inset zone mask, OR-accumulated
  - final alpha = NOT(accumulated mask); RGB channels keep the ORIGINAL
    pixel values (filtres_liste.py:132-134 merges original b, g, r + alpha)
  - zones list must match the filter list length; None zone = whole image
  - GIMP-scale conversion via use_gimp_scale (filtres_liste.py:8-39)
  - output name ``{prefix}_{stem}.png`` (underscore only with a prefix),
    always PNG (filtres_liste.py:138)

The whole filter stack is elementwise torch ops on the batch.  The JAX
class's native C++ twin (``native_fn``) is not ported yet.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from image_processor_pipeline_tpu_torch.transforms.base import BatchTransform
from image_processor_pipeline_tpu_torch.ops import color as color_ops
from image_processor_pipeline_tpu_torch.io.images import (
    decode_padded,
    encode_image,
    probe_padded,
)
from image_processor_pipeline_tpu_torch.utils.utils import validate_dirs


class ColorMaskTransparency(BatchTransform):
    max_batch = 32
    # save_item reads the decoded input (its RGB under the new alpha), so
    # the hybrid device decode stays off
    save_needs_image = True

    @staticmethod
    def _require_ranges(options: Dict) -> None:
        if not options.get("color_ranges_to_exclude_hsv"):
            raise ValueError(
                "color_ranges_to_exclude_hsv is required for the color-mask "
                "transform"
            )

    def load_item(self, inputs: Tuple, options: Dict) -> Dict[str, Any]:
        self._require_ranges(options)
        path = Path(inputs[0])
        # cv2.imread default drops alpha (filtres_liste.py:84) — force RGB
        buf, h, w, canvas = decode_padded(path, mode="RGB")
        return {
            "canvas": canvas,
            "image": buf,
            "size": np.asarray([h, w], np.int32),
        }

    def probe_item(self, inputs: Tuple, options: Dict):
        self._require_ranges(options)
        path = Path(inputs[0])
        meta = probe_padded(path, mode="RGB")
        if meta is None:
            return None
        h, w, canvas = meta
        return {
            "canvas": canvas,
            "size": np.asarray([h, w], np.int32),
            "_decode": (str(path), "RGB", False),
        }

    def static_args(self, options: Dict, key: Tuple) -> Tuple:
        filters = options["color_ranges_to_exclude_hsv"]
        zones = options.get("zones")
        if zones and len(zones) != len(filters):
            raise ValueError(
                f"zones ({len(zones)}) must match filters ({len(filters)})"
            )
        if not zones:
            zones = [None] * len(filters)
        use_gimp = bool(options.get("use_gimp_scale", False))
        scaled = [color_ops.rescale_filter(f, use_gimp) for f in filters]
        lowers = tuple(tuple(f[:3]) for f in scaled)
        uppers = tuple(tuple(f[3:]) for f in scaled)
        zones = tuple(tuple(z) if z else (0, 0, 0, 0) for z in zones)
        return (lowers, uppers, zones)

    def device_fn(self, batch, static):
        lowers, uppers, zones = static
        size = batch["size"]
        return {"alpha": color_ops.color_mask_alpha(
            batch["image"], size[:, 0], size[:, 1], lowers, uppers, zones)}

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
        rgb = item["image"][:h, :w]
        alpha = out["alpha"][:h, :w, None]
        rgba = np.concatenate([rgb, alpha], axis=-1)
        prefix = options.get("output_prefix", "")
        name = f"{prefix}{'_' if prefix else ''}{path.stem}.png"
        p = Path(target) / name
        encode_image(rgba, p)
        return p

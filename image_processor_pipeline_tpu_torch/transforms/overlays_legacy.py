"""Deprecated overlay-pair variant (host transform).

Behavior parity with reference overlays.py:190-354 (process_overlay_pair,
marked @deprecated there in favor of paste_overlay_onto_background):
  - overlay scaled so its LONGER side = uniform(min_scale=0.1,
    max_scale=0.35) × min(bg_w, bg_h), aspect preserved (int truncation)
  - up to ``max_placement_attempts`` re-draws when the scaled overlay
    doesn't fit; None after exhausting attempts
  - LANCZOS resize, PIL alpha paste, single YOLO label line (no newline)
  - outputs ``{overlay_stem}{background_suffix}`` / ``{overlay_stem}.txt``
  - partial outputs removed on save failure

Kept host-side, on Pillow as in image_processor_pipeline_tpu/transforms/
overlays_legacy.py (of which this is the port): it exists only for drop-in
compatibility with notebooks that still call it.  New code should use
transforms.overlays.PasteOverlayOntoBackground (the batched device path).
"""

from __future__ import annotations

import random
import warnings
from pathlib import Path
from typing import Any, List, Optional


def process_overlay_pair(
    overlay_path: Path,
    background_path: Path,
    output_dirs: List[Path],
    yolo_class_id: int = 0,
    min_scale: float = 0.1,
    max_scale: float = 0.35,
    max_placement_attempts: int = 10,
    **options: Any,
) -> Optional[List[Path]]:
    warnings.warn(
        "process_overlay_pair is deprecated; use PasteOverlayOntoBackground",
        DeprecationWarning,
        stacklevel=2,
    )
    from PIL import Image

    overlay_path = Path(overlay_path)
    background_path = Path(background_path)
    if len(output_dirs) < 2:
        print(f"[overlay_pair] need 2 output dirs, got {len(output_dirs)}")
        return None
    img_dir, lbl_dir = Path(output_dirs[0]), Path(output_dirs[1])

    try:
        overlay = Image.open(overlay_path)
        if overlay.mode != "RGBA":
            overlay = overlay.convert("RGBA")
        background = Image.open(background_path).convert("RGB")
    except Exception as e:  # noqa: BLE001 — soft failure contract
        print(f"[overlay_pair] failed to read inputs: {e}")
        return None

    bg_w, bg_h = background.size
    if bg_w <= 0 or bg_h <= 0:
        return None

    composite = None
    label_line = None
    for _ in range(max_placement_attempts):
        scale = random.uniform(min_scale, max_scale)
        base = min(bg_w, bg_h) * scale
        ov_w, ov_h = overlay.size
        if ov_w <= 0 or ov_h <= 0:
            return None
        if ov_w >= ov_h:
            new_w = int(base)
            new_h = int(ov_h * (new_w / ov_w)) if ov_w else 0
        else:
            new_h = int(base)
            new_w = int(ov_w * (new_h / ov_h)) if ov_h else 0
        if new_w <= 0 or new_h <= 0:
            continue
        max_x, max_y = bg_w - new_w, bg_h - new_h
        if max_x < 0 or max_y < 0:
            continue
        px = random.randint(0, max_x)
        py = random.randint(0, max_y)
        canvas = background.copy()
        resized = overlay.resize((new_w, new_h), Image.LANCZOS)
        canvas.paste(resized, (px, py), resized)
        cx = (px + px + new_w) / 2.0 / bg_w
        cy = (py + py + new_h) / 2.0 / bg_h
        label_line = (
            f"{yolo_class_id} {cx:.6f} {cy:.6f} "
            f"{new_w / bg_w:.6f} {new_h / bg_h:.6f}"
        )
        composite = canvas
        break

    if composite is None or label_line is None:
        print(
            f"[overlay_pair] could not place {overlay_path.name} on "
            f"{background_path.name} after {max_placement_attempts} attempts"
        )
        return None

    img_out = img_dir / f"{overlay_path.stem}{background_path.suffix}"
    lbl_out = lbl_dir / f"{overlay_path.stem}.txt"
    saved: List[Path] = []
    try:
        composite.save(img_out)
        saved.append(img_out)
        lbl_out.write_text(label_line)
        saved.append(lbl_out)
        return saved
    except Exception as e:  # noqa: BLE001 — rollback partial outputs
        print(f"[overlay_pair] save failed: {e}")
        for p in saved:
            try:
                if p.exists():
                    p.unlink()
            except OSError:
                pass
        return None

"""YOLO label class-id remapping (host transform; the port's own copy of
image_processor_pipeline_tpu/transforms/labels.py).

Behavior parity: reference labels.py:7-65 — rewrite a label file line by
line, mapping class ids through ``cls_mapping`` (identity when absent),
returning None and removing the partial output on failure.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional


def change_label_class(
    input_path: Path,
    output_dirs: List[Path],
    cls_mapping: Dict[int, int] = None,
    **options: Any,
) -> Optional[Path]:
    cls_mapping = cls_mapping or {}
    input_path = Path(input_path)
    output_dir = Path(output_dirs[0])
    output_path = output_dir / input_path.name
    try:
        with input_path.open("r", encoding="utf-8") as src, \
                output_path.open("w", encoding="utf-8") as dst:
            for line in src:
                parts = line.strip().split()
                if not parts:
                    continue
                cur = int(parts[0])
                parts[0] = str(cls_mapping.get(cur, cur))
                dst.write(" ".join(parts) + "\n")
        return output_path
    except Exception as e:  # noqa: BLE001 — soft failure contract
        print(f"[labels] failed: {e}")
        if output_path.exists():
            output_path.unlink()
        return None

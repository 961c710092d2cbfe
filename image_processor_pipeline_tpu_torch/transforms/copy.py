"""File-copy host transforms (the port's own copy of
image_processor_pipeline_tpu/transforms/copy.py).

Behavior parity: reference copy.py:6-66 — copy2 image+label to two dirs
(returning None on IO failure), and single-file copy with mutually-exclusive
``suffix`` stem append / ``replace_params`` name substitution.
"""

from __future__ import annotations

import shutil
from pathlib import Path
from typing import Any, List, Optional, Tuple

from image_processor_pipeline_tpu_torch.utils.utils import validate_dirs


def copy_img_with_labels(
    input_image_path: Path,
    input_label_path: Path,
    output_dirs: List[Path],
    **options: Any,
) -> Optional[List[Path]]:
    """Copy an image and its label file to the two output dirs."""
    if len(output_dirs) < 2:
        raise ValueError(f"need 2 output dirs, got {output_dirs}")
    try:
        img_out = shutil.copy2(input_image_path, output_dirs[0])
        lbl_out = shutil.copy2(input_label_path, output_dirs[1])
        return [Path(img_out), Path(lbl_out)]
    except OSError as e:
        print(f"[copy] failed to copy: {e}")
        return None


def copy_files(
    input_file: Path,
    output_dirs: List[Path],
    suffix: str = None,
    replace_params: Tuple[str, str] = None,
    **options: Any,
) -> Optional[Path]:
    """Copy one file, optionally renaming by stem suffix or substring replace."""
    output_dir = validate_dirs(output_dirs, 1)
    input_file = Path(input_file)
    if suffix and replace_params:
        raise ValueError("suffix and replace_params are mutually exclusive")
    if suffix:
        target = output_dir / input_file.with_stem(f"{input_file.stem}_{suffix}").name
        out = shutil.copy2(input_file, target)
    elif replace_params:
        target = output_dir / input_file.name.replace(
            replace_params[0], replace_params[1]
        )
        out = shutil.copy2(input_file, target)
    else:
        out = shutil.copy2(input_file, output_dir)
    return Path(out)

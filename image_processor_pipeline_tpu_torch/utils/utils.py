"""Shared host-side utilities (the port's own copy of
image_processor_pipeline_tpu/utils/utils.py).

Behavioral parity targets: reference utils/utils.py:7-98 (check_path,
_validate_dirs, _save_crop_files).  Fresh implementations — the reference's
known defects (SURVEY.md §2.7) are intentionally not reproduced.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

PathLike = Union[str, Path]


def check_path(path: PathLike, root_dir: Optional[PathLike] = None) -> Path:
    """Resolve ``path`` against ``root_dir`` unless it is already absolute.

    Parity: reference utils/utils.py:7-37 and pipeline.py:92-111 (the two are
    duplicates there; here there is one implementation).
    """
    p = Path(path)
    if p.is_absolute():
        return p
    base = Path(root_dir) if root_dir is not None else Path.cwd()
    return base / p


def validate_dirs(
    output_dirs: Sequence[PathLike], nb_dirs: int = 1
) -> Union[Path, Tuple[Path, ...]]:
    """Require at least ``nb_dirs`` output directories.

    Returns a single Path when ``nb_dirs == 1``, else a tuple of the first
    ``nb_dirs`` paths.  Parity: reference utils/utils.py:39-65.
    """
    if output_dirs is None:
        raise ValueError("output_dirs is required")
    dirs = [Path(d) for d in output_dirs]
    if len(dirs) < nb_dirs:
        raise ValueError(
            f"expected at least {nb_dirs} output dir(s), got {len(dirs)}"
        )
    if nb_dirs == 1:
        return dirs[0]
    return tuple(dirs[:nb_dirs])


def format_yolo_lines(classes: np.ndarray, xywhn: np.ndarray) -> str:
    """Render YOLO label lines ``cls cx cy w h`` with 6-decimal coords.

    Bit-compatible with reference utils/utils.py:95-98 output format.
    """
    classes = np.asarray(classes).reshape(-1).astype(int)
    xywhn = np.asarray(xywhn, dtype=np.float64).reshape(-1, 4)
    lines = [
        f"{c} {b[0]:.6f} {b[1]:.6f} {b[2]:.6f} {b[3]:.6f}"
        for c, b in zip(classes, xywhn)
    ]
    return "\n".join(lines) + ("\n" if lines else "")


def save_yolo_pair(
    image: np.ndarray,
    classes: np.ndarray,
    xywhn: np.ndarray,
    image_path: Path,
    label_path: Path,
) -> List[Path]:
    """Write an image (RGB/RGBA uint8 HWC) and its YOLO label file.

    Parity: reference utils/utils.py:67-98 (_save_crop_files), which writes
    the image via cv2.imwrite and one label line per bbox.
    """
    from image_processor_pipeline_tpu_torch.io.images import encode_image

    image_path = Path(image_path)
    label_path = Path(label_path)
    image_path.parent.mkdir(parents=True, exist_ok=True)
    label_path.parent.mkdir(parents=True, exist_ok=True)
    encode_image(image, image_path)
    label_path.write_text(format_yolo_lines(classes, xywhn))
    return [image_path, label_path]


IMG_FORMATS = {
    "bmp", "dng", "jpeg", "jpg", "mpo", "png", "tif", "tiff", "webp", "pfm",
    "heic",
}
VID_FORMATS = {
    "asf", "avi", "gif", "m4v", "mkv", "mov", "mp4", "mpeg", "mpg", "ts",
    "wmv", "webm",
}


def is_image_file(path: PathLike) -> bool:
    return Path(path).suffix.lower().lstrip(".") in IMG_FORMATS


def is_video_file(path: PathLike) -> bool:
    return Path(path).suffix.lower().lstrip(".") in VID_FORMATS

"""YOLO label text IO, bit-compatible with the reference formats (the
port's own copy of image_processor_pipeline_tpu/io/labels.py).

Read parity: reference crop_square.py:39-68 (_read_bboxes via np.loadtxt →
int classes (N,), float xywhn (N, 4)).
Write parity: reference utils/utils.py:95-98 — one line per box,
``cls cx cy w h`` with 6-decimal floats.
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np

from image_processor_pipeline_tpu_torch.utils.utils import format_yolo_lines


def read_yolo_labels(path: Path) -> Tuple[np.ndarray, np.ndarray]:
    """Return (classes int64 [N], xywhn float32 [N, 4]).  N may be 0."""
    data = np.loadtxt(path, ndmin=2, dtype=np.float64)
    if data.size == 0:
        return np.zeros((0,), np.int64), np.zeros((0, 4), np.float32)
    if data.shape[1] != 5:
        raise ValueError(
            f"label file {path} has {data.shape[1]} columns, expected 5"
        )
    classes = data[:, 0].astype(np.int64)
    xywhn = data[:, 1:5].astype(np.float32)
    return classes, xywhn


def write_yolo_labels(path: Path, classes: np.ndarray, xywhn: np.ndarray) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(format_yolo_lines(classes, xywhn))
    return path

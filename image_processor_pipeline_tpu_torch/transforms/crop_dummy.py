"""Toy fixed-box crop (reference crop_dummy.py:5-8; port of
image_processor_pipeline_tpu/transforms/crop_dummy.py) — example transform
showing the minimal per-file contract.  Returns the cropped array rather
than saving (the reference returns a PIL image; same contract deviation)."""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np


def crop_image(input_path: Path, output_dirs=None, **options: Any) -> np.ndarray:
    from image_processor_pipeline_tpu_torch.io.images import decode_image

    arr = decode_image(Path(input_path))
    return arr[100:400, 100:400]

"""Image file helpers of the reference: Pillow decode and JPEG encode in
memory, and the square canvas a rotation is drawn on."""

from __future__ import annotations

import io
import math

import numpy as np
from PIL import Image

#: canvas sides: multiples of 128 up to 1024, then of 512
_LADDER = (128, 256, 384, 512, 640, 768, 896, 1024)


def canvas_side(n: int) -> int:
    """The smallest ladder side that holds ``n`` pixels."""
    for v in _LADDER:
        if n <= v:
            return v
    return int(math.ceil(n / 512) * 512)


def decode(data: bytes, mode=None) -> np.ndarray:
    """uint8 [H, W, C] pixels of an image file's bytes, converted to
    ``mode`` (its own bands when None)."""
    with Image.open(io.BytesIO(data)) as im:
        if mode is not None and im.mode != mode:
            im = im.convert(mode)
        arr = np.asarray(im)
    return arr if arr.ndim == 3 else arr[..., None]


def encode_jpeg(arr: np.ndarray, quality: int) -> bytes:
    """Pillow's baseline JPEG of the RGB bands of ``arr`` at ``quality``
    (its default 4:2:0 chroma)."""
    im = Image.fromarray(np.ascontiguousarray(arr[..., :3]))
    buf = io.BytesIO()
    im.save(buf, format="JPEG", quality=quality)
    return buf.getvalue()

"""Reference of the colour mask into transparency: the image's 8-bit
BGR pixels converted to HSV as OpenCV's ``cvtColor(COLOR_BGR2HSV)`` does
on 8-bit data, each exclusion range tested as ``inRange`` does (bounds
rounded and saturated to 0-255, both ends inclusive), the tests OR-ed and
inverted into alpha (0 where any range holds, 255 elsewhere); the RGB
kept as decoded; written as an RGBA PNG named ``{stem}.png``.

OpenCV's 8-bit conversion, as its source documents it: V = max(R, G, B),
d = V - min(R, G, B); S = d * 255 / V and H = 30 * (sector offset) / d,
each as a product with a table of 2**12-scaled reciprocals, rounded half
up (the tables themselves rounded half to even); H wraps at 180.
"""

from __future__ import annotations

import io
from pathlib import Path

import numpy as np
import torch
from PIL import Image

from port_bench.reference.images import decode

#: OpenCV's fixed-point shift for the 8-bit HSV conversion
SHIFT = 12
_I = np.arange(256, dtype=np.float64)
#: round((255 << 12) / i) and round((180 << 12) / (6 i)), 0 at i = 0
S_TABLE = np.where(_I > 0, np.round((255 << SHIFT) / np.maximum(_I, 1)),
                   0).astype(np.int64)
H_TABLE = np.where(_I > 0, np.round((180 << SHIFT) / (6 * np.maximum(_I, 1))),
                   0).astype(np.int64)
_OPTIONS = {"color_ranges_to_exclude_hsv"}


def hsv8(rgb: np.ndarray, dtype=torch.float32) -> np.ndarray:
    """uint8 [..., 3] H (0-180), S, V of uint8 RGB [..., 3].  At float32
    (the stated precision: OpenCV's integer arithmetic) the products are
    exact integers; any other ``dtype`` computes them in that type (the
    control)."""
    x = torch.as_tensor(np.asarray(rgb, np.int64))
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    d = v - torch.minimum(torch.minimum(r, g), b)
    h = torch.where(v == r, g - b,
                    torch.where(v == g, b - r + 2 * d, r - g + 4 * d))
    st, ht = torch.as_tensor(S_TABLE)[v], torch.as_tensor(H_TABLE)[d]
    half = 1 << (SHIFT - 1)
    if dtype == torch.float32:
        s = (d * st + half) >> SHIFT
        h = (h * ht + half) >> SHIFT
    else:
        scale = float(1 << SHIFT)
        s = torch.floor((d.to(dtype) * st.to(dtype) + half) / scale).long()
        h = torch.floor((h.to(dtype) * ht.to(dtype) + half) / scale).long()
    h = torch.where(h < 0, h + 180, h)
    return torch.stack([h, s, v], -1).clamp(0, 255).to(torch.uint8).numpy()


def in_range(hsv: np.ndarray, lower, upper) -> np.ndarray:
    """Bool [...]: every channel within [lower, upper], the bounds rounded
    half to even and saturated to 0-255 as inRange casts them."""
    lo = np.clip(np.rint(np.asarray(lower, np.float64)), 0, 255)
    hi = np.clip(np.rint(np.asarray(upper, np.float64)), 0, 255)
    x = np.asarray(hsv, np.uint8)
    return np.all((x >= lo.astype(np.uint8)) & (x <= hi.astype(np.uint8)),
                  axis=-1)


def mask_alpha(rgb: np.ndarray, ranges, dtype=torch.float32) -> np.ndarray:
    """uint8 [H, W] alpha: 0 where a range holds the pixel, else 255."""
    hsv = hsv8(rgb, dtype)
    hit = np.zeros(rgb.shape[:2], bool)
    for f in ranges:
        hit |= in_range(hsv, f[:3], f[3:])
    return np.where(hit, 0, 255).astype(np.uint8)


def encode_png(arr: np.ndarray) -> bytes:
    """A PNG of ``arr``, stored uncompressed: the reference's files are
    only decoded again, never kept."""
    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(arr)).save(buf, format="PNG",
                                                    compress_level=0)
    return buf.getvalue()


def outputs(names, options):
    """(output dir index, file name) of what an item writes."""
    return [(0, f"{Path(names[0]).stem}.png")]


def apply(inputs, seed: int, options, dtype=torch.float32):
    """{(dir, name): bytes} for one item; ``inputs``: [(name, bytes)]."""
    if not set(options) <= _OPTIONS:
        raise ValueError(f"the reference holds the options {sorted(_OPTIONS)}"
                         f" only, not {sorted(set(options) - _OPTIONS)}")
    (name, data), = inputs[:1]
    rgb = decode(data, "RGB")
    alpha = mask_alpha(rgb, options["color_ranges_to_exclude_hsv"], dtype)
    rgba = np.concatenate([rgb, alpha[..., None]], -1)
    return {(0, f"{Path(name).stem}.png"): encode_png(rgba)}

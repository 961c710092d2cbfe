"""Reference of the random rotations by the shear method.

Each image, as RGBA with an opaque alpha, is centred on a square canvas
that holds its diagonal, turned by ``num_rotations`` angles drawn
uniformly in [angle_min, angle_max), cut to the box of its opaque pixels
and written as a q75 JPEG (``{stem}_r001`` ...); the input itself is
written again at q75 as ``{stem}_r000``.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from port_bench.reference import draws, shear
from port_bench.reference.images import canvas_side, decode, encode_jpeg


def _suffix(options) -> str:
    fmt = str(options.get("output_format", "png")).lower()
    return ".jpg" if fmt == "jpeg" else f".{fmt}"


def outputs(names, options):
    """(output dir index, file name) of what an item writes."""
    stem, sfx = Path(names[0]).stem, _suffix(options)
    n = int(options.get("num_rotations", 10))
    first = 0 if options.get("include_original", True) else 1
    return [(0, f"{stem}_r{i:03d}{sfx}") for i in range(first, n + 1)]


def apply(inputs, seed: int, options, dtype=torch.float32):
    """{(dir, name): bytes} for one item; ``inputs``: [(name, bytes)]."""
    if str(options.get("method")) != "shear" or _suffix(options) != ".jpg":
        raise ValueError("the reference holds the shear method with JPEG "
                         "outputs only")
    (name, data), = inputs
    rgba = decode(data, "RGBA")
    h, w = rgba.shape[:2]
    n = int(options.get("num_rotations", 10))
    angles = draws.uniform(draws.prng_key(np.uint32(seed)), (n,),
                           float(options.get("angle_min", 1.0)),
                           float(options.get("angle_max", 359.0)))
    side = canvas_side(int(math.ceil(math.hypot(h, w))))
    canvas = np.zeros((side, side, 4), np.uint8)
    top, left = (side - h) // 2, (side - w) // 2
    canvas[top:top + h, left:left + w] = rgba
    batch = torch.from_numpy(canvas)[None].expand(n, -1, -1, -1).contiguous()
    turned = shear.rotate(batch, *shear.shear_params(angles, side, dtype))
    turned = turned.numpy()
    names = [nm for _, nm in outputs((name,), options)]
    out = {}
    if options.get("include_original", True):
        out[(0, names.pop(0))] = encode_jpeg(rgba, 75)
    for img, nm in zip(turned, names):
        opaque = img[..., 3] != 0
        rows, cols = np.flatnonzero(opaque.any(1)), np.flatnonzero(opaque.any(0))
        img = img[rows[0]:rows[-1] + 1, cols[0]:cols[-1] + 1]
        out[(0, nm)] = encode_jpeg(img, 75)
    return out

"""Reference of the square crop around an image's boxes.

The crop's side is the image's shorter side; its offset is drawn
uniformly among those whose square holds the union of the boxes (the
bounds truncated to integers); each box is moved into the crop, clipped
to it and kept where it keeps an area; the crop is written as a q95 JPEG
and the boxes as YOLO lines with six decimals.
"""

from __future__ import annotations

import io
from pathlib import Path

import numpy as np
import torch

from port_bench.reference import draws
from port_bench.reference.images import decode, encode_jpeg

#: boxes that constrain the placement (the rest are ignored)
MAX_BOXES = 64


def outputs(names, options):
    """(output dir index, file name) of what an item writes."""
    return [(0, Path(names[0]).name), (1, Path(names[1]).name)]


def _labels(text: str):
    data = np.loadtxt(io.StringIO(text), ndmin=2, dtype=np.float64)
    return data[:, 0].astype(np.int64), data[:, 1:5].astype(np.float32)


def apply(inputs, seed: int, options, dtype=torch.float32):
    """{(dir, name): bytes} for one item; ``inputs``: [(name, bytes)] of
    its image and its label file; ``seed``: the item's seed."""
    (img_name, img_bytes), (lbl_name, lbl_bytes) = inputs
    rgb = decode(img_bytes, "RGB")
    h, w = rgb.shape[:2]
    classes, xywhn = _labels(lbl_bytes.decode())
    classes, xywhn = classes[:MAX_BOXES], xywhn[:MAX_BOXES]
    kx, ky = draws.split(draws.prng_key(np.uint32(seed)))

    xy = torch.as_tensor(xywhn).to(dtype)
    wf = torch.tensor(float(w), dtype=dtype)
    hf = torch.tensor(float(h), dtype=dtype)
    cx, cy, bw, bh = xy.unbind(-1)
    boxes = torch.stack([wf * (cx - bw / 2), hf * (cy - bh / 2),
                         wf * (cx + bw / 2), hf * (cy + bh / 2)], -1)
    s = min(h, w)
    sf = torch.tensor(float(s), dtype=dtype)
    lo_x = max(0, int((boxes[:, 2].max() - sf).to(torch.int32)))
    hi_x = min(int(boxes[:, 0].min().to(torch.int32)), w - s)
    lo_y = max(0, int((boxes[:, 3].max() - sf).to(torch.int32)))
    hi_y = min(int(boxes[:, 1].min().to(torch.int32)), h - s)
    if lo_x > hi_x or lo_y > hi_y:
        raise ValueError(f"{img_name}: no square crop holds its boxes")
    x0 = int(draws.randint(kx, (), lo_x, hi_x + 1))
    y0 = int(draws.randint(ky, (), lo_y, hi_y + 1))

    off = torch.tensor([x0, y0, x0, y0], dtype=dtype)
    moved = torch.minimum(torch.maximum(boxes - off, torch.zeros((), dtype=dtype)), sf)
    keep = (moved[:, 0] < moved[:, 2]) & (moved[:, 1] < moved[:, 3])
    x1, y1, x2, y2 = moved.unbind(-1)
    out = torch.stack([((x1 + x2) / 2) / sf, ((y1 + y2) / 2) / sf,
                       (x2 - x1) / sf, (y2 - y1) / sf], -1)
    lines = [f"{c} " + " ".join(f"{v:.6f}" for v in row)
             for c, row in zip(classes[keep.numpy()].tolist(),
                               out[keep].to(torch.float64).tolist())]
    text = "\n".join(lines) + ("\n" if lines else "")
    return {(0, Path(img_name).name):
            encode_jpeg(rgb[y0:y0 + s, x0:x0 + s], 95),
            (1, Path(lbl_name).name): text.encode()}

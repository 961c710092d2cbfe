"""Seeded YOLO datasets of textured JPEGs.

Each image is a field of 1/f noise (amplitude falling as the inverse of
the spatial frequency, as in photographs), with correlated colour, and
one filled rectangle of another texture and tint a box.  Its label file
holds those boxes as YOLO lines (class, centre, size, normalised, six
decimals).  The textures are drawn on ``device`` by a ``torch.Generator``
in a few large calls; the host only encodes the JPEGs (Pillow, on
``workers`` threads) and writes them.

Parameters (the traffic file's ``dataset`` object): ``width``,
``height``, ``quality``, ``boxes`` [min, max], ``classes``,
``box_centre`` [lo, hi], ``box_width`` and ``box_height`` [lo, hi]
(fractions of the image's sides), ``slope`` (of the amplitude spectrum),
``contrast`` (grey levels of one standard deviation) and ``chroma`` (the
colour fields' share of it).
"""

from __future__ import annotations

import math
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
from PIL import Image

#: images drawn on the device in one call
CHUNK = 32


def draw_boxes(rng, n: int, p):
    """Per image: (classes [k] int, boxes [k, 4] float cx, cy, w, h)."""
    out = []
    lo, hi = p["boxes"]
    for _ in range(n):
        k = int(rng.integers(lo, hi + 1))
        cls = rng.integers(0, p["classes"], k)
        box = np.stack([rng.uniform(*p["box_centre"], k),
                        rng.uniform(*p["box_centre"], k),
                        rng.uniform(*p["box_width"], k),
                        rng.uniform(*p["box_height"], k)], -1)
        out.append((cls, box))
    return out


def _fields(gen, n: int, H: int, W: int, slope: float, device):
    """[n, 3, H, W] float32 fields of 1/f**slope noise, each of unit
    standard deviation."""
    fy = torch.fft.fftfreq(H, device=device)[:, None]
    fx = torch.fft.rfftfreq(W, device=device)[None, :]
    f = torch.sqrt(fy * fy + fx * fx)
    amp = torch.where(f > 0, f.clamp(min=1.0 / max(H, W)) ** -slope,
                      torch.zeros((), device=device))
    shape = (n, 3, H, W // 2 + 1)
    re = torch.randn(shape, generator=gen, device=device)
    im = torch.randn(shape, generator=gen, device=device)
    field = torch.fft.irfft2(torch.complex(re, im) * amp, s=(H, W))
    return field / field.std(dim=(-2, -1), keepdim=True)


def _colour(fields, base, contrast: float, chroma: float):
    """RGB [n, H, W, 3] float from three fields (luma, two chroma) and a
    base colour [n, 3]."""
    lum, c1, c2 = fields[:, 0], fields[:, 1], fields[:, 2]
    rgb = torch.stack([lum + chroma * c1,
                       lum - chroma * (0.5 * c1 - 0.87 * c2),
                       lum - chroma * (0.5 * c1 + 0.87 * c2)], -1)
    return base[:, None, None, :] + contrast * rgb


def draw_images(gen, boxes, p, device):
    """uint8 [n, H, W, 3] images on the host for the boxes of each."""
    H, W = p["height"], p["width"]
    n = len(boxes)
    out = np.empty((n, H, W, 3), np.uint8)
    ys = torch.arange(H, device=device, dtype=torch.float32)[:, None] + 0.5
    xs = torch.arange(W, device=device, dtype=torch.float32)[None, :] + 0.5
    for lo in range(0, n, CHUNK):
        part = boxes[lo:lo + CHUNK]
        m = len(part)
        fields = _fields(gen, 2 * m, H, W, p["slope"], device)
        tints = 40 + 176 * torch.rand((2 * m, 3), generator=gen,
                                      device=device)
        img = _colour(fields[:m], tints[:m], p["contrast"], p["chroma"])
        obj = _colour(fields[m:], tints[m:], p["contrast"], p["chroma"])
        for i, (_, box) in enumerate(part):
            for cx, cy, bw, bh in box:
                inside = ((xs >= (cx - bw / 2) * W) & (xs < (cx + bw / 2) * W)
                          & (ys >= (cy - bh / 2) * H)
                          & (ys < (cy + bh / 2) * H))
                img[i] = torch.where(inside[..., None], obj[i], img[i])
        out[lo:lo + m] = img.round().clamp(0, 255).to(torch.uint8).cpu() \
            .numpy()
    return out


def label_text(classes, boxes) -> str:
    return "".join(f"{c} {b[0]:.6f} {b[1]:.6f} {b[2]:.6f} {b[3]:.6f}\n"
                   for c, b in zip(classes.tolist(), boxes.tolist()))


def make(root: Path, n: int, groups: int, seed: int, p, device,
         workers: int):
    """``n`` images and labels under ``root``, split into ``groups``
    directory pairs ``root/<g>/imgs``, ``root/<g>/labels`` of n // groups
    files each (``im_0000.jpg`` ...).  Returns the pairs and the mean
    JPEG size in bytes."""
    rng = np.random.default_rng([seed, 1])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    boxes = draw_boxes(rng, n, p)
    per = n // groups
    dirs = []
    for g in range(groups):
        imgs, labels = root / str(g) / "imgs", root / str(g) / "labels"
        imgs.mkdir(parents=True)
        labels.mkdir(parents=True)
        dirs.append((imgs, labels))
    sizes = []

    def write(job):
        arr, path = job
        Image.fromarray(arr).save(path, quality=p["quality"], subsampling=2)
        return path.stat().st_size

    with ThreadPoolExecutor(max(1, workers)) as ex:
        for lo in range(0, n, 4 * CHUNK):
            part = boxes[lo:lo + 4 * CHUNK]
            arrs = draw_images(gen, part, p, device)
            jobs = []
            for j, (arr, (cls, box)) in enumerate(zip(arrs, part)):
                i = lo + j
                imgs, labels = dirs[min(i // per, groups - 1)]
                (labels / f"im_{i:04d}.txt").write_text(label_text(cls, box))
                jobs.append((arr, imgs / f"im_{i:04d}.jpg"))
            sizes += list(ex.map(write, jobs))
    return dirs, float(np.mean(sizes)) if sizes else math.nan

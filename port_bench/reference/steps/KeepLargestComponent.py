"""Reference of the isolated-pixel cleanup: the RGBA PNG's foreground
(alpha > 1) split into 8-connected components, every component but the
largest made transparent (of two of one size, the one whose first pixel
in raster order comes first), then the image cropped to the box of its
remaining opaque pixels; written as an RGBA PNG under the input's name.
The upstream's defaults: ``keep_large_components`` off, so
``min_component_size`` plays no part.

The labelling is a scan-line union-find over runs: each row's runs of
foreground are found at once, each run is joined with every run of the
row above that it touches (8-connected: their column spans, widened by
one on each side, overlap), and a run's component is its root.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from port_bench.reference.images import decode
from port_bench.reference.steps.ColorMaskTransparency import encode_png

_OPTIONS = {"min_component_size"}


def runs(fg: np.ndarray):
    """(row, start, end) int arrays of the foreground runs of bool [H, W],
    in raster order, ``end`` exclusive."""
    H, W = fg.shape
    p = np.zeros((H, W + 2), np.int8)
    p[:, 1:-1] = fg
    d = np.diff(p, axis=1)
    row, start = np.nonzero(d == 1)
    _, end = np.nonzero(d == -1)
    return row, start, end


def _find(parent, i):
    root = i
    while parent[root] != root:
        root = parent[root]
    while parent[i] != root:
        parent[i], i = root, parent[i]
    return root


def run_components(fg: np.ndarray):
    """(row, start, end, component) of the foreground runs: ``component``
    numbers each run's 8-connected component 0, 1, ... in the raster order
    of the components' first pixels."""
    row, start, end = runs(fg)
    n = len(row)
    parent = list(range(n))
    first = np.searchsorted(row, np.arange(fg.shape[0] + 1))
    st, en = start.tolist(), end.tolist()
    for r in range(1, fg.shape[0]):
        i, i_end = int(first[r - 1]), int(first[r])
        j, j_end = int(first[r]), int(first[r + 1])
        while i < i_end and j < j_end:
            if st[j] <= en[i] and st[i] <= en[j]:
                a, b = _find(parent, i), _find(parent, j)
                if a != b:
                    parent[max(a, b)] = min(a, b)
            if en[i] < en[j]:
                i += 1
            else:
                j += 1
    roots = np.array([_find(parent, i) for i in range(n)], np.int64)
    # roots are each component's first run; number them in that order
    _, comp = np.unique(roots, return_inverse=True)
    return row, start, end, comp.reshape(-1)


def labels(fg: np.ndarray) -> np.ndarray:
    """int32 [H, W]: each foreground pixel's component number, -1 off it."""
    H, W = fg.shape
    row, start, end, comp = run_components(fg)
    out = np.full(H * W, -1, np.int32)
    length = end - start
    base = np.repeat(row * W + start - np.cumsum(length) + length, length)
    out[base + np.arange(length.sum())] = np.repeat(comp, length)
    return out.reshape(H, W)


def keep_mask(fg: np.ndarray) -> np.ndarray:
    """Bool [H, W]: the pixels of the largest component."""
    H, W = fg.shape
    row, start, end, comp = run_components(fg)
    if not len(row):
        return np.zeros_like(fg)
    sizes = np.bincount(comp, weights=end - start)
    # the first maximum: components are numbered in raster order
    on = comp == int(np.argmax(sizes))
    edge = np.zeros((H, W + 1), np.int32)
    np.add.at(edge, (row[on], start[on]), 1)
    np.add.at(edge, (row[on], end[on]), -1)
    return np.cumsum(edge, axis=1)[:, :W] > 0


def outputs(names, options):
    """(output dir index, file name) of what an item writes."""
    return [(0, Path(names[0]).name)]


def apply(inputs, seed: int, options, dtype=torch.float32):
    """{(dir, name): bytes} for one item; ``inputs``: [(name, bytes)] of
    an RGBA PNG.  ``dtype`` changes nothing: the step is integer work."""
    if not set(options) <= _OPTIONS:
        raise ValueError(f"the reference holds the options {sorted(_OPTIONS)}"
                         f" only, not {sorted(set(options) - _OPTIONS)}")
    (name, data), = inputs
    if Path(name).suffix.lower() != ".png":
        raise ValueError(f"{name} is not a PNG")
    rgba = decode(data)
    if rgba.shape[2] != 4:
        raise ValueError(f"{name} has no alpha channel")
    alpha = rgba[..., 3]
    keep = keep_mask(alpha > 1)
    alpha = np.where(keep, alpha, 0).astype(np.uint8)
    ys, xs = np.nonzero(alpha)
    if not len(ys):
        raise ValueError(f"no opaque pixels remain in {name}")
    out = np.concatenate([rgba[..., :3], alpha[..., None]], -1)
    out = out[ys.min():ys.max() + 1, xs.min():xs.max() + 1]
    return {(0, Path(name).name): encode_png(out)}

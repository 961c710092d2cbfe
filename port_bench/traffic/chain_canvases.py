"""Seeded batches for the augment chain: uint8 canvases drawn on the card
by a ``torch.Generator`` (one call a batch), and a YOLO-like box an image
drawn on the host, its centre uniform in ``box_centre`` and its sides in
``box_side`` (fractions of the canvas).  The chain's work does not depend
on the pixels' values, so they are uniform noise.

Parameters (the traffic file): ``batch``, ``canvas`` (side), ``channels``,
``pool_batches``, ``box_centre`` [lo, hi], ``box_side`` [lo, hi].
"""

from __future__ import annotations

import numpy as np
import torch


def make(seed: int, p, device):
    """(canvases: list of ``pool_batches`` uint8 [B, S, S, C] tensors on
    ``device``, boxes: float32 [pool_batches, B, 4] cx, cy, w, h)."""
    B, S, C = p["batch"], p["canvas"], p["channels"]
    n = p["pool_batches"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    canvases = [torch.randint(0, 256, (B, S, S, C), generator=gen,
                              device=device, dtype=torch.uint8)
                for _ in range(n)]
    rng = np.random.default_rng([seed, 2])
    boxes = np.concatenate([rng.uniform(*p["box_centre"], (n, B, 2)),
                            rng.uniform(*p["box_side"], (n, B, 2))],
                           -1).astype(np.float32)
    return canvases, boxes

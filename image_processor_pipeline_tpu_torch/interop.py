"""Carries the flagship chain's state across from the JAX package.

The chain has no weights.  Its state is the per-item draws (crop offsets,
angles, flip codes, enhance parameters) and the static HSV filter stack.
``draws_from_jax`` takes the JAX package's arrays as numpy and returns the
port's tensors; ``shifts_from_jax`` does the same for the rotation's shift
vectors, so a kernel can be held against the JAX package given its own
vectors; ``filter_stack`` rounds the filter bounds the way cv2.inRange and
ops/pallas/augment.py:602-605 do.  Nothing here imports jax.
"""

from __future__ import annotations

import numpy as np
import torch


def draws_from_jax(y0, x0, angles, flips, prms, device="cpu"):
    """(y0, x0, angles, flips, prms) as (int32 [B], int32 [B], float32 [B],
    int32 [B], float32 [B, 8]) tensors on ``device``."""
    def put(a, dtype):
        return torch.as_tensor(np.asarray(a).astype(dtype), device=device)

    return (put(y0, np.int32), put(x0, np.int32), put(angles, np.float32),
            put(flips, np.int32), put(prms, np.float32))


def shifts_from_jax(quad, sh1, sh2, device="cpu"):
    """The JAX package's (quad [B], sh1 [B, S], sh2 [B, S]) shift vectors
    as int32 tensors on ``device``, in the form the port's rotations take."""
    return tuple(torch.as_tensor(np.asarray(a).astype(np.int32),
                                 device=device) for a in (quad, sh1, sh2))


def _sat(v) -> int:
    """cv2.inRange's saturate-cast of a bound to uint8: round half to even
    (cvRound, like python's round), clamped to [0, 255]."""
    return int(min(255, max(0, round(float(v)))))


def filter_stack(lowers, uppers, zones):
    """(lowers [F, 3], uppers [F, 3], zones [F, 4]) as int32 CPU tensors,
    the bounds saturate-rounded so integer compares equal cv2.inRange."""
    lo = torch.tensor([[_sat(v) for v in row] for row in lowers],
                      dtype=torch.int32)
    hi = torch.tensor([[_sat(v) for v in row] for row in uppers],
                      dtype=torch.int32)
    zn = torch.tensor([[int(v) for v in row] for row in zones],
                      dtype=torch.int32)
    if not (lo.shape == hi.shape and lo.ndim == 2 and lo.shape[1] == 3
            and zn.shape == (lo.shape[0], 4)):
        raise ValueError("filters need lowers/uppers [F, 3] and zones [F, 4]")
    return lo, hi, zn

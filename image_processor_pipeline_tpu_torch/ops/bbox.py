"""YOLO bbox math on float32 tensors (twin of
image_processor_pipeline_tpu/ops/bbox.py)."""

from __future__ import annotations

import torch


def xywhn2xyxy(x, w, h, padw=0.0, padh=0.0):
    """Normalized center xywh [..., 4] -> absolute corner xyxy [..., 4],
    float32, in the JAX function's operation order (ultralytics semantics:
    x1 = w*(cx - bw/2) + padw, etc.)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    w = torch.as_tensor(w, dtype=torch.float32, device=x.device)
    h = torch.as_tensor(h, dtype=torch.float32, device=x.device)
    cx, cy, bw, bh = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    x1 = w * (cx - bw / 2) + padw
    y1 = h * (cy - bh / 2) + padh
    x2 = w * (cx + bw / 2) + padw
    y2 = h * (cy + bh / 2) + padh
    return torch.stack([x1, y1, x2, y2], dim=-1)


def xyxy2xywhn(x, w, h, clip=False, eps=0.0):
    """Absolute corner xyxy [..., 4] -> normalized center xywh [..., 4].
    ``w``/``h``: tensors that broadcast against ``x[..., 0]`` (a tensor
    divisor gives the IEEE quotient on every device)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    w = torch.as_tensor(w, dtype=torch.float32, device=x.device)
    h = torch.as_tensor(h, dtype=torch.float32, device=x.device)
    if clip:
        x = clip_boxes(x, (h - eps, w - eps))
    x1, y1, x2, y2 = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    cx = ((x1 + x2) / 2) / w
    cy = ((y1 + y2) / 2) / h
    bw = (x2 - x1) / w
    bh = (y2 - y1) / h
    return torch.stack([cx, cy, bw, bh], dim=-1)


def clip_boxes(boxes, shape):
    """Clip xyxy boxes to image shape (h, w); h and w are numbers or
    tensors that broadcast against ``boxes[..., 0]``."""
    boxes = torch.as_tensor(boxes, dtype=torch.float32)
    h, w = (torch.as_tensor(v, dtype=torch.float32, device=boxes.device)
            for v in shape)
    zero = torch.zeros((), dtype=torch.float32, device=boxes.device)
    x1 = torch.minimum(torch.maximum(boxes[..., 0], zero), w)
    y1 = torch.minimum(torch.maximum(boxes[..., 1], zero), h)
    x2 = torch.minimum(torch.maximum(boxes[..., 2], zero), w)
    y2 = torch.minimum(torch.maximum(boxes[..., 3], zero), h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def shift_boxes(boxes, dx, dy):
    """Translate xyxy boxes [..., N, 4] by (-dx, -dy) into a crop frame;
    ``dx``/``dy`` have the boxes' leading shape [...]."""
    boxes = torch.as_tensor(boxes, dtype=torch.float32)
    dx = torch.as_tensor(dx, dtype=torch.float32, device=boxes.device)
    dy = torch.as_tensor(dy, dtype=torch.float32, device=boxes.device)
    offset = torch.stack([dx, dy, dx, dy], dim=-1)
    return boxes - offset[..., None, :]


def valid_boxes(boxes, min_size=1.0):
    """Validity mask for xyxy boxes [..., 4]: an extent of at least
    ``min_size`` on both axes, (x2 - x1 >= min_size) & (y2 - y1 >=
    min_size), the elementwise test the reference meant
    (crop_square.py:210)."""
    boxes = torch.as_tensor(boxes, dtype=torch.float32)
    return ((boxes[..., 2] - boxes[..., 0]) >= min_size) & (
        (boxes[..., 3] - boxes[..., 1]) >= min_size)


def union_box(boxes, mask=None):
    """Union (enclosing) xyxy box over the boxes axis (-2) of [..., N, 4].

    With ``mask`` (bool [..., N]), ignored boxes don't affect the union.
    Used for the square-crop placement bounds."""
    boxes = torch.as_tensor(boxes, dtype=torch.float32)
    big = 1e9
    if mask is not None:
        m = mask[..., None]
        mins = torch.where(m, boxes, big)
        maxs = torch.where(m, boxes, -big)
    else:
        mins = maxs = boxes
    x1 = mins[..., 0].amin(dim=-1)
    y1 = mins[..., 1].amin(dim=-1)
    x2 = maxs[..., 2].amax(dim=-1)
    y2 = maxs[..., 3].amax(dim=-1)
    return torch.stack([x1, y1, x2, y2], dim=-1)

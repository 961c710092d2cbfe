"""Connected-component labeling and isolated-pixel cleanup (twin of
image_processor_pipeline_tpu/ops/ccl.py:32-152), batched over [B, H, W].

Parity target: reference pixels_isolés.py:8-81 — binarize alpha > 1,
8-connected components (cv2.connectedComponentsWithStats), keep the largest
component, then tight-crop to the surviving alpha bbox.

The labeling is the JAX package's: iterative min-label propagation (each
pixel takes the min label of its 8-neighbourhood) interleaved with pointer
jumping (label ← label[label], a gather), which converges in
O(log geodesic diameter) sweeps.  A label is the linear index, within its
own image, of a pixel of the same component; the fixed point is the
component's smallest index, so it does not depend on how many sweeps ran.

The JAX loop is a ``lax.while_loop`` whose end depends on the data; here
the whole batch is swept until no item changes, and the host reads the
"changed" flag back every ``CHECK_EVERY`` sweeps (each read-back
synchronises a CUDA stream).  Sweeps past an item's fixed point change
nothing, and its sweep count is kept on the device, so the result and the
counts are those of the per-item loop.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from image_processor_pipeline_tpu_torch.ops import geometry

_INF = 2 ** 30
#: sweeps between two looks of the host at the batch's "changed" flag
CHECK_EVERY = 4


def _neighbor_min(lbl, fg):
    """Min label over the 8-neighbourhood (edges excluded), masked to fg."""
    H, W = lbl.shape[-2:]
    cur = lbl
    padded = F.pad(lbl, (1, 1, 1, 1), value=_INF)
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            if dy == 1 and dx == 1:
                continue
            cur = torch.minimum(cur, padded[..., dy:dy + H, dx:dx + W])
    return torch.where(fg, cur, _INF)


def _pointer_jump(lbl):
    """label ← label[label] within each image: every label is the linear
    index of a same-component pixel whose own label is <= it, so one gather
    halves the remaining chain length."""
    flat = lbl.flatten(-2)
    inside = flat < _INF
    safe = torch.where(inside, flat, 0).long()
    new = torch.where(inside, torch.gather(flat, -1, safe), _INF)
    return new.reshape(lbl.shape)


def label_components(fg, max_iters: int = 4096, return_iters: bool = False):
    """8-connected component labels for bool masks [..., H, W].

    Returns int32 [..., H, W]: for foreground pixels the min linear index
    (within the image) of their component, _INF for background.
    ``return_iters=True`` appends each image's number of sweep rounds
    (int32 [...]), the last, unchanged one included, as the JAX loop
    counts them.  At most ``max_iters`` sweeps run; the host looks at the
    batch's "changed" flag after every ``CHECK_EVERY`` of them.
    """
    H, W = fg.shape[-2:]
    lin = torch.arange(H * W, dtype=torch.int32,
                       device=fg.device).reshape(H, W)
    lbl = torch.where(fg, lin, _INF)
    active = torch.ones(fg.shape[:-2], dtype=torch.bool, device=fg.device)
    iters = torch.zeros(fg.shape[:-2], dtype=torch.int32, device=fg.device)
    done = 0
    while done < max_iters:
        # two jumps per sweep: labels hop along already-discovered chains
        new = _pointer_jump(_pointer_jump(_neighbor_min(lbl, fg)))
        iters = iters + active
        active = active & (new != lbl).flatten(-2).any(-1)
        lbl = new
        done += 1
        if (done % CHECK_EVERY == 0 or done == max_iters) \
                and not bool(active.any()):
            break
    if return_iters:
        return lbl, iters
    return lbl


def component_sizes(labels, H: int, W: int):
    """Histogram of component sizes indexed by root linear index:
    int32 [..., H*W] (an integer scatter-add, exact in any order)."""
    flat = labels.flatten(-2)
    inside = flat < _INF
    idx = torch.where(inside, flat, 0).long()
    sizes = torch.zeros(flat.shape[:-1] + (H * W,), dtype=torch.int32,
                        device=labels.device)
    return sizes.scatter_add_(-1, idx, inside.to(torch.int32))


def first_argmax(values):
    """Index of the first maximum along the last axis, as ``jnp.argmax``
    takes it: the smallest index where the maximum sits, on any device."""
    n = values.shape[-1]
    top = values.amax(-1, keepdim=True)
    index = torch.arange(n, device=values.device)
    return torch.where(values == top, index, n).amin(-1)


def keep_largest_component(rgba, h, w, min_component_size: int = 500,
                           alpha_threshold: int = 1,
                           keep_large_components: bool = False):
    """Zero the alpha of every component except the largest (of two
    components of one size, the one whose root index is smaller).

    rgba: uint8 [B, H, W, 4]; h, w: [B] or numbers.  Foreground = alpha >
    ``alpha_threshold`` inside the valid region (reference
    pixels_isolés.py:35-55 keeps ONLY the largest component);
    ``keep_large_components=True`` additionally keeps non-largest
    components >= min_component_size.
    """
    H, W = rgba.shape[-3], rgba.shape[-2]
    dev = rgba.device
    alpha = rgba[..., 3]
    fg = (alpha > alpha_threshold) & geometry.valid_mask(
        geometry.item_extent(h, dev), geometry.item_extent(w, dev), H, W,
        device=dev)
    labels = label_components(fg)
    sizes = component_sizes(labels, H, W)
    largest_root = first_argmax(sizes)
    keep = fg & (labels == largest_root[..., None, None])
    if keep_large_components:
        flat = labels.flatten(-2)
        safe = torch.where(flat < _INF, flat, 0).long()
        px_size = torch.gather(sizes, -1, safe).reshape(labels.shape)
        keep = keep | (fg & (px_size >= min_component_size))
    alpha = torch.where(keep, alpha, 0)
    return torch.cat([rgba[..., :3], alpha[..., None]], dim=-1)


def cleanup_and_fit(rgba, h, w, min_component_size: int = 500,
                    keep_large_components: bool = False):
    """Component cleanup then alpha-bbox tight crop (reference
    pixels_isolés.py:8-81).  rgba: uint8 [B, H, W, 4].  Returns (rgba,
    new_h, new_w), the extents int32 [B]; an item left without opaque
    pixels gets the extents (0, 0)."""
    cleaned = keep_largest_component(
        rgba, h, w, min_component_size,
        keep_large_components=keep_large_components)
    B, H, W, _ = cleaned.shape
    dev = cleaned.device
    nz = cleaned[..., 3] > 0
    rows = nz.any(dim=2)
    cols = nz.any(dim=1)
    iy = torch.arange(H, dtype=torch.int32, device=dev)
    ix = torch.arange(W, dtype=torch.int32, device=dev)
    big = 1 << 30
    any_nz = rows.any(dim=1)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    y0 = torch.where(any_nz, torch.where(rows, iy, big).amin(dim=1), zero)
    y1 = torch.where(any_nz, torch.where(rows, iy, -1).amax(dim=1), zero - 1)
    x0 = torch.where(any_nz, torch.where(cols, ix, big).amin(dim=1), zero)
    x1 = torch.where(any_nz, torch.where(cols, ix, -1).amax(dim=1), zero - 1)
    bh = y1 - y0 + 1
    bw = x1 - x0 + 1
    return geometry.crop(cleaned, y0, x0, bh, bw), bh, bw

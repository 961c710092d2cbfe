"""The flagship augment chain — the framework's "model" (port of
image_processor_pipeline_tpu/models/chains.py).

  512-crop around the bbox → random-angle rotation → random dihedral flip →
  HSV color-mask filter → photometric enhance (brightness/contrast/color +
  per-channel gain), RGBA out.

The per-item draws are made on the host by ``random`` (bit-exact to the JAX
package's ``jax.random`` draws for the same seeds), vectorised over the
batch; the pixels stay on the device.  Modes, each with the counterpart
in the JAX package whose output it equals:

  'cuda_full'       crop → flip → rotate → mask → enhance in one
                    hand-written CUDA kernel launch reading the uint8
                    canvas ('pallas_full'); the plain twin on a CPU tensor;
  'full_reference'  the plain torch twin of that kernel ('full_reference');
  'shear'           crop → rotate_square_shear → flip → mask → enhance in
                    torch ops, the XLA 'shear' mode;
  'cuda_shear'      the same stages with the crop and rotation in the
                    hand-written CUDA shear kernel, which reads the canvas
                    ('pallas'); the plain twin on a CPU tensor;
  'cuda_fused'      crop, then flip → rotate → mask → enhance in one
                    hand-written CUDA kernel launch ('pallas_fused'); the
                    plain twin on a CPU tensor;
  'fused_reference' the plain torch twin of that kernel ('fused_reference').

The 'full' and 'fused' modes flip before they rotate and the two 'shear'
modes rotate before they flip, so for the same seeds the first four give
one image and the two 'shear' modes another.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from image_processor_pipeline_tpu_torch import random as jrandom
from image_processor_pipeline_tpu_torch.ops import bbox as bbox_ops
from image_processor_pipeline_tpu_torch.ops import color as color_ops
from image_processor_pipeline_tpu_torch.ops import geometry, photometric
from image_processor_pipeline_tpu_torch.ops.augment import (
    _crop,
    augment_finish_reference,
    augment_full_reference,
    augment_fused,
    augment_fused_full,
    pack_rgba,
)
from image_processor_pipeline_tpu_torch.ops.rotate import shear_rotate_crop

CROP = 512

# The fixed two-range HSV exclusion stack of the benchmark filter stage
# (cv2 scale), as in the JAX package.
_FILTER_LOWERS = ((35.0, 60.0, 60.0), (100.0, 40.0, 40.0))
_FILTER_UPPERS = ((85.0, 255.0, 255.0), (140.0, 230.0, 230.0))
_FILTER_ZONES = ((0, 0, 0, 0), (16, 16, 8, 8))

MODES = ("cuda_full", "full_reference", "shear", "cuda_shear", "cuda_fused",
         "fused_reference")


def _seeds(seeds):
    return np.asarray(seeds.cpu() if isinstance(seeds, torch.Tensor)
                      else seeds)


def _crop_params(shape, xywhn, seeds, crop: int = CROP):
    """Random bbox-containing crop placement and rotation angle for a batch:
    (y0 [B] int32, x0 [B] int32, angle [B] float32) as numpy, the JAX
    function's draws for the same seeds.  shape: (H, W) of the canvas."""
    H, W = int(shape[0]), int(shape[1])
    keys = jrandom.split(jrandom.PRNGKey(_seeds(seeds)), 3)
    xyxy = bbox_ops.xywhn2xyxy(torch.as_tensor(xywhn).cpu(), float(W),
                               float(H))
    xyxy = xyxy.to(torch.int32).numpy().astype(np.int64)
    lo_x = np.maximum(0, xyxy[:, 2] - crop)
    hi_x = np.maximum(lo_x, np.minimum(xyxy[:, 0], W - crop))
    lo_y = np.maximum(0, xyxy[:, 3] - crop)
    hi_y = np.maximum(lo_y, np.minimum(xyxy[:, 1], H - crop))
    x0 = jrandom.randint(keys[:, 0], (), lo_x, hi_x + 1)
    y0 = jrandom.randint(keys[:, 1], (), lo_y, hi_y + 1)
    angle = jrandom.uniform(keys[:, 2], (), 1.0, 359.0)
    return y0, x0, angle


def _flip_and_params(seeds):
    """Per-item user flip code [B] int32 and enhance parameters [B, 8]
    float32 (brightness, contrast, color, gain r/g/b, 0, 0) as numpy."""
    keys = jrandom.split(jrandom.PRNGKey(_seeds(seeds)), 5)
    flips = jrandom.randint(keys[:, 3], (), 0, 4)
    kb, kc, kcol, krgb = np.moveaxis(jrandom.split(keys[:, 4], 4), -2, 0)
    prm = np.concatenate([
        np.stack([jrandom.uniform(kb, (), 0.7, 1.3),
                  jrandom.uniform(kc, (), 0.7, 1.3),
                  jrandom.uniform(kcol, (), 0.7, 1.3)], axis=-1),
        jrandom.uniform(krgb, (3,), 0.75, 1.25),
        np.zeros((len(flips), 2), np.float32),
    ], axis=-1)
    return flips, prm


def _crop_one(images, y0, x0, crop: int = CROP):
    """Per-item crop of [B, H, W, C] at the drawn offsets ([B] tensors)."""
    return _crop(images, y0, x0, crop)


def _finish_one(img, flips, prms, crop: int = CROP):
    """Post-rotation stages of the 'shear' chain on a batch [B, S, S, 3]:
    flip (bit 0 x, bit 1 y), HSV mask from the flipped pixels, enhance."""
    f = flips.reshape(-1, 1, 1, 1)
    img = torch.where((f & 1).bool(), img.flip(2), img)
    img = torch.where((f & 2).bool(), img.flip(1), img)
    alpha = color_ops.color_mask_alpha(img, crop, crop, _FILTER_LOWERS,
                                       _FILTER_UPPERS, _FILTER_ZONES)
    img = photometric.brightness(img, prms[:, 0])
    img = photometric.contrast(img, prms[:, 1])
    img = photometric.color_balance(img, prms[:, 2])
    img = photometric.channel_gains(img, prms[:, 3:6])
    return torch.cat([img, alpha[..., None]], dim=-1)


def augment_chain(images, xywhn, seeds, crop: int = CROP,
                  rotation: str = "cuda_full"):
    """Batched chain: [B, H, W, 3|4] uint8 → [B, crop, crop, 4] uint8 RGBA
    on the images' device.  xywhn: [B, 4] normalized bbox; seeds: [B]
    non-negative integers (host draws)."""
    if rotation not in MODES:
        raise ValueError(f"unknown rotation mode {rotation!r}; "
                         f"choose from {MODES}")
    dev = images.device
    y0, x0, angles = _crop_params(images.shape[1:3], xywhn, seeds, crop)
    flips, prms = _flip_and_params(seeds)
    # the shift vectors from the host's angles, so that every device and
    # every mode gets the same ones (the card's tanf/sinf move a shift on
    # a few angles in 10^4)
    shifts = geometry.shear_params(torch.from_numpy(angles), crop)
    y0, x0, flips, prms, *shifts = (torch.as_tensor(a, device=dev)
                                    for a in (y0, x0, flips, prms, *shifts))
    if rotation == "cuda_full":
        # the kernel reads the uint8 canvas itself: no packing pass
        return augment_fused_full(images.contiguous(), y0, x0, None, prms,
                                  flips, _FILTER_LOWERS, _FILTER_UPPERS,
                                  _FILTER_ZONES, crop=crop, shifts=shifts)
    if rotation == "full_reference":
        return augment_full_reference(pack_rgba(images), y0, x0, None,
                                      prms, flips, _FILTER_LOWERS,
                                      _FILTER_UPPERS, _FILTER_ZONES,
                                      crop=crop, shifts=shifts)
    if rotation == "cuda_shear":
        # the kernel reads its crop from the canvas: no torch crop index
        rotated = shear_rotate_crop(images.contiguous(), y0, x0, *shifts,
                                    crop)
        return _finish_one(rotated, flips, prms, crop)
    cropped = _crop_one(images[..., :3], y0, x0, crop).contiguous()
    if rotation in ("cuda_fused", "fused_reference"):
        fn = augment_fused if rotation == "cuda_fused" \
            else augment_finish_reference
        return fn(cropped, None, prms, _FILTER_LOWERS, _FILTER_UPPERS,
                  _FILTER_ZONES, flips=flips, shifts=shifts)
    return _finish_one(geometry.rotate_square_shear_by(cropped, *shifts),
                       flips, prms, crop)


class AugmentChain(nn.Module):
    """The flagship chain as a module on an explicit device.

    ``rotation`` defaults to 'cuda_full', the hand-written kernel, which is
    the path the JAX package's benchmark drives ('pallas_full', bench.py).
    The JAX class instead hard-codes its XLA 'shear' mode (its
    chains.py:276); 'shear' here is that mode's twin.  The chain has no
    weights: its state is the seeds' draws and the static filter stack.
    """

    def __init__(self, input_size: int = 640, rotation: str = "cuda_full",
                 device="cuda"):
        super().__init__()
        if input_size < CROP:
            raise ValueError(f"input_size must be >= {CROP}")
        if rotation not in MODES:
            raise ValueError(f"unknown rotation mode {rotation!r}; "
                             f"choose from {MODES}")
        self.input_size = input_size
        self.rotation = rotation
        self.device = torch.device(device)

    def forward(self, images, xywhn, seeds):
        images = torch.as_tensor(images, device=self.device)
        return augment_chain(images, xywhn, seeds, CROP, self.rotation)

    def example_inputs(self, batch: int = 8):
        """The JAX class's example batch (numpy default_rng(0)): images on
        the module's device, bbox and seeds on the host for the draws."""
        rng = np.random.default_rng(0)
        images = rng.integers(
            0, 256, size=(batch, self.input_size, self.input_size, 3),
            dtype=np.uint8)
        xywhn = np.tile(np.asarray([0.5, 0.5, 0.2, 0.2], np.float32),
                        (batch, 1))
        seeds = np.arange(batch, dtype=np.int64)
        return (torch.as_tensor(images, device=self.device),
                torch.as_tensor(xywhn), torch.as_tensor(seeds))

"""The flagship chain's kernel wrappers, their glue and their plain twins
(port of image_processor_pipeline_tpu/ops/pallas/augment.py:153-272,
435-496, 498-747).

``augment_fused_full`` has the contract of ``augment_fused_pallas_full``
widened to the uint8 canvas: packed RGBA canvases (the JAX contract) or
uint8 ``[B, SIN, SIN, 3|4]`` canvases in, ``[B, S, S, 4]`` uint8 RGBA out,
byte-identical to ``augment_full_reference``.  ``augment_fused`` has the
contract of ``augment_fused_pallas``: RGB crops in, RGBA out,
byte-identical to ``augment_finish_reference``.  On a CPU tensor each runs
its plain version; on a CUDA tensor it launches the hand-written kernel in
``csrc/augment_full.cu`` (replacing the TPU kernels ``_augment_full_kernel``
and ``_augment_kernel``) or raises.  ``chain_path`` picks, from the crop
size alone, which of that source's two launchers runs: one launch on a
thread-block cluster per image, or two passes for crops too large to stage
on chip.  Kernel and plain version get the same shift vectors, computed
once in the wrapper.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from image_processor_pipeline_tpu_torch import kernels
from image_processor_pipeline_tpu_torch.interop import filter_stack
from image_processor_pipeline_tpu_torch.ops import color as color_ops
from image_processor_pipeline_tpu_torch.ops import geometry, photometric


def _shifts(angles, S: int):
    """(quad, sh1, sh2) of the batch: ``geometry.shear_params``, whose
    float32 ops are those of the JAX ``_shifts``; its clip never binds."""
    return geometry.shear_params(angles, S)


def _dihedral_table():
    """Static D4 composition table: (quad*4 + flip) → (transpose, fy, fx)
    with application order  out = flip_x^fx( flip_y^fy( T^t(x) ) ),
    found by brute force on a probe array as the JAX package does."""
    probe = np.arange(16).reshape(4, 4)

    def flip_f(x, f):
        return x[::-1 if f & 2 else 1, ::-1 if f & 1 else 1]

    def quad_q(x, q):
        if q == 1:
            return np.flip(np.swapaxes(x, 0, 1), axis=0)
        if q == 2:
            return np.flip(np.flip(x, axis=0), axis=1)
        if q == 3:
            return np.flip(np.swapaxes(x, 0, 1), axis=1)
        return x

    table = np.zeros((16, 3), np.int32)
    for q in range(4):
        for f in range(4):
            target = quad_q(flip_f(probe, f), q)
            hits = [(t, fy, fx) for t in range(2) for fy in range(2)
                    for fx in range(2)
                    if (flip_f(probe.T if t else probe, fy * 2 + fx)
                        == target).all()]
            if len(hits) != 1:
                raise AssertionError("D4 table is not a bijection")
            table[q * 4 + f] = hits[0]
    return table


_D4_TABLE = _dihedral_table()
# the table as one code per entry, transpose<<2 | fy<<1 | fx, for the kernel
_D4_CODES = (_D4_TABLE[:, 0] * 4 + _D4_TABLE[:, 1] * 2
             + _D4_TABLE[:, 2]).astype(np.int32)


@functools.lru_cache(maxsize=None)
def d4_codes(device: torch.device):
    """_D4_CODES as a tensor on ``device``, copied there once: a copy from
    pageable host memory synchronises the stream on every call."""
    return torch.as_tensor(_D4_CODES, device=device)


def flip_bits_through_transpose(tbit, fy, fx):
    """Swap the D4 flip-bit roles through a transpose:
    Fx^fx ∘ Fy^fy ∘ T^t  =  T^t ∘ Fy^(t?fx:fy) ∘ Fx^(t?fy:fx)."""
    t_b = torch.as_tensor(tbit).bool()
    fy, fx = torch.as_tensor(fy), torch.as_tensor(fx)
    return torch.where(t_b, fx, fy).bool(), torch.where(t_b, fy, fx).bool()


def pack_rgba(images):
    """uint8 [..., H, W, 3|4] → packed int32 [..., H, W], one RGBA pixel per
    word (R in the low byte); 3-channel input gets alpha 255."""
    if images.shape[-1] == 3:
        alpha = torch.full((*images.shape[:-1], 1), 255, dtype=torch.uint8,
                           device=images.device)
        images = torch.cat([images, alpha], dim=-1)
    return images.contiguous().view(torch.int32)[..., 0]


def augment_finish_reference(images, angles, enh_params, lowers, uppers,
                             zones, flips=None, shifts=None):
    """Plain twin of the post-crop chain, in the straightforward order:
    user flip → rotate_square_shear → HSV mask → enhance.

    images: [B, S, S, 3] uint8; angles: [B] degrees; enh_params: [B, 8]
    float32; flips: [B] codes (bit 0 = x-flip, bit 1 = y-flip); shifts:
    (quad, sh1, sh2) to use instead of computing them from ``angles``.
    Returns RGBA [B, S, S, 4] uint8.
    """
    B, S = images.shape[0], images.shape[1]
    if flips is None:
        flips = torch.zeros(B, dtype=torch.int32, device=images.device)
    f = flips.to(images.device).clamp(0, 3).reshape(B, 1, 1, 1)
    img = torch.where((f & 1).bool(), images.flip(2), images)
    img = torch.where((f & 2).bool(), img.flip(1), img)
    if shifts is None:
        shifts = _shifts(angles, S)
    img = geometry.rotate_square_shear_by(img, *shifts)
    alpha = color_ops.color_mask_alpha(img, S, S, lowers, uppers, zones)
    prm = torch.as_tensor(enh_params, dtype=torch.float32,
                          device=images.device)
    img = photometric.brightness(img, prm[:, 0])
    img = photometric.contrast(img, prm[:, 1])
    img = photometric.color_balance(img, prm[:, 2])
    img = photometric.channel_gains(img, prm[:, 3:6])
    return torch.cat([img, alpha[..., None]], dim=-1)


def _crop(images, y0, x0, crop: int):
    """Per-item [crop, crop] window at (y0, x0) of [B, H, W, ...], with
    lax.dynamic_slice's index rule: a negative offset counts from the end,
    then the offset is clamped so the window lies in the canvas."""
    B, H, W = images.shape[:3]
    ar = torch.arange(crop, device=images.device)
    y0 = y0.to(images.device).long()
    x0 = x0.to(images.device).long()
    y0 = torch.where(y0 < 0, y0 + H, y0).clamp(0, H - crop)
    x0 = torch.where(x0 < 0, x0 + W, x0).clamp(0, W - crop)
    rows = (y0[:, None] + ar)[:, :, None]
    cols = (x0[:, None] + ar)[:, None, :]
    return images[torch.arange(B, device=images.device)[:, None, None],
                  rows, cols]


# CTAs in one image's thread-block cluster on the cluster path: 16, the
# largest Hopper allows (non-portable), measured against 8 on the H100 at
# B=8 and B=64 (PERF.md): two of its smaller CTAs share an SM.
CLUSTER = 16
# shared memory a block may use on sm_90, and the cluster kernel's fixed
# part: csrc/augment_full.cu kSmemLimit and kFixedSmem
SMEM_LIMIT = 232448
_FIXED_SMEM = 16 + 128 + 2048 + 2048


def cluster_smem_bytes(S: int, cluster: int = CLUSTER) -> int:
    """Shared memory of one CTA of the cluster kernel at crop size S: the
    fixed part, sh1, sh2, the row addresses and the zone masks, and
    ceil(S/cluster) staged crop lines at 4 bytes a pixel, S + 1 words apart
    (csrc/augment_full.cu:cluster_smem_bytes)."""
    band = -(-S // cluster)
    return _FIXED_SMEM + ((14 * S + 15) & ~15) + 4 * band * (S + 1)


def chain_path(S: int, cluster: int = CLUSTER) -> str:
    """The launcher of csrc/augment_full.cu for crop size S: "cluster" (one
    launch, the crop staged across the cluster's shared memory) where a
    CTA's share fits in a block's shared memory, else "two_pass"."""
    return ("cluster" if cluster_smem_bytes(S, cluster) <= SMEM_LIMIT
            else "two_pass")


def canvas_u8(canvas):
    """The canvas as uint8 [B, SIN, SIN, C], C in {3, 4}, with no copy: a
    packed int32 [B, SIN, SIN] canvas (pack_rgba, the JAX contract) is its
    C = 4 form reinterpreted.  Raises ValueError on any other form or on a
    canvas that is not contiguous."""
    if not isinstance(canvas, torch.Tensor):
        raise ValueError("canvas must be a torch.Tensor")
    if not canvas.is_contiguous():
        raise ValueError("canvas must be contiguous")
    square = canvas.ndim >= 3 and canvas.shape[1] == canvas.shape[2]
    if canvas.dtype == torch.int32 and canvas.ndim == 3 and square:
        return canvas.view(torch.uint8).view(*canvas.shape, 4)
    if canvas.dtype == torch.uint8 and canvas.ndim == 4 and square \
            and canvas.shape[3] in (3, 4):
        return canvas
    raise ValueError("canvas must be packed int32 [B, SIN, SIN] or uint8 "
                     "[B, SIN, SIN, 3|4]")


def augment_full_reference(canvas, y0, x0, angles, enh_params, flips,
                           lowers, uppers, zones, crop: int = 512,
                           shifts=None):
    """Plain twin of the whole chain: crop → user flip →
    rotate_square_shear → mask → enhance.  canvas: packed int32
    [B, SIN, SIN] or uint8 [B, SIN, SIN, 3|4] (alpha ignored)."""
    rgb = canvas_u8(canvas.contiguous())[..., :3]
    cropped = _crop(rgb, y0, x0, crop)
    return augment_finish_reference(cropped, angles, enh_params, lowers,
                                    uppers, zones, flips=flips,
                                    shifts=shifts)


def _check(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the images on {device}")


def _checked_shifts(angles, shifts, B: int, S: int, dev):
    """The batch's (quad, sh1, sh2): ``shifts`` when given, else computed
    from ``angles`` [B] float32 on ``dev``; checked either way."""
    if shifts is None:
        _check("angles", angles, torch.float32, (B,), dev)
        shifts = _shifts(angles, S)
    for name, t, shape in zip(("quad", "sh1", "sh2"), shifts,
                              ((B,), (B, S), (B, S))):
        _check(name, t, torch.int32, shape, dev)
    return shifts


def chain_args(canvas, y0, x0, shifts, enh_params, flips, lowers, uppers,
               zones, S: int):
    """launch_chain's arguments after its name, for a uint8 canvas
    [B, SIN, SIN, 3|4] on the card: the canvas, one 16-byte item row per
    image (y0, x0, D4 code of quarter turn and flip, unused), the shift
    vectors, the enhance parameters, the host filter rows and S."""
    codes = d4_codes(canvas.device)[shifts[0] * 4 + flips.clamp(0, 3)]
    items = torch.stack([y0, x0, codes, torch.zeros_like(codes)], dim=1)
    filt = torch.cat(filter_stack(lowers, uppers, zones), dim=1).contiguous()
    return canvas, items, shifts, enh_params.contiguous(), filt, S


def launch_chain(name, canvas, items, shifts, params, filt, S, path=None,
                 cluster: int = CLUSTER):
    """Launch csrc/augment_full.cu's ipp_augment_full on the canvas's
    device by the launcher ``path`` names (default chain_path(S)), with
    ``cluster`` CTAs an image on the cluster path, and count the launch
    under ``name``.  Returns [B, S, S, 4] uint8."""
    dev = canvas.device
    B, SIN, _, C = canvas.shape
    path = chain_path(S) if path is None else path
    if path not in ("cluster", "two_pass"):
        raise ValueError(f"unknown chain path {path!r}")
    _, sh1, sh2 = (t.contiguous() for t in shifts)
    out = torch.empty((B, S, S), dtype=torch.int32, device=dev)
    # the two-pass path's 64-bit luma sums; the cluster path needs none
    lum_sums = (torch.empty(B, dtype=torch.int64, device=dev)
                if path == "two_pass" else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = kernels.library().ipp_augment_full(
            canvas.data_ptr(), out.data_ptr(),
            None if lum_sums is None else lum_sums.data_ptr(),
            items.data_ptr(), sh1.data_ptr(), sh2.data_ptr(),
            params.data_ptr(), filt.data_ptr(), filt.shape[0], B, SIN, C, S,
            cluster if path == "cluster" else 0, stream)
    kernels.check(code)
    kernels.launch_counts[name] += 1
    return out.view(torch.uint8).view(B, S, S, 4)


def max_active_clusters(S: int, C: int = 3, cluster: int = CLUSTER) -> int:
    """cudaOccupancyMaxActiveClusters of the cluster kernel at crop size S
    on the current card: how many images it can work on at once."""
    n = ctypes.c_int(0)
    kernels.check(kernels.library().ipp_augment_max_active_clusters(
        C, S, cluster, ctypes.byref(n)))
    return n.value


def augment_fused_full(canvas, y0, x0, angles, enh_params, flips, lowers,
                       uppers, zones, crop: int = 512, shifts=None):
    """The whole chain for a batch: crop → flip → rotate → mask → enhance.

    canvas: packed int32 [B, SIN, SIN] RGBA (see pack_rgba) or uint8
    [B, SIN, SIN, C] with C in {3, 4} (alpha ignored), contiguous;
    y0/x0: [B] int32 crop offsets; angles: [B] float32 degrees;
    enh_params: [B, 8] float32 (brightness, contrast, color, gain r/g/b);
    flips: [B] int32 user flip codes (0=o, 1=h, 2=v, 3=hv);
    lowers/uppers/zones: the static filter stack ([F, 3], [F, 3], [F, 4]);
    shifts: (quad [B], sh1 [B, S], sh2 [B, S]) int32 to use in place of
    ``angles`` (which may then be None).  Returns [B, S, S, 4] uint8.  CPU
    tensors run augment_full_reference; CUDA tensors launch the kernel (no
    fallback); other devices raise.
    """
    src = canvas_u8(canvas)
    B, SIN, S, dev = src.shape[0], src.shape[1], crop, src.device
    if not 1 <= S <= SIN:
        raise ValueError(f"crop {S} must lie in [1, {SIN}]")
    for name, t, dtype, shape in (
            ("y0", y0, torch.int32, (B,)), ("x0", x0, torch.int32, (B,)),
            ("enh_params", enh_params, torch.float32, (B, 8)),
            ("flips", flips, torch.int32, (B,))):
        _check(name, t, dtype, shape, dev)
    shifts = _checked_shifts(angles, shifts, B, S, dev)
    if dev.type == "cpu":
        return augment_full_reference(src, y0, x0, angles, enh_params,
                                      flips, lowers, uppers, zones, crop=S,
                                      shifts=shifts)
    if dev.type != "cuda":
        raise ValueError(f"augment_fused_full runs on cpu or cuda, not {dev}")
    return launch_chain("augment_full", *chain_args(
        src, y0, x0, shifts, enh_params, flips, lowers, uppers, zones, S))


def augment_fused(images, angles, enh_params, lowers, uppers, zones,
                  flips=None, shifts=None):
    """The post-crop chain for a batch: flip → rotate → mask → enhance.

    images: [B, S, S, 3] uint8 RGB crops, contiguous; angles: [B] float32
    degrees; enh_params: [B, 8] float32 (brightness, contrast, color, gain
    r/g/b); flips: [B] int32 user flip codes (0=o, 1=h, 2=v, 3=hv), none
    by default; shifts: (quad [B], sh1 [B, S], sh2 [B, S]) int32 to use in
    place of ``angles`` (which may then be None); lowers/uppers/zones: the
    static filter stack.  Returns [B, S, S, 4] uint8 RGBA.  CPU tensors run
    augment_finish_reference; CUDA tensors launch the kernel, the whole
    chain's with the crops as canvases (no fallback); other devices raise.
    """
    if not isinstance(images, torch.Tensor) or images.dtype != torch.uint8 \
            or images.ndim != 4 or images.shape[1] != images.shape[2] \
            or images.shape[3] != 3:
        raise ValueError("images must be a uint8 [B, S, S, 3] tensor")
    if not images.is_contiguous():
        raise ValueError("images must be contiguous")
    B, S, dev = images.shape[0], images.shape[1], images.device
    if flips is None:
        flips = torch.zeros(B, dtype=torch.int32, device=dev)
    for name, t, dtype, shape in (
            ("enh_params", enh_params, torch.float32, (B, 8)),
            ("flips", flips, torch.int32, (B,))):
        _check(name, t, dtype, shape, dev)
    shifts = _checked_shifts(angles, shifts, B, S, dev)
    if dev.type == "cpu":
        return augment_finish_reference(images, angles, enh_params, lowers,
                                        uppers, zones, flips=flips,
                                        shifts=shifts)
    if dev.type != "cuda":
        raise ValueError(f"augment_fused runs on cpu or cuda, not {dev}")
    zeros = torch.zeros_like(flips)
    return launch_chain("augment_fused", *chain_args(
        images, zeros, zeros, geometry.applied_shifts(*shifts, S),
        enh_params, flips, lowers, uppers, zones, S))

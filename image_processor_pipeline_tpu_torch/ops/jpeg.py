"""Device-side JPEG decode finish and encode start in integer torch ops
(port of image_processor_pipeline_tpu/ops/jpeg.py).

The hybrid decode path: the host does ONLY the entropy decode
(native/ipp_io.cpp:ipp_read_jpeg_coefs — jpeg_read_coefficients); the
step's device finishes with dequantisation, the islow IDCT, fancy chroma
upsampling and the YCbCr→RGB conversion.  The hybrid encode is its mirror:
colour conversion, 4:2:0 downsampling, the islow FDCT and quantisation on
the device, entropy coding on the host (ipp_write_jpeg_coefs).  Every
stage replicates libjpeg's integer math bit for bit, so files and pixels
equal the native host codec's:

  - jpeg_idct_islow (jidctint.c): CONST_BITS=13/PASS1_BITS=2 fixed-point
    butterflies, DESCALE round-half-up shifts, and the exact post-IDCT
    range-limit table (the `& 1023` wraparound included);
  - h2v1/h2v2 fancy upsampling (jdsample.c) and libjpeg-turbo's h1v2;
  - ycc_rgb_convert (jdcolor.c) and rgb_ycc_convert (jccolor.c):
    SCALEBITS=16 fixed point;
  - h2v2_downsample (jcsample.c), jpeg_fdct_islow (jfdctint.c) and
    quantize (jcdctmgr.c, round half away from zero).

All arithmetic is int32 on the inputs' device.  Intermediate wrap-around
matches the JAX package's modular int32 ops (torch's int32 add, multiply
and arithmetic shift wrap the same way on the CPU and on the card; the
tests hold crafted overflow blocks).  Divisions truncate
(``rounding_mode="trunc"``, the JAX package's ``lax.div``).  Per-item
valid sizes are [B] tensors: the batch axis is written out where the JAX
package vmaps a per-image function.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

import numpy as np
import torch

# jidctint.c fixed-point constants (CONST_BITS = 13)
_F_0_298631336 = 2446
_F_0_390180644 = 3196
_F_0_541196100 = 4433
_F_0_765366865 = 6270
_F_0_899976223 = 7373
_F_1_175875602 = 9633
_F_1_501321110 = 12299
_F_1_847759065 = 15137
_F_1_961570560 = 16069
_F_2_053119869 = 16819
_F_2_562915447 = 20995
_F_3_072711026 = 25172

_CONST_BITS = 13
_PASS1_BITS = 2

_I32 = torch.int32


def _descale(x, n: int):
    """libjpeg DESCALE: round-half-up arithmetic shift."""
    return (x + (1 << (n - 1))) >> n


def _idct_butterfly(s, descale_bits: int):
    """One 1-D islow pass over 8 stacked slices s[0..7] (jidctint.c).

    Returns the 8 output slices, each descaled by ``descale_bits``.
    """
    z2, z3 = s[2], s[6]
    z1 = (z2 + z3) * _F_0_541196100
    tmp2 = z1 - z3 * _F_1_847759065
    tmp3 = z1 + z2 * _F_0_765366865
    z2, z3 = s[0], s[4]
    tmp0 = (z2 + z3) << _CONST_BITS
    tmp1 = (z2 - z3) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2

    t0, t1, t2, t3 = s[7], s[5], s[3], s[1]
    z1, z2 = t0 + t3, t1 + t2
    z3, z4 = t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F_1_175875602
    t0 = t0 * _F_0_298631336
    t1 = t1 * _F_2_053119869
    t2 = t2 * _F_3_072711026
    t3 = t3 * _F_1_501321110
    z1 = z1 * -_F_0_899976223
    z2 = z2 * -_F_2_562915447
    z3 = z3 * -_F_1_961570560 + z5
    z4 = z4 * -_F_0_390180644 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4

    return [
        _descale(tmp10 + t3, descale_bits),
        _descale(tmp11 + t2, descale_bits),
        _descale(tmp12 + t1, descale_bits),
        _descale(tmp13 + t0, descale_bits),
        _descale(tmp13 - t0, descale_bits),
        _descale(tmp12 - t1, descale_bits),
        _descale(tmp11 - t2, descale_bits),
        _descale(tmp10 - t3, descale_bits),
    ]


def _range_limit(v):
    """libjpeg's post-IDCT sample range limit, exactly (jdmaster.c).

    out = (sample_range_limit + CENTERJSAMPLE)[v & 1023]:
    [0,127]→v+128, [128,511]→255, [512,895]→0, [896,1023]→v-896 —
    the &1023 wraparound included, so even coefficient-overflow streams
    match libjpeg byte for byte.
    """
    i = v & 1023
    return torch.where(i < 128, i + 128,
                       torch.where(i < 512, torch.full_like(i, 255),
                                   torch.where(i < 896, torch.zeros_like(i),
                                               i - 896)))


def idct_islow_blocks(coefs, qtab):
    """Dequantize + exact jpeg_idct_islow over a block grid.

    coefs: [..., by, bx, 64] int (natural frequency order);
    qtab:  [..., 64] uint16/int broadcastable over the grid.
    Returns samples [..., by*8, bx*8] int32 in [0, 255].
    """
    x = coefs.to(_I32) * qtab.to(_I32)[..., None, None, :]
    by, bx = x.shape[-3], x.shape[-2]
    x = x.reshape(*x.shape[:-1], 8, 8)          # [..., by, bx, u, v]

    # pass 1: columns (axis u), output scaled up by PASS1_BITS
    cols = _idct_butterfly([x[..., u, :] for u in range(8)],
                           _CONST_BITS - _PASS1_BITS)
    # pass 2: rows (axis v), final descale + range limit
    mid = torch.stack(cols, dim=-2)
    rows = _idct_butterfly([mid[..., :, v] for v in range(8)],
                           _CONST_BITS + _PASS1_BITS + 3)
    out = torch.stack([_range_limit(r) for r in rows], dim=-1)

    # [..., by, bx, u, v] → [..., by*8, bx*8]
    out = out.movedim(-2, -3)                    # [..., by, u, bx, v]
    return out.reshape(*out.shape[:-4], by * 8, bx * 8)


def _extend_valid(arr, dim: int, n):
    """Replicate line n-1 along ``dim`` into the padding, per item:
    arr [B, ...], n [B]; edge-clamped taps then see the TRUE edge."""
    L = arr.shape[dim]
    dim = dim % arr.ndim
    pos = torch.arange(L, dtype=_I32, device=arr.device)
    idx = torch.minimum(pos[None, :], (n.to(_I32) - 1)[:, None])  # [B, L]
    shape = [arr.shape[0]] + [1] * (arr.ndim - 1)
    shape[dim] = L
    idx = idx.reshape(shape).expand(arr.shape).long()
    return torch.gather(arr, dim, idx)


def _shift_prev(arr, dim: int):
    """arr[max(pos-1, 0)] along ``dim``."""
    L = arr.shape[dim]
    return torch.cat([arr.narrow(dim, 0, 1), arr.narrow(dim, 0, L - 1)],
                     dim=dim)


def _shift_next(arr, dim: int):
    """arr[min(pos+1, L-1)] along ``dim``."""
    L = arr.shape[dim]
    return torch.cat([arr.narrow(dim, 1, L - 1), arr.narrow(dim, L - 1, 1)],
                     dim=dim)


def _interleave(even, odd, dim: int):
    """[..., L, ...] pairs → [..., 2L, ...] with even/odd alternating."""
    dim = dim % even.ndim
    out = torch.stack([even, odd], dim=dim + 1)
    shape = list(even.shape)
    shape[dim] *= 2
    return out.reshape(shape)


def _fancy_h2(arr, dim: int = -1):
    """libjpeg h2v1 fancy upsampling along ``dim`` (jdsample.c), exactly:
    out[2x] = (3 in[x] + in[x-1] + 1) >> 2, out[2x+1] = (3 in[x] + in[x+1]
    + 2) >> 2, taps clamped at the array edge (== libjpeg's special-cased
    first/last columns: (4a+1)>>2 = (4a+2)>>2 = a)."""
    even = (3 * arr + _shift_prev(arr, dim) + 1) >> 2
    odd = (3 * arr + _shift_next(arr, dim) + 2) >> 2
    return _interleave(even, odd, dim)


def _fancy_h2v2(plane, ch, cw):
    """libjpeg h2v2 fancy upsampling of a batch of chroma planes
    (jdsample.c).

    plane: [B, CH, CW] int32 on a padded canvas whose valid region is
    [0:ch, 0:cw] per item (ch, cw [B]).  Vertical 3:1 triangular colsums
    (context rows clamped at the valid edge), then horizontal 3:1 with the
    8/7 rounding pair.  Returns [B, 2*CH, 2*CW] int32; valid region
    [0:2*ch, 0:2*cw].
    """
    p = _extend_valid(_extend_valid(plane, -1, cw), -2, ch)
    cs_up = 3 * p + _shift_prev(p, -2)          # colsum for even output rows
    cs_dn = 3 * p + _shift_next(p, -2)          # colsum for odd output rows

    def haxis(cs):
        even = (3 * cs + _shift_prev(cs, -1) + 8) >> 4
        odd = (3 * cs + _shift_next(cs, -1) + 7) >> 4
        return _interleave(even, odd, -1)

    return _interleave(haxis(cs_up), haxis(cs_dn), -2)


def _ycc_to_rgb(y, cb, cr):
    """jdcolor.c ycc_rgb_convert, exactly (SCALEBITS=16 fixed point).

    y/cb/cr int32 in [0,255].  libjpeg's final range_limit here only ever
    sees [-256, 511], where it equals a plain clamp.
    """
    cbd = cb - 128
    crd = cr - 128
    r = y + ((91881 * crd + 32768) >> 16)
    b = y + ((116131 * cbd + 32768) >> 16)
    g = y + ((-22554 * cbd - 46802 * crd + 32768) >> 16)
    return r.clamp(0, 255), g.clamp(0, 255), b.clamp(0, 255)


def _valid_hw(h, w, H: int, W: int, device):
    iy = torch.arange(H, dtype=_I32, device=device)[None, :, None]
    ix = torch.arange(W, dtype=_I32, device=device)[None, None, :]
    return (iy < h.to(_I32)[:, None, None]) & (ix < w.to(_I32)[:, None, None])


def decode_finish(coefs_y, coefs_c, qtabs, h, w, *, samp: tuple,
                  cap_h: int, cap_w: int, grayscale: bool = False,
                  channels: int = 3):
    """Finish a batch of JPEG decodes on the inputs' device.

    coefs_y: [B, cap_by, cap_bx, 64] int16 luma block grids;
    coefs_c: [B, 2, cap_by_c, cap_bx_c, 64] int16 Cb/Cr grids (zero-padded,
    from ipp_read_jpeg_coefs_batch); qtabs: [B, 3, 64] uint16 (or int);
    h/w: [B] valid dims; samp: the (h_samp, v_samp) of the luma component
    — (1, 1), (2, 1), (1, 2) and (2, 2) are supported (chroma 1x1).
    cap_h/cap_w: output canvas (multiples of 8·samp).  Returns [B, cap_h,
    cap_w, channels] uint8, zero outside the valid region — byte-identical
    to the full libjpeg host decode.

    NOTE: the (1, 2) upsample replicates libjpeg-TURBO's
    h1v2_fancy_upsample (vanilla libjpeg replicates rows there); the tests
    hold the device decode against the linked decoder.
    """
    hs, vs = samp
    lby, lbx = cap_h // 8, cap_w // 8
    cby, cbx = cap_h // (8 * vs), cap_w // (8 * hs)
    h = h.to(_I32)
    w = w.to(_I32)

    y_plane = idct_islow_blocks(coefs_y[:, :lby, :lbx], qtabs[:, 0])
    if grayscale:
        r = g = b = y_plane
    else:
        cb_plane = idct_islow_blocks(coefs_c[:, 0, :cby, :cbx], qtabs[:, 1])
        cr_plane = idct_islow_blocks(coefs_c[:, 1, :cby, :cbx], qtabs[:, 2])
        # chroma caps may be tighter than cap/(8·samp) (the batch reader
        # sizes them for 4:2:0); zero-pad up to the pre-upsample size —
        # the valid data always fits (the reader rejects overflow with -3)
        # and _extend_valid replicates the true edge over the padding
        need_h, need_w = cap_h // vs, cap_w // hs
        ph = need_h - cb_plane.shape[-2]
        pw = need_w - cb_plane.shape[-1]
        if ph or pw:
            cb_plane = torch.nn.functional.pad(cb_plane, (0, pw, 0, ph))
            cr_plane = torch.nn.functional.pad(cr_plane, (0, pw, 0, ph))
        # chroma valid dims: ceil(valid / samp) (jdinput.c downscaled size)
        ch = torch.div(h + vs - 1, vs, rounding_mode="floor")
        cw = torch.div(w + hs - 1, hs, rounding_mode="floor")
        if (hs, vs) == (2, 2):
            cb = _fancy_h2v2(cb_plane, ch, cw)
            cr = _fancy_h2v2(cr_plane, ch, cw)
        elif (hs, vs) == (2, 1):
            cb = _fancy_h2(_extend_valid(cb_plane, -1, cw), -1)
            cr = _fancy_h2(_extend_valid(cr_plane, -1, cw), -1)
        elif (hs, vs) == (1, 2):
            # libjpeg-turbo h1v2_fancy_upsample: the h2v1 triangular
            # filter rotated to the vertical axis (rounding +1 even/+2 odd)
            cb = _fancy_h2(_extend_valid(cb_plane, -2, ch), -2)
            cr = _fancy_h2(_extend_valid(cr_plane, -2, ch), -2)
        elif (hs, vs) == (1, 1):
            cb, cr = cb_plane, cr_plane
        else:
            raise ValueError(f"unsupported sampling {samp}")
        r, g, b = _ycc_to_rgb(y_plane, cb, cr)

    planes = [r, g, b]
    if channels == 4:
        planes.append(torch.full_like(r, 255))
    out = torch.stack(planes, dim=-1).to(torch.uint8)
    # padded-canvas invariant: zero outside the valid region
    valid = _valid_hw(h, w, cap_h, cap_w, out.device)
    return out * valid[..., None].to(torch.uint8)


def decode_finish_sparse(idx, val, qtabs, h, w, *, samp: tuple,
                         cap_h: int, cap_w: int, cap_by_c: int,
                         cap_bx_c: int, grayscale: bool = False,
                         channels: int = 3):
    """decode_finish fed by sparse (COO) coefficient transport.

    idx/val: [B, cap_nnz] int32/int16 nonzero-coefficient pairs from
    ipp_read_jpeg_coefs_sparse_batch — idx is the linear position in the
    dense per-image layout (Y [cap_by, cap_bx, 64], then Cb and Cr
    [cap_by_c, cap_bx_c, 64] each).  A scatter-add reconstructs the dense
    grids on the device.  Padding pairs are (0, 0) and land on slot 0,
    where a real coefficient may sit, so it must accumulate: the sum is
    taken in int32 (each slot holds at most one real value, so the
    int16 value survives unchanged).  Output is identical to
    decode_finish on the dense arrays.
    """
    B = idx.shape[0]
    cap_by, cap_bx = cap_h // 8, cap_w // 8
    ny = cap_by * cap_bx * 64
    nc = cap_by_c * cap_bx_c * 64
    flat = torch.zeros((B, ny + 2 * nc), dtype=_I32, device=idx.device)
    flat.scatter_add_(1, idx.long(), val.to(_I32))
    coefs_y = flat[:, :ny].reshape(B, cap_by, cap_bx, 64)
    coefs_c = flat[:, ny:].reshape(B, 2, cap_by_c, cap_bx_c, 64)
    return decode_finish(coefs_y, coefs_c, qtabs, h, w, samp=samp,
                         cap_h=cap_h, cap_w=cap_w, grayscale=grayscale,
                         channels=channels)


# ---------------------------------------------------------------------------
# Hybrid device JPEG ENCODE: the exact mirror of the decode above.  Files
# written from its coefficients by ipp_write_jpeg_coefs are byte-identical
# to ipp_encode_jpeg / cv2.imwrite / PIL Image.save at the same quality
# (reference encoders: crop_square.py:41 cv2 q95, tranfo.py:53 PIL q75).

# jcparam.c std_luminance/chrominance_quant_tbl (JPEG spec K.1/K.2,
# natural order — libjpeg's quantval is stored in natural order and
# zigzagged only when the DQT marker is written)
_STD_LUMA_QTAB = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99], np.int64)
_STD_CHROMA_QTAB = np.array([
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99], np.int64)


def quality_qtabs(quality: int) -> np.ndarray:
    """jpeg_set_quality's quantization tables, exactly (jcparam.c).

    scale = 5000/q below 50 else 200-2q; val = (base*scale+50)/100
    clamped to [1, 255] (force_baseline).  Returns [3, 64] uint16 in
    natural order (tables 0, 1, 1 — the component→table assignment of
    jpeg_set_defaults) matching what ipp_read_jpeg_coefs reads back from
    an ipp_encode_jpeg file.
    """
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - q * 2
    luma = np.clip((_STD_LUMA_QTAB * scale + 50) // 100, 1, 255)
    chroma = np.clip((_STD_CHROMA_QTAB * scale + 50) // 100, 1, 255)
    return np.stack([luma, chroma, chroma]).astype(np.uint16)


_QTAB_CACHE: Dict[Tuple[int, str], torch.Tensor] = {}
_QTAB_LOCK = threading.Lock()


def quality_qtabs_on(quality: int, device) -> torch.Tensor:
    """quality_qtabs as an int32 [3, 64] tensor on ``device``, cached: a
    copy from pageable memory to a card would synchronise its stream."""
    device = torch.device(device)
    key = (int(quality), str(device))
    with _QTAB_LOCK:
        t = _QTAB_CACHE.get(key)
        if t is None:
            t = torch.from_numpy(quality_qtabs(quality).astype(np.int32))
            t = t.to(device)
            _QTAB_CACHE[key] = t
    return t


# jccolor.c FIX() constants (SCALEBITS = 16)
_FIX_0_29900 = 19595
_FIX_0_58700 = 38470
_FIX_0_11400 = 7471
_FIX_0_16874 = 11059
_FIX_0_33126 = 21709
_FIX_0_50000 = 32768
_FIX_0_41869 = 27439
_FIX_0_08131 = 5329
_ONE_HALF_16 = 1 << 15
_CBCR_OFFSET = 128 << 16


def rgb_to_ycc(rgb):
    """jccolor.c rgb_ycc_convert, exactly.  rgb: [..., 3+] int/uint (alpha
    ignored); returns (y, cb, cr) int32 in [0, 255]."""
    r = rgb[..., 0].to(_I32)
    g = rgb[..., 1].to(_I32)
    b = rgb[..., 2].to(_I32)
    y = (_FIX_0_29900 * r + _FIX_0_58700 * g + _FIX_0_11400 * b
         + _ONE_HALF_16) >> 16
    cb = (-_FIX_0_16874 * r - _FIX_0_33126 * g + _FIX_0_50000 * b
          + _CBCR_OFFSET + _ONE_HALF_16 - 1) >> 16
    cr = (_FIX_0_50000 * r - _FIX_0_41869 * g - _FIX_0_08131 * b
          + _CBCR_OFFSET + _ONE_HALF_16 - 1) >> 16
    return y, cb, cr


def _take2(plane, rows, cols):
    """plane [B, H, W] gathered at per-item rows [B, R] and cols [B, C]."""
    B, _, W = plane.shape
    R, C = rows.shape[1], cols.shape[1]
    t = torch.gather(plane, 1, rows.long()[:, :, None].expand(B, R, W))
    return torch.gather(t, 2, cols.long()[:, None, :].expand(B, R, C))


def _h2v2_downsample(plane, h, w, out_h: int, out_w: int):
    """jcsample.c h2v2_downsample over a batch of padded canvases, exactly.

    plane: [B, H, W] int32 whose valid region is [0:h, 0:w] per item
    (h, w [B]); returns [B, out_h, out_w] int32 — the 2x2 biased mean with
    libjpeg's edge expansion: columns clamp to w-1 (expand_right_edge on
    the input), the input is padded to even height by duplicating row
    h-1, and output rows beyond ceil(h/2) duplicate the last real chroma
    row (jcprepct.c's last-iMCU-row expand_bottom_edge)."""
    dev = plane.device
    h = h.to(_I32)[:, None]
    w = w.to(_I32)[:, None]
    ch = torch.div(h + 1, 2, rounding_mode="floor")
    ar_h = torch.arange(out_h, dtype=_I32, device=dev)[None, :]
    ar_w = torch.arange(out_w, dtype=_I32, device=dev)[None, :]
    r0 = torch.minimum(ar_h, ch - 1) * 2
    r1 = torch.minimum(r0 + 1, h - 1)
    r0 = torch.minimum(r0, h - 1)
    c0 = torch.minimum(ar_w * 2, w - 1)
    c1 = torch.minimum(ar_w * 2 + 1, w - 1)
    s = (_take2(plane, r0, c0) + _take2(plane, r0, c1)
         + _take2(plane, r1, c0) + _take2(plane, r1, c1))
    bias = 1 + (ar_w & 1)
    return (s + bias[:, None, :]) >> 2


def _edge_pad(plane, h, w, out_h: int, out_w: int):
    """Clamp-pad each item's valid region to [out_h, out_w] by edge
    duplication (the compressor's expand_bottom/right_edge for the
    fullsize Y component).  plane [B, H, W], h/w [B]."""
    dev = plane.device
    rows = torch.minimum(torch.arange(out_h, dtype=_I32, device=dev)[None, :],
                         h.to(_I32)[:, None] - 1)
    cols = torch.minimum(torch.arange(out_w, dtype=_I32, device=dev)[None, :],
                         w.to(_I32)[:, None] - 1)
    return _take2(plane, rows, cols)


def _fdct_butterfly(s, pass1: bool):
    """One 1-D islow forward pass over 8 stacked slices (jfdctint.c).

    pass1: outputs scaled up by PASS1_BITS (descale CONST_BITS-PASS1_BITS);
    else the final descale (PASS1_BITS / CONST_BITS+PASS1_BITS)."""
    tmp0, tmp7 = s[0] + s[7], s[0] - s[7]
    tmp1, tmp6 = s[1] + s[6], s[1] - s[6]
    tmp2, tmp5 = s[2] + s[5], s[2] - s[5]
    tmp3, tmp4 = s[3] + s[4], s[3] - s[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2

    if pass1:
        out0 = (tmp10 + tmp11) << _PASS1_BITS
        out4 = (tmp10 - tmp11) << _PASS1_BITS
        bits = _CONST_BITS - _PASS1_BITS
    else:
        out0 = _descale(tmp10 + tmp11, _PASS1_BITS)
        out4 = _descale(tmp10 - tmp11, _PASS1_BITS)
        bits = _CONST_BITS + _PASS1_BITS

    z1 = (tmp12 + tmp13) * _F_0_541196100
    out2 = _descale(z1 + tmp13 * _F_0_765366865, bits)
    out6 = _descale(z1 - tmp12 * _F_1_847759065, bits)

    z1 = tmp4 + tmp7
    z2 = tmp5 + tmp6
    z3 = tmp4 + tmp6
    z4 = tmp5 + tmp7
    z5 = (z3 + z4) * _F_1_175875602
    tmp4 = tmp4 * _F_0_298631336
    tmp5 = tmp5 * _F_2_053119869
    tmp6 = tmp6 * _F_3_072711026
    tmp7 = tmp7 * _F_1_501321110
    z1 = z1 * -_F_0_899976223
    z2 = z2 * -_F_2_562915447
    z3 = z3 * -_F_1_961570560 + z5
    z4 = z4 * -_F_0_390180644 + z5
    out7 = _descale(tmp4 + z1 + z3, bits)
    out5 = _descale(tmp5 + z2 + z4, bits)
    out3 = _descale(tmp6 + z2 + z3, bits)
    out1 = _descale(tmp7 + z1 + z4, bits)
    return [out0, out1, out2, out3, out4, out5, out6, out7]


def fdct_quant_blocks(plane, qtab):
    """Center, islow-FDCT, and quantize every 8x8 block of a plane.

    plane: [..., H, W] int32 samples (H/W multiples of 8); qtab: [..., 64]
    uint16/int broadcastable over the grid.  Returns [..., by, bx, 64]
    int32 quantized coefficients in natural order — exactly libjpeg's
    forward_DCT + quantize (jcdct.h DCTELEM is 32-bit).
    """
    H, W = plane.shape[-2], plane.shape[-1]
    by, bx = H // 8, W // 8
    x = plane.to(_I32).reshape(*plane.shape[:-2], by, 8, bx, 8)
    x = x.transpose(-3, -2) - 128                 # [..., by, bx, u, v]
    # pass 1: rows (1-D DCT along v)
    rows = _fdct_butterfly([x[..., v] for v in range(8)], pass1=True)
    x = torch.stack(rows, dim=-1)                 # [..., by, bx, u, v]
    # pass 2: columns (along u)
    cols = _fdct_butterfly([x[..., u, :] for u in range(8)], pass1=False)
    coef = torch.stack(cols, dim=-2)              # [..., by, bx, u, v]
    coef = coef.reshape(*coef.shape[:-2], 64)
    # jcdctmgr.c quantize: divisor = quantval<<3, round half away from 0
    qval = (qtab.to(_I32) << 3)[..., None, None, :]
    mag = coef.abs() + (qval >> 1)
    q = torch.div(mag, qval, rounding_mode="trunc")
    return torch.where(coef < 0, -q, q)


def encode_start(rgb, h, w, qtabs, *, cap_h: int, cap_w: int):
    """Start a batch of JPEG encodes on the inputs' device (dense
    transport).

    rgb: [B, cap_h, cap_w, C] uint8 padded canvases (C >= 3; alpha
    ignored — the reference saves .jpg from RGB); h/w: [B] valid dims;
    qtabs: [3, 64] from quality_qtabs(quality) — MUST match the quality
    the host writer is called with.  cap_h/cap_w: canvas dims, multiples
    of 16 (the 4:2:0 iMCU).  Returns (coefs_y [B, by, bx, 64] int16,
    coefs_c [B, 2, byc, bxc, 64] int16) with blocks outside each item's
    valid grid zeroed; feeding them to ipp_write_jpeg_coefs yields files
    byte-identical to ipp_encode_jpeg.
    """
    if cap_h % 16 or cap_w % 16:
        raise ValueError("encode_start canvas must be a 4:2:0 iMCU "
                         f"multiple of 16, got {(cap_h, cap_w)}")
    by, bx = cap_h // 8, cap_w // 8
    byc, bxc = cap_h // 16, cap_w // 16
    dev = rgb.device
    h = h.to(_I32)
    w = w.to(_I32)
    qtabs = qtabs.to(dev)

    y, cb, cr = rgb_to_ycc(rgb)
    y = _edge_pad(y, h, w, by * 8, bx * 8)
    cb = _h2v2_downsample(cb, h, w, byc * 8, bxc * 8)
    cr = _h2v2_downsample(cr, h, w, byc * 8, bxc * 8)
    cy = fdct_quant_blocks(y, qtabs[0])
    ccb = fdct_quant_blocks(cb, qtabs[1])
    ccr = fdct_quant_blocks(cr, qtabs[2])
    # zero blocks beyond each item's real block grid (garbage from the
    # clamp-pad of out-of-valid canvas; the writer skips them, sparse
    # transport must not ship them)
    vby = torch.div(h + 7, 8, rounding_mode="floor")[:, None, None]
    vbx = torch.div(w + 7, 8, rounding_mode="floor")[:, None, None]
    vbyc = torch.div(h + 15, 16, rounding_mode="floor")[:, None, None]
    vbxc = torch.div(w + 15, 16, rounding_mode="floor")[:, None, None]
    ar = torch.arange(max(by, bx), dtype=_I32, device=dev)
    ym = (ar[:by][None, :, None] < vby) & (ar[:bx][None, None, :] < vbx)
    cm = (ar[:byc][None, :, None] < vbyc) & (ar[:bxc][None, None, :] < vbxc)
    cy = cy * ym[..., None]
    ccb = ccb * cm[..., None]
    ccr = ccr * cm[..., None]
    return (cy.to(torch.int16),
            torch.stack([ccb, ccr], dim=1).to(torch.int16))


def encode_start_sparse(rgb, h, w, qtabs, *, cap_h: int, cap_w: int,
                        cap_nnz: int):
    """encode_start with on-device COO compaction for the D2H transport.

    Returns (idx [B, cap_nnz] int32, val [B, cap_nnz] int16, nnz [B]
    int32): each nonzero quantized coefficient as (linear position in the
    dense per-image layout — Y [by, bx, 64] then Cb and Cr [byc, bxc, 64]
    — , value), padding pairs (0, 0).  nnz[i] > cap_nnz marks a capacity
    overflow: that item's pairs are truncated and the caller must refetch
    its pixels.
    """
    coefs_y, coefs_c = encode_start(rgb, h, w, qtabs, cap_h=cap_h,
                                    cap_w=cap_w)
    B = coefs_y.shape[0]
    flat = torch.cat([coefs_y.reshape(B, -1), coefs_c.reshape(B, -1)],
                     dim=1)
    mask = flat != 0
    pos = torch.cumsum(mask, dim=1, dtype=_I32)
    nnz = pos[:, -1]
    # scatter each nonzero to its compacted slot; everything else (and
    # overflow beyond cap_nnz) lands in a dump column that's sliced off —
    # every other slot is written by exactly one element, so the scatter
    # is deterministic where it is read
    slot = torch.where(mask, pos - 1, torch.full_like(pos, cap_nnz))
    slot = slot.clamp(max=cap_nnz).long()
    lin = torch.arange(flat.shape[1], dtype=_I32, device=flat.device)
    idx = torch.zeros((B, cap_nnz + 1), dtype=_I32, device=flat.device)
    idx.scatter_(1, slot, lin[None, :].expand(B, -1))
    val = torch.zeros((B, cap_nnz + 1), dtype=torch.int16,
                      device=flat.device)
    val.scatter_(1, slot, flat)
    return idx[:, :cap_nnz], val[:, :cap_nnz], nnz


# ---------------------------------------------------------------------------
# Shared engine-side shrink helper: the device-encode D2H transport used by
# FusedChain.shrink_output and the per-transform device_encode hooks
# (rotations etc.).  Operates on a FLAT batch of padded canvases.  The JAX
# package keeps an LRU of jitted programs here, one per shape; torch runs
# these ops eagerly, so there is nothing to compile or cache.


def fetch(tensors):
    """Host numpy copies of ``tensors`` (a list), copied into pinned
    memory without blocking behind one CUDA event and waited on by that
    event alone: never a whole-stream synchronisation, so batches queued
    behind these copies keep running."""
    host, event = [], None
    for t in tensors:
        if t.device.type == "cuda":
            dst = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            dst.copy_(t, non_blocking=True)
            if event is None:
                event = torch.cuda.Event()
            host.append(dst)
        else:
            host.append(t)
    if event is not None:
        event.record()
        event.synchronize()
    return [x.numpy() for x in host]


def encode_shrink(images, h_dev, w_dev, h_np, w_np, quality: int,
                  cap_frac: float = 0.25):
    """Run the JPEG front half on the device and stage a density-sized
    fetch.

    images: [N, H, W, C>=3] uint8 padded canvases on the device (zeros
    outside each item's valid [0:h, 0:w] region); h_dev/w_dev: [N] int32
    on the device; h_np/w_np: the same on the host.

    Returns (idx, val, nnz_np, meta, pixels) — idx/val are device tensors
    sliced to the batch's max valid nnz (4096-rounded), nnz_np is host
    int32 [N], meta = (hm16, wm16, quality) for
    io.native.write_jpeg_coefs_sparse, and pixels maps overflowed item
    indices to fetched RGB crops for the ordinary host-encode fallback.
    Returns None when the cap'd transport could not beat the pixels.
    """
    H, W = int(images.shape[1]), int(images.shape[2])
    hm = min(H, int(-(-max(int(h_np.max()), 1) // 128) * 128))
    wm = min(W, int(-(-max(int(w_np.max()), 1) // 128) * 128))
    hm16 = -(-hm // 16) * 16
    wm16 = -(-wm // 16) * 16
    cap_nnz = max(1024, int(hm16 * wm16 * 3 // 2 * cap_frac))
    if cap_nnz * 6 >= hm * wm * 3:
        return None
    qtabs = quality_qtabs_on(quality, images.device)
    crop_h, crop_w = min(hm16, H), min(wm16, W)
    x = images[:, :crop_h, :crop_w, :3]
    if (crop_h, crop_w) != (hm16, wm16):
        # odd (diag) canvas smaller than the iMCU-rounded crop: zero-pad —
        # outside-valid pixels are zero by invariant
        x = torch.nn.functional.pad(
            x, (0, 0, 0, wm16 - crop_w, 0, hm16 - crop_h))
    idx, val, nnz = encode_start_sparse(x, h_dev, w_dev, qtabs, cap_h=hm16,
                                        cap_w=wm16, cap_nnz=cap_nnz)
    nnz_np, = fetch([nnz])  # saver-thread context
    # overflowed items fall back to the ordinary pixel save: fetch them
    # all in ONE sliced copy (a per-item fetch loop would pay the link
    # latency B times on exactly the dense batches that overflow)
    ov = np.nonzero(nnz_np > cap_nnz)[0]
    pixels = {}
    if ov.size:
        ho = max(int(h_np[ov].max()), 1)
        wo = max(int(w_np[ov].max()), 1)
        sel = torch.as_tensor(ov, dtype=torch.long).to(images.device)
        crop, = fetch([images.index_select(0, sel)[:, :ho, :wo, :3]])
        for k, i in enumerate(ov):
            pixels[int(i)] = crop[k, :max(int(h_np[i]), 1),
                                  :max(int(w_np[i]), 1)]
    # two-phase fetch: the cap sizes only the ON-DEVICE compaction — the
    # D2H copy ships just the batch's real density (max valid nnz,
    # 4096-rounded)
    valid = nnz_np[nnz_np <= cap_nnz]
    m = int(valid.max()) if valid.size else 0
    m = min(cap_nnz, -(-max(m, 1) // 4096) * 4096)
    return idx[:, :m], val[:, :m], nnz_np, (hm16, wm16, quality), pixels


# Minimum cumulative sample before a sticky codec-gate disable may trip:
# one unlucky tiny remainder batch (a single dense image in a size-1
# ladder tail) must not kill the transport for a long sparse run.
_GATE_MIN_SAMPLE = 16

# The cumulative gate counters are read-modify-written from SAVER threads
# (ProcessingStep runs one saver per worker) — unsynchronized `+=` on a
# shared transform attribute loses increments under interleaving.  One
# module lock is plenty: the counters are touched once per batch.
_GATE_LOCK = threading.Lock()


def reset_codec_gates(transform) -> None:
    """Clear the sticky device_encode/device_decode disables and their
    cumulative counters.  The engine calls this at the start of every
    step run: the gates are per-RUN state."""
    with _GATE_LOCK:
        for a in ("_device_encode_off", "_device_decode_off",
                  "_enc_overflow_n", "_enc_total_n",
                  "_dec_dense_n", "_dec_total_n"):
            if hasattr(transform, a):
                delattr(transform, a)


def _auto(options, name: str, device) -> bool:
    v = options.get(name, "auto")
    if v == "auto" or v is None:
        return torch.device(device).type == "cuda"
    return bool(v)


def device_encode_enabled(options, transform, device) -> bool:
    """Engine gate for the coefficient D2H transport.

    Default is AUTO: on when the step's device is a CUDA card (the
    transport ships sparse coefficients instead of pixels over the link),
    off on the CPU where "device" work shares the host cores.  Explicit
    True/False override the AUTO resolution — but NOT the sticky disable:
    a transform whose run keeps overflowing the compaction cap (dense
    content) trips a sticky per-run disable (note_overflows, printed
    once) so the rest of the run degrades to the plain pixel fetch.
    """
    if getattr(transform, "_device_encode_off", False):
        return False
    return _auto(options, "device_encode", device)


def note_overflows(transform, n_overflow: int, n_total: int) -> None:
    """Accumulate capacity overflows across the run; once a minimum
    sample (16 items) is seen and the cumulative majority overflowed,
    device_encode sticky-disables for the rest of the run."""
    with _GATE_LOCK:
        of = transform._enc_overflow_n = (
            getattr(transform, "_enc_overflow_n", 0) + n_overflow)
        tot = transform._enc_total_n = (
            getattr(transform, "_enc_total_n", 0) + n_total)
        trip = (tot >= _GATE_MIN_SAMPLE and of * 2 > tot
                and not getattr(transform, "_device_encode_off", False))
        if trip:
            transform._device_encode_off = True
    if trip:
        print(f"[device_encode] {of}/{tot} items overflowed or declined "
              f"the sparse transport; falling back to the pixel path "
              f"for the rest of this run")


def note_declines(transform, n: int) -> None:
    """Count a whole-batch transport decline (encode_shrink returned
    None) toward the same sticky gate as cap overflows: transforms that
    skip the host decode expecting the transport (symmetry) must not keep
    paying the fallback forever."""
    note_overflows(transform, n, n)


def transport_cap_viable(cap_frac: float) -> bool:
    """Static mirror of encode_shrink's decline inequality for LARGE
    canvases: cap_nnz ~= hm16*wm16*1.5*cap_frac declines when
    cap_nnz*6 >= hm*wm*3, i.e. cap_frac >= 1/3."""
    return float(cap_frac) < 1.0 / 3.0


def device_decode_enabled(options, transform, device) -> bool:
    """Engine gate for the coefficient H2D transport (the decode mirror of
    device_encode_enabled): AUTO is on when the step's device is a CUDA
    card, explicit True/False override it, and a cumulative-majority
    dense run trips a sticky disable (note_decode_dense)."""
    if getattr(transform, "_device_decode_off", False):
        return False
    return _auto(options, "device_decode", device)


def note_decode_dense(transform, n_dense: int, n_total: int) -> None:
    """Accumulate sparse-capacity overflows (items re-read through the
    dense coefficient reader) across the run; once a minimum sample (16
    items) is seen and the cumulative majority was dense, device_decode
    sticky-disables for the rest of the run."""
    with _GATE_LOCK:
        dn = transform._dec_dense_n = (
            getattr(transform, "_dec_dense_n", 0) + n_dense)
        tot = transform._dec_total_n = (
            getattr(transform, "_dec_total_n", 0) + n_total)
        trip = (tot >= _GATE_MIN_SAMPLE and dn * 2 > tot
                and not getattr(transform, "_device_decode_off", False))
        if trip:
            transform._device_decode_off = True
    if trip:
        print(f"[device_decode] {dn}/{tot} items overflowed the sparse "
              f"transport (dense content); falling back to the host "
              f"pixel decode for the rest of this run")


def shrink_transport(transform, images, h_dev, w_dev, h_np, w_np,
                     quality: int, options, n_valid_rows: int):
    """The per-transform device_encode shrink, shared.

    Runs encode_shrink on a FLAT batch of padded canvases, accounts cap
    overflows into the transform's sticky gate (pad rows beyond
    ``n_valid_rows`` are duplicates and excluded), and returns the
    standard transport dict — jpeg_idx / jpeg_val / jpeg_nnz / jpeg_meta
    / jpeg_pixels — or None when the native writer is unavailable or the
    cap'd transport cannot beat the pixel bytes (callers fall back to
    the ordinary pixel fetch; callers that SKIPPED work expecting the
    transport should also call note_declines)."""
    from image_processor_pipeline_tpu_torch.io import native as io_native

    if not io_native.available():
        return None
    res = encode_shrink(
        images, h_dev, w_dev, h_np, w_np, quality,
        cap_frac=float(options.get("device_encode_cap", 0.25)))
    if res is None:
        return None
    idx, val, nnz_np, meta, pixels = res
    nv = min(n_valid_rows, len(nnz_np))
    note_overflows(transform, sum(1 for i in pixels if i < nv), nv)
    return {"jpeg_idx": idx, "jpeg_val": val, "jpeg_nnz": nnz_np,
            "jpeg_meta": meta, "jpeg_pixels": pixels}


def materialize_jpeg_batch(out_dev, n: int, per_item_keys=()):
    """Split a shrink_transport batch into per-item save dicts, shared by
    the flat-batch transforms (fused/enhance/overlays/crop_square).

    Convention (save_item dispatches on the presence of ``jpeg_meta``):
    transported items carry jpeg_idx/val/nnz/meta; cap-overflowed items
    carry ONLY ``image`` (the fetched pixel crop) plus ``per_item_keys``
    and take the ordinary pixel save path."""
    from image_processor_pipeline_tpu_torch.transforms.base import host_arrays

    meta = out_dev["jpeg_meta"]
    pixels = out_dev["jpeg_pixels"]
    fetch_np = host_arrays(out_dev)
    items = []
    for i in range(n):
        it = {k: fetch_np[k][i] for k in per_item_keys}
        if i in pixels:
            it["image"] = pixels[i]  # overflow: ordinary pixel save path
        else:
            it.update(jpeg_idx=fetch_np["jpeg_idx"][i],
                      jpeg_val=fetch_np["jpeg_val"][i],
                      jpeg_nnz=out_dev["jpeg_nnz"][i],
                      jpeg_meta=meta)
        items.append(it)
    return items


def write_sparse_item(path, out, h: int, w: int) -> None:
    """Entropy-encode ONE item's device-quantized sparse coefficients to
    ``path`` — the host half of the device_encode transport, shared by
    every transform's save_item.  ``out`` holds jpeg_idx/jpeg_val/jpeg_nnz
    for the item plus the batch's jpeg_meta = (hm16, wm16, quality); h/w
    are the item's valid dims."""
    from image_processor_pipeline_tpu_torch.io import native as io_native

    hm16, wm16, quality = out["jpeg_meta"]
    rc = io_native.write_jpeg_coefs_sparse(
        path, out["jpeg_idx"], out["jpeg_val"], int(out["jpeg_nnz"]),
        (hm16 // 8, wm16 // 8), (hm16 // 16, wm16 // 16), h, w, quality)
    if rc != 0:
        raise RuntimeError(
            f"device_encode entropy write failed rc={rc} for {path}")

"""The chain's packed rows (ops/native_draws.py:chain_pack over
native/ipp_draws.cpp:ipp_chain_pack) against the torch glue they replace
on the card: the item rows ``ops/augment.py:chain_args`` stacks (y0, x0,
``item_codes`` of quarter turn and flip, 0), the enhance rows as drawn,
and ``geometry.shear_params``' sh1 and sh2, bit for bit.  Both sides take
the per-item factors from the same torch ops (``geometry.shear_factors``),
so the pack is held to the [B, S] expansion, the item codes and the
layout.  The launch from the packed rows runs on the card only
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from image_processor_pipeline_tpu_torch.models import chains
from image_processor_pipeline_tpu_torch.ops import augment, geometry
from image_processor_pipeline_tpu_torch.ops import native_draws

SECTIONS = ("items", "enh", "sh1", "sh2")
BATCHES = (1, 5, 15, 16, 17, 256)
BIG_SEED = 2**33 + 4099


@pytest.fixture(autouse=True)
def library():
    assert native_draws.available(), native_draws.build_error()


def todays_rows(y0, x0, flips, prm, angles, S):
    """The torch glue's arrays for the kernel."""
    quad, sh1, sh2 = geometry.shear_params(torch.from_numpy(angles), S)
    codes = augment.item_codes(quad, torch.from_numpy(flips))
    items = torch.stack([torch.from_numpy(y0), torch.from_numpy(x0), codes,
                         torch.zeros_like(codes)], dim=1)
    return dict(zip(SECTIONS, (items, torch.from_numpy(prm), sh1, sh2)))


def packed_rows(y0, x0, flips, prm, angles, S):
    """The sections of one packed buffer, its padding filled with 0xAB."""
    layout = native_draws.pack_layout(len(y0), S)
    buf = torch.full((layout.nbytes,), 0xAB, dtype=torch.uint8)
    quad, a, b = geometry.shear_factors(torch.from_numpy(angles))
    native_draws.chain_pack(buf, layout, y0, x0, flips, prm, quad, a, b,
                            augment._D4_CODES, *geometry.shift_limits(S))
    return {name: native_draws.section(buf, layout, name)
            for name in SECTIONS}


def assert_rows_equal(y0, x0, flips, prm, angles, S):
    want = todays_rows(y0, x0, flips, prm, angles, S)
    got = packed_rows(y0, x0, flips, prm, angles, S)
    for name in SECTIONS:
        assert got[name].dtype == want[name].dtype, name
        assert torch.equal(got[name], want[name]), name


def drawn(seeds, S, canvas=640):
    """The chain's draws for ``seeds`` over boxes drawn from them."""
    rng = np.random.default_rng(int(seeds[0]) % 2**32)
    B = len(seeds)
    xywhn = np.concatenate([rng.uniform(0.3, 0.7, (B, 2)),
                            rng.uniform(0.05, 0.3, (B, 2))],
                           axis=1).astype(np.float32)
    y0, x0, angles = chains._crop_params((canvas, canvas), xywhn, seeds, S)
    flips, prm = chains._flip_and_params(seeds)
    return y0, x0, flips, prm, angles


@pytest.mark.parametrize("S", [512, 97, 64])
@pytest.mark.parametrize("B", BATCHES)
def test_the_pack_equals_the_torch_glue(B, S):
    seeds = BIG_SEED + 7 * B + np.arange(B, dtype=np.int64)
    assert_rows_equal(*drawn(seeds, S), S)


@pytest.mark.parametrize("base", [0, BIG_SEED])
def test_the_pack_equals_the_torch_glue_over_2_16_seeds(base):
    """The draws of 65,536 consecutive seeds at 640 -> 512, 4,096 a
    pack."""
    for lo in range(0, 1 << 16, 4096):
        seeds = base + lo + np.arange(4096, dtype=np.int64)
        assert_rows_equal(*drawn(seeds, 512), 512)


@pytest.mark.parametrize("ulps", [-1, 0, 1])
@pytest.mark.parametrize("degrees", [45.0, 135.0, 225.0, 315.0])
@pytest.mark.parametrize("B", BATCHES)
def test_the_pack_at_the_octant_boundaries(B, degrees, ulps):
    """Angles at and one float32 ulp around the quarter turns' edges,
    every other item of the batch (so in torch's vector body and in its
    scalar tail), every flip."""
    y0, x0, flips, prm, angles = drawn(
        BIG_SEED + 101 * B + np.arange(B, dtype=np.int64), 512)
    edge = np.float32(degrees)
    for _ in range(abs(ulps)):
        edge = np.nextafter(edge, np.float32(ulps * np.inf))
    angles[::2] = edge
    flips = (np.arange(B) % 4).astype(np.int32)
    assert_rows_equal(y0, x0, flips, prm, angles, 512)


@pytest.mark.parametrize("flip", range(4))
@pytest.mark.parametrize("quad", range(4))
def test_the_item_code_of_each_quarter_turn_and_flip(quad, flip):
    B = 3
    y0, x0, _, prm, _ = drawn(BIG_SEED + np.arange(B, dtype=np.int64), 64)
    angles = np.full(B, 10.0 + 90.0 * quad, np.float32)
    flips = np.full(B, flip, np.int32)
    rows = packed_rows(y0, x0, flips, prm, angles, 64)
    assert (rows["items"][:, 2] == int(augment._D4_CODES[4 * quad + flip])
            ).all()
    assert (rows["items"][:, 3] == 0).all()
    assert_rows_equal(y0, x0, flips, prm, angles, 64)


def test_flips_out_of_range_clamp_as_item_codes_clamps():
    B = 6
    y0, x0, _, prm, angles = drawn(BIG_SEED + np.arange(B, dtype=np.int64),
                                   64)
    flips = np.asarray([-3, -1, 4, 5, 1 << 20, -(1 << 20)], np.int32)
    assert_rows_equal(y0, x0, flips, prm, angles, 64)


@pytest.mark.parametrize("B,S", [(1, 512), (16, 512), (17, 97), (256, 64)])
def test_each_section_starts_aligned_after_the_last(B, S):
    lay = native_draws.pack_layout(B, S)
    starts = [lay.items, lay.enh, lay.sh1, lay.sh2]
    sizes = [16 * B, 32 * B, 4 * B * S, 4 * B * S]
    assert lay.items == 0
    assert all(s % native_draws.ALIGN == 0 for s in starts)
    assert all(a + n <= b for a, n, b in zip(starts, sizes, starts[1:]))
    assert lay.nbytes == lay.sh2 + 4 * B * S


@pytest.mark.parametrize("fault", ["short_buffer", "int64_buffer",
                                   "rows_of_another_batch", "d4_table"])
def test_the_pack_refuses_what_does_not_fit(fault):
    B, S = 4, 64
    y0, x0, flips, prm, angles = drawn(
        BIG_SEED + np.arange(B, dtype=np.int64), S)
    layout = native_draws.pack_layout(B, S)
    buf = torch.empty(layout.nbytes, dtype=torch.uint8)
    quad, a, b = geometry.shear_factors(torch.from_numpy(angles))
    d4 = augment._D4_CODES
    if fault == "short_buffer":
        buf = buf[:-1]
    elif fault == "int64_buffer":
        buf = torch.empty(layout.nbytes, dtype=torch.int64)
    elif fault == "rows_of_another_batch":
        y0 = np.concatenate([y0, y0])
    else:
        d4 = d4[:8]
    with pytest.raises(ValueError):
        native_draws.chain_pack(buf, layout, y0, x0, flips, prm, quad, a, b,
                                d4, *geometry.shift_limits(S))


def test_shear_params_expands_shear_factors():
    """Both paths take the per-item factors from one definition."""
    angles = torch.from_numpy(drawn(BIG_SEED + np.arange(17), 97)[4])
    quad, a, b = geometry.shear_factors(angles)
    q2, sh1, sh2 = geometry.shear_params(angles, 97)
    lim1, lim2 = geometry.shift_limits(97)
    iy = torch.arange(97, dtype=torch.float32) - 48.0
    assert torch.equal(q2, quad)
    assert torch.equal(sh1, torch.round(a[:, None] * iy).to(torch.int32)
                       .clamp(-lim1, lim1))
    assert torch.equal(sh2, torch.round(b[:, None] * iy).to(torch.int32)
                       .clamp(-lim2, lim2))


@pytest.mark.parametrize("S", [64, 97])
def test_factors_past_the_clip_and_nan_expand_as_torch_expands_them(S):
    """shear_params' own factors never reach the clip; factors that do,
    and NaN, give the vectors of shear_params' torch expansion."""
    a = torch.tensor([10.0, -10.0, float("nan"), 0.4, 1e30, -3.3e9])
    b = torch.tensor([-7.5, 7.5, 0.2, float("nan"), -1e30, 2.5])
    B = len(a)
    quad = torch.arange(B, dtype=torch.int32) % 4
    y0, x0, flips, prm, _ = drawn(BIG_SEED + np.arange(B, dtype=np.int64), S)
    layout = native_draws.pack_layout(B, S)
    buf = torch.empty(layout.nbytes, dtype=torch.uint8)
    native_draws.chain_pack(buf, layout, y0, x0, flips, prm, quad, a, b,
                            augment._D4_CODES, *geometry.shift_limits(S))
    iy = torch.arange(S, dtype=torch.float32) - (float(S) - 1.0) / 2.0
    want = geometry._clip_shifts(
        torch.round(a[:, None] * iy[None, :]).to(torch.int32),
        torch.round(b[:, None] * iy[None, :]).to(torch.int32), S)
    assert torch.equal(native_draws.section(buf, layout, "sh1"), want[0])
    assert torch.equal(native_draws.section(buf, layout, "sh2"), want[1])
    assert (want[0].abs() == geometry.shift_limits(S)[0]).any()

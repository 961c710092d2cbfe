"""The chain's packed rows (ops/native_draws.py:chain_pack over
native/ipp_draws.cpp:ipp_chain_pack) against the torch glue they replace
on the card: the item rows ``ops/augment.py:chain_args`` stacks (y0, x0,
``item_codes`` of quarter turn and flip, 0), the enhance rows as drawn,
and ``geometry.shear_params``' sh1 and sh2, bit for bit.  The pack takes
its per-item factors from the native pass (``native_draws.shear_factors``
over ``ipp_chain_angles``, with torch's ``tan`` and ``sin``), which is
held here to ``geometry.shear_factors``' intermediates and outputs; the
pack is held to the [B, S] expansion, the item codes and the layout.  The
launch from the packed rows runs on the card only
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


def factors(angles, native=True):
    """(quad, tan(phi/2), sin(phi)) of ``angles``: the packed path's
    native pass, or ``geometry.shear_factors`` with its b negated."""
    if native:
        return native_draws.shear_factors(angles)
    quad, a, b = geometry.shear_factors(torch.from_numpy(angles))
    return quad, a, -b


def packed_buffer(y0, x0, flips, prm, angles, S, native=True):
    """One packed buffer, its padding filled with 0xAB, and its layout."""
    layout = native_draws.pack_layout(len(y0), S)
    buf = torch.full((layout.nbytes,), 0xAB, dtype=torch.uint8)
    native_draws.chain_pack(buf, layout, y0, x0, flips, prm,
                            *factors(angles, native), augment._D4_CODES,
                            *geometry.shift_limits(S))
    return buf, layout


def packed_rows(y0, x0, flips, prm, angles, S):
    """The sections of one packed buffer."""
    buf, layout = packed_buffer(y0, x0, flips, prm, angles, S)
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
    quad, a, s = factors(angles)
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
        native_draws.chain_pack(buf, layout, y0, x0, flips, prm, quad, a, s,
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
    native_draws.chain_pack(buf, layout, y0, x0, flips, prm, quad, a, -b,
                            augment._D4_CODES, *geometry.shift_limits(S))
    iy = torch.arange(S, dtype=torch.float32) - (float(S) - 1.0) / 2.0
    want = geometry._clip_shifts(
        torch.round(a[:, None] * iy[None, :]).to(torch.int32),
        torch.round(b[:, None] * iy[None, :]).to(torch.int32), S)
    assert torch.equal(native_draws.section(buf, layout, "sh1"), want[0])
    assert torch.equal(native_draws.section(buf, layout, "sh2"), want[1])
    assert (want[0].abs() == geometry.shift_limits(S)[0]).any()


# -- the native factors (native_draws.chain_angles, shear_factors) -----------

def torch_angles(angles):
    """``geometry.shear_factors``' quad, phi / 2 and phi, in its torch ops
    and order."""
    theta = torch.from_numpy(angles) * geometry._DEG2RAD
    theta = torch.fmod(theta, geometry._TWO_PI)
    theta = torch.where(theta < 0, theta + geometry._TWO_PI, theta)
    quad = torch.remainder(torch.floor(
        (theta + geometry._PI_4)
        / torch.full_like(theta, geometry._PI_2)).to(torch.int32), 4)
    phi = theta - quad.to(torch.float32) * geometry._PI_2
    return quad, phi / 2, phi


def assert_factors_equal(angles):
    """The native quad, phi / 2 and phi equal the torch intermediates bit
    for bit, and the factors from them equal ``shear_factors``'."""
    got = native_draws.chain_angles(angles)
    want = torch_angles(angles)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    quad, a, b = geometry.shear_factors(torch.from_numpy(angles))
    assert torch.equal(torch.tan(want[1]), a)
    assert torch.equal(-torch.sin(want[2]), b)
    q2, a2, s2 = native_draws.shear_factors(angles)
    assert torch.equal(q2, quad) and torch.equal(a2, a)
    assert torch.equal(s2.view(torch.int32), (-b).view(torch.int32))


def nudged(values, ulps):
    """float32 ``values`` moved ``ulps`` float32 steps (signed)."""
    out = np.asarray(values, np.float32)
    for _ in range(abs(ulps)):
        out = np.nextafter(out, np.float32(np.sign(ulps) * np.inf))
    return out


@pytest.mark.parametrize("base", [0, BIG_SEED])
def test_the_native_factors_over_the_angles_of_2_16_seeds(base):
    seeds = base + np.arange(1 << 16, dtype=np.int64)
    boxes = np.asarray([0.5, 0.5, 0.2, 0.2], np.float32)
    angles = native_draws.crop_draws(seeds, boxes, 640, 640, 512)[2]
    assert_factors_equal(angles)


@pytest.mark.parametrize("ulps", [-4, -3, -2, -1, 0, 1, 2, 3, 4])
@pytest.mark.parametrize("step", [45.0, 90.0])
def test_the_native_factors_at_the_octant_and_quarter_turn_edges(step, ulps):
    """k * 45 and k * 90 degrees, k in [-8, 8], and 1 to 4 float32 ulps
    either side."""
    edges = step * np.arange(-8, 9)
    assert_factors_equal(nudged(edges, ulps))


def test_the_native_factors_at_the_draws_ends():
    """1 degree, the draw's low end, and the angles just under 359, its
    high end, and just above 1."""
    angles = np.concatenate([nudged([1.0, 359.0], u) for u in range(-4, 5)])
    assert_factors_equal(angles)


def test_the_native_factors_where_the_quarter_turn_is_an_ulp_from_an_integer():
    """Angles whose float32 (theta + pi/4) / (pi/2) lies within one ulp of
    an integer, so that floor decides the quarter turn on the last bit:
    found among 4,001 float32 neighbours of each octant edge."""
    edges = np.float32([45.0, 135.0, 225.0, 315.0, -45.0, 405.0])
    # adjacent bit patterns are adjacent floats of one sign
    near = (edges.view(np.int32)[:, None]
            + np.arange(-2000, 2001, dtype=np.int32)).view(np.float32)
    near = near.ravel()
    quad, _, _ = torch_angles(near)
    theta = torch.fmod(torch.from_numpy(near) * geometry._DEG2RAD,
                       geometry._TWO_PI)
    theta = torch.where(theta < 0, theta + geometry._TWO_PI, theta)
    ratio = ((theta + geometry._PI_4)
             / torch.full_like(theta, geometry._PI_2)).numpy()
    gap = np.abs(ratio - np.round(ratio))
    close = near[gap <= np.spacing(ratio)]
    assert len(close) >= 24
    assert_factors_equal(np.ascontiguousarray(close))


def test_non_finite_angles_give_nan_factors_and_the_torch_rows():
    """NaN and infinite angles: NaN phi on both sides (the payloads may
    differ), and the same packed buffer."""
    angles = np.float32([np.nan, np.inf, -np.inf, 1e30, -1e30, 7.0])
    got = native_draws.chain_angles(angles)
    want = torch_angles(angles)
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g.isnan(), w.isnan())
        assert torch.equal(g[~g.isnan()], w[~w.isnan()])
    B = len(angles)
    y0, x0, flips, prm, _ = drawn(BIG_SEED + np.arange(B, dtype=np.int64), 97)
    native, _ = packed_buffer(y0, x0, flips, prm, angles, 97)
    torch_side, _ = packed_buffer(y0, x0, flips, prm, angles, 97,
                                  native=False)
    assert torch.equal(native, torch_side)


@pytest.mark.parametrize("S", [512, 97, 64])
@pytest.mark.parametrize("B", [1, 5, 16, 17, 256])
def test_the_native_factors_pack_the_buffer_of_the_torch_factors(B, S):
    """The whole buffer, padding included, from the native factors equals
    the one from ``geometry.shear_factors``."""
    args = drawn(BIG_SEED + 13 * B + np.arange(B, dtype=np.int64), S)
    native, _ = packed_buffer(*args, S)
    torch_side, _ = packed_buffer(*args, S, native=False)
    assert torch.equal(native, torch_side)


@pytest.mark.parametrize("fault", ["float64", "two_dims", "strided",
                                   "tensor"])
def test_the_native_factors_refuse_what_does_not_fit(fault):
    angles = np.linspace(1.0, 359.0, 8, dtype=np.float32)
    bad = {"float64": lambda: angles.astype(np.float64),
           "two_dims": lambda: angles.reshape(2, 4),
           "strided": lambda: np.repeat(angles, 2)[::2],
           "tensor": lambda: torch.from_numpy(angles)}[fault]()
    with pytest.raises(ValueError):
        native_draws.chain_angles(bad)
    with pytest.raises(ValueError):
        native_draws.shear_factors(bad)

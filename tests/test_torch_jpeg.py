"""The port's device JPEG halves (ops/jpeg.py) against the JAX package's on
the same inputs, on the CPU: every function equal exactly, crafted
overflow blocks included, and the codec gates' semantics.  The JAX side
runs its jitted functions as its own tests do; the port's functions are
plain torch ops on CPU tensors."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_processor_pipeline_tpu.ops import jpeg as J
from image_processor_pipeline_tpu_torch.ops import jpeg as T
from torch_port_data import make_image


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def eq(jax_out, torch_out):
    np.testing.assert_array_equal(torch_out.numpy(), np.asarray(jax_out))


def test_idct_extreme_blocks():
    """±2047 and ±2048 coefficients at quantiser 255, every quantiser
    1–255, and the whole int16 range: the int32 intermediates wrap the
    same way (libjpeg's range limit `& 1023` included)."""
    rng = np.random.default_rng(0)
    q_all = np.arange(1, 256, dtype=np.uint16)
    qtab = np.repeat(q_all[:, None], 64, axis=1)            # [255, 64]
    for coefs in (np.full((255, 1, 2, 64), 2047, np.int16),
                  np.full((255, 1, 2, 64), -2048, np.int16),
                  rng.integers(-2048, 2048, (255, 1, 2, 64)).astype(np.int16),
                  rng.integers(-32768, 32768, (255, 1, 2, 64)).astype(
                      np.int16)):
        coefs[:, 0, 1, 1::2] *= -1
        eq(J.idct_islow_blocks(jnp.asarray(coefs), jnp.asarray(qtab)),
           T.idct_islow_blocks(t(coefs), t(qtab)))


def test_fdct_extreme_planes():
    """Sample planes far outside [0, 255] (so the FDCT's int32
    intermediates wrap) and every quantiser 1–255; the quantiser's
    division truncates like lax.div."""
    rng = np.random.default_rng(1)
    planes = np.concatenate([
        rng.integers(0, 256, (85, 8, 16)),
        rng.integers(-2 ** 20, 2 ** 20, (85, 8, 16)),
        rng.integers(-2 ** 31, 2 ** 31 - 1, (85, 8, 16))]).astype(np.int32)
    qtab = np.repeat(np.arange(1, 256, dtype=np.uint16)[:, None], 64, 1)
    want = jax.vmap(J.fdct_quant_blocks)(jnp.asarray(planes),
                                         jnp.asarray(qtab))
    got = T.fdct_quant_blocks(t(planes), t(qtab))
    eq(want, got)


def _coefs(rng, B, cap_h, cap_w, lo=-60, hi=60):
    cy = rng.integers(lo, hi, (B, cap_h // 8, cap_w // 8, 64)).astype(np.int16)
    cc = rng.integers(lo, hi, (B, 2, cap_h // 8, cap_w // 8, 64)).astype(
        np.int16)
    qt = rng.integers(1, 40, (B, 3, 64)).astype(np.uint16)
    return cy, cc, qt


# (samp, grayscale, channels): every sampling with RGB output, grayscale,
# and a 4-channel canvas
DECODE_CASES = [((1, 1), False, 3), ((2, 1), False, 3), ((1, 2), False, 3),
                ((2, 2), False, 3), ((1, 1), True, 3), ((2, 2), False, 4)]


@pytest.mark.parametrize("samp,gray,channels", DECODE_CASES)
def test_decode_finish_matches_jax(samp, gray, channels):
    """Odd valid sizes on a padded canvas, chroma grids at full size."""
    rng = np.random.default_rng(2)
    cap_h, cap_w = 32, 48
    cy, cc, qt = _coefs(rng, 3, cap_h, cap_w)
    h = np.array([32, 31, 17], np.int32)
    w = np.array([48, 45, 9], np.int32)
    kw = dict(samp=samp, cap_h=cap_h, cap_w=cap_w, grayscale=gray,
              channels=channels)
    want = J.decode_finish(jnp.asarray(cy), jnp.asarray(cc), jnp.asarray(qt),
                           jnp.asarray(h), jnp.asarray(w), **kw)
    got = T.decode_finish(t(cy), t(cc), t(qt), t(h), t(w), **kw)
    eq(want, got)
    assert not got[1, 31:].any() and not got[2, :, 9:].any()


def test_decode_finish_sparse_is_the_dense_decode():
    """The COO scatter (padding pairs add 0 to slot 0, where a real DC
    coefficient sits) equals decode_finish on the dense grids, and the
    JAX package's sparse decode; the 4:2:0 chroma caps are half size."""
    rng = np.random.default_rng(3)
    cap_h, cap_w, B = 32, 48, 3
    by, bx, byc, bxc = cap_h // 8, cap_w // 8, cap_h // 16, cap_w // 16
    ny, nc = by * bx * 64, byc * bxc * 64
    flat = np.zeros((B, ny + 2 * nc), np.int16)
    mask = rng.random(flat.shape) < 0.2
    flat[mask] = rng.integers(-300, 300, mask.sum())
    flat[:, 0] = 77                                   # slot 0 is real
    cap = 1024
    idx = np.zeros((B, cap), np.int32)
    val = np.zeros((B, cap), np.int16)
    for i in range(B):
        nz = np.nonzero(flat[i])[0]
        idx[i, :len(nz)], val[i, :len(nz)] = nz, flat[i, nz]
    qt = rng.integers(1, 40, (B, 3, 64)).astype(np.uint16)
    h = np.array([32, 20, 9], np.int32)
    w = np.array([48, 33, 47], np.int32)
    kw = dict(samp=(2, 2), cap_h=cap_h, cap_w=cap_w)
    got = T.decode_finish_sparse(t(idx), t(val), t(qt), t(h), t(w),
                                 cap_by_c=byc, cap_bx_c=bxc, **kw)
    dense = T.decode_finish(
        t(flat[:, :ny].reshape(B, by, bx, 64)),
        t(flat[:, ny:].reshape(B, 2, byc, bxc, 64)), t(qt), t(h), t(w), **kw)
    assert torch.equal(got, dense)
    eq(J.decode_finish_sparse(jnp.asarray(idx), jnp.asarray(val),
                              jnp.asarray(qt), jnp.asarray(h), jnp.asarray(w),
                              cap_by_c=byc, cap_bx_c=bxc, **kw), got)


def test_quality_qtabs_every_quality():
    for q in range(0, 102):
        np.testing.assert_array_equal(T.quality_qtabs(q), J.quality_qtabs(q))


def _rgb_batch(rng, B, H, W, C=4):
    return np.stack([make_image(rng, H, W, C) for _ in range(B)])


@pytest.mark.parametrize("quality,cap_nnz", [(95, 700), (75, 1200)])
def test_encode_start_sparse_matches_jax(quality, cap_nnz):
    """idx, val and nnz equal the JAX package's arrays, an item that
    overflows the cap (its pairs truncated, the dump column sliced off)
    included; the dense encode_start too."""
    rng = np.random.default_rng(4)
    rgb = _rgb_batch(rng, 3, 32, 48)
    rgb[0] = rng.integers(0, 256, rgb[0].shape)       # dense: overflows
    h = np.array([32, 31, 9], np.int32)
    w = np.array([48, 17, 47], np.int32)
    qt = T.quality_qtabs(quality)
    want = J.encode_start_sparse(jnp.asarray(rgb), jnp.asarray(h),
                                 jnp.asarray(w), jnp.asarray(qt), cap_h=32,
                                 cap_w=48, cap_nnz=cap_nnz)
    got = T.encode_start_sparse(t(rgb), t(h), t(w), t(qt.astype(np.int32)),
                                cap_h=32, cap_w=48, cap_nnz=cap_nnz)
    for a, b in zip(want, got):
        eq(a, b)
    assert int(got[2][0]) > cap_nnz
    for a, b in zip(J.encode_start(jnp.asarray(rgb), jnp.asarray(h),
                                   jnp.asarray(w), jnp.asarray(qt),
                                   cap_h=32, cap_w=48),
                    T.encode_start(t(rgb), t(h), t(w), t(qt), cap_h=32,
                                   cap_w=48)):
        eq(a, b)


def test_encode_shrink_matches_jax_overflow_pixels_included():
    """The density-sized slices, the host nnz, the meta and the
    overflowed items' fetched pixel crops equal the JAX package's, on a
    canvas smaller than its 16-rounded crop (zero-padded)."""
    rng = np.random.default_rng(5)
    imgs = _rgb_batch(rng, 4, 200, 136)
    imgs[2] = rng.integers(0, 256, imgs[2].shape)       # noise: overflows
    h = np.array([200, 150, 199, 7], np.int32)
    w = np.array([136, 101, 130, 133], np.int32)
    for i in range(4):
        imgs[i, h[i]:] = 0
        imgs[i, :, w[i]:] = 0
    want = J.encode_shrink(jnp.asarray(imgs), jnp.asarray(h), jnp.asarray(w),
                           h, w, 95, cap_frac=0.2)
    got = T.encode_shrink(t(imgs), t(h), t(w), h, w, 95, cap_frac=0.2)
    eq(want[0], got[0])
    eq(want[1], got[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[3] == want[3] == (208, 144, 95)
    assert sorted(got[4]) == sorted(want[4]) and 2 in got[4]
    for i in want[4]:
        np.testing.assert_array_equal(got[4][i], want[4][i])
    # a cap that cannot beat the pixels declines on both sides
    assert T.encode_shrink(t(imgs), t(h), t(w), h, w, 95,
                           cap_frac=0.34) is None
    assert J.encode_shrink(jnp.asarray(imgs), jnp.asarray(h),
                           jnp.asarray(w), h, w, 95, cap_frac=0.34) is None


class _T:  # stand-in transform instance for the sticky flags
    pass


@pytest.mark.parametrize("name", ["device_decode", "device_encode"])
def test_gate_semantics(name):
    """AUTO is on for a CUDA device and off on the CPU (the JAX gate's
    accelerator-backend rule); explicit True/False override it."""
    gate = getattr(T, f"{name}_enabled")
    tr = _T()
    for dev in ("cpu", torch.device("cpu")):
        assert not gate({}, tr, dev)
        assert not gate({name: None}, tr, dev)
        assert not gate({name: "auto"}, tr, dev)
        assert gate({name: True}, tr, dev)
    for dev in ("cuda", torch.device("cuda", 0)):
        assert gate({}, tr, dev) and gate({name: "auto"}, tr, dev)
        assert not gate({name: False}, tr, dev)
    # the JAX gate on its CPU backend agrees with the port's on the CPU
    jgate = getattr(J, f"{name}_enabled")
    for opts in ({}, {name: "auto"}, {name: False}, {name: True}):
        assert jgate(opts, _T()) == gate(opts, _T(), "cpu")


def test_decode_hysteresis_sticky_tiny_and_reset():
    t_ = _T()
    T.note_decode_dense(t_, n_dense=1, n_total=1)   # a dense remainder
    assert T.device_decode_enabled({"device_decode": True}, t_, "cpu")
    T.note_decode_dense(t_, n_dense=6, n_total=15)  # 7/16: no majority
    assert T.device_decode_enabled({"device_decode": True}, t_, "cpu")
    T.note_decode_dense(t_, n_dense=16, n_total=16)  # 23/32: trips
    # sticky: overrides even an explicit True
    assert not T.device_decode_enabled({"device_decode": True}, t_, "cuda")
    T.note_overflows(t_, n_overflow=16, n_total=16)
    assert not T.device_encode_enabled({"device_encode": True}, t_, "cuda")
    T.reset_codec_gates(t_)
    assert T.device_decode_enabled({"device_decode": True}, t_, "cpu")
    assert T.device_encode_enabled({"device_encode": True}, t_, "cpu")
    T.note_decode_dense(t_, n_dense=8, n_total=8)   # below the min sample
    assert T.device_decode_enabled({"device_decode": True}, t_, "cpu")


def test_encode_counters_thread_safe_and_declines(capsys):
    """note_overflows is called from saver threads: no lost increments;
    whole-batch declines trip the gate, printed once, reset restores."""
    t_ = _T()

    def work():
        for _ in range(400):
            T.note_overflows(t_, 1, 3)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert (t_._enc_overflow_n, t_._enc_total_n) == (3200, 9600)
    assert not getattr(t_, "_device_encode_off", False)
    t2 = _T()
    T.note_declines(t2, T._GATE_MIN_SAMPLE)
    assert not T.device_encode_enabled({"device_encode": True}, t2, "cpu")
    assert capsys.readouterr().out.count("falling back") == 1
    T.note_declines(t2, 1)
    assert capsys.readouterr().out == ""
    assert T.transport_cap_viable(0.25) and not T.transport_cap_viable(0.34)
    assert T._GATE_MIN_SAMPLE == J._GATE_MIN_SAMPLE

"""The port's flagship chain against the JAX package's augment_chain, called
eagerly on the same numpy inputs, and the port's independence from jax."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_processor_pipeline_tpu.models import chains as jchains
from image_processor_pipeline_tpu.ops import geometry as jgeo
from image_processor_pipeline_tpu_torch import interop, kernels
from image_processor_pipeline_tpu_torch.models import chains as tchains
from image_processor_pipeline_tpu_torch.ops import geometry as tgeo
from image_processor_pipeline_tpu_torch.ops import native_draws
from image_processor_pipeline_tpu_torch.utils import profiling

PORT_MODULES = (
    "image_processor_pipeline_tpu_torch",
    "image_processor_pipeline_tpu_torch.random",
    "image_processor_pipeline_tpu_torch.interop",
    "image_processor_pipeline_tpu_torch.kernels",
    "image_processor_pipeline_tpu_torch.ops.bbox",
    "image_processor_pipeline_tpu_torch.ops.geometry",
    "image_processor_pipeline_tpu_torch.ops.color",
    "image_processor_pipeline_tpu_torch.ops.photometric",
    "image_processor_pipeline_tpu_torch.ops.augment",
    "image_processor_pipeline_tpu_torch.ops.rotate",
    "image_processor_pipeline_tpu_torch.models",
    "image_processor_pipeline_tpu_torch.models.chains",
    "image_processor_pipeline_tpu_torch.ops.ccl",
    "image_processor_pipeline_tpu_torch.pipeline",
    "image_processor_pipeline_tpu_torch.transforms",
    "image_processor_pipeline_tpu_torch.transforms.fused",
    "image_processor_pipeline_tpu_torch.transforms.filters",
    "image_processor_pipeline_tpu_torch.transforms.cleanup",
    "image_processor_pipeline_tpu_torch.transforms.enhance",
    "image_processor_pipeline_tpu_torch.transforms.recadrages",
    "image_processor_pipeline_tpu_torch.ops.compose",
    "image_processor_pipeline_tpu_torch.transforms.overlays",
    "image_processor_pipeline_tpu_torch.transforms.ovlborder",
    "image_processor_pipeline_tpu_torch.transforms.overlays_legacy",
    "image_processor_pipeline_tpu_torch.transforms.video",
    "image_processor_pipeline_tpu_torch.transforms.rotsymchain",
    "image_processor_pipeline_tpu_torch.transforms.chainsym",
    "image_processor_pipeline_tpu_torch.transforms.symchain",
    "image_processor_pipeline_tpu_torch.transforms.rotchainsym",
    "image_processor_pipeline_tpu_torch.transforms.symchainsym",
    "image_processor_pipeline_tpu_torch.fuse",
    "image_processor_pipeline_tpu_torch.transforms.rotsym",
    "image_processor_pipeline_tpu_torch.transforms.rotchain",
    "image_processor_pipeline_tpu_torch.transforms.crop_dummy",
    "image_processor_pipeline_tpu_torch.ops.jpeg",
    "image_processor_pipeline_tpu_torch.io.native",
    "image_processor_pipeline_tpu_torch.ops.native_cpu",
    "image_processor_pipeline_tpu_torch.ops.native_draws",
    "image_processor_pipeline_tpu_torch.io.images",
    "image_processor_pipeline_tpu_torch.config",
    "image_processor_pipeline_tpu_torch.__main__",
    "image_processor_pipeline_tpu_torch.parallel",
    "image_processor_pipeline_tpu_torch.parallel.mesh",
    "image_processor_pipeline_tpu_torch.parallel.distributed",
    "image_processor_pipeline_tpu_torch.parallel.dryrun",
    "image_processor_pipeline_tpu_torch.utils.profiling",
    "image_processor_pipeline_tpu_torch.utils.hsv_tuner",
    "image_processor_pipeline_tpu_torch.utils.trace_probe",
)


def chain_inputs(B, size, seed):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (B, size, size, 3), np.uint8)
    xywhn = np.concatenate([rng.uniform(0.3, 0.7, (B, 2)),
                            rng.uniform(0.05, 0.3, (B, 2))],
                           axis=1).astype(np.float32)
    seeds = (np.arange(B) * 101 + seed).astype(np.uint32)
    return images, xywhn, seeds


def f1_items(images, xywhn, seeds, crop):
    """Items whose port shift vectors differ from JAX's (F1)."""
    _, _, angles = tchains._crop_params(images.shape[1:3], xywhn, seeds,
                                        crop)
    jq, j1, j2 = jax.vmap(lambda a: jgeo.shear_params(a, crop))(
        jnp.asarray(angles))
    tq, t1, t2 = tgeo.shear_params(torch.as_tensor(angles), crop)
    same = ((tq.numpy() == np.asarray(jq))
            & (t1.numpy() == np.asarray(j1)).all(1)
            & (t2.numpy() == np.asarray(j2)).all(1))
    return same


def assert_chain_equal(got, want, same):
    assert same.all(), (f"F1: the shift vectors of items "
                        f"{np.flatnonzero(~same).tolist()} differ from JAX's")
    np.testing.assert_array_equal(got[same], want[same])


@pytest.mark.parametrize("mode,jax_mode", [
    ("full_reference", "full_reference"), ("shear", "shear"),
    ("cuda_full", "full_reference"), ("cuda_shear", "shear"),
    ("cuda_fused", "fused_reference"),
    ("fused_reference", "fused_reference")])
def test_augment_chain_matches_jax_96_to_64(mode, jax_mode):
    """On CPU tensors the 'cuda_*' modes run their kernels' plain twins.
    JAX's 'pallas' mode needs a TPU, so 'cuda_shear' is held against its
    XLA twin 'shear'."""
    images, xywhn, seeds = chain_inputs(4, 96, seed=11)
    want = np.asarray(jchains.augment_chain(
        jnp.asarray(images), jnp.asarray(xywhn), jnp.asarray(seeds), 64,
        jax_mode))
    kernels.reset_launch_counts()
    got = tchains.augment_chain(torch.as_tensor(images), xywhn, seeds, 64,
                                mode)
    assert all(n == 0 for n in kernels.launch_counts.values())
    assert got.shape == (4, 64, 64, 4) and got.dtype == torch.uint8
    assert_chain_equal(got.numpy(), want, f1_items(images, xywhn, seeds, 64))


def test_cuda_fused_equals_cuda_full_on_cpu():
    """The post-crop kernel path and the whole-chain kernel path compute
    one function: flip, then rotate, mask and enhance."""
    images, xywhn, seeds = chain_inputs(8, 96, seed=12)
    images = torch.as_tensor(images)
    fused = tchains.augment_chain(images, xywhn, seeds, 64, "cuda_fused")
    full = tchains.augment_chain(images, xywhn, seeds, 64, "cuda_full")
    assert torch.equal(fused, full)
    flips, _ = tchains._flip_and_params(seeds)
    assert {1, 2} & set(flips.tolist()), "no single-axis flip drawn"
    # a single-axis flip does not commute with the rotation
    shear = tchains.augment_chain(images, xywhn, seeds, 64, "cuda_shear")
    assert not torch.equal(shear, fused)


def test_cuda_full_reads_the_canvas_without_packing(monkeypatch):
    """'cuda_full' hands the uint8 canvas to its wrapper as it is (no
    pack_rgba pass) and still equals JAX's full_reference except for F1
    items; 'full_reference' keeps the JAX contract's packed canvas."""
    images, xywhn, seeds = chain_inputs(4, 96, seed=13)
    want = np.asarray(jchains.augment_chain(
        jnp.asarray(images), jnp.asarray(xywhn), jnp.asarray(seeds), 64,
        "full_reference"))
    packed = []
    real = tchains.pack_rgba
    monkeypatch.setattr(tchains, "pack_rgba",
                        lambda x: packed.append(x.shape) or real(x))
    got = tchains.augment_chain(torch.as_tensor(images), xywhn, seeds, 64,
                                "cuda_full")
    assert packed == []
    assert_chain_equal(got.numpy(), want, f1_items(images, xywhn, seeds, 64))
    ref = tchains.augment_chain(torch.as_tensor(images), xywhn, seeds, 64,
                                "full_reference")
    assert len(packed) == 1 and torch.equal(got, ref)


def test_augment_chain_module_matches_jax_640():
    chain = tchains.AugmentChain(input_size=640, rotation="full_reference",
                                 device="cpu")
    images, xywhn, seeds = chain.example_inputs(batch=2)
    jimages, jxywhn, jseeds = jchains.AugmentChain(640).example_inputs(2)
    np.testing.assert_array_equal(images.numpy(), jimages)
    np.testing.assert_array_equal(xywhn.numpy(), jxywhn)
    np.testing.assert_array_equal(seeds.numpy(), jseeds)
    want = np.asarray(jchains.augment_chain(
        jnp.asarray(jimages), jnp.asarray(jxywhn), jnp.asarray(jseeds), 512,
        "full_reference"))
    got = chain(images, xywhn, seeds)
    assert got.shape == (2, 512, 512, 4) and got.device.type == "cpu"
    assert_chain_equal(got.numpy(), want,
                       f1_items(jimages, jxywhn, jseeds, 512))


def test_chain_rejects_bad_configuration():
    """What is left to refuse: a canvas smaller than the crop and a mode
    of the JAX package's that the port names otherwise, from the module
    and from the function."""
    with pytest.raises(ValueError):
        tchains.AugmentChain(input_size=500, device="cpu")
    images, xywhn, seeds = chain_inputs(1, 96, seed=0)
    with pytest.raises(ValueError, match="unknown rotation mode"):
        tchains.AugmentChain(rotation="pallas_full", device="cpu")
    with pytest.raises(ValueError, match="unknown rotation mode"):
        tchains.augment_chain(torch.as_tensor(images), xywhn, seeds, 64,
                              "pallas_full")


#: the spellings of K1's placements that the chain once took, and a TPU
#: timing probe of the JAX chain's: each is an unknown mode now
RETIRED_SPELLINGS = ("cuda_full_ikc", "cuda_full:", "cuda_full:pre",
                     "cuda_full:gath", "cuda_full:i32crop", "cuda_full:ikc",
                     "cuda_full:interp", "cuda_full:noepi")


@pytest.mark.parametrize("spelling", RETIRED_SPELLINGS)
def test_retired_spellings_raise(spelling):
    """Each retired spelling is refused as an unknown rotation mode, by
    the module and by the function."""
    images, xywhn, seeds = chain_inputs(1, 96, seed=0)
    with pytest.raises(ValueError, match="unknown rotation mode"):
        tchains.AugmentChain(rotation=spelling, device="cpu")
    with pytest.raises(ValueError, match="unknown rotation mode"):
        tchains.augment_chain(torch.as_tensor(images), xywhn, seeds, 64,
                              spelling)


def test_port_never_imports_jax():
    """The port's modules load without jax (own process: conftest imports
    jax into this one)."""
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in PORT_MODULES)
            + "bad = sorted(m for m in sys.modules if m == 'jax' "
              "or m.startswith(('jax.', 'jaxlib', "
              "'image_processor_pipeline_tpu.')))\n"
              "assert not bad, bad\nprint('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


@pytest.mark.parametrize("channels", [3, 4])
def test_cuda_shear_reads_the_canvas_without_a_crop_index(monkeypatch,
                                                          channels):
    """'cuda_shear' hands the canvas and offsets to shear_rotate_crop (no
    torch crop), launches nothing on the CPU, and equals 'shear' on 3- and
    4-channel canvases."""
    images, xywhn, seeds = chain_inputs(4, 96, seed=14)
    if channels == 4:
        alpha = np.full((*images.shape[:3], 1), 77, np.uint8)
        images = np.concatenate([images, alpha], axis=-1)
    images = torch.as_tensor(images)
    crops = []
    real = tchains._crop
    monkeypatch.setattr(tchains, "_crop",
                        lambda *a, **k: crops.append(1) or real(*a, **k))
    kernels.reset_launch_counts()
    got = tchains.augment_chain(images, xywhn, seeds, 64, "cuda_shear")
    assert crops == [] and all(n == 0 for n in kernels.launch_counts.values())
    want = tchains.augment_chain(images, xywhn, seeds, 64, "shear")
    assert crops == [1] and torch.equal(got, want)


@pytest.fixture
def fresh_recorder():
    rec = profiling.RECORDER
    rec.reset()
    yield rec
    rec.reset()


def test_the_native_draws_are_counted_and_change_no_byte(monkeypatch,
                                                         fresh_recorder):
    """One call counts ``chain.draws_native`` twice (both draw functions
    served by the library) and, with the library taken away, not at all;
    the output bytes are the same both ways."""
    assert native_draws.available(), native_draws.build_error()
    images, xywhn, seeds = chain_inputs(3, 96, seed=21)
    images = torch.as_tensor(images)
    with profiling.recording() as rec:
        native = tchains.augment_chain(images, xywhn, seeds, 64)
    assert rec.counters["chain.draws_native"] == 2
    rec.reset()
    monkeypatch.setattr(native_draws, "available", lambda: False)
    with profiling.recording() as rec:
        fallback = tchains.augment_chain(images, xywhn, seeds, 64)
    assert "chain.draws_native" not in rec.counters
    assert rec.counters["chain.h2d_copies"] == 7
    assert torch.equal(native, fallback)


@pytest.mark.parametrize("mode", ["cuda_full", "shear", "gather"])
def test_each_draw_function_runs_once_a_call(monkeypatch, mode):
    """The two draw functions are module globals called once each a call
    (port_bench/drivers/chain.py times them by those names)."""
    calls = []
    for name in ("_crop_params", "_flip_and_params"):
        real = getattr(tchains, name)
        monkeypatch.setattr(tchains, name, lambda *a, _n=name, _f=real, **k:
                            calls.append(_n) or _f(*a, **k))
    images, xywhn, seeds = chain_inputs(2, 96, seed=22)
    for i in range(1, 3):
        tchains.augment_chain(torch.as_tensor(images), xywhn, seeds, 64,
                              mode)
        assert calls == ["_crop_params", "_flip_and_params"] * i


# 'gather' makes no shift vectors: its cos and sin come from the host's
# angles instead (test_gather_takes_cos_sin_from_the_host_angles)
@pytest.mark.parametrize("mode", [m for m in tchains.MODES if m != "gather"])
def test_chain_takes_its_shift_vectors_from_the_host_angles(monkeypatch,
                                                            mode):
    """F6: every mode computes shear_params once, from the CPU tensor of
    the host's angles, and hands the vectors to its kernel wrapper or
    plain twin (which would otherwise compute them again on the images'
    device)."""
    images, xywhn, seeds = chain_inputs(4, 96, seed=15)
    calls = []
    real = tgeo.shear_params
    monkeypatch.setattr(tgeo, "shear_params",
                        lambda a, H: calls.append((a, H)) or real(a, H))
    got = tchains.augment_chain(torch.as_tensor(images), xywhn, seeds, 64,
                                mode)
    _, _, angles = tchains._crop_params(images.shape[1:3], xywhn, seeds, 64)
    assert len(calls) == 1
    (a, H), = calls
    assert H == 64 and a.device.type == "cpu" and a.dtype == torch.float32
    np.testing.assert_array_equal(a.numpy(), angles)
    monkeypatch.setattr(tgeo, "shear_params", real)
    twin = {"cuda_full": "full_reference", "cuda_fused": "fused_reference",
            "cuda_shear": "shear"}.get(mode, mode)
    assert torch.equal(got, tchains.augment_chain(
        torch.as_tensor(images), xywhn, seeds, 64, twin))


# -- the 'gather' mode: rotate_fixed, the direct nearest inverse map ----------

def jax_cos_sin(angles):
    """XLA's float32 (cos, sin) of the JAX rotate_fixed, as numpy."""
    theta = jnp.deg2rad(jnp.asarray(angles, jnp.float32))
    return np.asarray(jnp.cos(theta)), np.asarray(jnp.sin(theta))


@pytest.mark.parametrize("S,angle", [(64, a) for a in (
    17.0, 45.0, 90.0, 133.0, 180.0, 260.0, 359.0)] + [(768, 44.0)])
def test_rotate_fixed_matches_jax(S, angle):
    """tests/test_chains.py:18-61's angles and sizes: byte for byte against
    the eager JAX rotate_fixed given XLA's cos/sin, and with the host's
    own cos/sin wherever they are XLA's (else within F17's bound)."""
    rng = np.random.default_rng(int(angle) + S)
    img = rng.integers(0, 256, (S, S, 3), np.uint8)
    want = np.asarray(jgeo.rotate_fixed(jnp.asarray(img), S, S, angle))
    batch = torch.as_tensor(img[None])
    cs = interop.cos_sin_from_jax(*jax_cos_sin([angle]))
    got = tgeo.rotate_fixed(batch, S, S, cos_sin=cs)
    np.testing.assert_array_equal(got[0].numpy(), want)
    own = tgeo.rotate_fixed(batch, S, S, [angle])[0].numpy()
    if all(a == b for a, b in zip(tgeo.rotation_cos_sin([angle]),
                                  jax_cos_sin([angle]))):
        np.testing.assert_array_equal(own, want)
    else:
        assert (own != want).any(-1).mean() <= F17_BOUND


#: F17: pixels that the host's cos/sin move against XLA's, as a share of
#: all pixels over 20,000 angles at S=512 (measured 1.88e-7)
F17_BOUND = 1e-6


def test_rotate_fixed_f17_rate_of_moved_pixels():
    """F17: over 20,000 angles from uniform(1, 359), the host's float32
    cos/sin differ from XLA's on some angles; the rotation given each pair
    moves at most F17_BOUND of the pixels at S=512 (only those angles can
    move one).  Each pixel of the probe carries its own index."""
    S, n = 512, 20_000
    angles = np.random.default_rng(17).uniform(1, 359, n).astype(np.float32)
    hc, hs = tgeo.rotation_cos_sin(angles)
    jc, js = jax_cos_sin(angles)
    differ = np.flatnonzero((hc != jc) | (hs != js))
    assert 0 < len(differ) < 0.05 * n, len(differ)
    probe = torch.arange(1, S * S + 1, dtype=torch.int32).reshape(1, S, S, 1)
    moved = 0
    for i in range(0, len(differ), 64):
        k = differ[i:i + 64]
        batch = probe.expand(len(k), S, S, 1)
        moved += int((tgeo.rotate_fixed(batch, S, S, cos_sin=(hc[k], hs[k]))
                      != tgeo.rotate_fixed(batch, S, S,
                                           cos_sin=(jc[k], js[k]))).sum())
    assert moved / (n * S * S) <= F17_BOUND, (len(differ), moved)


def test_gather_chain_matches_jax():
    """The 'gather' chain against JAX's augment_chain(..., 'gather')
    called eagerly: byte for byte given XLA's cos/sin, and with the host's
    own on every item whose cos/sin are XLA's."""
    images, xywhn, seeds = chain_inputs(4, 96, seed=21)
    want = np.asarray(jchains.augment_chain(
        jnp.asarray(images), jnp.asarray(xywhn), jnp.asarray(seeds), 64,
        "gather"))
    _, _, angles = tchains._crop_params(images.shape[1:3], xywhn, seeds, 64)
    own = tchains.augment_chain(torch.as_tensor(images), xywhn, seeds, 64,
                                "gather").numpy()
    same = np.all(np.stack(tgeo.rotation_cos_sin(angles))
                  == np.stack(jax_cos_sin(angles)), axis=0)
    np.testing.assert_array_equal(own[same], want[same])
    real = tgeo.rotation_cos_sin
    tgeo.rotation_cos_sin = lambda a: jax_cos_sin(a)
    try:
        got = tchains.augment_chain(torch.as_tensor(images), xywhn, seeds,
                                    64, "gather")
    finally:
        tgeo.rotation_cos_sin = real
    np.testing.assert_array_equal(got.numpy(), want)


def test_gather_takes_cos_sin_from_the_host_angles(monkeypatch):
    """'gather' computes (cos, sin) once, on the host, from the drawn
    angles, and computes no shift vectors' rotation."""
    images, xywhn, seeds = chain_inputs(4, 96, seed=22)
    calls = []
    real = tgeo.rotation_cos_sin
    monkeypatch.setattr(tgeo, "rotation_cos_sin",
                        lambda a: calls.append(np.asarray(a)) or real(a))
    tchains.augment_chain(torch.as_tensor(images), xywhn, seeds, 64,
                          "gather")
    _, _, angles = tchains._crop_params(images.shape[1:3], xywhn, seeds, 64)
    assert len(calls) == 1
    np.testing.assert_array_equal(calls[0], angles)


def test_gather_footprint_agrees_with_shear():
    """JAX's bar (tests/test_chains.py:122-136): the direct map and the
    3-shear cover the same footprint, IoU > 0.8."""
    images, xywhn, seeds = chain_inputs(4, 96, seed=23)
    a = tchains.augment_chain(torch.as_tensor(images), xywhn, seeds, 64,
                              "shear").numpy()
    b = tchains.augment_chain(torch.as_tensor(images), xywhn, seeds, 64,
                              "gather").numpy()
    nz_a, nz_b = a[..., :3].sum(-1) > 0, b[..., :3].sum(-1) > 0
    assert (nz_a & nz_b).sum() / max(1, (nz_a | nz_b).sum()) > 0.8


# -- the canvas's alpha -------------------------------------------------------

@pytest.mark.parametrize("mode", tchains.MODES)
def test_every_mode_ignores_the_canvas_alpha(mode):
    """A 4-channel canvas whose alpha is 99 gives the bytes of its
    3-channel canvas in every mode, and nothing launches on the CPU."""
    images, xywhn, seeds = chain_inputs(8, 96, seed=24)
    alpha = np.full((*images.shape[:3], 1), 99, np.uint8)
    rgba = torch.as_tensor(np.concatenate([images, alpha], axis=-1))
    kernels.reset_launch_counts()
    got = tchains.augment_chain(rgba, xywhn, seeds, 64, mode)
    assert all(n == 0 for n in kernels.launch_counts.values())
    assert torch.equal(got, tchains.augment_chain(torch.as_tensor(images),
                                                  xywhn, seeds, 64, mode))

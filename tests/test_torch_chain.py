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
from image_processor_pipeline_tpu_torch import kernels
from image_processor_pipeline_tpu_torch.models import chains as tchains
from image_processor_pipeline_tpu_torch.ops import geometry as tgeo

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
    "image_processor_pipeline_tpu_torch.io.images",
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
    with pytest.raises(ValueError):
        tchains.AugmentChain(input_size=500, device="cpu")
    with pytest.raises(ValueError):
        tchains.AugmentChain(rotation="pallas_full", device="cpu")
    images, xywhn, seeds = chain_inputs(1, 96, seed=0)
    with pytest.raises(ValueError):
        tchains.augment_chain(torch.as_tensor(images), xywhn, seeds, 64,
                              "gather")


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
    _crop_one), launches nothing on the CPU, and equals 'shear' on 3- and
    4-channel canvases."""
    images, xywhn, seeds = chain_inputs(4, 96, seed=14)
    if channels == 4:
        alpha = np.full((*images.shape[:3], 1), 77, np.uint8)
        images = np.concatenate([images, alpha], axis=-1)
    images = torch.as_tensor(images)
    crops = []
    real = tchains._crop_one
    monkeypatch.setattr(tchains, "_crop_one",
                        lambda *a, **k: crops.append(1) or real(*a, **k))
    kernels.reset_launch_counts()
    got = tchains.augment_chain(images, xywhn, seeds, 64, "cuda_shear")
    assert crops == [] and all(n == 0 for n in kernels.launch_counts.values())
    want = tchains.augment_chain(images, xywhn, seeds, 64, "shear")
    assert crops == [1] and torch.equal(got, want)


@pytest.mark.parametrize("mode", tchains.MODES)
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

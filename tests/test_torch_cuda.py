"""The port's hand-written CUDA kernels against their plain PyTorch twins on
the card, byte for byte, and the chain modes that run through them.  Needs
a CUDA card and skips without one.

This file imports neither jax nor the JAX package, so it also runs where jax
is not installed, with the repository's conftest (which imports jax) left
out:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from image_processor_pipeline_tpu_torch import interop, kernels
from image_processor_pipeline_tpu_torch.models import chains
from image_processor_pipeline_tpu_torch.ops import augment, geometry, rotate
from image_processor_pipeline_tpu_torch.ops import native_draws
from image_processor_pipeline_tpu_torch.utils import profiling

FILTERS = (chains._FILTER_LOWERS, chains._FILTER_UPPERS,
           chains._FILTER_ZONES)
BOUNDARY_ANGLES = (0.0, 44.99, 45.0, 45.01, 90.0, 135.0, 180.0, 270.0,
                   315.0, 358.9)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def kernel_args(B, SIN, S, shift, dev):
    """Canvases and draws with every flip code and the boundary angles;
    ``shift`` moves the crop offsets off the canvas."""
    rng = np.random.default_rng(S + abs(shift))
    imgs = rng.integers(0, 256, (B, SIN, SIN, 3), np.uint8)
    y0 = rng.integers(0, SIN - S + 1, B) + shift
    x0 = rng.integers(0, SIN - S + 1, B) - shift
    angles = (BOUNDARY_ANGLES + tuple(rng.uniform(1, 359, B)))[:B]
    y0, x0, angles, flips, prms = interop.draws_from_jax(
        y0, x0, angles, np.arange(B) % 4, rng.uniform(0.7, 1.3, (B, 8)), dev)
    packed = augment.pack_rgba(torch.as_tensor(imgs, device=dev))
    return packed, y0, x0, angles, prms, flips


def canvas_form(packed, form):
    """The packed canvas as itself or as a uint8 canvas of 4 or 3 channels."""
    if form == "packed":
        return packed
    u8 = packed.view(torch.uint8).view(*packed.shape, 4)
    return u8 if form == "u8_4" else u8[..., :3].contiguous()


# the smallest crop above the cluster path's shared-memory limit
TWO_PASS_S = 927


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["packed", "u8_4", "u8_3"])
@pytest.mark.parametrize("SIN,S,B,shift", [
    (96, 64, 8, 0), (640, 512, 4, 0), (96, 64, 8, -70), (96, 64, 8, 50),
    (128, 97, 8, 0), (TWO_PASS_S + 41, TWO_PASS_S, 2, 0)])
def test_kernel_matches_plain_on_card(cuda_device, SIN, S, B, shift, form):
    """Both paths (chain_path: cluster up to the limit, two passes above),
    for the packed canvas and the uint8 canvases of 4 and 3 channels."""
    packed, *draws = kernel_args(B, SIN, S, shift, cuda_device)
    kernels.reset_launch_counts()
    got = augment.augment_fused_full(canvas_form(packed, form), *draws,
                                     *FILTERS, crop=S)
    assert kernels.launch_counts["augment_full"] == 1
    want = augment.augment_full_reference(packed, *draws, *FILTERS, crop=S)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("path,cluster", [("cluster", 8), ("cluster", 16),
                                          ("two_pass", None)])
def test_each_path_and_cluster_size_on_card(cuda_device, path, cluster):
    packed, y0, x0, angles, prms, flips = kernel_args(8, 640, 512, 0,
                                                      cuda_device)
    u8 = canvas_form(packed, "u8_3")
    shifts = augment._shifts(angles, 512)
    args = augment.chain_args(u8, y0, x0, shifts, prms, flips, *FILTERS, 512)
    got = augment.launch_chain("augment_full", *args, path=path,
                               cluster=cluster)
    want = augment.augment_full_reference(packed, y0, x0, angles, prms,
                                          flips, *FILTERS, crop=512,
                                          shifts=shifts)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [4, 8])
def test_chain_through_kernel_on_card(cuda_device, batch):
    chain = chains.AugmentChain(input_size=640, device=cuda_device)
    images, xywhn, seeds = chain.example_inputs(batch=batch)
    kernels.reset_launch_counts()
    got = chain(images, xywhn, seeds)
    assert kernels.launch_counts["augment_full"] == 1
    want = chains.augment_chain(images, xywhn, seeds,
                                rotation="full_reference")
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_gather_chain_on_card_matches_the_cpu(cuda_device):
    """'gather' on the card (one index gather, the host's cos/sin) equals
    the same chain on the CPU, byte for byte."""
    chain = chains.AugmentChain(input_size=640, rotation="gather",
                                device=cuda_device)
    images, xywhn, seeds = chain.example_inputs(batch=8)
    got = chain(images, xywhn, seeds)
    want = chains.augment_chain(images.cpu(), xywhn, seeds,
                                rotation="gather")
    assert torch.equal(got.cpu(), want)


# -- the chain's packed path (models/chains.py:_packed_call) -------------------

@pytest.fixture
def recorder():
    rec = profiling.RECORDER
    rec.reset()
    yield rec
    rec.reset()


def packed_inputs(B, dev, seed):
    """B 640 px canvases on the card, boxes and large seeds."""
    rng = np.random.default_rng(seed)
    images = torch.randint(0, 256, (B, 640, 640, 3), dtype=torch.uint8,
                           device=dev,
                           generator=torch.Generator(dev).manual_seed(seed))
    xywhn = np.concatenate([rng.uniform(0.3, 0.7, (B, 2)),
                            rng.uniform(0.05, 0.3, (B, 2))],
                           axis=1).astype(np.float32)
    seeds = 2**33 + seed * 1000 + np.arange(B, dtype=np.int64)
    return images, xywhn, seeds


def todays_glue(images, xywhn, seeds, S=512):
    """The 'cuda_full' call as the array-at-a-time glue makes it: the
    draws, shear_params' vectors, seven copies, augment_fused_full."""
    y0, x0, angles = chains._crop_params(images.shape[1:3], xywhn, seeds, S)
    flips, prms = chains._flip_and_params(seeds)
    shifts = geometry.shear_params(torch.from_numpy(angles), S)
    y0, x0, flips, prms, *shifts = (
        torch.as_tensor(a, device=images.device)
        for a in (y0, x0, flips, prms, *shifts))
    return augment.augment_fused_full(images, y0, x0, None, prms, flips,
                                      *FILTERS, crop=S, shifts=shifts)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 16, 256])
def test_the_packed_path_gives_the_bytes_of_todays_glue(cuda_device,
                                                        recorder, B):
    """'cuda_full' on the card: one packed copy, one K1 launch, counted
    as one packed call, the bytes of the array-at-a-time glue."""
    assert native_draws.available(), native_draws.build_error()
    images, xywhn, seeds = packed_inputs(B, cuda_device, seed=B)
    kernels.reset_launch_counts()
    with profiling.recording():
        got = chains.augment_chain(images, xywhn, seeds)
    assert recorder.counters["chain.packed"] == 1
    assert recorder.counters["chain.factors_native"] == 1
    assert recorder.counters["chain.h2d_copies"] == 1
    assert kernels.launch_counts["augment_full"] == 1
    want = todays_glue(images, xywhn, seeds)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [97, 512])
@pytest.mark.parametrize("B", [5, 15, 17])
def test_the_packed_path_equals_the_plain_twin_on_card(cuda_device, recorder,
                                                       B, S):
    """'cuda_full' (native factors, one pack, K1) against 'full_reference'
    (shear_params' torch factors, the kernel's plain twin) on 640 px
    canvases, byte for byte, at batches off the kernel's cluster and
    vector widths and at an odd crop."""
    images, xywhn, seeds = packed_inputs(B, cuda_device, seed=100 + B + S)
    with profiling.recording():
        got = chains.augment_chain(images, xywhn, seeds, crop=S)
    assert recorder.counters["chain.factors_native"] == 1
    want = chains.augment_chain(images, xywhn, seeds, crop=S,
                                rotation="full_reference")
    torch.cuda.synchronize()
    assert got.shape == (B, S, S, 4)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_back_to_back_packed_calls_equal_synchronised_ones(cuda_device,
                                                           recorder):
    """32 calls queued behind a sleeping kernel, so that every pack is
    written before any copy lands, equal the same calls synchronised one
    by one: no pinned block is handed out again before its copy."""
    images, xywhn, seeds = packed_inputs(16, cuda_device, seed=32)
    calls = [seeds + 16 * i for i in range(32)]
    torch.cuda.synchronize()
    with profiling.recording():
        torch.cuda._sleep(200_000_000)
        queued = [chains.augment_chain(images, xywhn, s) for s in calls]
    torch.cuda.synchronize()
    assert recorder.counters["chain.packed"] == 32
    assert recorder.counters["chain.h2d_copies"] == 32
    for s, got in zip(calls, queued):
        want = chains.augment_chain(images, xywhn, s)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_other_modes_take_todays_glue(cuda_device, recorder):
    """'cuda_shear' copies its arrays one at a time, counts no packed call
    and gives today's bytes."""
    images, xywhn, seeds = packed_inputs(16, cuda_device, seed=7)
    want = chains.augment_chain(images, xywhn, seeds, rotation="shear")
    with profiling.recording():
        got = chains.augment_chain(images, xywhn, seeds,
                                   rotation="cuda_shear")
    assert "chain.packed" not in recorder.counters
    assert "chain.factors_native" not in recorder.counters
    assert recorder.counters["chain.h2d_copies"] == 7
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_full_without_the_library_raises_on_card(cuda_device,
                                                      monkeypatch, recorder):
    """'cuda_full' has no other glue on the card: without the native
    library it raises, naming the build's error, before any draw, copy or
    launch."""
    images, xywhn, seeds = packed_inputs(16, cuda_device, seed=7)
    monkeypatch.setattr(native_draws, "available", lambda: False)
    monkeypatch.setattr(native_draws, "build_error",
                        lambda: "g++: the build's error")
    kernels.reset_launch_counts()
    with profiling.recording():
        with pytest.raises(RuntimeError, match=r"g\+\+: the build's error"):
            chains.augment_chain(images, xywhn, seeds)
    assert not recorder.counts and not recorder.counters
    assert kernels.launch_counts["augment_full"] == 0


def rotate_args(B, S, C, dev):
    """Images and shift vectors covering the boundary angles (every quad)."""
    rng = np.random.default_rng(S * 10 + C)
    imgs = torch.as_tensor(rng.integers(0, 256, (B, S, S, C), np.uint8),
                           device=dev)
    angles = (BOUNDARY_ANGLES + tuple(rng.uniform(1, 359, B)))[:B]
    angles = torch.as_tensor(np.asarray(angles, np.float32), device=dev)
    return imgs, geometry.shear_params(angles, S)


@pytest.fixture
def direct_tiles(cuda_device):
    """kernels.direct_tiles set to a zeroed counter for the test."""
    kernels.direct_tiles = torch.zeros(1, dtype=torch.int32,
                                       device=cuda_device)
    yield kernels.direct_tiles
    kernels.direct_tiles = None


def rotate_name(C):
    return "shear_rotate_packed" if C in (3, 4) else "shear_rotate"


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 2, 3, 4])
@pytest.mark.parametrize("S", [64, 97, 512, 768])
def test_shear_rotate_matches_plain_on_card(cuda_device, direct_tiles, S, C):
    """The tiled path, every quad and the boundary angles: no tile of
    shear_params vectors leaves its window."""
    imgs, shifts = rotate_args(16 if S < 512 else 10, S, C, cuda_device)
    kernels.reset_launch_counts()
    got = rotate.shear_rotate(imgs, *shifts)
    assert kernels.launch_counts[rotate_name(C)] == 1
    assert sum(kernels.launch_counts.values()) == 1
    want = geometry.rotate_square_shear_by(imgs, *shifts)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert int(direct_tiles) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 2, 3, 4])
def test_shear_rotate_arbitrary_vectors_on_card(cuda_device, direct_tiles, C):
    """Random shifts past the clip and quads outside [0, 4): the kernel
    applies applied_shifts itself, and the tiles whose sources spread
    beyond the window take the direct path."""
    B, S = 8, 256
    rng = np.random.default_rng(20 + C)
    imgs = torch.as_tensor(rng.integers(0, 256, (B, S, S, C), np.uint8),
                           device=cuda_device)
    quad = torch.tensor([-1, 0, 1, 2, 3, 7, 4, -9], dtype=torch.int32,
                        device=cuda_device)
    sh1, sh2 = (torch.as_tensor(rng.integers(-S, S + 1, (B, S)),
                                dtype=torch.int32, device=cuda_device)
                for _ in range(2))
    got = rotate.shear_rotate(imgs, quad, sh1, sh2)
    want = geometry.rotate_square_shear_by(imgs, quad, sh1, sh2)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert int(direct_tiles) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("S,C", [(97, 1), (97, 2), (512, 3), (512, 4),
                                 (768, 1)])
def test_shear_rotate_forced_direct_on_card(cuda_device, direct_tiles, S, C):
    imgs, (quad, sh1, sh2) = rotate_args(8, S, C, cuda_device)
    got = rotate.launch_shear(imgs, quad, sh1, sh2, path="direct")
    want = geometry.rotate_square_shear_by(imgs, quad, sh1, sh2)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert int(direct_tiles) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["tiled", "direct"])
@pytest.mark.parametrize("S,C", [(97, 1), (97, 3), (512, 1), (512, 3),
                                 (768, 4)])
def test_shear_rotate_each_path_on_card(cuda_device, direct_tiles, S, C,
                                        path):
    imgs, shifts = rotate_args(8, S, C, cuda_device)
    got = rotate.launch_shear(imgs, *shifts, path=path)
    want = geometry.rotate_square_shear_by(imgs, *shifts)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert (int(direct_tiles) > 0) == (path == "direct")


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["tiled", "direct"])
@pytest.mark.parametrize("cin", [3, 4])
@pytest.mark.parametrize("SIN,S,shift", [(96, 64, -70), (128, 97, 70),
                                         (640, 512, -70), (640, 512, 0)])
def test_shear_rotate_crop_on_card(cuda_device, direct_tiles, SIN, S, shift,
                                   cin, path):
    """cuda_shear's crop read from 3- and 4-channel canvases, offsets moved
    off the canvas, against _crop then the plain twin."""
    B = 8
    rng = np.random.default_rng(SIN + cin)
    canvas = torch.as_tensor(rng.integers(0, 256, (B, SIN, SIN, cin),
                                          np.uint8), device=cuda_device)
    y0, x0 = (torch.as_tensor(rng.integers(0, SIN - S + 1, B) + d,
                              dtype=torch.int32, device=cuda_device)
              for d in (shift, -shift))
    angles = torch.as_tensor(np.asarray(BOUNDARY_ANGLES[:B], np.float32),
                             device=cuda_device)
    shifts = geometry.shear_params(angles, S)
    kernels.reset_launch_counts()
    got = rotate.launch_shear(canvas, *shifts, offsets=(y0, x0), channels=3,
                              path=path)
    assert kernels.launch_counts["shear_rotate_packed"] == 1
    want = geometry.rotate_square_shear_by(
        augment._crop(canvas[..., :3], y0, x0, S), *shifts)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert (int(direct_tiles) > 0) == (path == "direct")
    assert torch.equal(rotate.shear_rotate_crop(canvas, y0, x0, *shifts, S),
                       want)


@pytest.mark.cuda
@pytest.mark.parametrize("S,B", [(64, 8), (512, 4), (97, 8),
                                 (TWO_PASS_S, 2)])
def test_augment_fused_matches_plain_on_card(cuda_device, S, B):
    packed, _, _, angles, prms, flips = kernel_args(B, S, S, 0, cuda_device)
    crops = packed[..., None].view(torch.uint8)[..., :3].contiguous()
    kernels.reset_launch_counts()
    got = augment.augment_fused(crops, angles, prms, *FILTERS, flips=flips)
    assert kernels.launch_counts["augment_fused"] == 1
    want = augment.augment_finish_reference(crops, angles, prms, *FILTERS,
                                            flips=flips)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [4, 8])
@pytest.mark.parametrize("mode,twin,kernel", [
    ("cuda_shear", "shear", "shear_rotate_packed"),
    ("cuda_fused", "cuda_full", "augment_fused")])
def test_chain_modes_through_kernels_on_card(cuda_device, mode, twin,
                                             kernel, batch):
    chain = chains.AugmentChain(input_size=640, rotation=mode,
                                device=cuda_device)
    images, xywhn, seeds = chain.example_inputs(batch=batch)
    kernels.reset_launch_counts()
    got = chain(images, xywhn, seeds)
    assert kernels.launch_counts[kernel] == 1
    assert sum(kernels.launch_counts.values()) == 1
    want = chains.augment_chain(images, xywhn, seeds, rotation=twin)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# -- the probe kernel (csrc/rev_probe.cu) -------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(512, 512), (37, 101), (1, 4), (5, 1),
                                   (64, 1028), (2051, 12)])
@pytest.mark.parametrize("name", ["copy", "roll", "rev_cols", "rev_rows"])
def test_rev_probe_matches_plain_on_card(cuda_device, name, shape):
    """Byte for byte against torch.flip / torch.roll / clone, on shapes
    that take the 16-byte vectors and shapes that take single words."""
    from image_processor_pipeline_tpu_torch.utils import rev_probe

    rng = np.random.default_rng(shape[0] + shape[1])
    x = torch.as_tensor(rng.integers(-2**31, 2**31, shape,
                                     dtype=np.int64).astype(np.int32),
                        device=cuda_device)
    for shift in ((7, 0, -5, shape[1] + 3) if name == "roll" else (7,)):
        kernels.reset_launch_counts()
        got = rev_probe.move(x, name, shift)
        assert kernels.launch_counts["rev_probe"] == 1
        want = rev_probe.plain_move(x, name, shift)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert got.data_ptr() != x.data_ptr()


@pytest.mark.cuda
def test_rev_probe_unaligned_rows_take_the_word_path(cuda_device):
    """A block that starts 4 bytes into an allocation is not 16-byte
    aligned: the same results through the word kernels."""
    from image_processor_pipeline_tpu_torch.utils import rev_probe

    base = torch.arange(1 + 64 * 64, dtype=torch.int32, device=cuda_device)
    x = base[1:].view(64, 64)
    assert x.data_ptr() % 16 == 4 and x.is_contiguous()
    for name in rev_probe.MOVES:
        got = rev_probe.move(x, name)
        torch.cuda.synchronize()
        assert torch.equal(got, rev_probe.plain_move(x, name))


# -- the engine's steps on the card ---------------------------------------------

def _engine_dataset(root, n=12):
    from torch_port_data import ENGINE_SIZES, make_dataset

    return make_dataset(root / "data", n, seed=17, sizes=ENGINE_SIZES)


def _decoded(directory):
    from PIL import Image

    return {p.name: np.asarray(Image.open(p)) if p.suffix == ".png"
            else p.read_text() for p in sorted(directory.iterdir())}


def _run_steps(root, imgs, labels, device):
    from image_processor_pipeline_tpu_torch import ProcessingStep
    from image_processor_pipeline_tpu_torch.transforms import (
        GenerateSymmetries, RandomRotations, SquareCropAroundBBox)

    crop = ProcessingStep(
        "crop", SquareCropAroundBBox(), input_dirs=[imgs, labels],
        output_dirs=[root / "crops", root / "labels"], pairing_method="zip",
        seed=3, workers=2, device=device)
    rot = ProcessingStep(
        "rot", RandomRotations(), input_dirs=[root / "crops"],
        output_dirs=[root / "rot"], seed=4, workers=2, device=device,
        options={"num_rotations": 3, "method": "shear"})
    sym = ProcessingStep(
        "sym", GenerateSymmetries(), input_dirs=[root / "rot"],
        output_dirs=[root / "sym"], seed=5, workers=2, device=device)
    counts = [step.run(progress=False) for step in (crop, rot, sym)]
    return counts, rot


@pytest.mark.cuda
def test_engine_steps_on_card_launch_the_kernel_and_match_the_plain_twin(
        cuda_device, tmp_path, monkeypatch):
    """crop_square, rotations (method shear) and symmetry over a directory
    of PNGs on the card: every item Success, the rotation kernel launched
    once a batch, and every file equal to a second run in which the plain
    twin (geometry.rotate_square_shear_by on the card, the same shift
    vectors) stands in the kernel's place."""
    from image_processor_pipeline_tpu_torch.transforms import rotations

    imgs, labels = _engine_dataset(tmp_path)
    kernels.reset_launch_counts()
    counts, rot = _run_steps(tmp_path / "kernel", imgs, labels, cuda_device)
    assert [dict(c) for c in counts] == [{"Success": 12}, {"Success": 12},
                                         {"Success": 48}]
    assert kernels.launch_counts["shear_rotate_packed"] == \
        rot.metrics.batches >= 2

    def plain_batch(images, angles, shifts=None):
        if shifts is None:
            shifts = geometry.shear_params(angles, images.shape[1])
        return geometry.rotate_square_shear_by(images, *shifts)

    monkeypatch.setattr(rotations.rotate_ops, "rotate_square_shear_batch",
                        plain_batch)
    kernels.reset_launch_counts()
    _run_steps(tmp_path / "plain", imgs, labels, cuda_device)
    assert kernels.launch_counts["shear_rotate_packed"] == 0
    for d in ("crops", "labels", "rot", "sym"):
        got = _decoded(tmp_path / "kernel" / d)
        want = _decoded(tmp_path / "plain" / d)
        assert sorted(got) == sorted(want) and len(got) > 0
        for name in got:
            assert np.array_equal(got[name], want[name]), (d, name)


@pytest.mark.cuda
def test_crop_and_symmetry_on_card_match_the_cpu(cuda_device, tmp_path):
    """No trigonometry in these two steps: the card's files equal the
    CPU's exactly."""
    from image_processor_pipeline_tpu_torch import ProcessingStep
    from image_processor_pipeline_tpu_torch.transforms import (
        GenerateSymmetries, SquareCropAroundBBox)

    imgs, labels = _engine_dataset(tmp_path)
    for device in ("cpu", cuda_device):
        root = tmp_path / str(device).replace(":", "_")
        ProcessingStep("crop", SquareCropAroundBBox(),
                       input_dirs=[imgs, labels],
                       output_dirs=[root / "crops", root / "labels"],
                       pairing_method="zip", seed=3,
                       device=device).run(progress=False)
        ProcessingStep("sym", GenerateSymmetries(), input_dirs=[imgs],
                       output_dirs=[root / "sym"], seed=5,
                       device=device).run(progress=False)
    for d in ("crops", "labels", "sym"):
        got = _decoded(tmp_path / "cuda_0" / d)
        want = _decoded(tmp_path / "cpu" / d)
        assert sorted(got) == sorted(want) and len(got) >= 12
        for name in got:
            assert np.array_equal(got[name], want[name]), (d, name)


@pytest.mark.cuda
def test_host_buffers_are_pinned_for_the_card(cuda_device):
    from image_processor_pipeline_tpu_torch.transforms.base import (
        BatchTransform, host_zeros, to_device)

    a = host_zeros((4, 8, 8, 3), cuda_device)
    assert torch.from_numpy(a).is_pinned() and not a.any()
    a[...] = 7
    t = to_device(a, cuda_device)
    out = {"x": t, "_stash": t, "n": torch.arange(4)}
    BatchTransform.start_host_copy(out)
    items = BatchTransform.materialize_batch(out, 3)
    assert len(items) == 3 and sorted(items[0]) == ["n", "x"]
    assert (items[2]["x"] == 7).all() and items[2]["n"] == 2
    assert out["_host_copy"][0]["x"].is_pinned()


# -- the mask, cleanup, enhance and crop ops and steps on the card --------------

def _canvases(seed, B=6, H=96, W=128, C=3):
    """Random canvases with per-item extents, zero outside them."""
    rng = np.random.default_rng(seed)
    hs = rng.integers(8, H + 1, B).astype(np.int32)
    ws = rng.integers(8, W + 1, B).astype(np.int32)
    img = rng.integers(0, 256, (B, H, W, C), np.uint8)
    yy, xx = np.mgrid[0:H, 0:W]
    img *= ((yy[None] < hs[:, None, None])
            & (xx[None] < ws[:, None, None]))[..., None]
    return rng, torch.as_tensor(img), torch.as_tensor(hs), torch.as_tensor(ws)


def _same_on_card(fn, cuda_device, *tensors):
    """fn's outputs on the card equal its outputs on the CPU, exactly."""
    want = fn(*tensors)
    got = fn(*(t.to(cuda_device) for t in tensors))
    torch.cuda.synchronize()
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.dtype == w.dtype
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_blur_and_enhance_on_card_match_the_cpu(cuda_device, seed):
    """The blur's constants are numpy arithmetic on the host and its passes
    integers; the blends round once an op on either device."""
    from image_processor_pipeline_tpu_torch.ops import photometric

    rng, img, hs, ws = _canvases(seed)
    B = len(img)
    sigma = rng.uniform(0.5, 3.0, B).astype(np.float32)
    mr = photometric.box_radius_bound(3.0)
    _same_on_card(lambda i, h, w: photometric.gaussian_blur(
        i, sigma, max_radius=mr, h=h, w=w, sigma_max=3.0),
        cuda_device, img, hs, ws)
    f = torch.as_tensor(rng.uniform(0.7, 1.3, (B, 3)).astype(np.float32))
    gains = torch.as_tensor(rng.uniform(0.75, 1.25, (B, 3)).astype(np.float32))
    blur = torch.arange(B) % 2 == 0
    rgb = torch.arange(B) % 3 == 0
    _same_on_card(lambda i, h, w, f, g, bl, rg: photometric.enhance(
        i, h, w, f[:, 0], f[:, 1], f[:, 2], sigma, bl, g, rg,
        blur_max_radius=mr, blur_sigma_max=3.0),
        cuda_device, img, hs, ws, f, gains, blur, rgb)


@pytest.mark.cuda
@pytest.mark.parametrize("keep_large", [False, True])
def test_cleanup_on_card_matches_the_cpu_ties_included(cuda_device,
                                                       keep_large):
    from image_processor_pipeline_tpu_torch.ops import ccl

    rng, img, hs, ws = _canvases(3, C=4)
    img[..., 3] = torch.as_tensor(np.where(
        rng.random(img.shape[:3]) > 0.45, 255, 0).astype(np.uint8)) \
        * (img[..., 0] > 0)
    img[1, ..., 3] = 0
    img[1, 2:6, 7:11, 3] = 200     # two components of one size:
    img[1, 3:7, 1:5, 3] = 255      # the smaller root index stays
    img[2, ..., 3] = 0
    _same_on_card(lambda i, h, w: ccl.cleanup_and_fit(
        i, h, w, 12, keep_large_components=keep_large),
        cuda_device, img, hs, ws)
    out, bh, bw = ccl.cleanup_and_fit(img.to(cuda_device),
                                      hs.to(cuda_device), ws.to(cuda_device),
                                      12)
    assert (int(bh[1]), int(bw[1])) == (4, 4)
    assert bool((out[1, :4, :4, 3] == 200).all())
    values = torch.tensor([[0, 3, 1, 3, 3], [5, 5, 5, 5, 5], [0, 0, 0, 0, 0]],
                          device=cuda_device)
    assert ccl.first_argmax(values).tolist() == [1, 0, 0]


@pytest.mark.cuda
def test_labels_and_sweep_counts_on_card_match_the_cpu(cuda_device,
                                                        monkeypatch):
    from image_processor_pipeline_tpu_torch.ops import ccl

    fg = torch.as_tensor(np.random.default_rng(5).random((4, 96, 128)) < 0.55)
    want, want_iters = ccl.label_components(fg, return_iters=True)
    for every in (1, 4):
        monkeypatch.setattr(ccl, "CHECK_EVERY", every)
        got, iters = ccl.label_components(fg.to(cuda_device),
                                          return_iters=True)
        assert torch.equal(got.cpu(), want)
        assert torch.equal(iters.cpu(), want_iters)


@pytest.mark.cuda
def test_color_mask_and_crops_on_card_match_the_cpu(cuda_device):
    from image_processor_pipeline_tpu_torch.ops import color

    _, img, hs, ws = _canvases(7)
    lowers = ((0, 0, 0), (35.0, 60.0, 60.0))
    uppers = ((180, 255, 110.5), (85.0, 255.0, 255.0))
    zones = ((0, 0, 0, 0), (4, 6, 2, 3))
    _same_on_card(lambda i, h, w: color.color_mask_alpha(
        i, h, w, lowers, uppers, zones), cuda_device, img, hs, ws)
    _same_on_card(lambda i, h, w: geometry.border_crop(i, h, w, 1, 2, 3, 4),
                  cuda_device, img, hs, ws)
    _same_on_card(geometry.fit_crop, cuda_device, img, hs, ws)


MASK_RANGES = [(0, 0, 0, 180, 255, 120), (20, 50, 50, 40, 255, 255)]


def _run_new_steps(root, imgs, device):
    """Pipelines C, D and E of the smoke run, at a small size."""
    from PIL import Image

    from image_processor_pipeline_tpu_torch import (ProcessingPipeline,
                                                    ProcessingStep)
    from image_processor_pipeline_tpu_torch.transforms import (
        BorderCrop, ColorMaskTransparency, EnhanceImage, FitCrop, FusedChain,
        KeepLargestComponent, fused)

    jpgs = root / "jpgs"
    jpgs.mkdir(parents=True)
    for p in sorted(imgs.iterdir()):
        Image.open(p).save(jpgs / f"{p.stem}.jpg", quality=90)
    kw = {"device": device, "workers": 2}
    pipe = ProcessingPipeline(root_dir=root)
    pipe.add_step(ProcessingStep(
        "mask", ColorMaskTransparency(), input_dirs=[imgs],
        output_dirs=["mask"], seed=3,
        options={"color_ranges_to_exclude_hsv": MASK_RANGES}, **kw))
    pipe.add_step(ProcessingStep(
        "clean", KeepLargestComponent(), output_dirs=["clean"], seed=3,
        options={"min_component_size": 20}, **kw))
    chain = ProcessingStep(
        "chain", FusedChain([fused.Rotate(method="shear"), fused.Flip(),
                             fused.ColorMask(MASK_RANGES), fused.Cleanup(20),
                             fused.Enhance(0.5, 0.5)]),
        input_dirs=[imgs], output_dirs=[root / "chain"], seed=5, **kw)
    pipe.add_step(chain)
    pipe.add_step(ProcessingStep(
        "enhance", EnhanceImage(), input_dirs=[jpgs], output_dirs=["enhance"],
        seed=4, pairing_method="sample", **kw))
    pipe.add_step(ProcessingStep(
        "border", BorderCrop(), output_dirs=["border"], seed=4,
        options={"crop_margins": (0.1, 2, 0.05, 3)}, **kw))
    pipe.add_step(ProcessingStep("fit", FitCrop(), output_dirs=["fit"],
                                 seed=4, **kw))
    return pipe.run(progress=False), chain


@pytest.mark.cuda
def test_mask_chain_and_crop_steps_on_card_match_the_cpu(cuda_device,
                                                         tmp_path):
    """Nothing in these steps depends on the card's trigonometry (the
    chain's shift vectors come from the host): the card's files equal the
    CPU's, and the chain launches the rotation kernel once a batch."""
    imgs, _ = _engine_dataset(tmp_path)
    kernels.reset_launch_counts()
    counts, chain = _run_new_steps(tmp_path / "cuda", imgs, cuda_device)
    assert [dict(c) for c in counts] == [{"Success": 12}] * 6
    assert kernels.launch_counts["shear_rotate_packed"] \
        == chain.metrics.batches >= 2
    kernels.reset_launch_counts()
    _run_new_steps(tmp_path / "cpu", imgs, "cpu")
    assert kernels.launch_counts["shear_rotate_packed"] == 0
    for d in ("mask", "clean", "chain", "enhance", "border", "fit"):
        from PIL import Image

        names = sorted(p.name for p in (tmp_path / "cuda" / d).iterdir())
        assert names == sorted(p.name for p in (tmp_path / "cpu" / d).iterdir())
        assert len(names) == 12
        for name in names:
            got = np.asarray(Image.open(tmp_path / "cuda" / d / name))
            want = np.asarray(Image.open(tmp_path / "cpu" / d / name))
            assert got.shape == want.shape and np.array_equal(got, want), \
                (d, name)


@pytest.mark.cuda
def test_rotations_on_card_match_the_cpu(cuda_device, tmp_path):
    """The shear method's vectors are computed on the host, so the step's
    files on the card equal its files on the CPU."""
    imgs, labels = _engine_dataset(tmp_path)
    _run_steps(tmp_path / "cuda", imgs, labels, cuda_device)
    _run_steps(tmp_path / "cpu", imgs, labels, "cpu")
    got = _decoded(tmp_path / "cuda" / "rot")
    want = _decoded(tmp_path / "cpu" / "rot")
    assert sorted(got) == sorted(want) and len(got) == 48
    for name in got:
        assert np.array_equal(got[name], want[name]), name


@pytest.mark.cuda
def test_empty_launch_runs_and_rejects_a_bad_grid(cuda_device):
    from image_processor_pipeline_tpu_torch.utils import rev_probe

    before = dict(kernels.launch_counts)
    rev_probe.launch_empty(cuda_device)
    rev_probe.launch_empty(cuda_device, 256)
    torch.cuda.synchronize()
    assert kernels.launch_counts == before   # not a move: not counted
    with pytest.raises(RuntimeError):
        rev_probe.launch_empty(cuda_device, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [3, 4])
def test_bilinear_rotations_on_card(cuda_device, channels):
    """The PIL-exact form is float64 arithmetic in a fixed order: the card
    gives the CPU's bytes.  The float32 form of the engine depends on the
    device's cos and sin: extents equal, pixels to 0.1 % of an item."""
    rng = np.random.default_rng(channels)
    img = np.zeros((4, 128, 128, channels), np.uint8)
    img[:, :50, :70] = rng.integers(0, 256, (4, 50, 70, channels), np.uint8)
    for angle in (30.0, 45.0, 90.0, 123.456, -17.25):
        want = geometry.rotate_bilinear_exact(torch.as_tensor(img[0]), angle,
                                              50, 70)
        got = geometry.rotate_bilinear_exact(
            torch.as_tensor(img[0], device=cuda_device), angle, 50, 70)
        assert got[1:] == want[1:] and torch.equal(got[0].cpu(), want[0])
    angles = torch.as_tensor(rng.uniform(1, 359, 4).astype(np.float32))
    h, w = torch.full((4,), 50, dtype=torch.int32), \
        torch.full((4,), 70, dtype=torch.int32)
    want = geometry.rotate_expand(torch.as_tensor(img), h, w, angles,
                                  "bilinear")
    got = geometry.rotate_expand(*(t.to(cuda_device) for t in (
        torch.as_tensor(img), h, w, angles)), "bilinear")
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[2].cpu(), want[2])
    assert (got[0].cpu() != want[0]).float().mean() <= 1e-3


# -- the chain modes on the card against the CPU (F6) ---------------------------

def moving_angles(dev, n=8):
    """Up to ``n`` angles whose shear_params computed on the card differ
    from the CPU's (the card's tanf/sinf), then random ones to fill n."""
    angles = np.random.default_rng(6).uniform(1, 359, 200_000).astype(
        np.float32)
    a = torch.as_tensor(angles)
    cpu = geometry.shear_params(a, 512)
    card = [t.cpu() for t in geometry.shear_params(a.to(dev), 512)]
    moved = np.zeros(len(angles), bool)
    for c, g in zip(cpu, card):
        moved |= (c != g).reshape(len(angles), -1).any(1).numpy()
    picked = angles[moved][:n]
    return np.concatenate([picked, angles[~moved][:n - len(picked)]])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", chains.MODES)
def test_chain_modes_on_card_match_the_cpu(cuda_device, monkeypatch, mode):
    """With the shift vectors from the host, every mode's batch on the
    card equals the same batch on the CPU, on angles where the card's own
    shear_params would move a shift."""
    angles = moving_angles(cuda_device)
    real = chains._crop_params

    def crop_params(*args, **kw):
        y0, x0, _ = real(*args, **kw)
        return y0, x0, angles[:len(y0)]

    monkeypatch.setattr(chains, "_crop_params", crop_params)
    chain = chains.AugmentChain(640, rotation=mode, device=cuda_device)
    images, xywhn, seeds = chain.example_inputs(batch=len(angles))
    got = chain(images, xywhn, seeds)
    want = chains.augment_chain(images.cpu(), xywhn, seeds, rotation=mode)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


# -- overlays, video and the composites on the card ------------------------------

@pytest.mark.cuda
def test_resize_and_paste_on_card_match_the_cpu(cuda_device):
    from image_processor_pipeline_tpu_torch.ops import compose

    rng = np.random.default_rng(12)
    img = torch.as_tensor(rng.integers(0, 256, (4, 96, 128, 4), np.uint8))
    sizes = ([90, 40, 96, 7], [128, 33, 100, 128], [45, 96, 200, 1],
             [61, 128, 33, 300])
    for method in ("lanczos", "bilinear"):
        want = geometry.resize(img, *sizes, method, out_canvas=(256, 320))
        got = geometry.resize(img.to(cuda_device), *sizes, method,
                              out_canvas=(256, 320))
        assert torch.equal(got.cpu(), want)
    bg = torch.as_tensor(rng.integers(0, 256, (4, 96, 128, 3), np.uint8))
    args = [torch.as_tensor(v, dtype=torch.int32) for v in (
        [96, 80, 50, 96], [128, 100, 128, 60], [20, 96, 1, 30],
        [30, 128, 9, 60], [0, 0, 40, 5], [3, 0, 100, 0])]
    want = compose.alpha_paste(bg, *args[:2], img, *args[2:])
    got = compose.alpha_paste(bg.to(cuda_device),
                              *(a.to(cuda_device) for a in args[:2]),
                              img.to(cuda_device),
                              *(a.to(cuda_device) for a in args[2:]))
    assert torch.equal(got.cpu(), want)


def _overlay_inputs(root, n_ov=8, n_bg=4):
    from PIL import Image
    from torch_port_data import make_image

    rng = np.random.default_rng(13)
    (root / "ov").mkdir(parents=True)
    (root / "bg").mkdir()
    for i in range(n_ov):
        ov = make_image(rng, 30 + 3 * i, 24 + 5 * i, 4)
        ov[..., 3] = np.where(ov[..., 3] > 0, 255, 0)
        ov[1:4, 1:4, 3] = 100
        Image.fromarray(ov).save(root / "ov" / f"ov{i}.png")
    for i in range(n_bg):
        Image.fromarray(make_image(rng, 70 + 10 * i, 110 - 10 * i)).save(
            root / "bg" / f"bg{i}.jpg", quality=92)
    return root / "ov", root / "bg"


@pytest.mark.cuda
def test_overlay_device_fn_on_card_matches_the_cpu(cuda_device, tmp_path):
    from image_processor_pipeline_tpu_torch.transforms import (
        PasteOverlayOntoBackground)

    ov, bg = _overlay_inputs(tmp_path)
    t = PasteOverlayOntoBackground()
    ovs, bgs = sorted(ov.iterdir()), sorted(bg.iterdir())
    chunk = [t.load_item((o, bgs[i % len(bgs)]), {})
             for i, o in enumerate(ovs)]
    by_key = {}
    for i, item in enumerate(chunk):
        item["_seed"] = 40 + i
        by_key.setdefault(t.bucket_key(item, {}), []).append(item)
    for key, items in by_key.items():
        outs = [t.launch_batch(key, items, {}, dev)
                for dev in (cuda_device, "cpu")]
        assert sorted(outs[0]) == sorted(outs[1])
        for k in outs[1]:
            assert torch.equal(outs[0][k].cpu(), outs[1][k]), k


def _run_config4(root, ov, bg, device):
    from image_processor_pipeline_tpu_torch import (ProcessingPipeline,
                                                    ProcessingStep)
    from image_processor_pipeline_tpu_torch.transforms import (
        BorderCrop, OverlaysBorderCrop, PasteOverlayOntoBackground)

    kw = {"device": device, "workers": 2}
    margins = {"crop_margins": (0.05, 0.05, 0.05, 0.05)}
    pipe = ProcessingPipeline(root_dir=root)
    pipe.add_step(ProcessingStep(
        "paste", PasteOverlayOntoBackground(), input_dirs=[ov, bg],
        output_dirs=["c4/i", "c4/l"], pairing_method="modulo", seed=6, **kw))
    pipe.add_step(ProcessingStep(
        "recrop", BorderCrop(), input_dirs=["c4/i"], output_dirs=["c4crop"],
        seed=7, fixed_input=True, options=margins, **kw))
    pipe.add_step(ProcessingStep(
        "ovlborder", OverlaysBorderCrop(), input_dirs=[ov, bg],
        output_dirs=["ob/i", "ob/l"], pairing_method="modulo", seed=6,
        fixed_input=True, options=margins, **kw))
    return pipe.run(progress=False)


def _assert_same_dirs(a, b, n):
    from PIL import Image

    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir()) and len(names) == n
    for name in names:
        if name.endswith(".txt"):
            assert (a / name).read_text() == (b / name).read_text(), name
            continue
        got, want = (np.asarray(Image.open(d / name)) for d in (a, b))
        assert got.shape == want.shape and np.array_equal(got, want), name


@pytest.mark.cuda
def test_config4_on_card_matches_the_cpu(cuda_device, tmp_path):
    ov, bg = _overlay_inputs(tmp_path / "data")
    counts = _run_config4(tmp_path / "cuda", ov, bg, cuda_device)
    assert [dict(c) for c in counts] == [{"Success": 8}] * 3
    _run_config4(tmp_path / "cpu", ov, bg, "cpu")
    for d in ("c4/i", "c4/l", "c4crop", "ob/i", "ob/l"):
        _assert_same_dirs(tmp_path / "cuda" / d, tmp_path / "cpu" / d, 8)


def _write_clip(path, n=7):
    cv2 = pytest.importorskip("cv2")
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10,
                        (64, 48))
    if not w.isOpened():
        path = path.with_suffix(".avi")
        w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 10,
                            (64, 48))
    assert w.isOpened(), "cv2 writes neither mp4v nor MJPG"
    rng = np.random.default_rng(7)
    for i in range(n):
        f = rng.integers(0, 256, (48, 64, 3), np.uint8)
        f[..., 2] = 30 * i
        w.write(f)
    w.release()
    return path


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["nearest", "shear"])
def test_config5_on_card_matches_the_cpu(cuda_device, tmp_path, method):
    from image_processor_pipeline_tpu_torch import (ProcessingPipeline,
                                                    ProcessingStep)
    from image_processor_pipeline_tpu_torch.transforms import (
        frame_extraction, fused)

    (tmp_path / "clips").mkdir()
    clip = _write_clip(tmp_path / "clips" / "clip.mp4")
    frames = tmp_path / "frames"
    ProcessingStep("frames", frame_extraction, input_dirs=[clip.parent],
                   output_dirs=[frames],
                   options={"file_basename": "clip"}).run(progress=False)
    for device in (cuda_device, "cpu"):
        pipe = ProcessingPipeline(root_dir=tmp_path / str(device)[:4])
        pipe.add_step(ProcessingStep(
            "augment", fused.FusedChain([
                fused.Rotate(method=method), fused.Flip(), fused.Enhance()]),
            input_dirs=[frames / "clip" / "0-raw"], output_dirs=["aug"],
            seed=8, device=device, workers=2))
        kernels.reset_launch_counts()
        assert pipe.run(progress=False) == [{"Success": 7}]
        if device != "cpu" and method == "shear":
            assert kernels.launch_counts["shear_rotate_packed"] \
                == pipe.steps[0].metrics.batches
    _assert_same_dirs(tmp_path / "cuda" / "aug", tmp_path / "cpu" / "aug", 7)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["nearest", "shear"])
def test_composites_on_card_match_the_cpu(cuda_device, tmp_path, method):
    from image_processor_pipeline_tpu_torch import ProcessingStep
    from image_processor_pipeline_tpu_torch.transforms import (
        RotationsChain, RotationsSymmetries, fused)

    imgs, _ = _engine_dataset(tmp_path)
    tail = [fused.ColorMask(MASK_RANGES, input_alpha="replace"),
            fused.Cleanup(20), fused.FitCrop(), fused.Enhance(0.5, 0.5)]
    for name, transform in (("rotsym", RotationsSymmetries()),
                            ("rotchain", RotationsChain(tail))):
        for device in (cuda_device, "cpu"):
            step = ProcessingStep(
                name, transform, input_dirs=[imgs],
                output_dirs=[tmp_path / str(device)[:4] / name], seed=9,
                device=device, workers=2,
                options={"num_rotations": 3, "method": method})
            kernels.reset_launch_counts()
            assert step.run(progress=False) == {"Success": 12}
            if device != "cpu" and method == "shear":
                assert kernels.launch_counts["shear_rotate_packed"] \
                    == step.metrics.batches >= 2
        n = 12 * 4 * (4 if name == "rotsym" else 1)
        _assert_same_dirs(tmp_path / "cuda" / name, tmp_path / "cpu" / name,
                          n)


@pytest.mark.cuda
def test_rotation_kernel_at_the_video_frames_shape(cuda_device,
                                                   direct_tiles):
    """K2 on config 5's batch: eight 640 x 480 frames on the diagonal
    canvas of 896, RGBA, tiled with no direct tile."""
    from image_processor_pipeline_tpu_torch.io.batching import bucket_dim

    S = bucket_dim(800)
    assert S == 896
    rng = np.random.default_rng(896)
    imgs = torch.as_tensor(rng.integers(0, 256, (8, S, S, 4), np.uint8),
                           device=cuda_device)
    angles = torch.as_tensor(rng.uniform(1, 359, 8).astype(np.float32))
    shifts = [t.to(cuda_device) for t in geometry.shear_params(angles, S)]
    kernels.reset_launch_counts()
    got = rotate.shear_rotate(imgs, *shifts)
    assert kernels.launch_counts["shear_rotate_packed"] == 1
    want = geometry.rotate_square_shear_by(imgs, *shifts)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and int(direct_tiles) == 0


# -- the symmetry fan-out composites and auto_fuse -----------------------------

FANOUT = ("ChainSymmetries", "SymmetriesChain", "SymmetriesChainSymmetries",
          "RotSymChain", "RotationsChainSymmetries")


def _fanout(name):
    from image_processor_pipeline_tpu_torch import transforms
    from image_processor_pipeline_tpu_torch.transforms import fused

    stages = [fused.ColorMask(MASK_RANGES, input_alpha="replace"),
              fused.Cleanup(20), fused.FitCrop()]
    syms = ("o", "h", "v", "hv")
    if name == "ChainSymmetries":
        return transforms.ChainSymmetries(stages)
    if name == "SymmetriesChainSymmetries":
        return transforms.SymmetriesChainSymmetries(stages, syms, ("hv", "o"))
    return getattr(transforms, name)(stages, syms)


@pytest.mark.cuda
@pytest.mark.parametrize("name", FANOUT)
def test_fanout_batch_on_card_matches_the_cpu(cuda_device, direct_tiles,
                                              name):
    """One batch of each class: device_fn on the card equals the same batch
    on the CPU byte for byte; the rotation-headed ones launch the rotation
    kernel once, with no direct tile."""
    step = _fanout(name)
    rotates = name.startswith("Rot")
    rng = np.random.default_rng(len(name))
    B, H = 4, 128
    img = rng.integers(0, 256, (B, H // 4, H // 4, 4), np.uint8)
    img = img.repeat(4, axis=1).repeat(4, axis=2)
    img[..., 3] = np.where(img[..., 0] > 70, 255, 0)
    side = int(H / np.sqrt(2)) if rotates else H
    size = rng.integers(side // 2, side + 1, (B, 2)).astype(np.int32)
    seeds = rng.integers(0, 2**31, B).astype(np.uint32)
    options = {"num_rotations": 3, "method": "shear"} if rotates else {}
    static = step.static_args(options, ())
    outs = {}
    for device in ("cpu", cuda_device):
        kernels.reset_launch_counts()
        outs[str(device)] = step.device_fn(
            {"image": torch.as_tensor(img, device=device),
             "size": torch.as_tensor(size, device=device), "seed": seeds},
            static)
        torch.cuda.synchronize()
        if device != "cpu":
            assert kernels.launch_counts["shear_rotate_packed"] \
                == int(rotates)
    assert int(direct_tiles) == 0
    got, want = outs["cuda:0"], outs["cpu"]
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k


def _fused_pipeline(root, imgs, device):
    from image_processor_pipeline_tpu_torch import (ProcessingPipeline,
                                                    ProcessingStep)
    from image_processor_pipeline_tpu_torch.transforms import (
        ColorMaskTransparency, FitCrop, GenerateSymmetries,
        KeepLargestComponent, RandomRotations)

    pipe = ProcessingPipeline(root_dir=root)
    for i, (transform, out, options) in enumerate((
            (RandomRotations(), "rot", {"num_rotations": 3,
                                        "method": "shear"}),
            (GenerateSymmetries(), "sym", {}),
            (ColorMaskTransparency(), "mask",
             {"color_ranges_to_exclude_hsv": MASK_RANGES}),
            (KeepLargestComponent(), "clean", {"min_component_size": 20}),
            (FitCrop(), "out", {}))):
        pipe.add_step(ProcessingStep(
            f"s{i}", transform, input_dirs=[imgs] if i == 0 else None,
            output_dirs=[out], seed=10 + i, options=options, device=device,
            workers=2))
    return pipe


@pytest.mark.cuda
def test_auto_fuse_on_card_writes_the_cpu_files(cuda_device, direct_tiles,
                                                tmp_path):
    """rotations -> symmetry -> mask -> cleanup -> fit crop fuses to one
    RotSymChain step on either device; on the card it launches the
    rotation kernel once a batch, and both write the same files."""
    imgs, _ = _engine_dataset(tmp_path)
    for device in (cuda_device, "cpu"):
        pipe = _fused_pipeline(tmp_path / str(device)[:4], imgs, device)
        kernels.reset_launch_counts()
        counts = pipe.run(progress=False, auto_fuse=True)
        step, = pipe.last_run_steps
        assert type(step.process_function).__name__ == "RotSymChain"
        assert counts == [{"Success": 12}]
        if device != "cpu":
            assert kernels.launch_counts["shear_rotate_packed"] \
                == step.metrics.batches >= 3
        assert not (tmp_path / str(device)[:4] / "sym").exists()
    assert int(direct_tiles) == 0
    out = tmp_path / "cuda" / "out"
    _assert_same_dirs(out, tmp_path / "cpu" / "out",
                      len(list(out.iterdir())))


# -- the codec's device halves (ops/jpeg.py) --------------------------------

def _coefs(rng, B, cap_h, cap_w, lo=-2048, hi=2048, samp=(2, 2)):
    cy = rng.integers(lo, hi, (B, cap_h // 8, cap_w // 8, 64)).astype(
        np.int16)
    cc = rng.integers(lo, hi, (B, 2, cap_h // (8 * samp[1]),
                               cap_w // (8 * samp[0]), 64)).astype(np.int16)
    qt = rng.integers(1, 256, (B, 3, 64)).astype(np.int32)
    return cy, cc, qt


def _on(dev, *arrays):
    return [torch.as_tensor(a, device=dev) for a in arrays]


@pytest.mark.cuda
def test_jpeg_block_transforms_on_card_match_the_cpu(cuda_device):
    """The IDCT and the FDCT on crafted extreme blocks (int32 wrap-around,
    the range limit's `& 1023`, truncating division) and every quantiser."""
    from image_processor_pipeline_tpu_torch.ops import jpeg

    rng = np.random.default_rng(0)
    coefs = np.concatenate([
        np.full((255, 1, 2, 64), 2047, np.int16),
        np.full((255, 1, 2, 64), -2048, np.int16),
        rng.integers(-32768, 32768, (255, 1, 2, 64)).astype(np.int16)])
    qtab = np.tile(np.repeat(np.arange(1, 256, dtype=np.int32)[:, None], 64,
                             1), (3, 1))
    planes = np.concatenate([
        rng.integers(0, 256, (255, 8, 16)),
        rng.integers(-2 ** 31, 2 ** 31 - 1, (510, 8, 16))]).astype(np.int32)
    for fn, args in ((jpeg.idct_islow_blocks, (coefs, qtab)),
                     (jpeg.fdct_quant_blocks, (planes, qtab))):
        got = fn(*_on(cuda_device, *args))
        assert torch.equal(got.cpu(), fn(*_on("cpu", *args))), fn.__name__


@pytest.mark.cuda
@pytest.mark.parametrize("samp,gray,channels", [
    ((1, 1), False, 3), ((2, 1), False, 3), ((1, 2), False, 3),
    ((2, 2), False, 3), ((1, 1), True, 3), ((2, 2), False, 4)])
def test_jpeg_decode_finish_on_card_matches_the_cpu(cuda_device, samp, gray,
                                                    channels):
    """decode_finish at every sampling, grayscale and 4 channels, odd valid
    sizes; and decode_finish_sparse (an int32 scatter-add on the card)."""
    from image_processor_pipeline_tpu_torch.ops import jpeg

    rng = np.random.default_rng(sum(samp) + channels)
    cap_h, cap_w, B = 48, 64, 3
    cy, cc, qt = _coefs(rng, B, cap_h, cap_w, -200, 200, samp=(1, 1))
    h = np.array([48, 47, 17], np.int32)
    w = np.array([64, 45, 9], np.int32)
    kw = dict(samp=samp, cap_h=cap_h, cap_w=cap_w, grayscale=gray,
              channels=channels)
    want = jpeg.decode_finish(*_on("cpu", cy, cc, qt, h, w), **kw)
    got = jpeg.decode_finish(*_on(cuda_device, cy, cc, qt, h, w), **kw)
    assert torch.equal(got.cpu(), want)
    flat = np.concatenate([cy.reshape(B, -1), cc.reshape(B, -1)], 1)
    flat[:, 1::3] = 0
    idx = np.zeros(flat.shape, np.int32)
    val = np.zeros(flat.shape, np.int16)
    for i in range(B):
        nz = np.nonzero(flat[i])[0]
        idx[i, :len(nz)], val[i, :len(nz)] = nz, flat[i, nz]
    kw.update(cap_by_c=cap_h // 8, cap_bx_c=cap_w // 8)
    want = jpeg.decode_finish_sparse(*_on("cpu", idx, val, qt, h, w), **kw)
    got = jpeg.decode_finish_sparse(*_on(cuda_device, idx, val, qt, h, w),
                                    **kw)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_jpeg_encode_start_and_shrink_on_card_match_the_cpu(cuda_device):
    """encode_start, encode_start_sparse (its scatter into the dump column
    included: an item overflows the cap), encode_shrink's slices, host nnz
    and overflow pixels, and the round trip through decode_finish_sparse."""
    from image_processor_pipeline_tpu_torch.ops import jpeg
    from torch_port_data import make_image

    rng = np.random.default_rng(5)
    B, H, W = 4, 208, 144
    imgs = np.stack([make_image(rng, H, W, 4) for _ in range(B)])
    imgs[2] = rng.integers(0, 256, imgs[2].shape)
    h = np.array([208, 150, 199, 7], np.int32)
    w = np.array([144, 101, 130, 133], np.int32)
    for i in range(B):
        imgs[i, h[i]:] = 0
        imgs[i, :, w[i]:] = 0
    qt = jpeg.quality_qtabs(95).astype(np.int32)
    kw = dict(cap_h=H, cap_w=W)
    for a, b in zip(jpeg.encode_start(*_on(cuda_device, imgs, h, w, qt), **kw),
                    jpeg.encode_start(*_on("cpu", imgs, h, w, qt), **kw)):
        assert torch.equal(a.cpu(), b)
    sparse = {}
    for label, dev in (("card", cuda_device), ("cpu", "cpu")):
        sparse[label] = jpeg.encode_start_sparse(
            *_on(dev, imgs, h, w, qt), cap_nnz=4000, **kw)
    for a, b in zip(sparse["card"], sparse["cpu"]):
        assert torch.equal(a.cpu(), b)
    assert int(sparse["cpu"][2][2]) > 4000
    idx, val, _ = sparse["card"]
    back = {label: jpeg.decode_finish_sparse(
        *_on(dev, idx.cpu()[[0, 1, 3]], val.cpu()[[0, 1, 3]],
             np.repeat(qt[None], 3, 0), h[[0, 1, 3]], w[[0, 1, 3]]),
        samp=(2, 2), cap_h=H, cap_w=W, cap_by_c=H // 16, cap_bx_c=W // 16)
        for label, dev in (("card", cuda_device), ("cpu", "cpu"))}
    assert torch.equal(back["card"].cpu(), back["cpu"])
    shrunk = {label: jpeg.encode_shrink(
        *_on(dev, imgs, h, w), h, w, 95, cap_frac=0.2)
        for label, dev in (("card", cuda_device), ("cpu", "cpu"))}
    got, want = shrunk["card"], shrunk["cpu"]
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[3] == want[3] and sorted(got[4]) == sorted(want[4])
    assert 2 in got[4]
    for i in want[4]:
        np.testing.assert_array_equal(got[4][i], want[4][i])


def _one_batch(transform, inputs, options, seed, device):
    chunk = [transform.load_item(args, options) for args in inputs]
    for i, item in enumerate(chunk):
        item["_seed"] = (seed + i) & 0x7FFFFFFF
    key = transform.bucket_key(chunk[0], options)
    return chunk, transform.launch_batch(key, chunk, options, device)


@pytest.mark.cuda
def test_pipeline_j_batches_shrink_on_card_as_on_the_cpu(cuda_device,
                                                         tmp_path):
    """One batch of each step of pipeline J (crop_square, rotations by
    shear with output_format="jpeg", symmetry) with device_encode on: the
    coefficients the card's JPEG front half leaves to fetch equal the
    CPU's.  The library's entropy coder is not needed for this half."""
    from PIL import Image

    from image_processor_pipeline_tpu_torch.ops import jpeg
    from image_processor_pipeline_tpu_torch.transforms import (
        GenerateSymmetries, RandomRotations, SquareCropAroundBBox)

    imgs, labels = _engine_dataset(tmp_path, n=4)
    jpgs = []
    for p in sorted(imgs.iterdir()):
        jpgs.append(tmp_path / f"{p.stem}.jpg")
        Image.open(p).convert("RGB").save(jpgs[-1], quality=90)
    crop_in = [(p, labels / f"{p.stem}.txt") for p in jpgs[2:3]]
    rot_in = [(p,) for p in jpgs[:1]]
    sym_in = [(p,) for p in jpgs[:1]]
    rot_opts = {"method": "shear", "num_rotations": 4,
                "output_format": "jpeg"}
    shrunk = {}
    for label, dev in (("card", cuda_device), ("cpu", "cpu")):
        kernels.reset_launch_counts()
        _, crop = _one_batch(SquareCropAroundBBox(), crop_in, {}, 3, dev)
        s = np.asarray(crop["crop_size"], np.int32)
        _, rot = _one_batch(RandomRotations(), rot_in, rot_opts, 4, dev)
        B, R = rot["images"].shape[:2]
        rh = rot["heights"].reshape(-1).to(torch.int32)
        rw = rot["widths"].reshape(-1).to(torch.int32)
        sym_t = GenerateSymmetries()
        chunk, sym = _one_batch(sym_t, sym_in, {}, 5, dev)
        sh = np.asarray([it["size"][0] for it in chunk], np.int32)
        sw = np.asarray([it["size"][1] for it in chunk], np.int32)
        shrunk[label] = [
            jpeg.encode_shrink(crop["image"], *_on(dev, s, s), s, s, 95),
            jpeg.encode_shrink(
                rot["images"].reshape((B * R,) + rot["images"].shape[2:]),
                rh, rw, rh.cpu().numpy(), rw.cpu().numpy(), 75),
            jpeg.encode_shrink(sym["_input_dev"], *_on(dev, sh, sw), sh, sw,
                               95)]
        if torch.device(dev).type == "cuda":
            assert kernels.launch_counts["shear_rotate_packed"] == 1
    for got, want in zip(shrunk["card"], shrunk["cpu"]):
        assert got is not None and want is not None
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])
        np.testing.assert_array_equal(got[2], want[2])
        assert got[3] == want[3] and not got[4] and not want[4]


@pytest.mark.cuda
def test_pipeline_j_with_transports_on_card_writes_the_cpu_files(
        cuda_device, tmp_path):
    """Pipeline J over JPEGs with the transports left on "auto" on the card
    (on, where the JPEG coefficient coder is built) and forced on on the
    CPU: the same files, byte for byte, and the coefficients crossed the
    link, each step fetching what the JAX engine fetches with the
    transports on (JPEG_PIPELINE_J_D2H, which tests/test_torch_codec.py
    holds against it).  Where the coder cannot be built "auto" is the host
    codec and the same files must come out."""
    import image_processor_pipeline_tpu_torch as tpkg
    import image_processor_pipeline_tpu_torch.transforms as ttransforms
    from image_processor_pipeline_tpu_torch.io import jcoef
    from torch_port_data import (JPEG_PIPELINE_J_D2H,
                                 make_jpeg_pipeline_j_data,
                                 run_jpeg_pipeline_j)

    jpg, lab = make_jpeg_pipeline_j_data(tmp_path)
    steps = {}
    for label, device, codec in (("card", cuda_device, {}), ("cpu", "cpu", {
            "device_decode": jcoef.available(),
            "device_encode": jcoef.available()})):
        kernels.reset_launch_counts()
        steps[label] = run_jpeg_pipeline_j(tpkg, ttransforms, jpg, lab,
                                           tmp_path / label, codec,
                                           device=device)
        if torch.device(device).type == "cuda":
            assert kernels.launch_counts["shear_rotate_packed"] \
                == steps[label][1].metrics.batches
    for d in ("crops", "labels", "rot", "sym"):
        got = {p.name: p.read_bytes()
               for p in sorted((tmp_path / "card" / d).iterdir())}
        want = {p.name: p.read_bytes()
                for p in sorted((tmp_path / "cpu" / d).iterdir())}
        assert got == want, d
    if jcoef.available() and torch.device(cuda_device).type == "cuda":
        for label in steps:
            got = {s.name: (s.metrics.d2h_bytes_full,
                            s.metrics.d2h_bytes_fetched)
                   for s in steps[label]}
            assert got == JPEG_PIPELINE_J_D2H, label


# -- meshes on the card (parallel/mesh.py, ProcessingStep(mesh=...)) ---------

def _mesh_chain_inputs(B=8, size=96, seed=9):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (B, size, size, 3), np.uint8)
    xywhn = np.concatenate([rng.uniform(0.3, 0.7, (B, 2)),
                            rng.uniform(0.05, 0.3, (B, 2))],
                           axis=1).astype(np.float32)
    return images, xywhn, np.arange(B, dtype=np.int64) * 7 + seed


@pytest.mark.cuda
@pytest.mark.parametrize("rotation,kernel", [
    ("cuda_full", "augment_full"), ("cuda_shear", "shear_rotate_packed"),
    (None, "shear_rotate_packed")])
def test_sharded_step_on_two_card_entries_matches_the_cpu(cuda_device,
                                                         rotation, kernel):
    """sharded_augment_step over [cuda:0, cuda:0] launches its kernel once
    a shard and gives the same bytes and count as the same call over a
    CPU mesh (the plain twins); None picks 'cuda_shear' on the card and
    'shear' on the CPU."""
    from image_processor_pipeline_tpu_torch.parallel.mesh import (
        make_mesh, sharded_augment_step)

    images, xywhn, seeds = _mesh_chain_inputs()
    kernels.reset_launch_counts()
    out, count = sharded_augment_step(
        make_mesh(devices=[cuda_device] * 2), crop=64, rotation=rotation)(
        torch.as_tensor(images, device=cuda_device), xywhn, seeds)
    assert kernels.launch_counts[kernel] == 2
    assert out.device == cuda_device and count.device == cuda_device
    want, want_count = sharded_augment_step(
        make_mesh(devices=["cpu"] * 2), crop=64, rotation=rotation)(
        images, xywhn, seeds)
    assert torch.equal(out.cpu(), want)
    assert int(count) == int(want_count) == 8


@pytest.mark.cuda
def test_engine_mesh_on_card_writes_the_cpu_files(cuda_device, tmp_path):
    """FusedChain([Rotate(shear), Flip, Enhance]) with a two-entry mesh on
    the card, n=11 (no multiple of 2): every batch launches the rotation
    kernel once a shard, and the files equal the CPU run's without a
    mesh, byte for byte."""
    from PIL import Image

    from image_processor_pipeline_tpu_torch import ProcessingStep
    from image_processor_pipeline_tpu_torch.parallel.mesh import make_mesh
    from image_processor_pipeline_tpu_torch.transforms.fused import (
        Enhance, Flip, FusedChain, Rotate)

    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(7)
    for i in range(11):
        arr = rng.integers(0, 256, (40 + (i % 3), 52, 3), np.uint8)
        Image.fromarray(arr).save(src / f"im{i}.png")
    steps = {}
    for tag, device, mesh in (
            ("cpu", "cpu", None),
            ("card", cuda_device, make_mesh(devices=[cuda_device] * 2))):
        steps[tag] = ProcessingStep(
            "chain", FusedChain([Rotate(method="shear"), Flip(), Enhance()]),
            input_dirs=[src], output_dirs=[tmp_path / tag], seed=99,
            mesh=mesh, device=device, workers=2)
        kernels.reset_launch_counts()
        assert steps[tag].run(progress=False) == {"Success": 11}
    assert kernels.launch_counts["shear_rotate_packed"] == \
        2 * steps["card"].metrics.batches
    got = {p.name: p.read_bytes() for p in sorted((tmp_path / "card").iterdir())}
    want = {p.name: p.read_bytes() for p in sorted((tmp_path / "cpu").iterdir())}
    assert got == want and len(got) == 11


@pytest.mark.cuda
def test_mesh_over_every_card_matches_the_cpu(cuda_device, tmp_path):
    """A mesh over all the machine's cards (one here, or several on a
    machine that has them): sharded_augment_step in both kernel modes and
    an engine step with the default mesh (None: "auto" on a CUDA step)
    give the CPU's bytes, each card launching its shard's kernel."""
    from PIL import Image

    from image_processor_pipeline_tpu_torch import ProcessingStep
    from image_processor_pipeline_tpu_torch.parallel.mesh import (
        make_mesh, sharded_augment_step)
    from image_processor_pipeline_tpu_torch.transforms.fused import (
        Enhance, Flip, FusedChain, Rotate)

    n = torch.cuda.device_count()
    mesh = make_mesh()
    assert mesh.shape["data"] == n
    images, xywhn, seeds = _mesh_chain_inputs(B=4 * n, seed=13)
    for rotation, kernel in (("cuda_shear", "shear_rotate_packed"),
                             ("cuda_full", "augment_full")):
        kernels.reset_launch_counts()
        out, count = sharded_augment_step(mesh, crop=64, rotation=rotation)(
            images, xywhn, seeds)
        assert kernels.launch_counts[kernel] == n
        assert out.device == torch.device("cuda", 0)
        want, want_count = sharded_augment_step(
            make_mesh(devices=["cpu"] * n), crop=64, rotation=rotation)(
            images, xywhn, seeds)
        assert torch.equal(out.cpu(), want)
        assert int(count) == int(want_count)

    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(5)
    for i in range(4 * n + 3):
        arr = rng.integers(0, 256, (40 + (i % 3), 52, 3), np.uint8)
        Image.fromarray(arr).save(src / f"im{i}.png")
    steps = {}
    for tag, device in (("cpu", "cpu"), ("cards", "cuda")):
        steps[tag] = ProcessingStep(
            "chain", FusedChain([Rotate(method="shear"), Flip(), Enhance()]),
            input_dirs=[src], output_dirs=[tmp_path / tag], seed=17,
            device=device, workers=2)
        kernels.reset_launch_counts()
        assert steps[tag].run(progress=False) == {"Success": 4 * n + 3}
    auto = steps["cards"]._resolve_mesh()
    assert (auto is None) if n == 1 else (auto.shape["data"] == n)
    assert kernels.launch_counts["shear_rotate_packed"] == \
        n * steps["cards"].metrics.batches
    got = {p.name: p.read_bytes() for p in sorted((tmp_path / "cards").iterdir())}
    want = {p.name: p.read_bytes() for p in sorted((tmp_path / "cpu").iterdir())}
    assert got == want and len(got) == 4 * n + 3


@pytest.mark.cuda
def test_hsv_tuner_on_card_matches_the_cpu(cuda_device, tmp_path):
    """preview_hsv_mask computes on the card by default and gives the CPU's
    arrays, byte for byte."""
    from PIL import Image

    from image_processor_pipeline_tpu_torch.utils.hsv_tuner import (
        preview_hsv_mask)

    path = tmp_path / "im.png"
    Image.fromarray(np.random.default_rng(5).integers(
        0, 256, (96, 128, 3), dtype=np.uint8)).save(path)
    for lower, upper in (((0, 0, 0), (180, 255, 120)),
                         ((35, 60, 60), (85, 255, 255))):
        got = preview_hsv_mask(path, lower, upper, show=False)
        want = preview_hsv_mask(path, lower, upper, show=False, device="cpu")
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert 0 < got[1].sum() < got[1].size


@pytest.mark.cuda
def test_warmed_profile_keeps_one_launch_after_a_long_session(cuda_device):
    """F14: in a process that has traced 50,000 launches in one bare
    session, each of 10 one-launch traces through utils/profiling.py's
    warmed window holds exactly that one kernel (a bare session there can
    lose a new session's first GPU records)."""
    from torch.profiler import ProfilerActivity, profile

    from image_processor_pipeline_tpu_torch.utils.profiling import (
        device_events, warmed_profile)

    x = torch.zeros(1, device=cuda_device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(50_000):
            x.add_(1)
        torch.cuda.synchronize()
    prof.events()
    y = torch.zeros(1024, device=cuda_device)
    kernels_seen = []
    for _ in range(10):
        with warmed_profile([ProfilerActivity.CUDA]) as prof:
            y.mul_(3)
        kernels_seen.append([e.name[:60] for e in device_events(prof)])
    counts = [len(names) for names in kernels_seen]
    assert counts == [1] * 10, (counts, [sorted(set(names))
                                         for names in kernels_seen])


@pytest.mark.cuda
def test_native_chain_step_writes_the_card_files(cuda_device, tmp_path):
    """One FusedChain([Rotate(shear), Flip, ColorMask, Cleanup, Enhance])
    step with native_compute=True (the C++ chain executor on host threads,
    built from native/ipp_cpu.cpp on this machine) and one on the card
    over the same seeded files: the same bytes, the executor called and
    the rotation kernel launched only by the card's run."""
    from PIL import Image

    from image_processor_pipeline_tpu_torch import ProcessingStep
    from image_processor_pipeline_tpu_torch.ops import native_cpu
    from image_processor_pipeline_tpu_torch.transforms.fused import (
        Cleanup, ColorMask, Enhance, Flip, FusedChain, Rotate)

    assert native_cpu.available(), native_cpu.build_error()
    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(17)
    for i in range(10):
        arr = rng.integers(0, 256, (60 + 3 * i, 72, 3), np.uint8)
        arr[10:40, 10:50] = (40, 160, 40)
        Image.fromarray(arr).save(src / f"im{i}.png")
    calls = []
    real = native_cpu.chain_batch

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    native_cpu.chain_batch = spy
    launched = {}
    try:
        for tag, options in (("card", {}), ("native",
                                            {"native_compute": True})):
            step = ProcessingStep(
                "chain", FusedChain([
                    Rotate(method="shear"), Flip(),
                    ColorMask([(35, 60, 60, 85, 255, 255)]), Cleanup(20),
                    Enhance()]),
                input_dirs=[src], output_dirs=[tmp_path / tag], seed=5,
                device=cuda_device, workers=4, options=options)
            kernels.reset_launch_counts()
            assert step.run(progress=False) == {"Success": 10}
            launched[tag] = kernels.launch_counts["shear_rotate_packed"]
    finally:
        native_cpu.chain_batch = real
    assert len(calls) >= 1
    assert launched["card"] >= 1 and launched["native"] == 0
    got = {p.name: p.read_bytes()
           for p in sorted((tmp_path / "native").iterdir())}
    want = {p.name: p.read_bytes()
            for p in sorted((tmp_path / "card").iterdir())}
    assert got == want and len(got) == 10


@pytest.mark.cuda
def test_save_fault_on_a_card_batch_stays_contained(cuda_device, tmp_path):
    """A permanent save fault on one item of a batch computed on the card
    (saved behind its pinned copy and CUDA event) is that item's Error,
    with its message and no outputs; the other items are saved, equal to
    the CPU run's files, and a transient fault with retries=1 is retried
    once."""
    from collections import Counter
    from pathlib import Path

    from PIL import Image

    from image_processor_pipeline_tpu_torch import ProcessingStep
    from image_processor_pipeline_tpu_torch.transforms.fused import (
        Enhance, FusedChain)

    rng = np.random.default_rng(42)
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    for i in range(8):
        h, w = int(rng.integers(50, 90)), int(rng.integers(50, 90))
        Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(
            imgs / f"im{i}.png")
    attempts = Counter()

    class Faulty(FusedChain):
        def save_item(self, out, item, output_dirs, options):
            stem = Path(item["_args"][0]).stem
            attempts[stem] += 1
            if stem == "im2" or (stem == "im5" and attempts[stem] == 1):
                raise IOError(f"injected save fault on {stem}")
            return super().save_item(out, item, output_dirs, options)

    runs = {}
    for device in ("cuda", "cpu"):
        attempts.clear()
        step = ProcessingStep(
            "chaos", Faulty([Enhance()]), input_dirs=[imgs],
            output_dirs=[tmp_path / device], pairing_method="one_input",
            seed=3, device=device, retries=1)
        assert step.run(progress=False) == Counter(Success=7, Error=1)
        bad, = [e for e in step.process_logs if e["status"] == "Error"]
        assert "injected save fault on im2" in bad["error_message"]
        assert bad["outputs"] is None
        assert attempts["im2"] == 2 and attempts["im5"] == 2
        runs[device] = {p.name: np.asarray(Image.open(p))
                        for p in sorted((tmp_path / device).iterdir())}
    assert len(runs["cuda"]) == 7 and runs["cuda"].keys() == runs["cpu"].keys()
    for name, pixels in runs["cuda"].items():
        np.testing.assert_array_equal(pixels, runs["cpu"][name])

"""The port's video source (transforms/video.py) and BASELINE.json config 5
(frames → FusedChain([Rotate, Flip, Enhance])) against the JAX package, on
the CPU, from a seeded 64 x 48 clip written with cv2 as tests/test_video.py
writes it.

Tolerances: ``iter_frames`` equal to JAX's frame for frame; the extracted
JPEG frames equal in name and decoded pixels (both engines encode them at
q95 and decode them alike on this host); the chain's PNG files equal the
JAX engine's (jit path) in name, status, report and decoded pixels, an
item whose blur weights differ under jit (F5) held to one grey level and
95 % of its values.
"""

from collections import Counter

import numpy as np
import pytest
from PIL import Image

import image_processor_pipeline_tpu as jpkg
import image_processor_pipeline_tpu.transforms as jtransforms
import image_processor_pipeline_tpu_torch as tpkg
import image_processor_pipeline_tpu_torch.transforms as ttransforms
from image_processor_pipeline_tpu.transforms import fused as jfused
from image_processor_pipeline_tpu.transforms.video import (
    iter_frames as jiter_frames)
from image_processor_pipeline_tpu_torch import random as trandom
from image_processor_pipeline_tpu_torch.transforms import fused as tfused
from image_processor_pipeline_tpu_torch.transforms.video import (
    frame_extraction, iter_frames)
from torch_port_data import assert_same_files, blur_differs_under_jit, reports

cv2 = pytest.importorskip("cv2")

N_FRAMES = 7


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    root = tmp_path_factory.mktemp("video")
    p = root / "clips" / "clip.mp4"
    p.parent.mkdir()
    w = cv2.VideoWriter(str(p), cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 48))
    rng = np.random.default_rng(7)
    gy = np.linspace(0, 255, 48, dtype=np.uint8)[:, None]
    gx = np.linspace(0, 255, 64, dtype=np.uint8)[None, :]
    for i in range(N_FRAMES):
        # smooth gradients and a moving block survive mp4 compression
        f = np.stack([np.broadcast_to(gy, (48, 64)),
                      np.broadcast_to(gx, (48, 64)),
                      np.full((48, 64), 30 * i, np.uint8)], axis=-1).copy()
        y, x = rng.integers(0, 30), rng.integers(0, 40)
        f[y:y + 16, x:x + 20] = rng.integers(0, 256, 3)
        w.write(f[:, :, ::-1])  # VideoWriter expects BGR
    w.release()
    return p


def test_names_and_structure(tmp_path, video):
    out = frame_extraction(video, [tmp_path / "t"], file_basename="cls")
    assert out == tmp_path / "t" / "clip" / "0-raw"
    names = sorted(f.name for f in out.iterdir())
    assert names == [f"cls-frame_{i:04d}.jpg" for i in range(1, 8)]
    jout = jtransforms.frame_extraction(video, [tmp_path / "j"],
                                        file_basename="cls")
    assert sorted(f.name for f in jout.iterdir()) == names
    for name in names:
        got = np.asarray(Image.open(out / name))
        assert got.shape == (48, 64, 3)
        np.testing.assert_array_equal(got, np.asarray(Image.open(jout / name)))


@pytest.mark.parametrize("fn", [frame_extraction,
                                jtransforms.frame_extraction])
def test_errors(tmp_path, video, fn):
    with pytest.raises(ValueError, match="file_basename"):
        fn(video, [tmp_path / "o"], file_basename=None)
    bad = tmp_path / "x.xyz"
    bad.write_bytes(b"no")
    with pytest.raises(ValueError, match="not supported"):
        fn(bad, [tmp_path / "o"], file_basename="c")
    junk = tmp_path / "junk.mp4"
    junk.write_bytes(b"not a video")
    with pytest.raises(RuntimeError):
        fn(junk, [tmp_path / "o"], file_basename="c")


def test_iter_frames_equals_jax(video):
    got = list(iter_frames(video))
    want = list(jiter_frames(video))
    assert len(got) == len(want) == N_FRAMES
    for g, w in zip(got, want):
        assert g.shape == (48, 64, 3) and g.dtype == np.uint8
        np.testing.assert_array_equal(g, w)


def build_config5(pkg, transforms, fused, root, video, method, **kw):
    """BASELINE.json config 5: frames, then one fused chain step."""
    pipe = pkg.ProcessingPipeline(root_dir=root)
    pipe.add_step(pkg.ProcessingStep(
        "frames", transforms.frame_extraction, input_dirs=[video.parent],
        output_dirs=["frames"], options={"file_basename": "clip"},
        save_log=True))
    pipe.add_step(pkg.ProcessingStep(
        "augment", fused.FusedChain([fused.Rotate(method=method),
                                     fused.Flip(), fused.Enhance()]),
        input_dirs=[root / "frames" / "clip" / "0-raw"],
        output_dirs=["aug"], seed=8, fixed_input=True, save_log=True, **kw))
    return pipe


def f5_named(n_items, seed):
    """Frame files whose Enhance (stage 2) blurs with box weights that
    differ under jit (F5): item i has the seed seed + i."""
    seeds = (seed + np.arange(n_items)).astype(np.uint32)
    keys = trandom.fold_in(trandom.PRNGKey(seeds), 2)
    draws = tfused.Enhance().draw(keys)
    named = draws[5] & blur_differs_under_jit(draws[3])
    return {f"clip-frame_{i + 1:04d}.png" for i in np.flatnonzero(named)}


@pytest.mark.parametrize("method", ["nearest", "shear"])
def test_config5_through_both_engines(tmp_path, video, method):
    runs = {}
    for tag, pkg, transforms, fused, kw in (
            ("j", jpkg, jtransforms, jfused,
             {"options": {"native_compute": False}}),
            ("t", tpkg, ttransforms, tfused, {"device": "cpu"})):
        pipe = build_config5(pkg, transforms, fused, tmp_path / tag, video,
                             method, **kw)
        runs[tag] = pipe.run(progress=False)
    assert runs["t"] == runs["j"] == [Counter(Success=1),
                                      Counter(Success=N_FRAMES)]
    frames = "frames/clip/0-raw"
    assert_same_files(tmp_path / "j" / frames, tmp_path / "t" / frames,
                      N_FRAMES)
    named = f5_named(N_FRAMES, 8)
    names = assert_same_files(tmp_path / "j" / "aug", tmp_path / "t" / "aug",
                              N_FRAMES, named=named)
    for name in names:   # rotated: the canvas grew, alpha marks the corners
        arr = np.asarray(Image.open(tmp_path / "t" / "aug" / name))
        assert arr.shape[2] == 4 and arr.shape[:2] != (48, 64)
        assert (arr[..., 3] == 0).any()
    assert reports(tmp_path / "t") == reports(tmp_path / "j")
    assert sorted(reports(tmp_path / "t")) == ["augment.json", "frames.json"]

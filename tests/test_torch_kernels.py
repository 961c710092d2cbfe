"""The port's kernel build and bookkeeping (kernels.py), checked without
nvcc: when the library counts as stale, which sources it builds, and the
launch counters."""

import os

import pytest

from image_processor_pipeline_tpu_torch import kernels


def _tree(tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a.cu", "b.cu", "walk.cuh"):
        (csrc / name).write_text("// source\n")
    so = tmp_path / "lib.so"
    so.write_bytes(b"")
    for p in (*csrc.iterdir(), so):
        os.utime(p, (1000, 1000))
    return csrc, so


@pytest.mark.parametrize("newer", ["walk.cuh", "a.cu", None])
def test_stale_when_any_file_under_csrc_is_newer(tmp_path, newer):
    """A header newer than the library makes it stale, as a source does."""
    csrc, so = _tree(tmp_path)
    if newer is not None:
        os.utime(csrc / newer, (2000, 2000))
    assert kernels._stale(csrc, so) == (newer is not None)


def test_stale_when_library_is_missing(tmp_path):
    csrc, so = _tree(tmp_path)
    so.unlink()
    assert kernels._stale(csrc, so)


def test_sources_are_every_cuda_file_in_csrc():
    assert sorted(kernels.SOURCES) == sorted(
        p.name for p in kernels.CSRC.glob("*.cu"))
    assert (kernels.CSRC / "shear_walk.cuh").is_file()


def test_reset_launch_counts():
    assert set(kernels.launch_counts) == {
        "augment_full", "augment_fused", "shear_rotate_packed",
        "shear_rotate"}
    kernels.launch_counts["shear_rotate"] += 2
    kernels.reset_launch_counts()
    assert all(n == 0 for n in kernels.launch_counts.values())

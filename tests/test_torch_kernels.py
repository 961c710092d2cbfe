"""The port's kernel build and bookkeeping (kernels.py), checked without
nvcc: when the library counts as stale, which sources it builds, and the
launch counters."""

import os

import numpy as np
import pytest
import torch

from image_processor_pipeline_tpu_torch import kernels
from image_processor_pipeline_tpu_torch.utils import rev_probe


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
        "shear_rotate", "rev_probe"}
    kernels.launch_counts["shear_rotate"] += 2
    kernels.reset_launch_counts()
    assert all(n == 0 for n in kernels.launch_counts.values())


@pytest.mark.parametrize("shape", [(512, 512), (37, 101), (1, 4), (5, 1)])
@pytest.mark.parametrize("name", list(rev_probe.MOVES))
def test_rev_probe_wrapper_on_the_cpu_is_the_numpy_move(name, shape):
    """On a CPU tensor the wrapper runs its plain version, which is the
    TPU probe's numpy reference, and counts no launch."""
    x = np.arange(shape[0] * shape[1], dtype=np.int32).reshape(shape)
    want = {"copy": x, "roll": np.roll(x, 7, 1), "rev_cols": x[:, ::-1],
            "rev_rows": x[::-1, :]}[name]
    kernels.reset_launch_counts()
    got = rev_probe.move(torch.as_tensor(x), name)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.data_ptr() != torch.as_tensor(x).data_ptr()
    assert kernels.launch_counts["rev_probe"] == 0


@pytest.mark.parametrize("shift", [0, 1, -3, 101, 1000])
def test_rev_probe_roll_takes_any_shift(shift):
    x = np.arange(37 * 101, dtype=np.int32).reshape(37, 101)
    got = rev_probe.move(torch.as_tensor(x), "roll", shift)
    np.testing.assert_array_equal(got.numpy(), np.roll(x, shift, 1))


@pytest.mark.parametrize("bad", ["move", "dtype", "ndim", "empty", "strided",
                                 "device"])
def test_rev_probe_wrapper_rejects_bad_inputs(bad):
    x = torch.zeros((8, 8), dtype=torch.int32)
    name = "copy"
    if bad == "move":
        name = "transpose"
    elif bad == "dtype":
        x = x.float()
    elif bad == "ndim":
        x = x[None]
    elif bad == "empty":
        x = x[:0]
    elif bad == "strided":
        x = x.t()
    elif bad == "device":
        x = x.to("meta")
    with pytest.raises(ValueError):
        rev_probe.move(x, name)


def test_rev_probe_move_codes_match_the_source():
    """MOVES mirrors the kernel's enum."""
    src = (kernels.CSRC / "rev_probe.cu").read_text()
    enum = src[src.index("enum Move {"):].split("}")[0]
    for name, const in (("copy", "kCopy"), ("roll", "kRoll"),
                        ("rev_cols", "kRevCols"), ("rev_rows", "kRevRows")):
        assert f"{const} = {rev_probe.MOVES[name]}" in enum

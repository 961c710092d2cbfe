"""The port's engine under injected faults, on the CPU: the counterparts of
tests/test_engine_chaos.py's seven cases with the port's FusedChain,
Enhance and ColorMaskTransparency.  Faults at the probe, the batch decode
and the save stay with their item: the other items complete, the statuses
are right, the run never hangs and the retry budget applies.  The two
mesh cases run on a four-wide mesh of the CPU.  The truncated-JPEG run is
also held against the JAX package's engine (its jit path): the same
statuses.  Last, the counterpart of tests/test_golden_regression.py: a
seeded crop + symmetry pipeline gives the same decoded pixels with 1 and
3 workers, and the JAX package's engine gives them too."""

import hashlib
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from image_processor_pipeline_tpu_torch import (ProcessingPipeline,
                                                ProcessingStep)
from image_processor_pipeline_tpu_torch.transforms import (
    ColorMaskTransparency, GenerateSymmetries, SquareCropAroundBBox)
from image_processor_pipeline_tpu_torch.transforms.fused import (Enhance,
                                                                 FusedChain)


@pytest.fixture
def imgs(tmp_path, rng):
    d = tmp_path / "imgs"
    d.mkdir()
    for i in range(8):
        h, w = int(rng.integers(50, 90)), int(rng.integers(50, 90))
        Image.fromarray(
            rng.integers(0, 256, (h, w, 3), np.uint8)).save(d / f"im{i}.jpg")
    return d


def _step(transform, imgs, out, **kw):
    return ProcessingStep(
        "chaos", transform, input_dirs=[imgs], output_dirs=[out],
        pairing_method="one_input", seed=3, device="cpu", **kw)


def test_probe_fault_isolated(imgs, tmp_path):
    class Flaky(FusedChain):
        def probe_item(self, inputs, options):
            if Path(inputs[0]).stem == "im3":
                raise RuntimeError("injected probe fault")
            return super().probe_item(inputs, options)

    step = _step(Flaky([Enhance()]), imgs, tmp_path / "o")
    assert step.run(progress=False) == Counter(Success=7, Error=1)
    bad, = [e for e in step.process_logs if e["status"] == "Error"]
    assert "injected probe fault" in bad["error_message"]
    assert Path(bad["inputs"][0]).stem == "im3" and bad["outputs"] is None
    assert len(list((tmp_path / "o").iterdir())) == 7


def test_decode_fault_isolated(imgs, tmp_path):
    """A JPEG cut in half probes fine; its decode may recover (libjpeg
    fills the rest) or fail.  Either way the run completes, no other item
    is lost, and the JAX engine gives the same statuses."""
    import image_processor_pipeline_tpu as jpkg
    from image_processor_pipeline_tpu.transforms import fused as jfused

    victim = imgs / "im5.jpg"
    data = victim.read_bytes()
    victim.write_bytes(data[: len(data) // 2])
    c = _step(FusedChain([Enhance()]), imgs, tmp_path / "o").run(
        progress=False)
    assert c["Success"] + c["Error"] == 8
    assert c["Success"] >= 7
    want = jpkg.ProcessingStep(
        "chaos", jfused.FusedChain([jfused.Enhance()]), input_dirs=[imgs],
        output_dirs=[tmp_path / "j"], pairing_method="one_input", seed=3,
        options={"native_compute": False}).run(progress=False)
    assert c == want


def test_save_fault_retry_budget(imgs, tmp_path):
    attempts = {}

    class FlakySave(FusedChain):
        def save_item(self, out, item, output_dirs, options):
            stem = Path(item["_args"][0]).stem
            attempts[stem] = attempts.get(stem, 0) + 1
            if stem == "im2" and attempts[stem] == 1:
                raise IOError("injected transient save fault")
            return super().save_item(out, item, output_dirs, options)

    step = _step(FlakySave([Enhance()]), imgs, tmp_path / "o", retries=1)
    assert step.run(progress=False) == Counter(Success=8)
    assert attempts["im2"] == 2  # one retry, then success
    assert all(n == 1 for stem, n in attempts.items() if stem != "im2")
    assert all(e["error_message"] is None for e in step.process_logs)


def test_save_fault_exhausted_budget(imgs, tmp_path):
    class BrokenSave(FusedChain):
        def save_item(self, out, item, output_dirs, options):
            if Path(item["_args"][0]).stem == "im2":
                raise IOError("injected permanent save fault")
            return super().save_item(out, item, output_dirs, options)

    step = _step(BrokenSave([Enhance()]), imgs, tmp_path / "o", retries=2)
    assert step.run(progress=False) == Counter(Success=7, Error=1)
    bad = [e for e in step.process_logs if e["status"] == "Error"]
    assert "injected permanent save fault" in bad[0]["error_message"]
    assert bad[0]["outputs"] is None  # reference schema: null, not []


def test_all_items_fail_run_completes(imgs, tmp_path):
    class AlwaysFails(FusedChain):
        def save_item(self, out, item, output_dirs, options):
            raise RuntimeError("injected")

    c = _step(AlwaysFails([Enhance()]), imgs, tmp_path / "o").run(
        progress=False)
    assert c["Error"] == 8 and c.get("Success", 0) == 0


# -- a mesh and the native twins: a decline mid-run --------------------------

def _mask_dataset(d, rng):
    d.mkdir()
    for i in range(11):  # ragged against a mesh of 4 on purpose
        arr = np.full((40, 56, 3), 190, np.uint8)
        arr[5:30, 5:40] = (170, 60, 70)
        arr[8:14, 8:14] = (60, 200, 60)
        arr += rng.integers(0, 5, arr.shape, dtype=np.uint8)
        Image.fromarray(arr).save(d / f"x{i}.png")


def _mask_run(tmp_path, d, tag, transform, mesh, native):
    root = tmp_path / tag
    root.mkdir()
    (root / "in").symlink_to(d)
    pipe = ProcessingPipeline(root_dir=root)
    pipe.add_step(ProcessingStep(
        "m", transform, input_dirs=["in"], output_dirs=["o"],
        pairing_method="one_input", seed=5, mesh=mesh, device="cpu",
        options={"color_ranges_to_exclude_hsv": [(35, 60, 60, 85, 255, 255)],
                 "native_compute": native}))
    c = pipe.run(progress=False)[0]
    assert c == Counter(Success=11), c
    return {p.name: p.read_bytes() for p in sorted((root / "o").iterdir())}


def test_mesh_with_midrun_native_decline(tmp_path, rng):
    """A step with a four-wide mesh whose C++ twin declines every second
    batch: the engine pairs the mesh with the device path only, a declined
    batch takes the one-device torch path, and the files are the plain
    one-device run's, byte for byte."""
    d = tmp_path / "in"
    _mask_dataset(d, rng)
    calls = {"n": 0}

    class FlakyNative(ColorMaskTransparency):
        max_batch = 4  # several dispatches, so the decline is mid-run

        def native_fn(self, batch, static, options, n_threads=1):
            calls["n"] += 1
            if calls["n"] % 2 == 0:
                return None  # injected mid-run decline
            return super().native_fn(batch, static, options, n_threads)

    plain = _mask_run(tmp_path, d, "plain", ColorMaskTransparency(), None,
                      False)
    declining = _mask_run(tmp_path, d, "declining", FlakyNative(), 4, True)
    assert calls["n"] >= 2  # the stub really declined mid-run
    assert declining == plain


def test_mesh_device_path_with_ragged_tails_stays_padded(tmp_path, rng):
    """A four-wide mesh on the device path: every batch is padded to the
    mesh quantum, ragged tails too (11 items), and the files are the
    one-device run's, byte for byte."""
    d = tmp_path / "in"
    _mask_dataset(d, rng)
    one = _mask_run(tmp_path, d, "one", ColorMaskTransparency(), None, False)
    mesh = _mask_run(tmp_path, d, "mesh", ColorMaskTransparency(), 4, False)
    assert mesh == one


# -- golden: the pixels do not depend on the worker count --------------------

def _pixel_digest(path: Path) -> str:
    arr = np.asarray(Image.open(path))
    return hashlib.sha256(arr.tobytes() + str(arr.shape).encode()
                          ).hexdigest()[:16]


def _golden_fixture(root: Path):
    rng = np.random.default_rng(1234)
    (root / "imgs").mkdir(parents=True)
    (root / "labels").mkdir()
    for i in range(3):
        arr = rng.integers(0, 256, (70 + 10 * i, 90, 3), dtype=np.uint8)
        Image.fromarray(arr).save(root / "imgs" / f"g{i}.png")
        (root / "labels" / f"g{i}.txt").write_text("0 0.5 0.5 0.3 0.3\n")


def _golden_run(root, pkg, transforms, workers, **kw):
    _golden_fixture(root)
    pipe = pkg.ProcessingPipeline(root_dir=root)
    options = kw.pop("options", {})
    pipe.add_step(pkg.ProcessingStep(
        name="crop", process_function=transforms.SquareCropAroundBBox(),
        input_dirs=["imgs", "labels"], output_dirs=["c/i", "c/l"],
        pairing_method="zip", seed=77, workers=workers,
        options=dict(options), **kw))
    pipe.add_step(pkg.ProcessingStep(
        name="sym", process_function=transforms.GenerateSymmetries(),
        input_dirs=["c/i"], output_dirs=["s"], seed=78, workers=workers,
        options=dict(options, choose_random=2), **kw))
    pipe.run(progress=False)
    return ({p.name: _pixel_digest(p) for p in sorted((root / "s").iterdir())},
            {p.name: p.read_text() for p in sorted((root / "c/l").iterdir())})


def test_seeded_run_is_worker_count_independent_and_jax_equal(tmp_path):
    """Same seeds, workers 1 and 3: the same pixel digests and label text;
    and the JAX package's engine (jit path, F15) gives the same ones."""
    import types

    import image_processor_pipeline_tpu as jpkg
    import image_processor_pipeline_tpu.transforms as jtransforms

    tpkg = types.SimpleNamespace(ProcessingPipeline=ProcessingPipeline,
                                 ProcessingStep=ProcessingStep)
    ttransforms = types.SimpleNamespace(
        SquareCropAroundBBox=SquareCropAroundBBox,
        GenerateSymmetries=GenerateSymmetries)
    runs = [_golden_run(tmp_path / f"w{w}", tpkg, ttransforms, w,
                        device="cpu") for w in (1, 3)]
    assert runs[0] == runs[1]
    assert len(runs[0][0]) >= 6  # 3 images x (original + >= 1 symmetry)
    want = _golden_run(tmp_path / "jax", jpkg, jtransforms, 1,
                       options={"native_compute": False})
    assert runs[0] == want

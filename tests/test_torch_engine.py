"""The port's engine (pipeline.py, pairing.py, transforms/base.py) on the
CPU: pairing, seeds, the batch ladder, the JSON report, resume, overwrite,
retries, per-item errors, independence of the batch size, and the options
ported last (kept, or raising naming a missing library).  The scenarios
run through the JAX package's engine too (its jit path,
``native_compute=False``) over the same temporary dataset, and the port is
held to it: the same status counts, the same report entries and the same
files.  Exact comparisons throughout (file names, statuses, decoded
pixels, label text); no tolerance is used."""

import json
import random
import re
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import image_processor_pipeline_tpu as jpkg
import image_processor_pipeline_tpu.transforms as jtransforms
import image_processor_pipeline_tpu_torch as tpkg
import image_processor_pipeline_tpu_torch.transforms as ttransforms
from image_processor_pipeline_tpu import pairing as jpairing
from image_processor_pipeline_tpu.io.batching import Bucketizer as JBucketizer
from image_processor_pipeline_tpu_torch import (MODES, ProcessingPipeline,
                                                ProcessingStep, pairing)
from image_processor_pipeline_tpu_torch import pipeline as tpipeline
from image_processor_pipeline_tpu_torch.io.batching import Bucketizer
from image_processor_pipeline_tpu_torch.transforms import (
    BatchTransform, SquareCropAroundBBox, copy_files, copy_img_with_labels)
from image_processor_pipeline_tpu_torch.transforms.base import (host_zeros,
                                                                to_device)
from torch_port_data import make_dataset

PORT = Path(tpipeline.__file__).resolve().parent
ROOT = PORT.parent


@pytest.fixture
def dataset(tmp_path):
    imgs, labels = make_dataset(tmp_path / "data", 12, seed=3)
    return tmp_path, imgs, labels


#: engine name -> (package, its transforms, what makes a step run the path
#: the engines are compared on: the JAX package's jit path, the port's CPU)
ENGINES = {
    "jax": (jpkg, jtransforms, {"options": {"native_compute": False}}),
    "torch": (tpkg, ttransforms, {"device": "cpu"}),
}


def engine_step(engine, name, function, **kw):
    """A ProcessingStep of either package; ``function`` is a callable or
    the name of one of the package's transform classes."""
    pkg, transforms, base = ENGINES[engine]
    options = dict(base.get("options", {}), **kw.pop("options", {}))
    kw = dict(base, **kw, options=options)
    if isinstance(function, str):
        function = getattr(transforms, function)()
    return pkg.ProcessingStep(name, function, **kw)


def crop_step(root, imgs, labels, engine="torch", transform=None, **kw):
    kw.setdefault("seed", 5)
    return engine_step(
        engine, "crop", transform or "SquareCropAroundBBox",
        input_dirs=[imgs, labels],
        output_dirs=[root / "crops" / "imgs", root / "crops" / "labels"],
        pairing_method="zip", **kw)


def decoded(directory):
    """name -> decoded pixels (images) or text (labels) of a directory."""
    return {p.name: p.read_text() if p.suffix == ".txt"
            else np.asarray(Image.open(p))
            for p in sorted(Path(directory).iterdir())}


def assert_same_files(got, want):
    assert sorted(got) == sorted(want)
    for name in got:
        assert np.array_equal(got[name], want[name]), name


def entries(step, root):
    """A step's log entries with the run's root taken out, in input order."""
    logs = json.loads(json.dumps(step.process_logs, default=str)
                      .replace(str(root), "ROOT"))
    return sorted(logs, key=lambda e: e["inputs"])


# -- imports ---------------------------------------------------------------

def port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_sources_hold_the_fan_out_modules():
    """The import rule below covers the fuser, the five symmetry
    fan-out composites and the codec (ops/jpeg.py, io/native.py)."""
    names = {str(p.relative_to(PORT)) for p in port_sources()
             if PORT in p.parents}
    assert {"fuse.py", "transforms/rotsymchain.py", "transforms/chainsym.py",
            "transforms/symchain.py", "transforms/rotchainsym.py",
            "transforms/symchainsym.py", "ops/jpeg.py",
            "io/native.py"} <= names


@pytest.mark.parametrize("path", port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    """No import statement names jax or image_processor_pipeline_tpu, and
    Pillow is imported inside functions only."""
    for line in path.read_text().splitlines():
        stmt = line.strip()
        if not re.match(r"(import|from)\s", stmt):
            continue
        assert not re.match(r"(import|from)\s+jax\b", stmt), line
        assert not re.match(
            r"(import|from)\s+image_processor_pipeline_tpu(\.|\s|$)",
            stmt), line
        if re.match(r"(import|from)\s+PIL\b", stmt):
            assert line.startswith(" "), f"{path}: PIL imported at top level"


# -- pairing ---------------------------------------------------------------

def _lists(n=(7, 5)):
    return [[Path(f"d{j}/f{i:02d}") for i in range(k)]
            for j, k in enumerate(n)]


@pytest.mark.parametrize("mode,lists,sample_k", [
    ("one_input", (7,), None), ("one_input", (7,), 3), ("zip", (7, 5), None),
    ("zip", (7, 5), 4), ("modulo", (7, 3), None), ("sample", (20,), None)])
def test_pairing_matches_the_jax_package(mode, lists, sample_k):
    """Same tuples in the same order for the same random.Random seed."""
    got, n_got = pairing.generate_processing_inputs(
        _lists(lists), mode, None, sample_k, random.Random(4))
    want, n_want = jpairing.generate_processing_inputs(
        _lists(lists), mode, None, sample_k, random.Random(4))
    assert (list(got), n_got) == (list(want), n_want)


def test_pairing_modes_and_custom():
    assert MODES == jpairing.MODES
    it, total = pairing.generate_processing_inputs(
        _lists(), "custom", pairing.pair_zip)
    assert total is None and len(list(it)) == 5
    with pytest.raises(ValueError, match="pairing_method"):
        ProcessingStep("s", copy_files, pairing_method="zipp")
    with pytest.raises(ValueError, match="pairing_function"):
        ProcessingStep("s", copy_files, pairing_method="custom")


# -- ladder and buffers ----------------------------------------------------

@pytest.mark.parametrize("mode", ["pow2", "fixed"])
@pytest.mark.parametrize("n", [0, 1, 3, 8, 13, 64, 71])
def test_batch_ladder_matches_the_jax_package(n, mode):
    assert Bucketizer.batch_ladder(n, 8, mode) == \
        JBucketizer.batch_ladder(n, 8, mode)


def test_host_zeros_and_to_device_on_the_cpu():
    a = host_zeros((3, 4, 2), "cpu", np.float32)
    assert a.shape == (3, 4, 2) and a.dtype == np.float32 and not a.any()
    t = to_device(np.arange(6, dtype=np.int32).reshape(2, 3), "cpu")
    assert t.dtype == torch.int32 and t.tolist() == [[0, 1, 2], [3, 4, 5]]


def test_batch_entry_points_take_no_device_by_default():
    """launch_batch and stack_batch run where the caller says: neither has
    a default that would quietly choose the CPU."""
    with pytest.raises(TypeError, match="device"):
        BatchTransform().stack_batch([{"_seed": 1}], {})
    with pytest.raises(TypeError, match="device"):
        SquareCropAroundBBox().launch_batch((), [{"_seed": 1}], {})
    assert not hasattr(BatchTransform, "run_batch")


def test_stack_batch_keeps_prestacked_image_and_seeds():
    pre = np.zeros((2, 4, 4, 3), np.uint8)
    chunk = [{"canvas": (4, 4), "size": np.asarray([3, 2], np.int32),
              "n": np.int32(i), "_seed": 10 + i, "_x": np.zeros(2)}
             for i in range(2)]
    chunk[0]["_prestacked_image"] = pre
    out = BatchTransform().stack_batch(chunk, {}, "cpu")
    assert out["image"] is pre
    assert sorted(out) == ["image", "n", "seed", "size"]
    assert out["seed"].dtype == np.uint32 and out["seed"].tolist() == [10, 11]
    assert out["size"].tolist() == [[3, 2], [3, 2]]


# -- the engine ------------------------------------------------------------

def test_crop_pipeline_statuses_files_and_report(dataset):
    root, imgs, labels = dataset
    pipe = ProcessingPipeline(root_dir=root)
    pipe.add_step(crop_step(root, imgs, labels, save_log=True))
    pipe.add_step(ProcessingStep(
        "copy", copy_img_with_labels, pairing_method="zip",
        output_dirs=["copy/imgs", "copy/labels"], save_log=True))
    results = pipe.run(progress=False, report_path=root / "run.json")
    assert results == [Counter(Success=12), Counter(Success=12)]
    names = sorted(p.name for p in imgs.iterdir())
    for d in ("crops/imgs", "copy/imgs"):
        assert sorted(p.name for p in (root / d).iterdir()) == names
    for name, img in decoded(root / "crops" / "imgs").items():
        src = np.asarray(Image.open(imgs / name))
        assert img.shape == (min(src.shape[:2]),) * 2 + (3,)
    # the step report: a bare list in the reference's schema
    report = json.loads((root / "crops" / "crop.json").read_text())
    assert isinstance(report, list) and len(report) == 12
    assert set(report[0]) == {"inputs", "outputs", "status", "error_message"}
    assert report[0]["inputs"] == [str(imgs / names[0]),
                                   str(labels / "im_000.txt")]
    assert report[0]["outputs"] == [str(root / "crops/imgs" / names[0]),
                                    str(root / "crops/labels/im_000.txt")]
    metrics = json.loads((root / "crops" / "crop.metrics.json").read_text())
    assert metrics["statuses"] == {"Success": 12}
    assert metrics["metrics"]["items"] == 12
    assert metrics["metrics"]["batches"] == 2  # two canvas buckets
    run = json.loads((root / "run.json").read_text())
    assert [s["name"] for s in run["steps"]] == ["crop", "copy"]


def with_save(engine, cls_name, before_save, **members):
    """An instance of the engine's transform ``cls_name`` whose save_item
    first calls ``before_save(name of the item's first input, item)``."""
    base = getattr(ENGINES[engine][1], cls_name)

    def save_item(self, out, item, output_dirs, options):
        before_save(Path(item["_args"][0]).name, item)
        return base.save_item(self, out, item, output_dirs, options)

    return type(cls_name, (base,), dict(members, save_item=save_item))()


def test_seeds_follow_base_seed_plus_index(dataset):
    """item['_seed'] = (seed + index) & 0x7FFFFFFF in pairing order, in
    both engines."""
    root, imgs, labels = dataset
    names = sorted(p.name for p in imgs.iterdir())
    for engine in ENGINES:
        seen = {}
        step = crop_step(
            root / engine, imgs, labels, engine, seed=0x7FFFFFFF - 3,
            transform=with_save(
                engine, "SquareCropAroundBBox",
                lambda name, item: seen.__setitem__(name, item["_seed"])))
        step.run(progress=False)
        assert seen == {n: (0x7FFFFFFF - 3 + i) & 0x7FFFFFFF
                        for i, n in enumerate(names)}, engine


@pytest.mark.parametrize("ladder", ["pow2", "fixed"])
def test_outputs_do_not_depend_on_batch_size(dataset, ladder):
    """max_batch 2 against 8 (and both ladders), in the port and in the JAX
    engine: the same files, equal decoded pixels and label text, whatever
    the batch size and whichever the engine."""
    root, imgs, labels = dataset
    outs = []
    for engine, mb in (("torch", 2), ("torch", 8), ("jax", 8)):
        base = root / f"{engine}{mb}"
        noop = lambda name, item: None  # noqa: E731
        step = crop_step(
            base, imgs, labels, engine, options={"batch_ladder": ladder},
            transform=with_save(engine, "SquareCropAroundBBox", noop,
                                max_batch=mb))
        assert step.run(progress=False) == Counter(Success=12)
        rot = engine_step(
            engine, "rot",
            with_save(engine, "RandomRotations", noop, max_batch=mb),
            input_dirs=[base / "crops" / "imgs"], output_dirs=[base / "rot"],
            seed=9, options={"num_rotations": 2, "method": "shear",
                             "batch_ladder": ladder})
        assert rot.run(progress=False) == Counter(Success=12)
        outs.append([decoded(base / d)
                     for d in ("crops/imgs", "rot", "crops/labels")])
    for other in outs[1:]:
        for got, want in zip(outs[0], other):
            assert_same_files(got, want)
    assert len(outs[0][1]) == 36


def test_sample_k_and_workers(dataset):
    """sample_k draws the same five items in both engines."""
    root, imgs, labels = dataset
    files = {}
    for engine in ENGINES:
        step = crop_step(root / engine, imgs, labels, engine, sample_k=5,
                         workers=3)
        assert step.run(progress=False) == Counter(Success=5)
        files[engine] = decoded(root / engine / "crops" / "imgs")
    assert len(files["torch"]) == 5
    assert_same_files(files["torch"], files["jax"])


def test_resume_skips_recorded_successes(dataset):
    """A resumed run redoes only the item whose output is gone, with the
    seed of its place; both engines redo the same item and end with the
    same report and files."""
    root, imgs, labels = dataset
    ends = {}
    for engine in ENGINES:
        base = root / engine
        first = crop_step(base, imgs, labels, engine, save_log=True)
        first.run(progress=False)
        before = decoded(base / "crops" / "imgs")
        victim = sorted((base / "crops" / "imgs").iterdir())[4]
        victim.unlink()
        saves = []
        again = crop_step(
            base, imgs, labels, engine, save_log=True, resume=True,
            transform=with_save(engine, "SquareCropAroundBBox",
                                lambda name, item: saves.append(name)))
        assert again.run(progress=False) == Counter(Success=12)
        assert saves == [victim.name]  # the only item redone
        assert_same_files(decoded(base / "crops" / "imgs"), before)
        report = json.loads((base / "crops" / "crop.json").read_text()
                            .replace(str(base), "ROOT"))
        assert len(report) == 12
        ends[engine] = (sorted(report, key=lambda e: e["inputs"]), before)
    assert ends["torch"][0] == ends["jax"][0]
    assert_same_files(ends["torch"][1], ends["jax"][1])


def test_overwrite_error_refuses_a_filled_directory(dataset):
    root, imgs, labels = dataset
    for engine in ENGINES:
        base = root / engine
        crop_step(base, imgs, labels, engine).run(progress=False)
        with pytest.raises(FileExistsError, match="overwrite='error'"):
            crop_step(base, imgs, labels, engine,
                      overwrite="error").run(progress=False)
        with pytest.raises(ValueError, match="overwrite"):
            crop_step(base, imgs, labels, engine, overwrite="never")


def test_retries_and_error_items(dataset):
    """A save that fails once succeeds within the retry budget; without a
    budget the item is logged Error and the run goes on.  The log entries
    are the JAX engine's, error messages included."""
    root, imgs, labels = dataset
    logs = {}
    for engine in ENGINES:
        def flaky():
            failed = set()

            def fail_once(name, item):
                if name.endswith(("3.png", "7.png")) and name not in failed:
                    failed.add(name)
                    raise OSError(f"disk hiccup on {name}")
            return with_save(engine, "SquareCropAroundBBox", fail_once)

        base = root / engine
        step = crop_step(base / "a", imgs, labels, engine, retries=1,
                         transform=flaky())
        assert step.run(progress=False) == Counter(Success=12)
        assert all(log["error_message"] is None for log in step.process_logs)
        logs[engine] = [entries(step, base)]
        step = crop_step(base / "b", imgs, labels, engine, transform=flaky())
        assert step.run(progress=False) == Counter(Success=10, Error=2)
        errors = [log for log in step.process_logs
                  if log["status"] == "Error"]
        assert all(log["outputs"] is None
                   and log["error_message"].startswith("OSError: disk hiccup")
                   for log in errors)
        logs[engine].append(entries(step, base))
    assert logs["torch"] == logs["jax"]


def test_load_and_decode_faults_are_per_item(dataset):
    """Three kinds of bad input each cost one item, the same three in both
    engines, and the other nine come out equal.  The error messages are
    each engine's own (each words its per-item decode fallback's failure
    itself), so of the failed entries the statuses, inputs and outputs
    are compared, and only the label fault's message."""
    root, imgs, labels = dataset
    bad = sorted(imgs.iterdir())
    bad[2].write_bytes(b"not a png")          # the probe fails: load_item
    data = bad[5].read_bytes()                # fails at the batch decode
    bad[5].write_bytes(data[:len(data) // 2])
    (labels / "im_008.txt").write_text("0 0.5 0.5\n")   # bad label file
    logs, files = {}, {}
    for engine in ENGINES:
        base = root / engine
        step = crop_step(base, imgs, labels, engine)
        assert step.run(progress=False) == Counter(Success=9, Error=3)
        failed = {Path(log["inputs"][0]).name for log in step.process_logs
                  if log["status"] == "Error"}
        assert failed == {"im_002.png", "im_005.png", "im_008.png"}
        logs[engine] = entries(step, base)
        files[engine] = decoded(base / "crops" / "imgs")
    for got, want in zip(logs["torch"], logs["jax"]):
        if "im_008" not in got["inputs"][0] and got["status"] == "Error":
            got, want = (dict(e, error_message=None) for e in (got, want))
        assert got == want
    assert_same_files(files["torch"], files["jax"])


def test_host_steps_statuses_and_collisions(tmp_path):
    """Host steps: the label remap, the collision count and warning, and
    the status of each kind of return value, equal in both engines."""
    src = tmp_path / "src"
    src.mkdir()
    for i in range(4):
        (src / f"l{i}.txt").write_text(f"{i} 0.5 0.5 0.1 0.1\n")

    def to_one_name(path, output_dirs, **options):
        out = Path(output_dirs[0]) / "same.txt"
        out.write_text(Path(path).read_text())
        return out

    def by_kind(path, output_dirs, **options):
        kind = Path(path).stem[-1]
        if kind == "0":
            return None
        if kind == "1":
            return "not a path"
        if kind == "2":
            raise RuntimeError("boom")
        return [Path(path)]

    logs = {}
    for engine in ENGINES:
        base = tmp_path / engine
        transforms = ENGINES[engine][1]
        step = engine_step(engine, "remap", transforms.change_label_class,
                           input_dirs=[src], output_dirs=[base / "out"],
                           workers=2, options={"cls_mapping": {1: 9}})
        assert step.run(progress=False) == Counter(Success=4)
        assert (base / "out" / "l1.txt").read_text() == "9 0.5 0.5 0.1 0.1\n"
        logs[engine] = [entries(step, base)]
        step = engine_step(engine, "same", to_one_name, input_dirs=[src],
                           output_dirs=[base / "out2"])
        with pytest.warns(UserWarning, match="collision"):
            step.run(progress=False)
        assert step.metrics.output_collisions == 3
        logs[engine].append(entries(step, base))
        step = engine_step(engine, "kinds", by_kind, input_dirs=[src],
                           output_dirs=[base / "out3"])
        with pytest.warns(UserWarning, match="invalid return type"):
            counts = step.run(progress=False)
        assert counts == Counter({"no_output": 1, "Type Error": 1,
                                  "Error": 1, "Success": 1})
        logs[engine].append(entries(step, base))
    assert logs["torch"] == logs["jax"]


def test_from_step_index_only_one_and_auto_chaining(dataset):
    root, imgs, labels = dataset
    pipe = ProcessingPipeline(root_dir=root)
    pipe.add_step(crop_step(root, imgs, labels))
    pipe.add_step(ProcessingStep("copy", copy_img_with_labels,
                                 pairing_method="zip",
                                 output_dirs=["copy/imgs", "copy/labels"]))
    assert pipe.steps[1].input_paths == pipe.steps[0].output_paths
    assert len(pipe.run(only_one=True, progress=False)) == 1
    assert not (root / "copy").exists()
    assert pipe.run(from_step_index=1, progress=False) == \
        [Counter(Success=12)]
    assert [s.name for s in pipe.last_run_steps] == ["copy"]


def test_missing_and_empty_input_directories_raise(tmp_path):
    step = ProcessingStep("s", copy_files, input_dirs=[tmp_path / "none"],
                          output_dirs=[tmp_path / "o"])
    with pytest.raises(FileNotFoundError):
        step.run(progress=False)
    (tmp_path / "empty").mkdir()
    step = ProcessingStep("s", copy_files, input_dirs=[tmp_path / "empty"],
                          output_dirs=[tmp_path / "o"])
    with pytest.raises(ValueError, match="empty"):
        step.run(progress=False)


def test_sync_executor_and_pool_choice(monkeypatch):
    ex = tpipeline._SyncExecutor()
    assert ex.submit(lambda a, b=1: a + b, 2, b=3).result() == 5
    with pytest.raises(ZeroDivisionError):
        ex.submit(lambda: 1 / 0).result()
    cpu = torch.device("cpu")
    monkeypatch.setattr("os.cpu_count", lambda: 1)
    assert tpipeline._engine_pool_cls(1, cpu) is tpipeline._SyncExecutor
    assert tpipeline._engine_pool_cls(2, cpu) is not tpipeline._SyncExecutor
    monkeypatch.setattr("os.cpu_count", lambda: 8)
    assert tpipeline._engine_pool_cls(1, cpu) is not tpipeline._SyncExecutor


# -- the options ported last: kept, or raising naming what is missing ------

@pytest.mark.parametrize("kwargs,named", [
    ({"mesh": "auto"}, "mesh"), ({"mesh": 4}, "mesh"),
    ({"host_sharded": True}, "host_sharded"),
    ({"trace_dir": "/tmp/trace"}, "trace_dir"),
    ({"options": {"native_compute": True}}, "native_compute"),
    ({"options": {"device_decode": True}}, "device_decode"),
    ({"options": {"device_encode": True}}, "device_encode")])
def test_ported_options_are_kept_or_raise_naming_what_is_missing(
        kwargs, named, monkeypatch, tmp_path):
    if named in ("mesh", "host_sharded", "trace_dir"):
        # ported: the step keeps the option (tests/test_torch_parallel.py,
        # test_torch_distributed.py and test_torch_cli.py run them)
        step = ProcessingStep("s", SquareCropAroundBBox(), **kwargs)
        assert getattr(step, named) == kwargs[named]
        return
    if named in ("device_decode", "device_encode"):
        # ported: an explicit True is taken where the JPEG coefficient
        # coder is built, and raises naming why where it is not
        from image_processor_pipeline_tpu_torch.io import jcoef

        assert jcoef.available()
        ProcessingStep("s", SquareCropAroundBBox(), **kwargs)
        monkeypatch.setattr(jcoef, "available", lambda: False)
        monkeypatch.setattr(jcoef, "build_error",
                            lambda: "g++: No such file or directory")
        with pytest.raises(RuntimeError, match=f"{named}.*g[+][+]: No such"):
            ProcessingStep("s", SquareCropAroundBBox(), **kwargs)
        return
    # ported: the step keeps the option and runs the transform's C++ twin,
    # and raises naming the compiler's error where the library is missing
    from image_processor_pipeline_tpu_torch.ops import native_cpu

    imgs, labels = make_dataset(tmp_path / "data", 4, seed=3)
    ran = _spy_native(monkeypatch, SquareCropAroundBBox)
    step = crop_step(tmp_path, imgs, labels, **kwargs)
    assert step.options[named] is True and step._use_native()
    assert step.run(progress=False) == Counter(Success=4)
    assert ran and all(ran)
    monkeypatch.setattr(native_cpu, "available", lambda: False)
    monkeypatch.setattr(native_cpu, "build_error",
                        lambda: "g++: command not found")
    with pytest.raises(RuntimeError, match=f"{named}.*g\\+\\+: command"):
        ProcessingStep("s", SquareCropAroundBBox(), **kwargs)


def _spy_native(monkeypatch, cls):
    """Record, for each batch ``cls.native_fn`` computes, whether the twin
    took it (True) or declined it (False)."""
    ran = []
    native_fn = cls.native_fn

    def spy(self, *a, **kw):
        out = native_fn(self, *a, **kw)
        ran.append(out is not None)
        return out

    monkeypatch.setattr(cls, "native_fn", spy)
    return ran


def test_native_compute_set_after_construction_runs_the_twin(
        dataset, monkeypatch):
    # ported: set after construction, the run takes the native path and
    # writes the device path's files
    root, imgs, labels = dataset

    def files():
        return {p.relative_to(root): p.read_bytes()
                for p in sorted((root / "crops").rglob("*.*"))}

    crop_step(root, imgs, labels).run(progress=False)
    dev = files()
    for p in (root / "crops").rglob("*.*"):
        p.unlink()
    ran = _spy_native(monkeypatch, SquareCropAroundBBox)
    step = crop_step(root, imgs, labels)
    step.options["native_compute"] = True
    assert step.run(progress=False) == Counter(Success=12)
    assert ran and all(ran)
    assert files() == dev and len(dev) == 24


@pytest.mark.parametrize("options", [
    {"native_compute": "auto"}, {"native_compute": False},
    {"device_decode": False, "device_encode": "auto"}])
def test_auto_and_false_mean_the_device_path(dataset, options):
    root, imgs, labels = dataset
    step = crop_step(root, imgs, labels, options=options, mesh=False)
    assert step.run(progress=False) == Counter(Success=12)


@pytest.mark.parametrize("auto_fuse", [True, "byte", "rng"])
def test_auto_fuse_tiers_run_and_a_misspelt_tier_raises(dataset,
                                                        auto_fuse):
    """Every tier runs (a lone crop step has nothing to fuse and runs as
    it is); only a misspelt tier raises."""
    root, imgs, labels = dataset
    pipe = ProcessingPipeline(root_dir=root)
    pipe.add_step(crop_step(root, imgs, labels))
    assert pipe.run(progress=False, auto_fuse=auto_fuse) \
        == [Counter(Success=12)]
    assert pipe.last_run_steps == pipe.steps
    with pytest.raises(ValueError, match="auto_fuse"):
        pipe.run(progress=False, auto_fuse="RNG")


def test_cuda_device_without_a_card_raises(dataset):
    """device='cuda' is the default and never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is there")
    root, imgs, labels = dataset
    step = crop_step(root, imgs, labels, device="cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        step.run(progress=False)
    assert ProcessingStep("s", SquareCropAroundBBox()).device == "cuda"
    step = crop_step(root, imgs, labels, device="meta")
    with pytest.raises(ValueError, match="device"):
        step.run(progress=False)


def test_symmetry_pool_rules(dataset):
    """The pool options choose the same flips, under the same names, in
    both engines (the draws of ``choose_random`` included)."""
    root, imgs, _ = dataset
    names_of = {}

    def run(name, **options):
        got = {}
        for engine in ENGINES:
            out = root / engine / name
            step = engine_step(engine, name, "GenerateSymmetries",
                               input_dirs=[imgs], output_dirs=[out], seed=2,
                               options=options)
            got[engine] = (step.run(progress=False), decoded(out))
        assert got["torch"][0] == got["jax"][0]
        assert_same_files(got["torch"][1], got["jax"][1])
        return got["torch"][0], sorted(got["torch"][1])

    counts, names = run("all")
    assert counts == Counter(Success=12) and len(names) == 48
    counts, names = run("one", pool=["h", "v"], choose_random=1,
                        include_original=False)
    assert len(names) == 12
    assert all(n.endswith(("_h.png", "_v.png")) for n in names)
    counts, names = run("orig", pool=["o"])
    assert names == [f"im_{i:03d}_o.png" for i in range(12)]
    with pytest.warns(UserWarning, match="clamping"):
        counts, names = run("clamp", pool=["h"], choose_random=3)
    assert len(names) == 24
    counts, _ = run("bad", pool=["h", "x"])
    assert counts == Counter(Error=12)

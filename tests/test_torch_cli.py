"""The port's entry points on the CPU: ``config.py`` (StepConfig,
PipelineConfig, build_pipeline, config_from_pipeline, the registry), the
CLI ``python -m image_processor_pipeline_tpu_torch`` and ``trace_dir``;
the counterparts of tests/test_aux.py's TestConfig,
TestConfigRejectsUnserializable, TestCLI and TestTracing and of
tests/test_fuse.py::TestCLIAutoFuse.  The same JSON config goes through
the JAX package's CLI (its jit path, ``native_compute=False``) and the
port's (``--device cpu``): the same files, PNG and label bytes equal,
and the same reports once the run's root is taken out.  Byte equality
throughout; no tolerance is used."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from image_processor_pipeline_tpu import config as jconfig
from image_processor_pipeline_tpu.__main__ import main as jmain
from image_processor_pipeline_tpu_torch import ProcessingPipeline, ProcessingStep
from image_processor_pipeline_tpu_torch import config as tconfig
from image_processor_pipeline_tpu_torch.__main__ import EXAMPLE
from image_processor_pipeline_tpu_torch.__main__ import main as tmain
from image_processor_pipeline_tpu_torch.config import (
    PipelineConfig, StepConfig, build_pipeline, config_from_pipeline)
from image_processor_pipeline_tpu_torch.transforms import SquareCropAroundBBox
from torch_port_data import make_dataset, reports

REPO = Path(__file__).resolve().parent.parent
HSV = [(0, 0, 0, 180, 255, 120)]


@pytest.fixture
def dataset(tmp_path):
    imgs, labels = make_dataset(tmp_path / "data", 6, seed=13)
    return tmp_path / "data"


def files(directory):
    """name -> bytes of every file under ``directory``."""
    return {str(p.relative_to(directory)): p.read_bytes()
            for p in sorted(Path(directory).rglob("*")) if p.is_file()}


# -- config ----------------------------------------------------------------

def test_build_and_run_from_config(dataset):
    cfg = PipelineConfig(
        root_dir=str(dataset),
        steps=[
            StepConfig(name="crop", transform="square_crop_around_bbox",
                       input_dirs=["imgs", "labels"],
                       output_dirs=["cfg/i", "cfg/l"],
                       pairing_method="zip", seed=3, device="cpu"),
            StepConfig(name="remap", transform="change_label_class",
                       input_dirs=["cfg/l"], output_dirs=["cfg/remap"],
                       options={"cls_mapping": {0: 9, 1: 9, 2: 9, 3: 9,
                                                4: 9}}),
        ],
    )
    pipe = build_pipeline(cfg)
    assert pipe.steps[0].device == "cpu" and pipe.steps[1].device == "cuda"
    counters = pipe.run(progress=False)
    assert counters[0]["Success"] == 6 and counters[1]["Success"] == 6
    assert (dataset / "cfg/remap/im_000.txt").read_text().startswith("9 ")


def test_json_roundtrip(tmp_path, dataset):
    cfg = PipelineConfig(
        root_dir=str(dataset),
        steps=[StepConfig(
            name="crop", transform="square_crop_around_bbox",
            input_dirs=["imgs", "labels"], output_dirs=["j/i", "j/l"],
            pairing_method="zip", seed=3, device="cpu")],
    )
    f = tmp_path / "pipe.json"
    f.write_text(cfg.to_json())
    assert json.loads(f.read_text())["steps"][0]["device"] == "cpu"
    pipe = build_pipeline(f)
    assert pipe.run(progress=False)[0]["Success"] == 6


def test_unknown_transform():
    with pytest.raises(ValueError, match="registry keys"):
        build_pipeline({"steps": [{
            "name": "x", "transform": "does_not_exist",
            "output_dirs": ["o"]}]})


def test_every_step_knob_roundtrips(dataset):
    """config → pipeline → config covers every ProcessingStep knob, the
    port's ``device`` included."""
    cfg = PipelineConfig(
        root_dir=str(dataset),
        steps=[StepConfig(
            name="crop",
            transform="square_crop_around_bbox",
            input_dirs=["imgs", "labels"],
            output_dirs=["rt/i", "rt/l"],
            pairing_method="custom",
            pairing_function="image_processor_pipeline_tpu_torch.pairing:"
                             "pair_zip",
            fixed_input=True,
            sample_k=3,
            save_log=True,
            workers=1,
            seed=7,
            overwrite="error",
            trace_dir="traces",
            retries=2,
            resume=True,
            host_sharded=True,
            mesh="auto",
            options={"quality": 90},
            device="cpu",
        )],
    )
    pipe = build_pipeline(cfg)
    s = pipe.steps[0]
    assert s.pairing_method == "custom" and callable(s.pairing_function)
    assert s.retries == 2 and s.resume and s.host_sharded
    assert s.overwrite == "error" and s.fixed_input and s.sample_k == 3
    assert s.mesh == "auto" and s.device == "cpu" and s.trace_dir == "traces"

    back = config_from_pipeline(pipe)
    s2 = back.steps[0]
    assert s2.transform == "square_crop_around_bbox"
    assert s2.pairing_function == (
        "image_processor_pipeline_tpu_torch.pairing:pair_zip")
    for knob in ("name", "pairing_method", "fixed_input", "sample_k",
                 "save_log", "workers", "seed", "overwrite", "trace_dir",
                 "retries", "resume", "host_sharded", "mesh", "options",
                 "device"):
        assert getattr(s2, knob) == getattr(cfg.steps[0], knob), knob
    assert build_pipeline(back).steps[0].retries == 2


def test_host_transform_roundtrips_as_function_spec(dataset):
    from image_processor_pipeline_tpu_torch.transforms.labels import (
        change_label_class)

    pipe = ProcessingPipeline(root_dir=dataset)
    pipe.add_step(ProcessingStep(
        "remap", change_label_class, input_dirs=["labels"],
        output_dirs=["rt2"], options={"cls_mapping": {0: 1}}))
    back = config_from_pipeline(pipe)
    assert back.steps[0].transform == "change_label_class"
    assert build_pipeline(back).steps[0].name == "remap"


def test_registry_has_the_jax_keys_on_the_ports_classes():
    """A config written for the JAX CLI names the same 15 keys; each
    resolves to the port's class or function of the same name."""
    assert sorted(tconfig.TRANSFORM_REGISTRY) == sorted(
        jconfig.TRANSFORM_REGISTRY)
    assert len(tconfig.TRANSFORM_REGISTRY) == 15
    for key, spec in tconfig.TRANSFORM_REGISTRY.items():
        jspec = jconfig.TRANSFORM_REGISTRY[key]
        assert spec == jspec.replace("image_processor_pipeline_tpu.",
                                     "image_processor_pipeline_tpu_torch.")
        assert tconfig._resolve_dotted(spec).__module__.startswith(
            "image_processor_pipeline_tpu_torch.")


@pytest.mark.parametrize("field,spec,counterpart", [
    ("transform", "image_processor_pipeline_tpu.transforms.copy:copy_files",
     "image_processor_pipeline_tpu_torch.transforms.copy:copy_files"),
    ("pairing_function", "image_processor_pipeline_tpu.pairing:pair_zip",
     "image_processor_pipeline_tpu_torch.pairing:pair_zip"),
    ("transform", "image_processor_pipeline_tpu:ProcessingStep",
     "image_processor_pipeline_tpu_torch:ProcessingStep")])
def test_a_jax_package_spec_is_refused_naming_the_port(dataset, field, spec,
                                                      counterpart):
    step = {"name": "x", "transform": "copy_files", "input_dirs": ["imgs"],
            "output_dirs": ["o"]}
    step[field] = spec
    if field == "pairing_function":
        step["pairing_method"] = "custom"
    code = ("import sys\nfrom image_processor_pipeline_tpu_torch.config "
            "import build_pipeline\ntry:\n"
            f"    build_pipeline({{'steps': [{step!r}]}})\n"
            "except ValueError as e:\n    print(e)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'image_processor_pipeline_tpu.')) or "
            "m == 'image_processor_pipeline_tpu')\nprint(bad)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    message, loaded = proc.stdout.strip().splitlines()[-2:]
    assert "names the JAX package" in message and counterpart in message
    assert loaded == "[]"


def test_nested_callable_rejected(dataset):
    from image_processor_pipeline_tpu_torch.transforms.labels import (
        change_label_class)

    def nested(lists):
        return zip(*lists)

    pipe = ProcessingPipeline(root_dir=dataset)
    pipe.add_step(ProcessingStep(
        "remap", change_label_class, input_dirs=["labels"],
        output_dirs=["x"], pairing_method="custom", pairing_function=nested))
    with pytest.raises(ValueError, match="nested"):
        config_from_pipeline(pipe)


def test_stateful_transform_instance_rejected(dataset):
    from image_processor_pipeline_tpu_torch.transforms.fused import (
        Enhance, FusedChain)

    pipe = ProcessingPipeline(root_dir=dataset)
    pipe.add_step(ProcessingStep(
        "fc", FusedChain([Enhance()]), input_dirs=["imgs"],
        output_dirs=["y"]))
    with pytest.raises(ValueError, match="constructor"):
        config_from_pipeline(pipe)


# -- the CLI ---------------------------------------------------------------

def write_config(path, steps, root):
    path.write_text(json.dumps({"root_dir": str(root), "steps": steps}))
    return path


def test_cli_run_and_validate(tmp_path, dataset, capsys):
    cfg = write_config(tmp_path / "pipe.json", [{
        "name": "crop", "transform": "square_crop_around_bbox",
        "input_dirs": ["imgs", "labels"],
        "output_dirs": ["c/imgs", "c/labels"], "pairing_method": "zip",
        "seed": 1, "save_log": True}], dataset)
    assert tmain(["validate", str(cfg)]) == 0
    assert "OK: 1 step(s) resolved" in capsys.readouterr().out
    assert tmain(["transforms"]) == 0
    listed = capsys.readouterr().out
    assert all(key in listed for key in tconfig.TRANSFORM_REGISTRY)
    assert tmain(["example"]) == 0
    assert json.loads(capsys.readouterr().out) == EXAMPLE
    rc = tmain(["run", str(cfg), "--no-progress", "--strict",
                "--device", "cpu"])
    assert rc == 0
    assert "crop: Success: 6" in capsys.readouterr().out
    assert len(list((dataset / "c/imgs").iterdir())) == 6
    report = json.loads((dataset / "c" / "crop.json").read_text())
    assert all(e["status"] == "Success" for e in report)


def test_cli_example_is_the_jax_clis(capsys):
    assert jmain(["example"]) == 0
    assert json.loads(capsys.readouterr().out) == EXAMPLE


def test_cli_strict_flags_failures(tmp_path):
    (tmp_path / "imgs").mkdir()
    (tmp_path / "imgs" / "bad.jpg").write_bytes(b"\xff\xd8 garbage")
    cfg = write_config(tmp_path / "pipe.json", [{
        "name": "rot", "transform": "rotations", "input_dirs": ["imgs"],
        "output_dirs": ["out"], "options": {"num_rotations": 1},
        "seed": 1}], tmp_path)
    args = ["run", str(cfg), "--no-progress", "--device", "cpu"]
    assert tmain(args) == 0
    assert tmain(args + ["--strict"]) == 1


def test_cli_runs_on_the_card_unless_told_cpu(tmp_path, dataset,
                                              monkeypatch):
    """Without ``--device`` a step computes on "cuda"; with no card that
    raises instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = write_config(tmp_path / "pipe.json", [{
        "name": "crop", "transform": "square_crop_around_bbox",
        "input_dirs": ["imgs", "labels"],
        "output_dirs": ["c/imgs", "c/labels"], "pairing_method": "zip",
        "seed": 1}], dataset)
    with pytest.raises(RuntimeError, match="is_available"):
        tmain(["run", str(cfg), "--no-progress"])
    assert not any((dataset / "c" / "imgs").iterdir())


#: configs run through both CLIs: JAX's example (crop, then 5 rotations an
#: image, by shear and by the default nearest), and JAX's TestCLIAutoFuse
#: pair (color mask, then cleanup; a step with save_log never fuses) run
#: with --auto-fuse
BOTH_CLIS = {
    "example": ([
        dict(EXAMPLE["steps"][0], input_dirs=["imgs", "labels"]),
        dict(EXAMPLE["steps"][1], save_log=True,
             options={"num_rotations": 5, "method": "shear"})], ()),
    "example_nearest": ([
        dict(EXAMPLE["steps"][0]),
        dict(EXAMPLE["steps"][1], save_log=True)], ()),
    "auto_fuse": ([
        {"name": "mask", "transform": "color_mask", "input_dirs": ["imgs"],
         "output_dirs": ["m"], "pairing_method": "one_input", "seed": 3,
         "options": {"color_ranges_to_exclude_hsv": HSV}},
        {"name": "clean", "transform": "cleanup", "input_dirs": ["m"],
         "output_dirs": ["c"], "pairing_method": "one_input",
         "options": {"min_component_size": 20}}],
        ("--auto-fuse",)),
}


@pytest.mark.parametrize("case", sorted(BOTH_CLIS))
def test_same_config_through_both_clis_writes_the_same_files(tmp_path,
                                                             case):
    """The JAX CLI and the port's (``--device cpu``) run one JSON config
    (each step's options say native_compute False: the JAX engine's jit
    path, the port's device path) and write the same files byte for byte
    and equal reports once the run's root is taken out."""
    steps, flags = BOTH_CLIS[case]
    for s in steps:
        s["options"] = dict(s.get("options", {}), native_compute=False)
    roots = {}
    for tag, main, extra in (("j", jmain, ()), ("t", tmain,
                                                ("--device", "cpu"))):
        root = tmp_path / tag
        make_dataset(root, 5, seed=29)
        cfg = write_config(tmp_path / f"{tag}.json", steps, root)
        assert main(["run", str(cfg), "--no-progress", "--strict",
                     *flags, *extra]) == 0
        roots[tag] = root
    got, want = files(roots["t"]), files(roots["j"])
    assert sorted(got) == sorted(want)
    assert len(got) > 10
    for name in want:
        if name.endswith(".json"):
            continue
        assert got[name] == want[name], name
    assert reports(roots["t"]) == reports(roots["j"])
    if flags:
        # fused: the intermediate directory was never written
        assert not (roots["t"] / "m").exists()
        assert not (roots["j"] / "m").exists()


def test_cli_module_entry_point_runs(tmp_path, dataset):
    """``python -m image_processor_pipeline_tpu_torch`` in its own process
    (no jax imported there)."""
    cfg = write_config(tmp_path / "pipe.json", [{
        "name": "copy", "transform": "copy_img_with_labels",
        "input_dirs": ["imgs", "labels"],
        "output_dirs": ["k/imgs", "k/labels"], "pairing_method": "zip"}],
        dataset)
    proc = subprocess.run(
        [sys.executable, "-m", "image_processor_pipeline_tpu_torch", "run",
         str(cfg), "--no-progress", "--strict", "--device", "cpu"],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "copy: Success: 6" in proc.stdout
    proc = subprocess.run(
        [sys.executable, "-m", "image_processor_pipeline_tpu_torch", "run"],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 2 and "config" in proc.stderr


# -- trace_dir ---------------------------------------------------------------

def test_trace_dir_produces_profile(dataset, tmp_path):
    trace_dir = tmp_path / "trace"
    step = ProcessingStep(
        name="crop", process_function=SquareCropAroundBBox(),
        input_dirs=[dataset / "imgs", dataset / "labels"],
        output_dirs=[dataset / "t/i", dataset / "t/l"],
        pairing_method="zip", seed=1, trace_dir=trace_dir, device="cpu")
    assert step.run(progress=False)["Success"] == 6
    traces = list(trace_dir.glob("*.pt.trace.json"))
    assert len(traces) == 1, list(trace_dir.iterdir())
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)


def test_no_trace_dir_writes_nothing(dataset, tmp_path, monkeypatch):
    import torch.profiler

    def refuse(*a, **k):
        raise AssertionError("profiler started without a trace_dir")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    step = ProcessingStep(
        name="crop", process_function=SquareCropAroundBBox(),
        input_dirs=[dataset / "imgs", dataset / "labels"],
        output_dirs=[dataset / "n/i", dataset / "n/l"],
        pairing_method="zip", seed=1, device="cpu")
    assert step.run(progress=False)["Success"] == 6


# -- hsv_tuner ---------------------------------------------------------------

@pytest.mark.parametrize("lower,upper", [((0, 0, 0), (180, 255, 120)),
                                         ((35, 60, 60), (85, 255, 255))])
def test_hsv_tuner_gives_the_jax_arrays(dataset, lower, upper):
    from image_processor_pipeline_tpu.utils.hsv_tuner import (
        preview_hsv_mask as jpreview)
    from image_processor_pipeline_tpu_torch.utils.hsv_tuner import (
        preview_hsv_mask as tpreview)

    path = dataset / "imgs" / "im_002.png"
    got = tpreview(path, lower, upper, show=False, device="cpu")
    want = jpreview(path, lower, upper, show=False)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert 0 < got[1].sum() < got[1].size


def test_hsv_tuner_runs_on_the_card_unless_asked_for_the_cpu(dataset,
                                                              monkeypatch):
    """The default device is the card: without one it raises instead of
    computing on the CPU."""
    from image_processor_pipeline_tpu_torch.utils.hsv_tuner import (
        preview_hsv_mask)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        preview_hsv_mask(dataset / "imgs" / "im_002.png", (0, 0, 0),
                         (180, 255, 120), show=False)

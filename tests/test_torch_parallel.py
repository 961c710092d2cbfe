"""The port's in-process data parallelism on the CPU: ``parallel/mesh.py``
(make_mesh, shard_batch, sharded_augment_step), the engine's ``mesh=``
(``ProcessingStep._resolve_mesh``, the padding to the mesh quantum, every
``launch_batch`` override and ``shrink_output`` hook shard by shard), the
fuser's mesh guard and ``parallel/dryrun.py``; the counterparts of
tests/test_chains.py's TestMeshSharding and TestEngineMesh, of
tests/test_fuse.py::TestNewFanoutMesh and of tests/test_graft_entry.py.

Meshes here repeat the CPU (``make_mesh(devices=["cpu"] * 4)``), as the
JAX tests use eight virtual CPU devices.  Tolerance: byte equality
throughout, against the JAX package's sharded step over its eight
devices (items whose shift vectors differ from JAX's, F1, are named and
left out, as tests/test_torch_chain.py does) and against the port's own
single-device run."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import image_processor_pipeline_tpu_torch as tpkg
import image_processor_pipeline_tpu_torch.transforms as ttransforms
from image_processor_pipeline_tpu.parallel import mesh as jmesh
from image_processor_pipeline_tpu_torch import (ProcessingPipeline,
                                                ProcessingStep, kernels)
from image_processor_pipeline_tpu_torch.fuse import fuse_steps
from image_processor_pipeline_tpu_torch.models import chains as tchains
from image_processor_pipeline_tpu_torch.parallel import distributed
from image_processor_pipeline_tpu_torch.parallel import mesh as tmesh
from image_processor_pipeline_tpu_torch.parallel.mesh import (
    Mesh, make_mesh, shard_batch, sharded_augment_step)
from image_processor_pipeline_tpu_torch.transforms import fused as tfused
from test_torch_chain import assert_chain_equal, chain_inputs, f1_items
from torch_port_data import make_dataset

REPO = Path(__file__).resolve().parent.parent
CPU4 = ["cpu"] * 4
MASK = [(0, 0, 0, 180, 255, 120)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small CPU batches run on one thread: the test workers share the
    machine's cores (pytest-xdist)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def read_dir(directory):
    return {p.name: p.read_bytes() for p in sorted(Path(directory).iterdir())
            if p.is_file()}


# -- make_mesh ---------------------------------------------------------------

def test_make_mesh_shapes_and_axes():
    mesh = make_mesh(devices=CPU4, shape=(2, 2))
    assert mesh.shape == {"data": 2, "model": 2}
    assert mesh.shape["data"] == 2 and mesh.axis_names == ("data", "model")
    assert mesh.devices.shape == (2, 2) and mesh.device_type == "cpu"
    assert mesh.data_devices() == [torch.device("cpu")] * 2
    flat = make_mesh(devices=CPU4)
    assert flat.shape == {"data": 4, "model": 1}
    assert make_mesh(3, devices=CPU4).shape["data"] == 3
    assert make_mesh(devices=CPU4) == make_mesh(devices=CPU4)
    assert make_mesh(devices=CPU4) != make_mesh(devices=CPU4, shape=(2, 2))


@pytest.mark.parametrize("kwargs,error", [
    ({"n_devices": 5, "devices": CPU4}, "requested 5 devices but only 4"),
    ({"shape": (3, 2), "devices": CPU4}, r"mesh shape \(3, 2\) != device "
                                         "count 4"),
    ({"devices": ["cpu", "cuda:0"]}, "devices of one type"),
    ({"devices": CPU4, "shape": (4,)}, "1-d device grid")])
def test_make_mesh_errors(kwargs, error):
    with pytest.raises(ValueError, match=error):
        make_mesh(**kwargs)


def test_make_mesh_defaults_to_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="device_count"):
        make_mesh()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = make_mesh()
    assert [str(d) for d in mesh.devices.flat] == ["cuda:0", "cuda:1"]
    with pytest.raises(ValueError, match="only 2 available"):
        make_mesh(4)


# -- shard_batch / sharded_augment_step ----------------------------------

def test_shard_batch_splits_and_gathers():
    calls = []

    def fn(x, host, scale):
        calls.append((tuple(x.shape), host.tolist(), scale))
        return {"y": x * scale, "n": torch.tensor([len(host)])}, host + 1

    out, host = shard_batch(fn, make_mesh(devices=CPU4, shape=(2, 2)))(
        torch.arange(8), np.arange(8), 3)
    assert calls == [((4,), [0, 1, 2, 3], 3), ((4,), [4, 5, 6, 7], 3)]
    assert out["y"].tolist() == [3 * i for i in range(8)]
    assert out["n"].tolist() == [4, 4]
    np.testing.assert_array_equal(host, np.arange(1, 9))
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(fn, make_mesh(devices=CPU4))(torch.arange(6),
                                                 np.arange(6), 1)


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
def test_sharded_step_matches_jax_sharded_and_unsharded(shape):
    """Over four CPU entries, the step equals JAX's sharded step over its
    eight virtual devices (mesh (4, 2)) and the port's unsharded
    augment_chain in 'shear', the mode a CPU mesh takes by default."""
    images, xywhn, seeds = chain_inputs(8, 96, seed=3)
    step = sharded_augment_step(make_mesh(devices=CPU4, shape=shape),
                                crop=64)
    kernels.reset_launch_counts()
    out, count = step(images, xywhn, seeds)
    assert all(n == 0 for n in kernels.launch_counts.values())
    assert tuple(out.shape) == (8, 64, 64, 4) and out.dtype == torch.uint8
    assert count.dtype == torch.int64 and count.ndim == 0 and int(count) == 8

    jm = jmesh.make_mesh(8, shape=(4, 2))
    with jm:
        want, jcount = jmesh.sharded_augment_step(jm, crop=64)(
            images, xywhn, seeds)
    assert int(jcount) == int(count)
    assert_chain_equal(out.numpy(), np.asarray(want),
                       f1_items(images, xywhn, seeds, 64))
    single = tchains.augment_chain(torch.as_tensor(images), xywhn, seeds, 64,
                                   "shear")
    assert torch.equal(out, single)


@pytest.mark.parametrize("rotation,twin", [
    ("cuda_full", "full_reference"), ("cuda_shear", "shear"),
    ("full_reference", "full_reference")])
def test_sharded_step_modes_equal_their_unsharded_twins(rotation, twin):
    """An explicit mode runs shard by shard (on CPU tensors the kernels'
    plain twins): the same bytes as the unsharded twin mode."""
    images, xywhn, seeds = chain_inputs(8, 96, seed=5)
    out, count = sharded_augment_step(
        make_mesh(devices=CPU4), crop=64, rotation=rotation)(
        torch.as_tensor(images), torch.as_tensor(xywhn),
        torch.as_tensor(seeds))
    want = tchains.augment_chain(torch.as_tensor(images), xywhn, seeds, 64,
                                 twin)
    assert torch.equal(out, want)
    assert int(count) == int((want[..., 3] > 0).flatten(1).any(1).sum())


def test_sharded_step_mode_by_device_type_and_bad_mode():
    assert tmesh.default_rotation("cuda") == "cuda_shear"
    assert tmesh.default_rotation("cpu") == "shear"
    with pytest.raises(ValueError, match="unknown rotation mode"):
        sharded_augment_step(make_mesh(devices=CPU4), rotation="pallas")


def test_global_counter_and_host_shard_in_one_process():
    assert not distributed.is_initialized()
    assert distributed.global_counter(5, make_mesh(devices=CPU4)) == 5
    assert distributed.global_counter(7) == 7
    items = list(range(10))
    shards = [distributed.host_shard(items, pid, 3) for pid in range(3)]
    assert sorted(sum(shards, [])) == items
    assert [len(s) for s in shards] == [4, 3, 3]
    assert distributed.host_shard(items) == items


# -- the engine's mesh ---------------------------------------------------------

def chain_step(root, mesh, out, **kw):
    return ProcessingStep(
        name="chain", process_function=tfused.FusedChain(
            [tfused.Rotate(method="shear"), tfused.Flip(), tfused.Enhance()]),
        input_dirs=["src"], output_dirs=[out], seed=99, mesh=mesh,
        save_log=True, root_dir=root, device="cpu", **kw)


@pytest.fixture
def eleven(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(7)
    for i in range(11):
        arr = rng.integers(0, 256, (40 + (i % 3), 52, 3), np.uint8)
        Image.fromarray(arr).save(src / f"im{i}.png")
        Image.fromarray(arr).save(src / f"jm{i}.jpg", quality=90)
    return tmp_path


@pytest.mark.parametrize("mesh", [4, 3, "grid"])
def test_engine_mesh_byte_identical(eleven, mesh, monkeypatch):
    """n=11 (22 files in two canvas buckets) is no multiple of the data
    axis: the mesh padding runs, the files and the report equal the
    single-device run's, and every batch went out shard by shard."""
    if mesh == "grid":
        mesh = make_mesh(devices=CPU4, shape=(2, 2))
    from image_processor_pipeline_tpu_torch.transforms import base

    shards = []
    real = base.BatchTransform.dispatch

    def spy(self, arrays, fn, device, mesh=None):
        out = real(self, arrays, fn, device, mesh)
        shards.append(len(out) if isinstance(out, list) else 1)
        return out

    one = chain_step(eleven, None, "one")
    c1 = one.run(progress=False)
    monkeypatch.setattr(base.BatchTransform, "dispatch", spy)
    meshed = chain_step(eleven, mesh, "mesh")
    cm = meshed.run(progress=False)
    quantum = 4 if mesh == 4 else 3 if mesh == 3 else 2
    assert shards and set(shards) == {quantum}
    assert c1 == cm and cm["Success"] == 22
    assert read_dir(eleven / "one") == read_dir(eleven / "mesh")

    def strip(step):
        return sorted(
            ({**e, "outputs": [Path(o).name for o in e["outputs"] or []]}
             for e in step.process_logs), key=lambda e: str(e["inputs"]))

    assert strip(one) == strip(meshed)


def test_engine_mesh_with_device_decode(eleven):
    """Mesh padding duplicates tail items; the hybrid device decode still
    feeds those padded chunks (the prestacked batch split by shard) and
    the files equal the single-device pixel-decode run's."""
    from image_processor_pipeline_tpu_torch.io import native

    assert native.available()
    px = chain_step(eleven, None, "px")
    px.input_dirs = ["src"]
    c1 = px.run(progress=False)
    dd = chain_step(eleven, 4, "dd", options={"device_decode": True})
    c4 = dd.run(progress=False)
    assert c1 == c4
    assert read_dir(eleven / "px") == read_dir(eleven / "dd")


#: every transform of the port with a shrink_output hook or a launch_batch
#: override, with the options that make it engage: (name, factory, input
#: suffix, options)
SHRINK_CASES = {
    "crop_square_jpeg": ("SquareCropAroundBBox", ".jpg", {}),
    "rotations_jpeg": ("RandomRotations", ".jpg",
                       {"output_format": "jpeg", "num_rotations": 2,
                        "method": "shear"}),
    "symmetry_jpeg": ("GenerateSymmetries", ".jpg", {}),
    "symmetry_png": ("GenerateSymmetries", ".png", {}),
    "enhance_jpeg": ("EnhanceImage", ".jpg", {}),
    "fused_jpeg": ("FusedChain", ".png", {"output_suffix": ".jpg"}),
    "fused_png": ("FusedChain", ".png", {}),
}


@pytest.fixture(scope="module")
def shrink_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("shrink")
    imgs, labels = make_dataset(root / "png", 7, seed=17)
    (root / "jpg").mkdir()
    for p in sorted(imgs.iterdir()):
        Image.open(p).save(root / "jpg" / f"{p.stem}.jpg", quality=92)
    return {".png": imgs, ".jpg": root / "jpg"}, labels


@pytest.mark.parametrize("case", sorted(SHRINK_CASES))
def test_shrink_hooks_under_a_mesh_write_the_single_device_files(
        shrink_data, tmp_path, case):
    """Each hook runs once a shard on that shard's rows (with the device
    JPEG transports forced on, as a card's "auto" would): the same files
    as without a mesh, and the JPEG transports ran in both runs (fewer
    bytes fetched than computed).  The byte counts themselves differ: a
    shard of mesh padding alone is not fetched, and a shard's shrink
    window or coefficient cap is its own."""
    sources, labels = shrink_data
    name, suffix, options = SHRINK_CASES[case]
    src = sources[suffix]
    out = {}
    for tag, mesh in (("one", None), ("mesh", 4)):
        if name == "FusedChain":
            transform = tfused.FusedChain([
                tfused.Rotate(method="shear"), tfused.Flip(),
                tfused.Enhance()])
        else:
            transform = getattr(ttransforms, name)()
        is_crop = name == "SquareCropAroundBBox"
        step = ProcessingStep(
            "s", transform,
            input_dirs=[src, labels] if is_crop else [src],
            output_dirs=([tmp_path / tag / "i", tmp_path / tag / "l"]
                         if is_crop else [tmp_path / tag / "o"]),
            pairing_method="zip" if is_crop else "one_input", seed=4,
            mesh=mesh, device="cpu",
            options=dict(options, device_encode=True, device_decode=True))
        assert step.run(progress=False)["Success"] == 7
        out[tag] = {d.name: read_dir(d) for d in (tmp_path / tag).iterdir()}
        m = step.metrics
        assert 0 < m.d2h_bytes_fetched <= m.d2h_bytes_full
        if "jpeg" in case:
            assert m.d2h_bytes_fetched < m.d2h_bytes_full
    assert out["one"] == out["mesh"]
    assert all(out["one"].values())


FANOUT = {
    "RotSymChain": lambda st: ttransforms.RotSymChain(st, ("o", "hv")),
    "ChainSymmetries": lambda st: ttransforms.ChainSymmetries(st),
    "SymmetriesChain": lambda st: ttransforms.SymmetriesChain(
        st, ("o", "h", "v")),
    "RotationsChainSymmetries": lambda st:
        ttransforms.RotationsChainSymmetries(st, ("o", "hv")),
    "SymmetriesChainSymmetries": lambda st:
        ttransforms.SymmetriesChainSymmetries(st, ("o", "h"), ("o", "v")),
}


@pytest.fixture(scope="module")
def fanout_inputs(tmp_path_factory):
    """Five RGBA PNGs (tests/test_fuse.py::TestNewFanoutMesh's)."""
    d = tmp_path_factory.mktemp("fanout")
    rng = np.random.default_rng(2)
    for i in range(5):
        h, w = 40 + 6 * i, 54
        arr = np.full((h, w, 4), 255, np.uint8)
        arr[..., :3] = (170, 60, 90)
        arr[:5, :, 3] = 0
        y, x = int(rng.integers(6, h - 6)), int(rng.integers(0, w - 6))
        arr[y:y + 5, x:x + 5, :3] = (60, 200, 60)
        Image.fromarray(arr).save(d / f"p{i}.png")
    return d


@pytest.mark.parametrize("name", sorted(FANOUT))
def test_fanout_composites_under_mesh_4(fanout_inputs, tmp_path, name):
    stages = [tfused.ColorMask(MASK, input_alpha="replace"),
              tfused.Cleanup(min_component_size=20)]
    options = ({"num_rotations": 2, "method": "shear"}
               if name.startswith("Rot") else {})
    results = {}
    for tag, mesh in (("one", None), ("mesh", 4)):
        step = ProcessingStep(
            "f", FANOUT[name](stages), input_dirs=[fanout_inputs],
            output_dirs=[tmp_path / tag], seed=5, mesh=mesh, device="cpu",
            options=options)
        assert step.run(progress=False)["Success"] == 5
        results[tag] = read_dir(tmp_path / tag)
    assert results["one"] == results["mesh"]
    assert len(results["one"]) >= 10


# -- _resolve_mesh -------------------------------------------------------------

def resolved(tmp_path, mesh, device="cpu"):
    return ProcessingStep(
        "m", ttransforms.EnhanceImage(), input_dirs=["x"], output_dirs=["y"],
        root_dir=tmp_path, mesh=mesh, device=device)._resolve_mesh()


def test_engine_mesh_defaults(tmp_path, monkeypatch):
    """None is no mesh on a CPU step and "auto" on a CUDA step; False is
    off; "auto" and an int build over the local cards and collapse to None
    for one; a CPU step's int repeats the CPU."""
    assert resolved(tmp_path, None) is None
    assert resolved(tmp_path, False) is None
    assert resolved(tmp_path, "auto") is None
    assert resolved(tmp_path, 1) is None
    four = resolved(tmp_path, 4)
    assert four.shape["data"] == 4 and four.device_type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert resolved(tmp_path, None, "cuda") is None
    assert resolved(tmp_path, "auto", "cuda") is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    auto = resolved(tmp_path, None, "cuda")
    assert [str(d) for d in auto.devices.flat] == ["cuda:0", "cuda:1"]
    assert resolved(tmp_path, "auto", "cuda") == auto
    assert resolved(tmp_path, False, "cuda") is None
    with pytest.raises(ValueError, match="only 2 available"):
        resolved(tmp_path, 4, "cuda")


def test_engine_mesh_int_and_validation(tmp_path):
    with pytest.raises(ValueError, match="'auto', an int"):
        resolved(tmp_path, "bogus")
    prebuilt = make_mesh(devices=CPU4, shape=(2, 2))
    assert resolved(tmp_path, prebuilt) is prebuilt
    no_data = Mesh(np.asarray(prebuilt.devices), ("rows", "cols"))
    with pytest.raises(ValueError, match="'data' axis"):
        resolved(tmp_path, no_data)
    cards = make_mesh(devices=["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="device='cpu' but its mesh is on "
                                         "cuda"):
        resolved(tmp_path, cards)
    with pytest.raises(ValueError, match="device='cuda' but its mesh is on "
                                         "cpu"):
        resolved(tmp_path, prebuilt, "cuda")


def test_fuser_merges_steps_only_on_equal_meshes(tmp_path):
    """fuse.py compares ``mesh`` when it merges steps: mask → cleanup
    fuses under equal meshes (equal prebuilt ones too) and not across
    different ones."""
    def steps(m1, m2):
        return [
            ProcessingStep("mask", ttransforms.ColorMaskTransparency(),
                           input_dirs=[tmp_path / "in"],
                           output_dirs=[tmp_path / "m"], mesh=m1,
                           device="cpu", seed=3,
                           options={"color_ranges_to_exclude_hsv": MASK}),
            ProcessingStep("clean", ttransforms.KeepLargestComponent(),
                           input_dirs=[tmp_path / "m"],
                           output_dirs=[tmp_path / "c"], mesh=m2,
                           device="cpu",
                           options={"min_component_size": 20})]

    assert len(fuse_steps(steps(4, 4), verbose=False)) == 1
    assert len(fuse_steps(steps(make_mesh(devices=CPU4),
                                make_mesh(devices=CPU4)),
                          verbose=False)) == 1
    assert len(fuse_steps(steps(4, None), verbose=False)) == 2
    assert len(fuse_steps(steps(make_mesh(devices=CPU4), 4),
                          verbose=False)) == 2


def test_a_fused_step_keeps_its_mesh(tmp_path):
    imgs, _ = make_dataset(tmp_path / "d", 5, seed=31)
    results = {}
    for tag, mesh in (("one", None), ("mesh", 4)):
        pipe = ProcessingPipeline(root_dir=tmp_path / tag)
        pipe.add_step(ProcessingStep(
            "mask", ttransforms.ColorMaskTransparency(), input_dirs=[imgs],
            output_dirs=["m"], mesh=mesh, device="cpu", seed=3,
            options={"color_ranges_to_exclude_hsv": MASK}))
        pipe.add_step(ProcessingStep(
            "clean", ttransforms.KeepLargestComponent(), output_dirs=["c"],
            mesh=mesh, device="cpu", options={"min_component_size": 20}))
        pipe.run(progress=False, auto_fuse=True)
        assert len(pipe.last_run_steps) == 1
        assert pipe.last_run_steps[0].mesh == mesh
        results[tag] = read_dir(tmp_path / tag / "c")
    assert results["one"] == results["mesh"] and len(results["one"]) == 5


# -- the dry run (tests/test_graft_entry.py's counterpart) -------------------

def test_dryrun_multichip_in_its_own_process():
    """As a user calls it, in a fresh process that imports no jax."""
    env = dict(os.environ)
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys\n"
         "from image_processor_pipeline_tpu_torch.parallel import dryrun\n"
         "dryrun.dryrun_multichip(8, device='cpu')\n"
         "assert 'jax' not in sys.modules\n"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, f"{proc.stdout}\n{proc.stderr}"
    assert "dryrun_multichip OK: mesh {'data': 4, 'model': 2}" in proc.stdout
    assert "engine mesh OK: 11 items" in proc.stdout


def test_dryrun_multichip_inprocess(capsys):
    from image_processor_pipeline_tpu_torch.parallel import dryrun

    dryrun.dryrun_multichip(3, device="cpu")
    out = capsys.readouterr().out
    assert "mesh {'data': 3, 'model': 1}" in out and "6 items" in out


def test_entry_is_the_chains_forward_step():
    from image_processor_pipeline_tpu_torch.parallel import dryrun

    fn, args = dryrun.entry("cpu")
    out = fn(*args)
    assert tuple(out.shape) == (8, 512, 512, 4)
    assert torch.equal(out, tchains.augment_chain(*args, 512, "shear"))


def run_tree(root):
    """relative path -> bytes of every file under ``root`` but the JSON
    reports, and the reports' entries with ``root`` taken out."""
    found, reports = {}, {}
    for p in sorted(Path(root).rglob("*")):
        if not p.is_file():
            continue
        rel = str(p.relative_to(root))
        if p.suffix == ".json":
            entries = json.loads(p.read_text().replace(str(root), "ROOT"))
            if isinstance(entries, list):
                reports[rel] = sorted(entries, key=lambda e: e["inputs"])
        else:
            found[rel] = p.read_bytes()
    return found, reports


def config4_pipe(root, data, mesh):
    from test_torch_overlays import build_config4, write_overlay_inputs

    if not (data / "ov").exists():
        write_overlay_inputs(data)
    pipe = build_config4(tpkg, ttransforms, root, data / "ov", data / "bg",
                         device="cpu", mesh=mesh)
    for step in pipe.steps:
        step.options.update(device_encode=True, device_decode=True)
    return pipe


def mask_pipe(root, data, mesh):
    if not (data / "imgs").exists():
        make_dataset(data, 6, seed=37)
    pipe = ProcessingPipeline(root_dir=root)
    for name, transform, options in (
            ("mask", ttransforms.ColorMaskTransparency(),
             {"color_ranges_to_exclude_hsv": MASK}),
            ("clean", ttransforms.KeepLargestComponent(),
             {"min_component_size": 20}),
            ("fit", ttransforms.FitCrop(), {})):
        pipe.add_step(ProcessingStep(
            name, transform, input_dirs=[data / "imgs"] if name == "mask"
            else None, output_dirs=[name], seed=3, mesh=mesh, device="cpu",
            save_log=True, options=options))
    return pipe


def composites_pipe(root, data, mesh):
    if not (data / "imgs").exists():
        make_dataset(data, 5, seed=43)
    pipe = ProcessingPipeline(root_dir=root)
    options = {"num_rotations": 2, "method": "shear"}
    pipe.add_step(ProcessingStep(
        "rotsym", ttransforms.RotationsSymmetries(),
        input_dirs=[data / "imgs"], output_dirs=["rs"], seed=8, mesh=mesh,
        device="cpu", fixed_input=True, options=options))
    pipe.add_step(ProcessingStep(
        "rotchain", ttransforms.RotationsChain(
            [tfused.ColorMask(MASK), tfused.Flip()]),
        input_dirs=[data / "imgs"], output_dirs=["rc"], seed=9, mesh=mesh,
        device="cpu", fixed_input=True, options=options))
    return pipe


@pytest.mark.parametrize("build", [config4_pipe, mask_pipe, composites_pipe],
                         ids=["config4", "mask_cleanup_fit", "composites"])
def test_other_steps_under_a_mesh_write_the_single_device_files(tmp_path,
                                                                build):
    """Config 4 (overlays with the JPEG transports forced on, border crop,
    OverlaysBorderCrop), config 3 with a fit crop, RotationsSymmetries and
    RotationsChain: under mesh=4 the same files and reports as without."""
    runs = {}
    for tag, mesh in (("one", None), ("mesh", 4)):
        counters = build(tmp_path / tag, tmp_path / "data", mesh).run(
            progress=False)
        assert all(set(c) <= {"Success", "no_output"} for c in counters)
        runs[tag] = run_tree(tmp_path / tag)
    assert runs["one"] == runs["mesh"]
    assert len(runs["one"][0]) >= 10

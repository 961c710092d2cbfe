"""The port's step fuser (fuse.py, ``ProcessingPipeline.run(auto_fuse=)``)
against the JAX package's, on the CPU.

Decisions: one table of step lists, each built once with either package
over the same directories; the port's ``fuse_steps`` and the JAX
``fuse_steps`` must give the same steps — names, transform classes, stage
configs, symmetry selections and samples, options, pairing and
directories — exactly.  The one difference is the port's device guard:
steps on different devices never fuse in the port.

Runs: each of the five symmetry fan-out shapes, run by the port with
``auto_fuse=True`` and without, over 4 PNGs of 64 to 96 px, must give the
same final file names and decoded pixels, exactly, with every item a
Success, the elided directories unwritten and the fused steps in
``last_run_steps`` and the run report.  An ``auto_fuse="rng"`` run must
give the JAX engine's ``auto_fuse="rng"`` files (its jit path,
``native_compute=False``), exactly: its tails draw nothing, so no blur
delta applies.
"""

import json
import pathlib
from collections import Counter

import numpy as np
import pytest
import torch
from PIL import Image

import image_processor_pipeline_tpu as jpkg
import image_processor_pipeline_tpu.fuse as jfuse
import image_processor_pipeline_tpu.transforms as jtransforms
import image_processor_pipeline_tpu_torch as tpkg
import image_processor_pipeline_tpu_torch.fuse as tfuse
import image_processor_pipeline_tpu_torch.transforms as ttransforms
from torch_port_data import assert_same_files, make_dataset, make_image

HSV = [(0, 0, 0, 180, 255, 120)]
ROT = {"num_rotations": 2, "method": "shear"}

#: step kind -> (transform class name, default options, pairing)
KINDS = {
    "mask": ("ColorMaskTransparency", {"color_ranges_to_exclude_hsv": HSV},
             "one_input"),
    "clean": ("KeepLargestComponent", {"min_component_size": 20},
              "one_input"),
    "fit": ("FitCrop", {}, "one_input"),
    "sym": ("GenerateSymmetries", {}, "one_input"),
    "rot": ("RandomRotations", ROT, "one_input"),
    "enh": ("EnhanceImage", {}, "sample"),
    "ovl": ("PasteOverlayOntoBackground", {}, "modulo"),
    "border": ("BorderCrop", {"crop_margins": (0.1, 0.1, 4, 4)},
               "one_input"),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops on these small batches run on one thread: the
    test workers share the machine's cores (pytest-xdist), and torch's
    thread pool oversubscribed by several workers runs many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def S(kind, out, inputs=None, **kw):
    """A step spec: ``kind`` of KINDS writing ``out`` (a dir or a list),
    reading ``inputs`` (auto-chained when None); ``options`` update the
    kind's defaults; other keywords go to ProcessingStep (``device`` to
    the port's only)."""
    return (kind, out, inputs, kw)


def build(pkg, transforms, specs, root):
    pipe = pkg.ProcessingPipeline(root_dir=root)
    for i, (kind, out, inputs, kw) in enumerate(specs):
        cls, options, pairing = KINDS[kind]
        kw = dict(kw)
        options = dict(options, **kw.pop("options", {}))
        device = kw.pop("device", "cpu")
        if pkg is tpkg:
            kw["device"] = device
        pipe.add_step(pkg.ProcessingStep(
            f"{kind}{i}", getattr(transforms, cls)(),
            input_dirs=inputs, output_dirs=out if isinstance(out, list)
            else [out], pairing_method=kw.pop("pairing", pairing),
            seed=kw.pop("seed", 3 + i), options=options, **kw))
    return pipe.steps


def describe(step):
    """Everything a fused step's behaviour depends on, comparable across
    the packages."""
    t = step.process_function
    d = {"name": step.name, "class": type(t).__name__,
         "inputs": [str(p) for p in step.input_paths],
         "outputs": [str(p) for p in step.output_paths],
         "options": step.options, "pairing": step.pairing_method,
         "fixed_input": step.fixed_input, "workers": step.workers,
         "seed": step.seed, "overwrite": step.overwrite,
         "retries": step.retries, "save_log": step.save_log,
         "sample_k": step.sample_k}
    if hasattr(t, "stages"):
        d["stages"] = [(type(s).__name__, s.config()) for s in t.stages]
    for a in ("syms", "tail_syms", "sym_sample", "tail_sample"):
        if hasattr(t, a):
            d[a] = getattr(t, a)
    return d


FC, CS, SC = "FusedChain", "ChainSymmetries", "SymmetriesChain"
#: case -> (tier, step specs, setup, the classes both fusers give)
TABLE = {
    # the shapes of fuse.py's docstring, byte tier
    "mask-clean": ("byte", [S("mask", "m", ["in"]), S("clean", "c")],
                   None, [FC]),
    "mask-clean-fit": ("byte", [S("mask", "m", ["in"]), S("clean", "c"),
                                S("fit", "f")], None, [FC]),
    "rgba-input-mask-head": ("byte", [S("mask", "m", ["rgba"]),
                                      S("clean", "c")], None, [FC]),
    "rot-sym": ("byte", [S("rot", "r", ["in"]), S("sym", "s")], None,
                ["RotationsSymmetries"]),
    "rot-sym-pool": ("byte", [S("rot", "r", ["in"]), S("sym", "s", options={
        "pool": ["h", "v"], "include_original": False})], None,
        ["RotationsSymmetries"]),
    "rot-sym-subpool": ("byte", [S("rot", "r", ["in"]), S(
        "sym", "s", options={"choose_random": 2})], None,
        ["RandomRotations", "GenerateSymmetries"]),
    "rot-jpg-sym": ("byte", [S("rot", "r", ["in"], options=dict(
        ROT, output_format="jpg")), S("sym", "s")], None,
        ["RandomRotations", "GenerateSymmetries"]),
    "rot-chain": ("byte", [S("rot", "r", ["in"]), S("mask", "m"),
                           S("clean", "c")], None, ["RotationsChain"]),
    "rot-sym-chain": ("byte", [S("rot", "r", ["in"]), S("sym", "s"),
                               S("mask", "m"), S("clean", "c"),
                               S("fit", "f")], None, ["RotSymChain"]),
    "rot-sym-chain-pool": ("byte", [S("rot", "r", ["in"]), S(
        "sym", "s", options={"pool": ["hv"], "include_original": False}),
        S("mask", "m"), S("clean", "c")], None, ["RotSymChain"]),
    "rot-sym-chain-subpool": ("byte", [S("rot", "r", ["in"]), S(
        "sym", "s", options={"choose_random": 2}), S("mask", "m"),
        S("clean", "c"), S("fit", "f")], None,
        ["RandomRotations", "GenerateSymmetries", FC]),
    "rot-sym-into-rot-dir": ("byte", [S("rot", "r", ["in"]), S("sym", "r"),
                                      S("mask", "m"), S("clean", "c")],
                             None, ["RandomRotations", "GenerateSymmetries",
                                    FC]),
    "rot-chain-sym": ("byte", [S("rot", "r", ["in"]), S("mask", "m"),
                               S("clean", "c"), S("sym", "s")], None,
                      ["RotationsChainSymmetries"]),
    "rot-chain-sym-subpool": ("byte", [S("rot", "r", ["in"]),
                                       S("mask", "m"), S("clean", "c"),
                                       S("sym", "s", options={
                                           "choose_random": 1})], None,
                              ["RotationsChain", "GenerateSymmetries"]),
    "rot-chain-sym-alias": ("byte", [S("rot", "r", ["in"]), S("mask", "m"),
                                     S("clean", "c"), S("sym", "m")], None,
                            ["RandomRotations", "ColorMaskTransparency",
                             "KeepLargestComponent", "GenerateSymmetries"]),
    "chain-sym": ("byte", [S("mask", "m", ["in"]), S("clean", "c"),
                           S("sym", "s")], None, [CS]),
    "mask-sym": ("byte", [S("mask", "m", ["in"]), S("sym", "s")], None,
                 [CS]),
    "chain-sym-subpool": ("byte", [S("mask", "m", ["in"]), S("clean", "c"),
                                   S("sym", "s", options={
                                       "choose_random": 2})], None,
                          [FC, "GenerateSymmetries"]),
    "chain-sym-alias": ("byte", [S("mask", "m", ["in"]), S("clean", "c"),
                                 S("sym", "m")], None,
                        ["ColorMaskTransparency", "KeepLargestComponent",
                         "GenerateSymmetries"]),
    "mask-sym-chain": ("byte", [S("mask", "m", ["in"]), S("sym", "s"),
                                S("clean", "c"), S("fit", "f")], None,
                       ["ColorMaskTransparency", SC]),
    "rgba-sym-chain": ("byte", [S("sym", "s", ["rgba"]), S("clean", "c"),
                                S("fit", "f")], None, [SC]),
    "rgb-sym-chain": ("byte", [S("sym", "s", ["in"]), S("clean", "c"),
                               S("fit", "f")], None,
                      ["GenerateSymmetries", "KeepLargestComponent",
                       "FitCrop"]),
    "jpg-sym-chain": ("byte", [S("sym", "s", ["jpgs"]), S("clean", "c")],
                      None, ["GenerateSymmetries", "KeepLargestComponent"]),
    "mask-sym-chain-sym": ("byte", [S("mask", "m", ["in"]), S("sym", "s"),
                                    S("clean", "c"), S("sym", "t")], None,
                           ["ColorMaskTransparency",
                            "SymmetriesChainSymmetries"]),
    "sym-chain-sym-pool": ("byte", [S("sym", "s", ["rgba"]), S("mask", "m"),
                                    S("sym", "t", options={
                                        "pool": ["v"],
                                        "include_original": False})], None,
                           ["SymmetriesChainSymmetries"]),
    "sym-chain-sym-alias": ("byte", [S("sym", "s", ["rgba"]),
                                     S("clean", "c"), S("sym", "c")], None,
                            [SC, "GenerateSymmetries"]),
    "sym-chain-sym-save-log": ("byte", [S("sym", "s", ["rgba"]),
                                        S("clean", "c"),
                                        S("sym", "t", save_log=True)],
                               None, [SC, "GenerateSymmetries"]),
    "sym-subpool-chain": ("byte", [S("sym", "s", ["rgba"], options={
        "choose_random": 2}), S("clean", "c")], None,
        ["GenerateSymmetries", "KeepLargestComponent"]),
    # the rng tier
    "rng-rot-sym-subpool": ("rng", [S("rot", "r", ["in"]), S(
        "sym", "s", options={"choose_random": 2})], None,
        ["RotationsSymmetries"]),
    "rng-rot-sym-chain-subpool": ("rng", [S("rot", "r", ["in"]), S(
        "sym", "s", options={"choose_random": 2}), S("mask", "m"),
        S("clean", "c")], None, ["RotSymChain"]),
    "rng-rot-chain-sym-subpool": ("rng", [S("rot", "r", ["in"]),
                                          S("mask", "m"), S("sym", "s",
                                          options={"choose_random": 1,
                                                   "include_original":
                                                   False})], None,
                                  ["RotationsChainSymmetries"]),
    "rng-rot-enh": ("rng", [S("rot", "r", ["in"]), S("mask", "m"),
                            S("enh", "e")], None, ["RotationsChain"]),
    "rng-rot-enh-sym": ("rng", [S("rot", "r", ["in"]), S("mask", "m"),
                                S("enh", "e"), S("sym", "s")], None,
                        ["RotationsChainSymmetries"]),
    "rng-chain-enh": ("rng", [S("mask", "m", ["in"]), S("clean", "c"),
                              S("enh", "e")], None, [FC]),
    "byte-chain-enh": ("byte", [S("mask", "m", ["in"]), S("clean", "c"),
                                S("enh", "e")], None,
                       [FC, "EnhanceImage"]),
    "rng-enh-sym": ("rng", [S("mask", "m", ["in"]), S("enh", "e"),
                            S("sym", "s")], None, [CS]),
    "rng-chain-sym-subpool": ("rng", [S("mask", "m", ["in"]),
                                      S("clean", "c"), S("sym", "s", options={
                                          "choose_random": 2})], None, [CS]),
    "rng-sym-chain-sym-subpool": ("rng", [S("sym", "s", ["rgba"], options={
        "choose_random": 3}), S("clean", "c"), S("sym", "t", options={
            "choose_random": 1})], None, ["SymmetriesChainSymmetries"]),
    "rng-ovl-border": ("rng", [S("ovl", ["o", "l"], ["ov", "bg"]),
                               S("border", "b", ["o"], fixed_input=True)],
                       None, ["OverlaysBorderCrop"]),
    "byte-ovl-border": ("byte", [S("ovl", ["o", "l"], ["ov", "bg"]),
                                 S("border", "b", ["o"], fixed_input=True)],
                        None, ["PasteOverlayOntoBackground", "BorderCrop"]),
    "rng-ovl-border-shared-labels": ("rng", [
        S("ovl", ["o", "o"], ["ov", "bg"]),
        S("border", "b", ["o"], fixed_input=True)], None,
        ["PasteOverlayOntoBackground", "BorderCrop"]),
    # the guards
    "stale-chain-intermediate": ("byte", [S("mask", "m", ["in"]),
                                          S("clean", "c")], "stale:m",
                                 ["ColorMaskTransparency",
                                  "KeepLargestComponent"]),
    "stale-rotsym-intermediate": ("byte", [S("rot", "r", ["in"]),
                                           S("sym", "s")], "stale:r",
                                  ["RandomRotations", "GenerateSymmetries"]),
    "stale-symchain-intermediate": ("byte", [S("sym", "s", ["rgba"]),
                                             S("clean", "c"),
                                             S("fit", "f")], "stale:c",
                                    ["GenerateSymmetries",
                                     "KeepLargestComponent", "FitCrop"]),
    "unreadable-intermediate": ("byte", [S("mask", "m", ["in"]),
                                         S("clean", "c")], "unreadable:m",
                                ["ColorMaskTransparency",
                                 "KeepLargestComponent"]),
    "elided-equals-final-rotsym": ("byte", [S("rot", "r", ["in"]),
                                            S("sym", "r")], None,
                                   ["RandomRotations", "GenerateSymmetries"]),
    "elided-equals-final-chain": ("byte", [S("mask", "m", ["in"]),
                                           S("clean", "m")], None,
                                  ["ColorMaskTransparency",
                                   "KeepLargestComponent"]),
    "intermediate-reader": ("byte", [S("mask", "m", ["in"]),
                                     S("clean", "c"),
                                     S("fit", "f", ["m"], fixed_input=True)],
                            None, ["ColorMaskTransparency",
                                   "KeepLargestComponent", "FitCrop"]),
    "earlier-writer": ("byte", [S("fit", "m", ["rgba"]),
                                S("mask", "m", ["in"]), S("clean", "c")],
                       None, ["FitCrop", "ColorMaskTransparency",
                              "KeepLargestComponent"]),
    "png-headed": ("byte", [S("clean", "c", ["rgba"]), S("fit", "f")], None,
                   [FC]),
    "png-headed-rgb": ("byte", [S("clean", "c", ["in"]), S("fit", "f")],
                       None, ["KeepLargestComponent", "FitCrop"]),
    "png-headed-jpg": ("byte", [S("clean", "c", ["jpgs"]), S("fit", "f")],
                       None, ["KeepLargestComponent", "FitCrop"]),
    "png-headed-missing": ("byte", [S("clean", "c", ["nowhere"]),
                                    S("fit", "f")], None,
                           ["KeepLargestComponent", "FitCrop"]),
    "png-producer-head": ("byte", [S("rot", "r", ["in"]), S("sym", "s"),
                                   S("clean", "c", ["r"], fixed_input=True),
                                   S("fit", "f")], None,
                          ["RandomRotations", "GenerateSymmetries", FC]),
    "jpg-producer-head": ("byte", [S("rot", "r", ["in"], options=dict(
        ROT, output_format="jpg")), S("clean", "c"), S("fit", "f")], None,
        ["RandomRotations", "KeepLargestComponent", "FitCrop"]),
    "unknown-option": ("byte", [S("mask", "m", ["in"]), S(
        "clean", "c", options={"foo": 1})], None,
        ["ColorMaskTransparency", "KeepLargestComponent"]),
    "output-prefix": ("byte", [S("mask", "m", ["in"], options={
        "color_ranges_to_exclude_hsv": HSV, "output_prefix": "p_"}),
        S("clean", "c")], None,
        ["ColorMaskTransparency", "KeepLargestComponent"]),
    "sample-k": ("byte", [S("mask", "m", ["in"]), S("clean", "c",
                                                   sample_k=2)], None,
                 ["ColorMaskTransparency", "KeepLargestComponent"]),
    "save-log": ("byte", [S("mask", "m", ["in"], save_log=True),
                          S("clean", "c")], None,
                 ["ColorMaskTransparency", "KeepLargestComponent"]),
    "workers-differ": ("byte", [S("mask", "m", ["in"], workers=2),
                                S("clean", "c")], None,
                       ["ColorMaskTransparency", "KeepLargestComponent"]),
    "engine-keys-ride": ("byte", [S("rot", "r", ["in"], options=dict(
        ROT, native_compute="auto")), S("sym", "s", options={
            "native_compute": "auto"}), S("mask", "m", options={
                "color_ranges_to_exclude_hsv": HSV,
                "native_compute": "auto"}), S("clean", "c", options={
                    "native_compute": "auto"})], None, ["RotSymChain"]),
}
#: cases with a step on another device in the port: the JAX fuser (which
#: has no devices) fuses across it, the port's must not.  case -> (tier,
#: step specs, the port's classes, their devices)
DEVICE_SPLIT = {
    "device-split-chain": ("byte", [S("mask", "m", ["in"]),
                                    S("clean", "c", device="cuda")],
                           ["ColorMaskTransparency", "KeepLargestComponent"],
                           ["cpu", "cuda"]),
    "device-split-rot-sym-chain": ("byte", [
        S("rot", "r", ["in"]), S("sym", "s"), S("mask", "m"),
        S("clean", "c", device="cuda"), S("fit", "f", device="cuda")],
        ["RotSymChain", FC], ["cpu", "cuda"]),
    "device-split-sym-chain": ("byte", [S("sym", "s", ["rgba"]),
                                        S("clean", "c", device="cuda")],
                               ["GenerateSymmetries", "KeepLargestComponent"],
                               ["cpu", "cuda"]),
}


def _png(path, channels):
    Image.fromarray(make_image(np.random.default_rng(len(str(path))), 24,
                               30, channels)).save(path)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("decisions")
    for d in ("in", "rgba", "jpgs", "ov", "bg"):
        (root / d).mkdir()
    for i in range(2):
        _png(root / "in" / f"x{i}.png", 3)
        _png(root / "rgba" / f"a{i}.png", 4)
        _png(root / "ov" / f"o{i}.png", 4)
        Image.fromarray(make_image(np.random.default_rng(i), 30, 40)).save(
            root / "jpgs" / f"j{i}.jpg")
        Image.fromarray(make_image(np.random.default_rng(i), 30, 40)).save(
            root / "bg" / f"b{i}.jpg")
    return root


def fuse_both(specs, tier, root):
    return {tag: fuse.fuse_steps(build(pkg, transforms, specs, root),
                                 verbose=False, tier=tier)
            for tag, pkg, transforms, fuse in (
                ("j", jpkg, jtransforms, jfuse),
                ("t", tpkg, ttransforms, tfuse))}


@pytest.mark.parametrize("case", list(TABLE))
def test_fuser_decides_as_the_jax_fuser(root, monkeypatch, tmp_path, case):
    tier, specs, setup, classes = TABLE[case]
    if setup:
        what, d = setup.split(":")
        # a directory of this test's own, so no other case sees the setup
        base = tmp_path / "root"
        base.mkdir()
        for src in root.iterdir():
            (base / src.name).symlink_to(src)
        root = base
        if what == "stale":
            (root / d).mkdir()
            _png(root / d / "old.png", 4)
        else:
            real = pathlib.Path.iterdir

            def deny(self):
                if self.name == d:
                    raise PermissionError(13, "denied", str(self))
                return real(self)

            monkeypatch.setattr(pathlib.Path, "iterdir", deny)
    got = fuse_both(specs, tier, root)
    assert [describe(s) for s in got["t"]] == [describe(s) for s in got["j"]]
    assert [type(s.process_function).__name__ for s in got["t"]] == classes
    fused = [s for s in got["t"] if "+" in s.name]
    assert all(s.device == "cpu" for s in got["t"])
    assert len(fused) == sum(c in (FC, CS, SC, "RotationsSymmetries",
                                   "RotationsChain", "RotSymChain",
                                   "RotationsChainSymmetries",
                                   "SymmetriesChainSymmetries",
                                   "OverlaysBorderCrop") for c in classes)


@pytest.mark.parametrize("case", list(DEVICE_SPLIT))
def test_steps_on_different_devices_never_fuse(root, case):
    tier, specs, classes, devices = DEVICE_SPLIT[case]
    got = fuse_both(specs, tier, root)
    assert [type(s.process_function).__name__ for s in got["t"]] == classes
    assert [s.device for s in got["t"]] == devices
    assert len(got["j"]) < len(got["t"])


def test_fuse_steps_rejects_an_unknown_tier_and_keeps_its_input(root):
    steps = build(tpkg, ttransforms, TABLE["chain-sym"][1], root)
    before = [describe(s) for s in steps]
    with pytest.raises(ValueError, match="tier"):
        tfuse.fuse_steps(steps, tier="RNG")
    assert len(tfuse.fuse_steps(steps, verbose=False)) == 1
    assert [describe(s) for s in steps] == before


def _probe_files(tmp_path):
    """One file of each kind the RGBA head probe tells apart."""
    cv2 = pytest.importorskip("cv2")
    _png(tmp_path / "rgba.png", 4)
    _png(tmp_path / "rgb.png", 3)
    Image.fromarray(make_image(np.random.default_rng(0), 8, 8)).convert(
        "P").save(tmp_path / "pal.png")
    assert cv2.imwrite(str(tmp_path / "deep.png"),
                       np.full((6, 5, 4), 40000, np.uint16))
    (tmp_path / "bad.png").write_bytes(b"not a png")
    Image.fromarray(make_image(np.random.default_rng(1), 8, 8)).save(
        tmp_path / "j.jpg")
    return sorted(tmp_path.iterdir())


def test_rgba_probe_declines_what_the_port_cannot_classify(tmp_path):
    """F12 closed: with both native libraries built, both fusers ask their
    native probe_bands first and decide alike on every file: 8-bit RGBA
    PNGs qualify; RGB, palette, 16-bit RGBA, JPEG and unreadable files do
    not."""
    from image_processor_pipeline_tpu.io import native as jnative
    from image_processor_pipeline_tpu_torch.io import native

    assert native.available() and jnative.available()
    files = _probe_files(tmp_path)
    got = {p.name: tfuse._rgba_png(p) for p in files}
    assert got == {"bad.png": False, "deep.png": False, "j.jpg": False,
                   "pal.png": False, "rgb.png": False, "rgba.png": True}
    assert got == {p.name: jfuse._rgba_png(p) for p in files}


def test_rgba_probe_falls_back_to_pillow_without_the_library(
        tmp_path, monkeypatch):
    """Without the native library the probe is Pillow's mode, as the JAX
    fuser's fallback is: a 16-bit RGBA PNG then reads as RGBA and
    qualifies."""
    from image_processor_pipeline_tpu_torch.io import native

    files = _probe_files(tmp_path)
    monkeypatch.setattr(native, "probe_bands", lambda path: None)
    got = {p.name: tfuse._rgba_png(p) for p in files}
    assert got == {"bad.png": False, "deep.png": True, "j.jpg": False,
                   "pal.png": False, "rgb.png": False, "rgba.png": True}


# -- runs on the CPU ------------------------------------------------------

#: the five symmetry fan-out shapes: step specs (the first reads "in") and
#: the classes they fuse to
SHAPES = {
    "rot-sym-chain": ([S("rot", "r", ["in"]), S("sym", "s"), S("mask", "m"),
                       S("clean", "c"), S("fit", "f")], ["RotSymChain"]),
    "rot-chain-sym": ([S("rot", "r", ["in"]), S("mask", "m"),
                       S("clean", "c"), S("sym", "f")],
                      ["RotationsChainSymmetries"]),
    "chain-sym": ([S("mask", "m", ["in"]), S("clean", "c"), S("sym", "f")],
                  [CS]),
    "mask-sym-chain": ([S("mask", "m", ["in"]), S("sym", "s"),
                        S("clean", "c"), S("fit", "f")],
                       ["ColorMaskTransparency", SC]),
    "mask-sym-chain-sym": ([S("mask", "m", ["in"]), S("sym", "s"),
                            S("clean", "c"), S("sym", "f")],
                           ["ColorMaskTransparency",
                            "SymmetriesChainSymmetries"]),
}
N_IMAGES = 4


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    imgs, _ = make_dataset(tmp_path_factory.mktemp("fuse_runs"), N_IMAGES,
                           seed=43, sizes=((64, 80), (96, 72), (72, 64)))
    return imgs


def run_pipeline(pkg, transforms, specs, root, images, auto_fuse):
    root.mkdir()
    (root / "in").symlink_to(images)
    pipe = pkg.ProcessingPipeline(root_dir=root)
    for step in build(pkg, transforms, specs, root):
        if pkg is jpkg:
            step.options["native_compute"] = False
        step.workers = 2
        pipe.add_step(step)
    counts = pipe.run(progress=False, auto_fuse=auto_fuse,
                      report_path=root / "run.json")
    return pipe, counts


@pytest.mark.parametrize("shape", list(SHAPES))
def test_fused_run_writes_the_unfused_files(images, tmp_path, shape):
    specs, classes = SHAPES[shape]
    pipes = {}
    for tag, fuse in (("plain", False), ("fused", True)):
        pipes[tag] = run_pipeline(tpkg, ttransforms, specs, tmp_path / tag,
                                  images, fuse)
    (plain, plain_counts), (fused, fused_counts) = pipes["plain"], \
        pipes["fused"]
    assert [type(s.process_function).__name__
            for s in fused.last_run_steps] == classes
    assert plain.last_run_steps == plain.steps
    assert all(set(c) == {"Success"} for c in plain_counts + fused_counts)
    assert fused_counts[-1] == Counter(Success=N_IMAGES)
    final = tmp_path / "plain" / "f"
    n = len(list(final.iterdir()))
    assert n > N_IMAGES
    assert_same_files(final, tmp_path / "fused" / "f", n)
    kept = {p.name for s in fused.last_run_steps for p in s.output_paths}
    for spec in specs[:-1]:
        d = spec[1]
        assert (tmp_path / "plain" / d).is_dir()
        assert (tmp_path / "fused" / d).exists() == (d in kept), d
    report = json.loads((tmp_path / "fused" / "run.json").read_text())
    assert [s["name"] for s in report["steps"]] \
        == [s.name for s in fused.last_run_steps]
    assert report["steps"][-1]["statuses"] == {"Success": N_IMAGES}
    assert "+" in report["steps"][-1]["name"]


def test_rng_tier_run_gives_the_jax_engines_files(images, tmp_path):
    """Sub-pool sampling at both ends of a symmetry-headed run: the port's
    rng-tier fusion draws the JAX engine's subsets and writes its
    pixels."""
    specs = [S("mask", "m", ["in"]),
             S("sym", "s", options={"choose_random": 2}),
             S("clean", "c"),
             S("sym", "f", options={"choose_random": 1,
                                    "include_original": False})]
    runs = {tag: run_pipeline(pkg, transforms, specs, tmp_path / tag,
                              images, "rng")
            for tag, pkg, transforms in (("j", jpkg, jtransforms),
                                         ("t", tpkg, ttransforms))}
    for tag, (pipe, counts) in runs.items():
        assert [type(s.process_function).__name__
                for s in pipe.last_run_steps] \
            == ["ColorMaskTransparency", "SymmetriesChainSymmetries"], tag
        assert counts == [Counter(Success=N_IMAGES)] * 2
    names = assert_same_files(tmp_path / "j" / "f", tmp_path / "t" / "f",
                              len(list((tmp_path / "j" / "f").iterdir())))
    assert 0 < len(names) <= N_IMAGES * 2
    assert not (tmp_path / "t" / "s").exists()


def test_fused_step_raises_as_its_unported_steps_would(images, tmp_path):
    """An engine option the port lacks rides onto the fused step, which
    raises the NotImplementedError its steps would have raised."""
    for fuse in (False, True):
        pipe = tpkg.ProcessingPipeline(root_dir=tmp_path / str(fuse))
        for step in build(tpkg, ttransforms, SHAPES["chain-sym"][0],
                          tmp_path / str(fuse)):
            step.options["native_compute"] = True
            pipe.add_step(step)
        pipe.steps[0].input_paths = [images]
        with pytest.raises(NotImplementedError, match="native_compute"):
            pipe.run(progress=False, auto_fuse=fuse)
        assert not (tmp_path / str(fuse) / "f").exists()

"""M12: random small pipelines through both engines, on the CPU.

A seeded generator draws 2- or 3-step pipelines over the names the
``transforms`` package exports.  Each pipeline runs once through the JAX
package's engine (its jit path, ``native_compute=False``: F15) and once
through the port's (``device="cpu"``) over the same 4 images of 64 to 96
px, and every step's statuses and output directories are compared.

Tiers.  A step of the byte tier computes the same bytes in both packages
by construction: same names, label text and decoded pixels, exactly.  A
step of the rng tier draws or resamples where a documented delta applies
(the blur of EnhanceImage and Enhance, F10; the overlay resize, F11; the
nearest rotation's cos/sin; python's unseeded ``random`` in
process_overlay_pair): the same statuses, file names and counts.  Every
step after an rng-tier step is compared at the rng tier too, since its
inputs may differ.

Two exported names are not steps and are never drawn: ``BatchTransform``
(the abstract base) and ``ALL_SYMS`` (a constant).  ``frame_extraction``
heads the pipelines that start from the dataset's clip.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import image_processor_pipeline_tpu as jpkg
import image_processor_pipeline_tpu.transforms as jtransforms
import image_processor_pipeline_tpu_torch as tpkg
import image_processor_pipeline_tpu_torch.transforms as ttransforms
from image_processor_pipeline_tpu.transforms import fused as jfused
from image_processor_pipeline_tpu_torch.transforms import fused as tfused
from torch_port_data import make_dataset, make_image

N_PIPELINES = 28
GENERATOR_SEED = 12
HSV = [(0, 0, 0, 180, 255, 120)]
ROT = {"num_rotations": 2, "method": "shear"}
PKGS = {"jax": (jpkg, jtransforms, jfused), "torch": (tpkg, ttransforms,
                                                      tfused)}
NOT_STEPS = ("BatchTransform", "ALL_SYMS")


def tail(f):
    return [f.ColorMask(HSV, input_alpha="replace"), f.Cleanup(20),
            f.FitCrop()]


# name -> (tier, what it needs of the state, what it makes)
#   needs: "lbl" labels beside the images, "jpg" JPEG images, "rgba" RGBA
#   PNGs, "video" the clip (a head); makes: "imgs" one image dir, "pair"
#   images and labels, "lbl" a labels dir, "frames" the clip's frames
def _catalog():
    return {
        "SquareCropAroundBBox": ("byte", {"lbl"}, "pair",
                                 lambda t, f: (t.SquareCropAroundBBox(), {},
                                               "zip")),
        "copy_img_with_labels": ("byte", {"lbl"}, "pair",
                                 lambda t, f: (t.copy_img_with_labels, {},
                                               "zip")),
        "copy_files": ("byte", set(), "imgs",
                       lambda t, f: (t.copy_files, {"suffix": "v2"},
                                     "one_input")),
        "change_label_class": ("byte", {"lbl"}, "lbl",
                               lambda t, f: (t.change_label_class,
                                             {"cls_mapping": {0: 3, 1: 0}},
                                             "one_input")),
        "RandomRotations": ("byte", set(), "imgs",
                            lambda t, f: (t.RandomRotations(), dict(ROT),
                                          "one_input")),
        "GenerateSymmetries": ("byte", set(), "imgs",
                               lambda t, f: (t.GenerateSymmetries(),
                                             {"choose_random": 2},
                                             "one_input")),
        "EnhanceImage": ("rng", set(), "imgs",
                         lambda t, f: (t.EnhanceImage(), {}, "sample")),
        "ColorMaskTransparency": ("byte", set(), "rgba",
                                  lambda t, f: (
                                      t.ColorMaskTransparency(),
                                      {"color_ranges_to_exclude_hsv": HSV},
                                      "one_input")),
        "KeepLargestComponent": ("byte", {"rgba"}, "rgba",
                                 lambda t, f: (t.KeepLargestComponent(),
                                               {"min_component_size": 20},
                                               "one_input")),
        "BorderCrop": ("byte", {"jpg"}, "imgs",
                       lambda t, f: (t.BorderCrop(),
                                     {"crop_margins": (0.1, 0.1, 4, 4)},
                                     "one_input")),
        "FitCrop": ("byte", set(), "imgs",
                    lambda t, f: (t.FitCrop(), {}, "one_input")),
        "FusedChain": ("byte", set(), "imgs",
                       lambda t, f: (t.FusedChain([
                           f.Rotate(method="shear"), f.Flip(),
                           f.Enhance(blur_prob=0.0)]), {}, "one_input")),
        "RotationsSymmetries": ("byte", set(), "imgs",
                                lambda t, f: (t.RotationsSymmetries(),
                                              dict(ROT), "one_input")),
        "RotationsChain": ("byte", set(), "imgs",
                           lambda t, f: (t.RotationsChain([f.Flip()]),
                                         dict(ROT), "one_input")),
        "RotSymChain": ("byte", set(), "imgs",
                        lambda t, f: (t.RotSymChain(tail(f), ("o", "hv")),
                                      dict(ROT), "one_input")),
        "ChainSymmetries": ("byte", set(), "imgs",
                            lambda t, f: (t.ChainSymmetries(tail(f)), {},
                                          "one_input")),
        "SymmetriesChain": ("byte", set(), "imgs",
                            lambda t, f: (t.SymmetriesChain(tail(f),
                                                            ("o", "v")),
                                          {}, "one_input")),
        "RotationsChainSymmetries": ("byte", set(), "imgs",
                                     lambda t, f: (
                                         t.RotationsChainSymmetries(
                                             tail(f), ("o", "h")),
                                         dict(ROT), "one_input")),
        "SymmetriesChainSymmetries": ("byte", set(), "imgs",
                                      lambda t, f: (
                                          t.SymmetriesChainSymmetries(
                                              tail(f), ("o", "h"),
                                              ("hv", "o")), {},
                                          "one_input")),
        "PasteOverlayOntoBackground": ("rng", {"jpg"}, "pair",
                                       lambda t, f: (
                                           t.PasteOverlayOntoBackground(),
                                           {}, "modulo")),
        "OverlaysBorderCrop": ("rng", {"jpg"}, "pair",
                               lambda t, f: (
                                   t.OverlaysBorderCrop(),
                                   {"crop_margins": (0.1, 0.1, 4, 4)},
                                   "modulo")),
        "process_overlay_pair": ("rng", {"jpg"}, "pair",
                                 lambda t, f: (t.process_overlay_pair, {},
                                               "modulo")),
        "frame_extraction": ("byte", {"video"}, "frames",
                             lambda t, f: (t.frame_extraction,
                                           {"file_basename": "clip"},
                                           "one_input")),
    }


CATALOG = _catalog()


def draw_pipelines(n, seed):
    """``n`` pipelines of 2 or 3 step names, each step's needs met by the
    state the steps before it leave: a start (PNG or JPEG images with
    labels, or the clip), then names drawn uniformly among those allowed."""
    rng = np.random.default_rng(seed)
    pipelines = []
    while len(pipelines) < n:
        start = ("png", "jpg", "video")[rng.integers(0, 3)]
        state = {"video"} if start == "video" else {"lbl", start}
        names = []
        for _ in range(int(rng.integers(2, 4))):
            allowed = sorted(k for k, (_, needs, _, _) in CATALOG.items()
                             if needs <= state
                             and ("video" in state) == ("video" in needs))
            name = allowed[rng.integers(0, len(allowed))]
            names.append(name)
            makes = CATALOG[name][2]
            if makes == "frames":
                state = {"jpg"}
            elif makes == "rgba":
                state = {"rgba"}
            elif makes == "imgs":
                state = state - {"lbl", "rgba"} | (
                    {"jpg"} if "jpg" in state else set())
            elif makes == "pair":
                state = {"lbl"} | ({"jpg"} if "jpg" in state else set())
        pipelines.append((start, tuple(names)))
    return pipelines


PIPELINES = draw_pipelines(N_PIPELINES, GENERATOR_SEED)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """4 PNGs of 64 to 96 px with labels, their JPEG copies, 2 RGBA
    overlays and a 4-frame clip, made from seeds."""
    root = tmp_path_factory.mktemp("m12")
    imgs, labels = make_dataset(root / "png", 4, seed=12,
                                sizes=((64, 96), (96, 64), (80, 80),
                                       (72, 88)))
    jpgs = root / "jpg"
    jpgs.mkdir()
    for p in sorted(imgs.iterdir()):
        Image.open(p).convert("RGB").save(jpgs / f"{p.stem}.jpg", quality=95)
    ovl = root / "ovl"
    ovl.mkdir()
    rng = np.random.default_rng(13)
    for i in range(2):
        Image.fromarray(make_image(rng, 24, 20, channels=4)).save(
            ovl / f"ov_{i}.png")
    video = root / "video"
    video.mkdir()
    import cv2

    writer = cv2.VideoWriter(str(video / "clip.avi"),
                             cv2.VideoWriter_fourcc(*"MJPG"), 5, (96, 64))
    for _ in range(4):
        writer.write(make_image(rng, 64, 96)[..., ::-1].copy())
    writer.release()
    return {"png": (imgs, labels), "jpg": (jpgs, labels), "ovl": ovl,
            "video": video}


def run_pipeline(engine, start, names, data, root):
    """Run the pipeline with one package; returns [(counter, output
    dirs)] a step."""
    pkg, transforms, fused = PKGS[engine]
    base = ({"options": {"native_compute": False}} if engine == "jax"
            else {"device": "cpu"})
    if start == "video":
        img, lbl = data["video"], None
    else:
        img, lbl = data[start]
    results = []
    for i, name in enumerate(names):
        _, _, makes, make = CATALOG[name]
        fn, options, pairing = make(transforms, fused)
        out = root / f"s{i}_{name}"
        if makes == "pair":
            inputs = ([data["ovl"], img] if pairing == "modulo"
                      else [img, lbl])
            outputs = [out / "i", out / "l"]
        elif makes == "lbl":
            inputs, outputs = [lbl], [out]
        else:
            inputs, outputs = [img], [out]
        step = pkg.ProcessingStep(
            name, fn, input_dirs=inputs, output_dirs=outputs,
            pairing_method=pairing, seed=100 + i,
            options=dict(base.get("options", {}), **options),
            **{k: v for k, v in base.items() if k != "options"})
        results.append((step.run(progress=False), outputs))
        if makes == "pair":
            img, lbl = outputs
        elif makes == "lbl":
            lbl = out
        elif makes == "frames":
            img = out / "clip" / "0-raw"
        else:
            img = out
    return results


def tree(directory):
    return sorted(str(p.relative_to(directory))
                  for p in Path(directory).rglob("*") if p.is_file())


def test_the_draws_cover_the_catalog_and_every_start():
    """The catalog holds every exported name but the two that are not
    steps, in both packages; the 12 pipelines start from each start and
    draw from both tiers."""
    assert sorted(CATALOG) == sorted(set(ttransforms.__all__)
                                     - set(NOT_STEPS))
    assert sorted(ttransforms.__all__) == sorted(jtransforms.__all__)
    assert {start for start, _ in PIPELINES} == {"png", "jpg", "video"}
    drawn = {name for _, names in PIPELINES for name in names}
    assert {CATALOG[n][0] for n in drawn} == {"byte", "rng"}
    assert all(2 <= len(names) <= 3 for _, names in PIPELINES)


@pytest.mark.parametrize("start,names", PIPELINES,
                         ids=[f"{i}-{s}-" + "-".join(n) for i, (s, n)
                              in enumerate(PIPELINES)])
def test_random_pipeline_matches_jax(start, names, data, tmp_path):
    jres = run_pipeline("jax", start, names, data, tmp_path / "jax")
    tres = run_pipeline("torch", start, names, data, tmp_path / "torch")
    tier = "byte"
    for name, (jc, jdirs), (tc, tdirs) in zip(names, jres, tres):
        if CATALOG[name][0] == "rng":
            tier = "rng"
        assert tc == jc, (name, tc, jc)
        assert sum(tc.values()) > 0, name
        for jdir, tdir in zip(jdirs, tdirs):
            names_here = tree(jdir)
            assert tree(tdir) == names_here, (name, jdir.name)
            if tier == "rng":
                continue
            for rel in names_here:
                jp, tp = jdir / rel, tdir / rel
                if jp.suffix == ".txt":
                    assert tp.read_text() == jp.read_text(), (name, rel)
                else:
                    np.testing.assert_array_equal(
                        np.asarray(Image.open(tp)), np.asarray(Image.open(jp)),
                        err_msg=f"{name}: {rel}")

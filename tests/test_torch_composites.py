"""The port's fan-out composites (transforms/rotsym.py, rotchain.py)
against the JAX package's, on the CPU, over a temporary dataset of 8 PNGs
of 40 to 150 px.

Tolerances: ``select_syms`` equal to JAX's; ``RotationsSymmetries`` and
``RotationsChain`` through both engines (the JAX engine on its jit path,
``native_compute=False``) give the same names, statuses, reports and
decoded pixels, for both rotation methods, a blurred item whose box
weights differ under jit (F5) held to one grey level and 95 % of its
values; ``RotationsSymmetries`` writes byte for byte the decoded pixels of
the port's own unfused ``RandomRotations`` → ``GenerateSymmetries`` pair.
"""

import random
from collections import Counter

import numpy as np
import pytest
from PIL import Image

import image_processor_pipeline_tpu as jpkg
import image_processor_pipeline_tpu.transforms as jtransforms
import image_processor_pipeline_tpu_torch as tpkg
import image_processor_pipeline_tpu_torch.transforms as ttransforms
from image_processor_pipeline_tpu.transforms import fused as jfused
from image_processor_pipeline_tpu.transforms import rotsym as jrotsym
from image_processor_pipeline_tpu_torch import random as trandom
from image_processor_pipeline_tpu_torch.transforms import fused as tfused
from image_processor_pipeline_tpu_torch.transforms import rotchain as trotchain
from image_processor_pipeline_tpu_torch.transforms import rotsym as trotsym
from torch_port_data import (assert_same_files, blur_differs_under_jit,
                             make_dataset, reports)

MASK = [(0, 0, 0, 180, 255, 120)]
N_IMAGES, N_ROT = 8, 2


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    imgs, _ = make_dataset(tmp_path_factory.mktemp("composites"), N_IMAGES,
                           seed=31)
    return imgs


def test_select_syms_equals_jax():
    rng = random.Random(5)
    pools = [("o", "h", "v", "hv"), ("h", "v"), ("hv", "o", "h")]
    for _ in range(3000):
        pool = rng.choice(pools)
        k = rng.randint(0, len(pool))
        args = ((pool, k, rng.random() < 0.5), rng.randrange(2**31),
                rng.randrange(12))
        assert trotsym.select_syms(None, *args) \
            == jrotsym.select_syms(None, *args)
    assert trotsym.select_syms(["h"], None, 3, 1) == ["h"]
    assert trotsym._VIEW.keys() == jrotsym._VIEW.keys()


def run_step(pkg, transform, images, root, method, seed=4, **options):
    kw = {"device": "cpu"} if pkg is tpkg else {}
    if pkg is jpkg:
        options["native_compute"] = False
    step = pkg.ProcessingStep(
        "composite", transform, input_dirs=[images],
        output_dirs=[root / "out"],
        seed=seed, save_log=True,
        options=dict(options, num_rotations=N_ROT, method=method), **kw)
    return step.run(progress=False)


@pytest.mark.parametrize("method", ["shear", "nearest"])
@pytest.mark.parametrize("options", [
    {}, {"pool": ["h", "v"], "sym_include_original": False},
    {"choose_random": 2, "rot_include_original": False}])
def test_rotations_symmetries_equals_jax(images, tmp_path, method, options):
    counts = {}
    for tag, pkg, transforms in (("j", jpkg, jtransforms),
                                 ("t", tpkg, ttransforms)):
        counts[tag] = run_step(pkg, transforms.RotationsSymmetries(), images,
                               tmp_path / tag, method, **dict(options))
    assert counts["t"] == counts["j"] == Counter(Success=N_IMAGES)
    slots = N_ROT + options.get("rot_include_original", True)
    per_slot = {0: 4, 1: 2}.get(len(options))   # the sampled case varies
    names = assert_same_files(tmp_path / "j" / "out", tmp_path / "t" / "out",
                              len(list((tmp_path / "j" / "out").iterdir())))
    if per_slot:
        assert len(names) == N_IMAGES * slots * per_slot
    assert reports(tmp_path / "t") == reports(tmp_path / "j")
    assert len(reports(tmp_path / "t")["composite.json"]) == N_IMAGES


@pytest.mark.parametrize("method", ["shear", "nearest"])
def test_rotations_symmetries_equals_the_unfused_pair(images, tmp_path,
                                                      method):
    assert run_step(tpkg, ttransforms.RotationsSymmetries(), images,
                    tmp_path / "fused", method) == Counter(Success=N_IMAGES)
    pipe = tpkg.ProcessingPipeline(root_dir=tmp_path)
    pipe.add_step(tpkg.ProcessingStep(
        "rot", ttransforms.RandomRotations(), input_dirs=[images],
        output_dirs=["rot"], seed=4, device="cpu",
        options={"num_rotations": N_ROT, "method": method,
                 "output_format": "png"}))
    pipe.add_step(tpkg.ProcessingStep(
        "sym", ttransforms.GenerateSymmetries(), output_dirs=["sym"],
        seed=5, device="cpu"))
    assert pipe.run(progress=False) == [
        Counter(Success=N_IMAGES), Counter(Success=N_IMAGES * (N_ROT + 1))]
    assert_same_files(tmp_path / "sym", tmp_path / "fused" / "out",
                      N_IMAGES * (N_ROT + 1) * 4)


TAILS = {
    "mask_clean_fit": [("ColorMask", (MASK, None, False, "replace")),
                       ("Cleanup", (20,)), ("FitCrop", ())],
    "flip_enhance": [("Flip", ()), ("Enhance", (0.5, 0.5))],
}


def f5_named(stages, images, seed):
    """Output files of the (item, slot)s whose Enhance stage blurs with
    box weights that differ under jit (F5)."""
    names = sorted(p.stem for p in images.iterdir())
    seeds = (seed + np.arange(len(names))).astype(np.uint32)
    keys = trotchain.tail_keys(seeds, N_ROT + 1).reshape(-1, 2)
    named = set()
    for index, (name, args) in enumerate(stages):
        if name == "Enhance":
            draws = tfused.Enhance(*args).draw(trandom.fold_in(keys, index))
            hit = (draws[5] & blur_differs_under_jit(draws[3])).reshape(
                len(names), N_ROT + 1)
            for i, slot in zip(*np.nonzero(hit)):
                key = "r000" if slot == 0 else f"r{slot:03d}"
                named.add(f"{names[i]}_{key}.png")
    return named


@pytest.mark.parametrize("method", ["shear", "nearest"])
@pytest.mark.parametrize("tail", list(TAILS))
def test_rotations_chain_equals_jax(images, tmp_path, method, tail):
    counts = {}
    for tag, pkg, transforms, fused in (("j", jpkg, jtransforms, jfused),
                                        ("t", tpkg, ttransforms, tfused)):
        stages = [getattr(fused, name)(*args) for name, args in TAILS[tail]]
        counts[tag] = run_step(pkg, transforms.RotationsChain(stages), images,
                               tmp_path / tag, method, output_bands=4)
    assert counts["t"] == counts["j"] == Counter(Success=N_IMAGES)
    named = f5_named(TAILS[tail], images, 4)
    assert_same_files(tmp_path / "j" / "out", tmp_path / "t" / "out",
                      N_IMAGES * (N_ROT + 1), named=named)
    assert reports(tmp_path / "t") == reports(tmp_path / "j")
    assert len(reports(tmp_path / "t")["composite.json"]) == N_IMAGES


def test_rotations_chain_rejects_a_rotate_tail_and_keys_its_slots():
    with pytest.raises(ValueError, match="may not contain Rotate"):
        ttransforms.RotationsChain([tfused.Rotate()])
    keys = trotchain.tail_keys(np.asarray([3, 9], np.uint32), 3)
    want = trandom.fold_in(trandom.PRNGKey(np.uint32(9)), 101 + 2)
    np.testing.assert_array_equal(keys[1, 2], want)
    out = {"heights": np.array([5, 0, 6]), "pre_heights": np.array([5, 7, 0]),
           "pre_widths": np.array([5, 7, 6])}
    chain = ttransforms.RotationsChain([tfused.FitCrop()])
    assert list(chain._slot_keys(out, {})) == [(0, "r000"), (1, "r001")]
    assert list(chain._slot_keys(out, {"include_original": False})) \
        == [(1, "r001")]
    assert trotchain.tail_encoder([tfused.Cleanup()]) \
        is not trotchain.tail_encoder([tfused.FitCrop()])

"""The port's five symmetry fan-out composites (transforms/chainsym.py,
symchain.py, symchainsym.py, rotchainsym.py, rotsymchain.py) against the
JAX package's, on the CPU.

Tolerances.  ``device_fn``: byte for byte against the JAX class's
``device_fn`` called eagerly (``jax.disable_jit()``) on the same batch at
64 px.  The rotation-headed classes are given the angles that JAX draws
eagerly (with jit disabled ``jax.random.uniform`` rounds twice, so the
eager draws are not the engine's) and, with ``method="shear"``, JAX's
shift vectors, as the rotation tests do; with ``method="nearest"`` items
whose angles have bitwise-equal float32 cos and sin in torch and XLA are
exact and the rest may differ in at most 0.1 % of their values.  Through
both engines (the JAX engine on its jit path, ``native_compute=False``)
over 5 PNGs of 64 to 96 px: the same names, statuses, reports and decoded
pixels, exact.  ``save_item``: the same files from the same outputs, each
written by the same encoder (cv2's ``encode_image`` or Pillow's
``encode_image_pil``: a wrong anchor changes the bytes, not the decoded
pixels), with the same sub-pool selections.  ``__init__``: the same
ValueError for every rejected configuration.
"""

from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import image_processor_pipeline_tpu as jpkg
import image_processor_pipeline_tpu.transforms as jtransforms
import image_processor_pipeline_tpu_torch as tpkg
import image_processor_pipeline_tpu_torch.transforms as ttransforms
from image_processor_pipeline_tpu.ops import geometry as jgeo
from image_processor_pipeline_tpu.transforms import chainsym as jchainsym
from image_processor_pipeline_tpu.transforms import fused as jfused
from image_processor_pipeline_tpu.transforms import rotchain as jrotchain
from image_processor_pipeline_tpu.transforms import rotchainsym as jrotchainsym
from image_processor_pipeline_tpu.transforms import symchainsym as jsymchainsym
from image_processor_pipeline_tpu_torch import interop
from image_processor_pipeline_tpu_torch.ops import geometry as tgeo
from image_processor_pipeline_tpu_torch.transforms import fused as tfused
from image_processor_pipeline_tpu_torch.transforms import rotations as trot
from image_processor_pipeline_tpu_torch.transforms import rotchain as trotchain
from image_processor_pipeline_tpu_torch.transforms import rotsym as trotsym
from torch_port_data import assert_same_files, make_dataset, reports

MASK = [(0, 0, 0, 180, 255, 120)]
ALL = ("o", "h", "v", "hv")
N_ROT = 2
PKGS = {"j": (jpkg, jtransforms, jfused), "t": (tpkg, ttransforms, tfused)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops on these small batches run on one thread: the
    test workers share the machine's cores (pytest-xdist), and torch's
    thread pool oversubscribed by several workers runs many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tail(fused, last="fit"):
    """The deterministic tail the fuser builds: mask, cleanup and, with
    ``last="fit"``, a fit crop (Pillow's anchor; cv2's without it)."""
    stages = [fused.ColorMask(MASK, input_alpha="replace"), fused.Cleanup(20)]
    return stages + [fused.FitCrop()] if last == "fit" else stages


def make(name, fused, transforms, last="fit", syms=ALL, tail_syms=("h", "o"),
         sym_sample=None, tail_sample=None):
    """One of the five classes of either package."""
    cls = getattr(transforms, name)
    stages = tail(fused, last)
    if name == "ChainSymmetries":
        return cls(stages)
    if name == "SymmetriesChainSymmetries":
        return cls(stages, syms, tail_syms, sym_sample=sym_sample,
                   tail_sample=tail_sample)
    return cls(stages, syms, sym_sample)


def _t(a):
    return torch.as_tensor(np.array(a))


# -- device_fn ------------------------------------------------------------

def canvas_batch(seed, B, H, diag):
    """RGBA canvases [B, H, H, 4] of 4 x 4 px blocks (the mask cuts them
    into a few components) with per-item extents, zero outside them
    (``diag``: the extents fit the diagonal, as the rotations' loader
    makes them), opaque where the red plane is bright, and seeds."""
    rng = np.random.default_rng(seed)
    side = int(H / np.sqrt(2)) if diag else H
    hs = rng.integers(side // 2, side + 1, B).astype(np.int32)
    ws = rng.integers(side // 2, side + 1, B).astype(np.int32)
    img = rng.integers(0, 256, (B, H // 4, H // 4, 4), np.uint8)
    img = img.repeat(4, axis=1).repeat(4, axis=2)
    img[..., 3] = np.where(img[..., 0] > 70, 255, 0)
    yy, xx = np.mgrid[0:H, 0:H]
    img *= ((yy[None] < hs[:, None, None])
            & (xx[None] < ws[:, None, None]))[..., None]
    return img, hs, ws, rng.integers(0, 2**31, B).astype(np.uint32)


def trig_agrees(angles):
    theta = jnp.deg2rad(jnp.asarray(angles, jnp.float32))
    t = _t(angles) * tgeo._DEG2RAD
    return (np.asarray(jnp.cos(theta)) == torch.cos(t).numpy()) \
        & (np.asarray(jnp.sin(theta)) == torch.sin(t).numpy())


CASES = [("ChainSymmetries", None), ("SymmetriesChain", None),
         ("SymmetriesChainSymmetries", None), ("RotSymChain", "shear"),
         ("RotSymChain", "nearest"), ("RotationsChainSymmetries", "shear"),
         ("RotationsChainSymmetries", "nearest")]


@pytest.mark.parametrize("name,method", CASES)
def test_device_fn_matches_jax_eager(monkeypatch, name, method):
    B, H = 3, 64
    img, hs, ws, seeds = canvas_batch(len(name), B, H, diag=bool(method))
    syms = ("hv", "o", "v") if name == "RotSymChain" else ALL
    jstep = make(name, jfused, jtransforms, syms=syms)
    tstep = make(name, tfused, ttransforms, syms=syms)
    options = {"num_rotations": N_ROT, "method": method} if method else {}
    static = tstep.static_args(options, ())
    assert static == jstep.static_args(options, ())
    size = np.stack([hs, ws], 1)
    with jax.disable_jit():
        want = jstep.device_fn({"image": jnp.asarray(img),
                                "size": jnp.asarray(size),
                                "seed": jnp.asarray(seeds)}, static)
        if method:
            angles = np.asarray(jax.vmap(lambda s: jax.random.uniform(
                jax.random.PRNGKey(s), (N_ROT,), minval=1.0,
                maxval=359.0))(jnp.asarray(seeds)))
            shifts = interop.shifts_from_jax(*jax.vmap(
                lambda a: jgeo.shear_params(a, H))(angles.reshape(-1)))
    if method:
        monkeypatch.setattr(trot, "draw_angles", lambda *a: angles)
        monkeypatch.setattr(trot, "host_shifts", lambda *a: shifts)
    got = tstep.device_fn({"image": _t(img), "size": _t(size),
                           "seed": seeds}, static)
    assert sorted(got) == sorted(want)
    exact = np.ones(B, bool)
    if method == "nearest":
        exact = trig_agrees(angles).all(axis=1)
        assert exact.any()
    for k in got:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape, k
        np.testing.assert_array_equal(g[exact], w[exact], err_msg=k)
        if not exact.all():
            assert (g[~exact] != w[~exact]).mean() <= 1e-3, k
    if name in ("SymmetriesChain", "SymmetriesChainSymmetries"):
        assert got["images"].shape == (B, 4, H, H, 4)
    if name == "RotSymChain":
        assert got["images"].shape == (B, N_ROT + 1, 3, H, H, 4)


# -- both engines ---------------------------------------------------------

ENGINE_CASES = [("ChainSymmetries", None), ("SymmetriesChain", None),
                ("SymmetriesChainSymmetries", None), ("RotSymChain", "shear"),
                ("RotationsChainSymmetries", "nearest")]
#: files an item writes: ChainSymmetries the whole pool, the head-fanned
#: ones per head sym (and per tail sym), the rotation heads per slot
PER_ITEM = {"ChainSymmetries": 4, "SymmetriesChain": 4,
            "SymmetriesChainSymmetries": 8, "RotSymChain": (N_ROT + 1) * 4,
            "RotationsChainSymmetries": (N_ROT + 1) * 4}
N_IMAGES = 5


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    imgs, _ = make_dataset(tmp_path_factory.mktemp("fanout"), N_IMAGES,
                           seed=41,
                           sizes=((64, 80), (80, 64), (72, 72), (96, 64)))
    return imgs


def run_engine(tag, name, method, images, root):
    pkg, transforms, fused = PKGS[tag]
    options = {"num_rotations": N_ROT, "method": method} if method else {}
    kw = {"device": "cpu"} if tag == "t" else {}
    if tag == "j":
        options["native_compute"] = False
    step = pkg.ProcessingStep(
        "fanout", make(name, fused, transforms), input_dirs=[images],
        output_dirs=[root / "out"], seed=6, save_log=True, workers=2,
        options=options, **kw)
    return step.run(progress=False)


@pytest.mark.parametrize("name,method", ENGINE_CASES)
def test_classes_give_the_jax_engines_files(images, tmp_path, name, method):
    counts = {tag: run_engine(tag, name, method, images, tmp_path / tag)
              for tag in PKGS}
    assert counts["t"] == counts["j"] == Counter(Success=N_IMAGES)
    names = assert_same_files(tmp_path / "j" / "out", tmp_path / "t" / "out",
                              len(list((tmp_path / "j" / "out").iterdir())))
    assert 0 < len(names) <= N_IMAGES * PER_ITEM[name]
    assert reports(tmp_path / "t") == reports(tmp_path / "j")
    assert len(reports(tmp_path / "t")["fanout.json"]) == N_IMAGES


# -- save_item: names, encoders, selections ------------------------------------

ENCODERS = {
    "j": [(jchainsym, "encode_image"), (jsymchainsym, "encode_image"),
          (jrotchainsym, "encode_image"), (jrotchain, "encode_image"),
          (jrotchain, "encode_image_pil")],
    "t": [(trotsym, "encode_image"), (trotchain, "encode_image"),
          (trotchain, "encode_image_pil")],
}


def fake_out(name, rng, K, S=N_ROT + 1, H=12):
    """A materialized item output of ``name`` with random content and a
    few empty slots (a tail that emptied, a rotation never written)."""
    def imgs(*lead):
        return rng.integers(0, 256, lead + (H, H, 4), np.uint8)

    def ext(*lead):
        e = rng.integers(3, H + 1, lead).astype(np.int32)
        e.reshape(-1)[::3] = 0
        return e

    if name == "ChainSymmetries":
        return {"image": imgs(1)[0],
                "h": np.int32(9), "w": np.int32(11)}
    if name in ("SymmetriesChain", "SymmetriesChainSymmetries"):
        return {"images": imgs(K), "heights": ext(K),
                "widths": np.full(K, H, np.int32)}
    lead = (S, K) if name == "RotSymChain" else (S,)
    return {"images": imgs(*lead), "heights": ext(*lead),
            "widths": np.full(lead, H, np.int32),
            "pre_heights": np.asarray([H, 0, H], np.int32)[:S],
            "pre_widths": np.full(S, H, np.int32)}


SAVE_CASES = {
    "ChainSymmetries-whole": ("ChainSymmetries", {}, {}),
    "ChainSymmetries-pool": ("ChainSymmetries", {},
                             {"pool": ["hv", "h"], "output_bands": 3}),
    "ChainSymmetries-sampled": ("ChainSymmetries", {},
                                {"choose_random": 2,
                                 "include_original": False}),
    "SymmetriesChain-whole": ("SymmetriesChain", {}, {}),
    "SymmetriesChain-sampled": ("SymmetriesChain",
                                {"sym_sample": (("h", "v", "hv"), 1, True)},
                                {"output_bands": 3}),
    "SymmetriesChainSymmetries-whole": ("SymmetriesChainSymmetries", {}, {}),
    "SymmetriesChainSymmetries-sampled": (
        "SymmetriesChainSymmetries",
        {"sym_sample": (ALL, 2, False),
         "tail_syms": ALL, "tail_sample": (("h", "v", "hv"), 1, True)}, {}),
    "RotSymChain-whole": ("RotSymChain", {}, {}),
    "RotSymChain-sampled": ("RotSymChain",
                            {"sym_sample": (ALL, 2, True)},
                            {"include_original": False}),
    "RotationsChainSymmetries-whole": ("RotationsChainSymmetries", {},
                                       {"output_prefix": "q"}),
    "RotationsChainSymmetries-sampled": (
        "RotationsChainSymmetries", {"sym_sample": (("h", "v"), 1, True),
                                     "syms": ("h", "v", "o")},
        {"output_bands": 3}),
}


@pytest.mark.parametrize("last", ["fit", "clean"])
@pytest.mark.parametrize("case", list(SAVE_CASES))
def test_save_item_writes_the_jax_files_with_the_jax_encoder(
        monkeypatch, tmp_path, case, last):
    name, kwargs, options = SAVE_CASES[case]
    K = len(kwargs.get("syms", ALL))
    written = {}
    for tag, (_, transforms, fused) in PKGS.items():
        calls = []
        for module, attr in ENCODERS[tag]:
            real = getattr(module, attr)
            kind = "pil" if attr.endswith("_pil") else "cv2"
            monkeypatch.setattr(
                module, attr, lambda img, p, real=real, kind=kind:
                calls.append((Path(p).name, kind)) or real(img, p))
        step = make(name, fused, transforms, last, **kwargs)
        rng = np.random.default_rng(7)
        files = []
        for seed in range(12):
            out = fake_out(name, rng, K)
            item = {"_args": (f"in/x{seed}.png",), "_seed": 1000 + seed}
            target = tmp_path / tag / str(seed)
            target.mkdir(parents=True)
            saved = step.save_item(out, item, [target], options)
            files.append([p.name for p in saved or []])
        written[tag] = (files, sorted(calls))
    assert written["t"] == written["j"]
    files, calls = written["t"]
    assert sum(map(len, files)) == len(calls) > 0
    for seed in range(12):
        for f in files[seed]:
            got = np.asarray(Image.open(tmp_path / "t" / str(seed) / f))
            want = np.asarray(Image.open(tmp_path / "j" / str(seed) / f))
            np.testing.assert_array_equal(got, want, err_msg=f)
    anchors = {k for _, k in calls}
    if name in ("SymmetriesChain", "RotSymChain"):
        assert anchors == {"pil" if last == "fit" else "cv2"}
    else:
        assert anchors == {"cv2"}
    if "sampled" in case:
        assert len({tuple(f) for f in files}) > 1


# -- __init__ -------------------------------------------------------------

def bad_configs(fused):
    return {
        "sym-rotate": ("SymmetriesChain", ([fused.Rotate()], ALL)),
        "sym-flip": ("SymmetriesChain", ([fused.Flip()], ALL)),
        "sym-enhance": ("SymmetriesChain", ([fused.Enhance()], ALL)),
        "sym-invalid": ("SymmetriesChain", ([fused.FitCrop()], ("o", "x"))),
        "sym-empty": ("SymmetriesChain", ([fused.FitCrop()], ())),
        "sym-sample-outside": ("SymmetriesChain", (
            [fused.FitCrop()], ("h",), (("h", "v"), 1, True))),
        "sym-sample-k": ("SymmetriesChain", (
            [fused.FitCrop()], ("h", "v"), (("h", "v"), 3, True))),
        "symsym-tail-invalid": ("SymmetriesChainSymmetries", (
            [fused.FitCrop()], ALL, ("hv", "y"))),
        "symsym-tail-empty": ("SymmetriesChainSymmetries", (
            [fused.FitCrop()], ALL, ())),
        "symsym-tail-sample": ("SymmetriesChainSymmetries", (
            [fused.FitCrop()], ALL, ("h",), None, (("v",), 1, False))),
        "symsym-head-flip": ("SymmetriesChainSymmetries", (
            [fused.Flip()], ALL, ALL)),
        "rotsym-rotate": ("RotSymChain", ([fused.Rotate()], ALL)),
        "rotsym-flip": ("RotSymChain", ([fused.Flip()], ALL)),
        "rotsym-enhance": ("RotSymChain", ([fused.Enhance()], ALL)),
        "rotsym-invalid": ("RotSymChain", ([fused.FitCrop()], ("z",))),
        "rotsym-sample-k": ("RotSymChain", (
            [fused.FitCrop()], ALL, (ALL, -1, True))),
        "rotchainsym-rotate": ("RotationsChainSymmetries", (
            [fused.Rotate()], ALL)),
        "rotchainsym-empty": ("RotationsChainSymmetries", (
            [fused.FitCrop()], ())),
        "rotchainsym-sample-outside": ("RotationsChainSymmetries", (
            [fused.FitCrop()], ("o",), (("o", "hv"), 1, True))),
    }


@pytest.mark.parametrize("case", list(bad_configs(tfused)))
def test_init_rejects_what_jax_rejects(case):
    messages = []
    for _, transforms, fused in PKGS.values():
        name, args = bad_configs(fused)[case]
        with pytest.raises(ValueError) as err:
            getattr(transforms, name)(*args)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_enhance_and_flip_tails_are_allowed_where_jax_allows_them():
    """ChainSymmetries and RotationsChainSymmetries take any tail (the rng
    tier ends them with an Enhance)."""
    for transforms, fused in ((jtransforms, jfused), (ttransforms, tfused)):
        transforms.ChainSymmetries([fused.Flip(), fused.Enhance()])
        transforms.RotationsChainSymmetries([fused.Enhance()], ALL)
    step = ttransforms.RotSymChain([tfused.FitCrop()], ("h", "o"))
    assert step.static_args({}, ())[-2:] == ("h", "o")
    assert step.max_batch == 4
    assert ttransforms.SymmetriesChainSymmetries(
        [tfused.FitCrop()], ALL, ALL).max_batch == 4
    assert ttransforms.RotationsChainSymmetries(
        [tfused.FitCrop()], ALL).max_batch == 8

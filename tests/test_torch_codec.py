"""The engine's coefficient transports on the CPU: ``device_decode`` and
``device_encode`` forced on with an explicit True, through the JAX
package's engine and the port's over the same JPEG dataset.

Pipeline J is crop_square (.jpg at q95), then rotations (method "shear",
4 an image, ``output_format="jpeg"`` at q75), then symmetry (.jpg at q95);
the fused pipeline is one FusedChain step (shear rotation, flip, enhance
without blur) to .jpg, then EnhanceImage.  Both engines must give the
same names, statuses, reports and JPEG bytes, and the same
``d2h_bytes_full``/``d2h_bytes_fetched``; within the port, the transports
on must write the files of the transports off, byte for byte."""

from collections import Counter
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import image_processor_pipeline_tpu as jpkg
import image_processor_pipeline_tpu.transforms as jtransforms
import image_processor_pipeline_tpu.transforms.fused as jfused
import image_processor_pipeline_tpu_torch as tpkg
import image_processor_pipeline_tpu_torch.transforms as ttransforms
import image_processor_pipeline_tpu_torch.transforms.fused as tfused
from image_processor_pipeline_tpu_torch.io import native
from image_processor_pipeline_tpu_torch.ops import jpeg as tjpeg
from torch_port_data import make_image, make_labels, reports

ON = {"device_decode": True, "device_encode": True}
OFF = {"device_decode": False, "device_encode": False}
#: engine tag -> (package, transforms, fused module, step keywords)
ENGINES = {
    "j": (jpkg, jtransforms, jfused, {"options": {"native_compute": False}}),
    "t": (tpkg, ttransforms, tfused, {"device": "cpu"}),
}
N_IMAGES = 6


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """JPEGs at q90 with YOLO labels: four 4:2:0 files in two sizes, and a
    4:4:4 one (the sparse reader's -3 retry with full chroma caps) and a
    progressive one."""
    assert native.available(), native.build_error()
    root = tmp_path_factory.mktemp("codec")
    (root / "imgs").mkdir()
    (root / "labels").mkdir()
    rng = np.random.default_rng(9)
    for i in range(N_IMAGES):
        h, w = ((96, 128), (128, 112))[i % 2]
        kw = {4: {"subsampling": 0}, 5: {"progressive": True}}.get(i, {})
        Image.fromarray(make_image(rng, h, w)).save(
            root / "imgs" / f"im_{i}.jpg", quality=90, **kw)
        (root / "labels" / f"im_{i}.txt").write_text(
            make_labels(rng, int(rng.integers(1, 3)), h, w))
    return root


def step(tag, name, function, options, **kw):
    pkg, _, _, base = ENGINES[tag]
    options = dict(base.get("options", {}), **options)
    return pkg.ProcessingStep(name, function, options=options, save_log=True,
                              **{k: v for k, v in base.items()
                                 if k != "options"}, **kw)


def pipeline_j(data, tag, codec, out):
    _, transforms, _, _ = ENGINES[tag]
    pkg = ENGINES[tag][0]
    pipe = pkg.ProcessingPipeline(root_dir=data / out)
    pipe.add_step(step(tag, "crop", transforms.SquareCropAroundBBox(), codec,
                       input_dirs=[data / "imgs", data / "labels"],
                       output_dirs=["crops/imgs", "crops/labels"],
                       pairing_method="zip", seed=3))
    pipe.add_step(step(tag, "rot", transforms.RandomRotations(),
                       dict(codec, method="shear", num_rotations=4,
                            output_format="jpeg"),
                       input_dirs=[data / out / "crops" / "imgs"],
                       output_dirs=["rot"], seed=4))
    pipe.add_step(step(tag, "sym", transforms.GenerateSymmetries(), codec,
                       output_dirs=["sym"], seed=5))
    return pipe, pipe.run(progress=False)


def pipeline_fused(data, tag, codec, out):
    pkg, transforms, fused, _ = ENGINES[tag]
    chain = fused.FusedChain([fused.Rotate(1.0, 359.0, "shear"), fused.Flip(),
                              fused.Enhance(0.0, 0.5)])
    pipe = pkg.ProcessingPipeline(root_dir=data / out)
    pipe.add_step(step(tag, "fused", chain, dict(codec, output_suffix=".jpg"),
                       input_dirs=[data / "imgs"], output_dirs=["fused"],
                       seed=6))
    pipe.add_step(step(tag, "enhance", transforms.EnhanceImage(), codec,
                       output_dirs=["enh"], seed=7))
    return pipe, pipe.run(progress=False)


#: run name -> (pipeline, its output directories, the files of each)
PIPELINES = {
    "J": (pipeline_j, ("crops/imgs", "crops/labels", "rot", "sym"),
          (N_IMAGES, N_IMAGES, 5 * N_IMAGES, None)),
    "fused": (pipeline_fused, ("fused", "enh"), (N_IMAGES, N_IMAGES)),
}


@pytest.fixture(scope="module")
def runs(data, monkeypatch_module):
    """Each pipeline through the JAX engine with the transports on, and
    through the port's with them on and off; counts the port's device
    decode finishes and device encode starts meanwhile."""
    calls = Counter()
    for name in ("decode_finish_sparse", "decode_finish", "encode_start_sparse"):
        real = getattr(tjpeg, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch_module.setattr(tjpeg, name, counted)
    out = {}
    for pname, (build, _, _) in PIPELINES.items():
        for tag, codec, label in (("j", ON, "j_on"), ("t", OFF, "t_off"),
                                  ("t", ON, "t_on")):
            if label == "t_on":
                calls.clear()
            out[pname, label] = build(data, tag, codec, f"{pname}_{label}")
        out[pname, "calls"] = dict(calls)
    return out


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def files(directory):
    return {p.name: p.read_bytes() for p in sorted(Path(directory).iterdir())}


@pytest.mark.parametrize("pname", list(PIPELINES))
def test_transports_write_the_jax_engines_bytes(data, runs, pname):
    """Names, statuses and file bytes equal the JAX engine's with the
    transports forced on in both."""
    _, dirs, counts = PIPELINES[pname]
    (jpipe, jstatus), (tpipe, tstatus) = runs[pname, "j_on"], \
        runs[pname, "t_on"]
    assert tstatus == jstatus
    assert all(set(c) == {"Success"} for c in tstatus)
    for d, n in zip(dirs, counts):
        got = files(data / f"{pname}_t_on" / d)
        want = files(data / f"{pname}_j_on" / d)
        assert sorted(got) == sorted(want), d
        if n is not None:
            assert len(got) == n, d
        for name in want:
            assert got[name] == want[name], (d, name)


@pytest.mark.parametrize("pname", list(PIPELINES))
def test_transports_on_equal_off_in_the_port(data, runs, pname):
    _, dirs, _ = PIPELINES[pname]
    for d in dirs:
        assert files(data / f"{pname}_t_on" / d) == \
            files(data / f"{pname}_t_off" / d), d


@pytest.mark.parametrize("pname", list(PIPELINES))
def test_reports_equal_the_jax_engines(data, runs, pname):
    want = reports(data / f"{pname}_j_on")
    got = reports(data / f"{pname}_t_on")
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == [
            {**e, "outputs": [o.replace(f"{pname}_j_on", f"{pname}_t_on")
                              for o in e["outputs"]]} for e in want[name]]


@pytest.mark.parametrize("pname", list(PIPELINES))
def test_d2h_counters_equal_the_jax_engines(runs, pname):
    """Every step fetches as many bytes as the JAX engine's step, and
    fewer with the transports on than off (off, FusedChain still fetches
    its valid region only, so off is not the full output everywhere)."""
    jpipe, tpipe = runs[pname, "j_on"][0], runs[pname, "t_on"][0]
    off = runs[pname, "t_off"][0]
    for js, ts, os_ in zip(jpipe.steps, tpipe.steps, off.steps):
        jm, tm, om = js.metrics, ts.metrics, os_.metrics
        assert (tm.d2h_bytes_full, tm.d2h_bytes_fetched) == \
            (jm.d2h_bytes_full, jm.d2h_bytes_fetched), ts.name
        assert om.d2h_bytes_full == tm.d2h_bytes_full, ts.name
        assert 0 < tm.d2h_bytes_fetched < om.d2h_bytes_fetched \
            <= om.d2h_bytes_full, ts.name


def test_transports_ran(runs):
    """The device decode finished items (the sparse reader, its -3 retry
    included) and the device encode started batches in both pipelines."""
    for pname in PIPELINES:
        calls = runs[pname, "calls"]
        assert calls.get("decode_finish_sparse", 0) > 0, pname
        assert calls.get("encode_start_sparse", 0) > 0, pname


def test_without_the_library_auto_falls_back_and_true_raises(
        data, monkeypatch, tmp_path):
    """With the native library unavailable, "auto" on the card resolves to
    the host path (the transports need the library's entropy coder), and
    an explicit True raises naming build_error()."""
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(native, "build_error",
                        lambda: "png.h: No such file or directory")
    with pytest.raises(RuntimeError, match="png.h"):
        step("t", "crop", ttransforms.SquareCropAroundBBox(),
             {"device_encode": True})
    sym = ttransforms.GenerateSymmetries()
    chunk = [{"_decode": (str(data / "imgs" / "im_0.jpg"), "RGB", False)}]
    assert sym.needs_host_image(chunk, {}, "cuda")


def test_hybrid_decode_ladder_equals_jax_and_the_host_decode(tmp_path):
    """_decode_group_device over one bucket that takes every rung: 4:2:0,
    4:2:2 (the -3 retry with full chroma caps), grayscale, progressive, a
    noise file past the sparse cap (the -6 dense re-read) and a corrupt
    file (host fallback, an error on its item).  Pixels equal the JAX
    package's hybrid decode and the host decode; the stats count the
    sparse items, the dense re-read and the host fallback."""
    from image_processor_pipeline_tpu.io import images as jimages
    from image_processor_pipeline_tpu_torch.io import images as timages
    from image_processor_pipeline_tpu_torch.io.batching import canvas_for

    rng = np.random.default_rng(12)
    H, W = 90, 120
    files = []
    for i, kw in enumerate([{}, {"subsampling": 1}, {"gray": True},
                            {"progressive": True}, {"noise": True}]):
        img = (rng.integers(0, 256, (H, W, 3), np.uint8) if kw.pop(
            "noise", False) else make_image(rng, H, W))
        im = Image.fromarray(img)
        if kw.pop("gray", False):
            im = im.convert("L")
        files.append(tmp_path / f"f{i}.jpg")
        im.save(files[-1], quality=95, **kw)
    files.append(tmp_path / "bad.jpg")
    files[-1].write_bytes(b"\xff\xd8 garbage")

    def items():
        return [{"size": np.asarray([H, W], np.int32),
                 "canvas": canvas_for(H, W),
                 "_decode": (str(p), "RGB", False)} for p in files]

    canvas = tuple(canvas_for(H, W))
    stats = {}
    t_items = items()
    got = timages._decode_group_device(t_items, canvas, "RGB", "cpu",
                                       stats=stats)
    j_items = items()
    want = np.asarray(jimages._decode_group_device(j_items, canvas, "RGB"))
    np.testing.assert_array_equal(got.numpy(), want)
    assert stats == {"n": 6, "dense": 1, "sparse": 4, "host": 1}
    assert "_load_error" in t_items[-1] and "_load_error" in j_items[-1]
    for i, p in enumerate(files[:-1]):
        host = timages.decode_padded(p, mode="RGB")[0]
        np.testing.assert_array_equal(got[i].numpy(), host, err_msg=p.name)


@pytest.mark.parametrize("name", ["RotationsSymmetries", "RotationsChain"])
def test_png_composites_never_take_the_jpeg_transport(data, tmp_path, name):
    """The rotation composites write .png whatever the options say: their
    shrink_output overrides fetch pixels, so output_format="jpeg" with
    device_encode forced on writes the files of the transports off."""
    from image_processor_pipeline_tpu_torch.transforms.fused import Flip

    for codec in (ON, OFF):
        transform = (ttransforms.RotationsChain([Flip()])
                     if name == "RotationsChain"
                     else ttransforms.RotationsSymmetries())
        tpkg.ProcessingStep(
            "c", transform, input_dirs=[data / "imgs"],
            output_dirs=[tmp_path / str(codec["device_encode"])], seed=8,
            device="cpu", options=dict(codec, method="shear",
                                       num_rotations=2,
                                       output_format="jpeg")).run(
            progress=False)
        assert transform.shrinks_output
    assert files(tmp_path / "True") == files(tmp_path / "False")
    assert all(n.endswith(".png") for n in files(tmp_path / "True"))


def test_config4_transports_on_equal_off(tmp_path):
    """Config 4 (PasteOverlayOntoBackground onto JPEG backgrounds, then
    BorderCrop, and OverlaysBorderCrop, whose override keeps the pixel
    fetch) writes the same bytes with the transports forced on as off,
    and the paste step fetches coefficients, not composites."""
    rng = np.random.default_rng(13)
    (tmp_path / "ov").mkdir()
    (tmp_path / "bg").mkdir()
    for i in range(4):
        ov = make_image(rng, 30 + 3 * i, 24 + 5 * i, 4)
        ov[..., 3] = np.where(ov[..., 3] > 0, 255, 0)
        Image.fromarray(ov).save(tmp_path / "ov" / f"ov{i}.png")
    for i in range(2):
        Image.fromarray(make_image(rng, 96, 128)).save(
            tmp_path / "bg" / f"bg{i}.jpg", quality=92)
    margins = {"crop_margins": (0.05, 0.05, 0.05, 0.05)}
    steps = {}
    for label, codec in (("on", ON), ("off", OFF)):
        root = tmp_path / label
        pipe = tpkg.ProcessingPipeline(root_dir=root)
        for name, transform, ins, outs, extra in (
                ("paste", ttransforms.PasteOverlayOntoBackground(),
                 [tmp_path / "ov", tmp_path / "bg"], ["p/i", "p/l"],
                 {"pairing_method": "modulo"}),
                ("crop", ttransforms.BorderCrop(), [root / "p" / "i"],
                 ["crop"], {"options": dict(codec, **margins)}),
                ("ob", ttransforms.OverlaysBorderCrop(),
                 [tmp_path / "ov", tmp_path / "bg"], ["ob/i", "ob/l"],
                 {"pairing_method": "modulo",
                  "options": dict(codec, **margins)})):
            extra.setdefault("options", dict(codec))
            pipe.add_step(tpkg.ProcessingStep(
                name, transform, input_dirs=ins, output_dirs=outs, seed=6,
                device="cpu", **extra))
        assert pipe.run(progress=False) == [
            Counter(Success=4), Counter(Success=4), Counter(Success=4)]
        steps[label] = pipe.steps
    for d in ("p/i", "p/l", "crop", "ob/i", "ob/l"):
        assert files(tmp_path / "on" / d) == files(tmp_path / "off" / d), d
    on = steps["on"][0].metrics
    assert 0 < on.d2h_bytes_fetched < on.d2h_bytes_full
    ob = steps["on"][2].metrics
    assert ob.d2h_bytes_fetched == ob.d2h_bytes_full > 0

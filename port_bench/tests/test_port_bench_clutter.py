"""The chroma-key cell ``fusedchain640.clutter`` on the CPU: its traffic
generator, its plain reference (against the port and against OpenCV),
the engine driver's fused path, the CCL's readers, and runs with the
timed path broken underneath, which must come out not correct."""

import json

import numpy as np
import pytest
import torch

from conftest import REPO, tiny_cell
from port_bench import harness, run
from port_bench.drivers import engine
from port_bench.reference.images import decode
from port_bench.reference.steps import ColorMaskTransparency as CM
from port_bench.reference.steps import KeepLargestComponent as KL
from port_bench.traffic import chroma_dataset

CELL = "fusedchain640.clutter"
TRAFFIC = json.loads((REPO / "port_bench" / "workloads" / f"{CELL}.json")
                     .read_text())
CONFIG = json.loads((REPO / "port_bench" / "configs" / "fusedchain640.json")
                    .read_text())
RANGES = CONFIG["steps"][0]["options"]["color_ranges_to_exclude_hsv"]


def _make(root, seed, n=8, width=320, height=240):
    p = dict(TRAFFIC["dataset"], width=width, height=height)
    stats = []
    dirs, _ = chroma_dataset.make(root, n, 1, seed, p, "cpu", 2, stats)
    files = sorted(dirs[0][0].iterdir())
    return files, {k: np.concatenate([s[k] for s in stats])
                   for k in stats[0]}


def test_the_generator_follows_its_seed_and_keeps_its_promises(tmp_path):
    files, st = _make(tmp_path / "a", 2**33 + 3)
    again, _ = _make(tmp_path / "b", 2**33 + 3)
    other, _ = _make(tmp_path / "c", 2**33 + 4)
    data = [f.read_bytes() for f in files]
    assert data == [f.read_bytes() for f in again]
    assert all(a != b for a, b in zip(data, (f.read_bytes() for f in other)))
    p = TRAFFIC["dataset"]
    keys = chroma_dataset.draw_params(np.random.default_rng(5), 64, p)["key"]
    assert np.bincount(keys).tolist() == [32, 32]
    assert ((st["object_share"] > 0.15) & (st["object_share"] < 0.45)).all()
    placed = st["distractor_shares"][st["distractor_shares"] > 0]
    assert len(placed) and (placed > 0.0045).all() and (placed < 0.033).all()
    assert ((st["distractor_shares"] > 0).sum(1) <= 3).all()
    specks, kept = [], []
    for i, data_ in enumerate(data):
        fg = CM.mask_alpha(decode(data_, "RGB"), RANGES) > 1
        # outside the key ranges after the JPEG: specks on the backdrop
        specks.append(fg[st["free"][i]].mean())
        kept.append(KL.keep_mask(fg).mean() / st["object_share"][i])
    specks = np.array(specks)
    assert (specks > 0.01).all() and (specks < 0.04).all(), specks
    # the cleanup keeps the object alone: specks and distractors go
    assert (np.array(kept) > 0.85).all() and (np.array(kept) < 1.05).all()


def _cell(fused: bool, **traffic):
    cell = tiny_cell(CELL)
    cell.traffic.update(pool_inputs=4, pass_inputs=4, check_inputs_per_pass=4,
                        **traffic)
    cell.traffic["dataset"].update(width=96, height=72)
    cell.config["auto_fuse"] = fused
    return cell


@pytest.mark.parametrize("fused", [True, False])
def test_the_reference_equals_the_port_and_the_control_does_not(fused):
    """Four 96 x 72 images, every output file compared: the program's
    files equal the reference's, the control's (the reference in
    bfloat16) do not."""
    cell = _cell(fused)
    drv = harness.driver("engine")
    st = drv.setup(2**31 + 5, cell.config, cell.traffic, "cpu")
    try:
        drv.window(st, 0.2, False)
        assert len(st.passes[0].steps) == (1 if fused else 2)
        program = {c.name: c.value for c in drv.check(st)}
        control = {c.name: c.value for c in drv.check(st, torch.bfloat16)}
    finally:
        drv.close(st)
    assert all(v == 0 for v in program.values()), program
    assert control["engine.files_differ"] > 0, control


def test_the_reference_equals_opencv():
    cv2 = pytest.importorskip("cv2")
    v = np.arange(256, dtype=np.uint8)
    # every 8-bit colour, a sixteenth at a time
    for r in range(0, 256, 16):
        rgb = np.stack(np.meshgrid(v[r:r + 16], v, v, indexing="ij"),
                       -1).reshape(-1, 256, 3)
        hsv = cv2.cvtColor(np.ascontiguousarray(rgb[..., ::-1]),
                           cv2.COLOR_BGR2HSV)
        assert np.array_equal(CM.hsv8(rgb), hsv)
        for lo, hi in [(f[:3], f[3:]) for f in RANGES] + [
                ((10.5, 0, 0), (20.5, 255, 255))]:
            want = cv2.inRange(hsv, np.float64(lo), np.float64(hi)) > 0
            assert np.array_equal(CM.in_range(hsv, lo, hi), want)
    rng = np.random.default_rng(11)
    for share in (0.3, 0.5, 0.6):
        fg = rng.random((120, 160)) < share
        n, cv_labels, stats, _ = cv2.connectedComponentsWithStats(
            fg.astype(np.uint8), connectivity=8)
        labels = KL.labels(fg)
        # the same partition: labels map one to one
        pairs = set(zip(labels[fg].tolist(), cv_labels[fg].tolist()))
        assert len(pairs) == labels.max() + 1 == n - 1
        assert np.array_equal(labels < 0, cv_labels == 0)
        largest = 1 + int(np.argmax(stats[1:, cv2.CC_STAT_AREA]))
        assert np.array_equal(KL.keep_mask(fg), cv_labels == largest)


def test_a_fused_pass_counts_its_saves_and_an_unfused_one_ends_the_run(
        monkeypatch):
    cell = _cell(True)
    drv = harness.driver("engine")
    st = drv.setup(2**32 + 9, cell.config, cell.traffic, "cpu")
    try:
        res = drv.window(st, 0.2, False)
        # one PNG an input, each save returning one Path
        assert all(p.images == p.steps[0]["items"] == 4 for p in st.passes)
        assert res["e2e"]["written_images_per_s"] > 0
        monkeypatch.setattr(engine.fuse, "fuse_steps",
                            lambda steps, **k: list(steps))
        with pytest.raises(harness.BenchError, match="auto_fuse left 2"):
            drv.window(st, 0.2, False)
    finally:
        drv.close(st)


def _trace(spans, device, calls=None, unlaunched=()):
    """A trace whose records were each made by a call 1 us before they
    start, from the profiled thread, unless ``calls`` says otherwise."""
    if calls is None:
        calls = [(d[1] - 1.0, d[1], i, True) for i, d in enumerate(device)]
    return harness.Trace(device=device, spans=spans, window=(0.0, 1e4),
                         calls=calls, unlaunched=list(unlaunched))


def test_the_ccl_readers():
    ms, sweeps, roof = (harness.metric_reader(n) for n in (
        "ccl_ms_per_batch", "ccl_sweeps_per_batch", "ccl_roofline"))
    kind = "NVIDIA H100 80GB HBM3"
    calls = [{"shape": (8, 512, 640), "sweeps": 4},
             {"shape": (8, 512, 640), "sweeps": 8}]
    spans = [("save", 0.0, 50.0), ("ccl", 100.0, 300.0),
             ("ccl", 400.0, 1400.0)]
    device = [("k", 110.0 + 10 * i, 115.0 + 10 * i) for i in range(4)] + [
        ("k", 410.0 + 10 * i, 420.0 + 10 * i) for i in range(8)] + [
        ("Memcpy DtoH (Device -> Pinned)", 120.0, 200.0), ("k", 20.0, 90.0),
        ("saver's copy", 150.0, 160.0)]
    launched = [(d[1] - 1.0, d[1], i, True) for i, d in enumerate(device)]
    # a saver thread's kernel, launched inside the first span
    launched[-1] = (149.0, 150.0, len(device) - 1, False)
    rec = {"trace": _trace(spans, device, launched), "ccl": calls,
           "kind": kind}
    assert ms(rec) == pytest.approx(0.6)
    assert sweeps(rec) == 6.0
    bound_us = 1e6 * 2 * 8 * 512 * 640 * 5 / 3.35e12
    # the labelling's own kernels: no copy, no other thread's kernel
    assert roof(rec) == pytest.approx(100 * bound_us / (4 * 5 + 8 * 10))
    # records without the spans
    bare = {"trace": _trace(spans[:1], device), "ccl": calls, "kind": kind}
    assert ms(bare) is None and roof(bare) is None
    assert sweeps(dict(rec, ccl=[])) is None
    assert roof(dict(rec, kind="cpu")) is None
    # a call in a span whose record on the card was lost
    lost = list(launched)
    lost[5] = lost[5][:2] + (None, True)
    assert roof(dict(rec, trace=_trace(spans, device, lost))) is None
    # a record in a span that no recorded call made
    assert roof(dict(rec, trace=_trace(spans, device, launched[1:],
                                       unlaunched=[0]))) is None
    # the labelling ran on a thread the profiler does not record
    other = [c[:3] + (False,) for c in launched]
    assert roof(dict(rec, trace=_trace(spans, device, other))) is None


class _Event:
    """A profiler record as ``harness.reduce_events`` reads it."""

    def __init__(self, name, cuda, t0, dur, corr, linked=0, thread=1):
        self._v = (name, "cuda" if cuda else "cpu", t0, dur, corr, linked,
                   thread)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def start_thread_id(self):
        return self._v[6]


def test_the_trace_ties_each_call_to_its_record_and_its_thread():
    E = _Event
    events = [
        E(harness.SPAN + "window", False, 1000, 1_000_000, 1, thread=7),
        E(harness.SPAN + "window", True, 1100, 999_000, 2),
        E(harness.WARMUP_KERNEL, True, 1500, 100, 90),
        E("aten::minimum", False, 1900, 400, 11, thread=7),
        E("aten::add", False, 1900, 400, 12, thread=8),
        # the profiled thread's launch, another thread's, one whose op
        # ran on a thread the window's range did not
        E("cudaLaunchKernel", False, 2000, 50, 501, linked=11),
        E("k_min", True, 3000, 500, 501),
        E("cudaLaunchKernel", False, 2100, 50, 502),
        E("k_save", True, 4000, 500, 502),
        E("cudaLaunchKernel", False, 2200, 50, 505, linked=12),
        E("k_add", True, 5000, 500, 505),
        # a record no call made, a call whose record was lost
        E("k_orphan", True, 6000, 500, 503),
        E("cudaMemcpyAsync", False, 2300, 50, 504, linked=11),
        E("cudaDeviceSynchronize", False, 2400, 50, 506, linked=11),
        # outside the window
        E("cudaLaunchKernel", False, 2_000_000, 50, 507, linked=11),
        E("k_late", True, 2_000_100, 500, 507),
    ]
    t = harness.reduce_events(events, 0, "cuda")
    assert t.window == (1.0, 1001.0)
    assert t.device == [("k_min", 3.0, 3.5), ("k_save", 4.0, 4.5),
                        ("k_add", 5.0, 5.5), ("k_orphan", 6.0, 6.5)]
    calls = [(round(a, 6), round(b, 6), d, own) for a, b, d, own in t.calls]
    assert calls == [(2.0, 2.05, 0, True), (2.1, 2.15, 1, False),
                     (2.2, 2.25, 2, False), (2.3, 2.35, None, True)]
    assert t.unlaunched == [3]


def _broken_run(monkeypatch, owner, attr, wrap):
    import importlib

    mod = importlib.import_module(owner)
    monkeypatch.setattr(mod, attr, wrap(getattr(mod, attr)))
    line, _ = run.run(CELL, 2147483671, 0.3, False, device="cpu")
    return json.loads(line)


def _centre_altered(fn):
    """keep_largest_component with the pixel at each image's centre
    changed."""
    def broken(rgba, h, w, *a, **k):
        out = fn(rgba, h, w, *a, **k).clone()
        for i in range(out.shape[0]):
            out[i, int(h[i]) // 2, int(w[i]) // 2] ^= 0x40
        return out
    return broken


def _unchanged(fn):
    """keep_largest_component returning its input: no cleanup."""
    return lambda rgba, h, w, *a, **k: rgba


def _half_saved(fn):
    """FusedChain.save_item writing every other item only."""
    calls = []

    def broken(self, out, item, output_dirs, options):
        calls.append(1)
        if len(calls) % 2:
            return None
        return fn(self, out, item, output_dirs, options)
    return broken


@pytest.mark.parametrize("owner, attr, wrap", [
    ("image_processor_pipeline_tpu_torch.ops.ccl", "keep_largest_component",
     _centre_altered),
    ("image_processor_pipeline_tpu_torch.ops.ccl", "keep_largest_component",
     _unchanged),
])
def test_a_broken_cleanup_is_not_correct(tiny, monkeypatch, owner, attr,
                                         wrap):
    out = _broken_run(monkeypatch, owner, attr, wrap)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_half_of_the_batch_left_unsaved_is_not_correct(tiny, monkeypatch):
    from image_processor_pipeline_tpu_torch.transforms import fused

    monkeypatch.setattr(fused.FusedChain, "save_item",
                        _half_saved(fused.FusedChain.save_item))
    line, _ = run.run(CELL, 2147483677, 0.3, False, device="cpu")
    assert json.loads(line)["correct"] is False

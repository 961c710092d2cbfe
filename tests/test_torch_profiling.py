"""The port's spans and counters (utils/profiling.py's recorder) and the
chain's spans inside augment_chain, on the CPU twin of 'cuda_full'."""

import dataclasses
import json
import sys
import threading

import numpy as np
import pytest
import torch

from image_processor_pipeline_tpu_torch.models import chains
from image_processor_pipeline_tpu_torch.ops import native_draws
from image_processor_pipeline_tpu_torch.utils import profiling

PHASES = ("chain.draws", "chain.shifts", "chain.h2d", "chain.launch")


def call_counters(calls=1):
    """The counters of ``calls`` chain calls: seven copies each, and both
    draw functions served by the native pass where its library built."""
    counters = {"chain.h2d_copies": 7 * calls}
    if native_draws.available():
        counters["chain.draws_native"] = 2 * calls
    return counters


@pytest.fixture(autouse=True)
def fresh_recorder():
    rec = profiling.RECORDER
    rec.reset()
    rec.on = rec.ranges = False
    rec.records = None
    yield rec
    rec.reset()
    rec.on = rec.ranges = False
    rec.records = None


def chain_args(B=3, size=80, seed=5):
    rng = np.random.default_rng(seed)
    images = torch.as_tensor(rng.integers(0, 256, (B, size, size, 3),
                                          np.uint8))
    xywhn = np.concatenate([rng.uniform(0.3, 0.7, (B, 2)),
                            rng.uniform(0.05, 0.3, (B, 2))],
                           axis=1).astype(np.float32)
    return images, xywhn, np.arange(B) * 97 + seed


def test_the_recorder_off_keeps_nothing_and_opens_no_range(
        fresh_recorder, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("record_function entered")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    with fresh_recorder.capture() as records:
        chains.augment_chain(*chain_args(), 64, "cuda_full")
    assert records == []
    assert fresh_recorder.totals == fresh_recorder.counts == {}
    assert fresh_recorder.counters == {}
    # on, but outside a device_trace: still no profiler range
    with profiling.recording():
        chains.augment_chain(*chain_args(), 64, "cuda_full")
    assert fresh_recorder.counts["chain.call"] == 1


@pytest.mark.parametrize("mode", ["cuda_full", "full_reference", "shear",
                                  "gather"])
def test_one_call_is_one_chain_call_around_its_four_phases(
        fresh_recorder, mode):
    with profiling.recording() as rec, rec.capture() as records:
        chains.augment_chain(*chain_args(), 64, mode)
    assert not rec.on
    (call,) = [r for r in records if r.name == "chain.call"]
    assert call.parent is None and call.call == 0
    children = [r for r in records if r.name != "chain.call"]
    assert [r.name for r in children] == list(PHASES)
    for r in children:
        assert r.parent == "chain.call" and r.call == call.call
        assert call.start_ns <= r.start_ns <= r.end_ns <= call.end_ns
    assert all(a.end_ns <= b.start_ns for a, b in zip(children,
                                                      children[1:]))
    assert rec.counters == call_counters()
    assert rec.counts == {name: 1 for name in PHASES + ("chain.call",)}
    assert rec.totals["chain.call"] >= sum(rec.totals[n] for n in PHASES)


def test_calls_number_their_spans_and_reset_restarts_them(fresh_recorder):
    with profiling.recording() as rec, rec.capture() as records:
        for _ in range(3):
            chains.augment_chain(*chain_args(B=2), 64, "cuda_full")
    assert sorted({r.call for r in records}) == [0, 1, 2]
    assert rec.counters["chain.h2d_copies"] == 21
    assert rec.counts["chain.call"] == 3
    rec.reset()
    assert rec.totals == rec.counts == rec.counters == {}
    with profiling.recording(), rec.capture() as records:
        chains.augment_chain(*chain_args(B=2), 64, "cuda_full")
    assert {r.call for r in records} == {0}


def test_outputs_are_byte_equal_with_the_recorder_on_and_off():
    args = chain_args(B=4, size=96, seed=9)
    off = chains.augment_chain(*args, 64, "cuda_full")
    with profiling.recording(), profiling.RECORDER.capture():
        on = chains.augment_chain(*args, 64, "cuda_full")
    assert torch.equal(off, on)


def test_device_trace_writes_the_chain_ranges(fresh_recorder, tmp_path):
    with profiling.device_trace(tmp_path):
        assert fresh_recorder.on and fresh_recorder.ranges
        chains.augment_chain(*chain_args(B=2), 64, "cuda_full")
    assert not fresh_recorder.on and not fresh_recorder.ranges
    (trace,) = tmp_path.glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(trace.read_text())
             ["traceEvents"]}
    assert {"chain.call", *PHASES} <= names


def test_spans_of_threads_nest_per_thread_and_lose_no_update(
        fresh_recorder):
    """More threads than cores, a short switch interval: every span and
    count lands, and each span's parent is its own thread's."""
    n_threads, n = 16, 300
    errors = []

    def work(i):
        try:
            for _ in range(n):
                with profiling.span(f"outer.{i}"):
                    with profiling.span("inner"):
                        profiling.count("c")
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording() as rec, rec.capture() as records:
            threads = [threading.Thread(target=work, args=(i,))
                       for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    assert rec.counts["inner"] == rec.counters["c"] == n_threads * n
    outer = {r.call: r.name for r in records if r.parent is None}
    assert len(outer) == n_threads * n
    for r in records:
        if r.name == "inner":
            assert r.parent == outer[r.call]


def test_timer_sums_from_threads_without_losing_an_update():
    timer = profiling.Timer()

    def work():
        for _ in range(2000):
            timer.add("save", 1.0)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert timer.totals["save"] == timer.counts["save"] == 32000


def test_stage_metrics_has_no_compiles_field():
    fields = {f.name for f in dataclasses.fields(profiling.StageMetrics)}
    assert "compiles" not in fields
    assert "compiles" not in profiling.StageMetrics().as_dict()


def test_a_profiler_session_records_the_chain_without_ranges(
        fresh_recorder, monkeypatch):
    """While a torch.profiler session collects, the recorder keeps the
    spans and counters unasked, and opens no range of its own."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        def boom(*a, **k):
            raise AssertionError("record_function entered")

        monkeypatch.setattr(torch.profiler, "record_function", boom)
        monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
        chains.augment_chain(*chain_args(), 64, "cuda_full")
    assert not fresh_recorder.on
    assert fresh_recorder.counts == {name: 1
                                     for name in PHASES + ("chain.call",)}
    assert fresh_recorder.counters == call_counters()
    chains.augment_chain(*chain_args(), 64, "cuda_full")
    assert fresh_recorder.counts["chain.call"] == 1

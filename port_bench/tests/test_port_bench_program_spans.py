"""The chain's host phases read from the program's own spans and counters
(``port_bench/recorder.py``): a traced run's profiled segment holds them,
a run's window and a program without the recorder do not."""

import json

import pytest
from torch.profiler import ProfilerActivity, profile

from port_bench import harness, run
from port_bench.drivers import chain, engine

from conftest import TINY, fake_profiled

from image_processor_pipeline_tpu_torch.utils import profiling

PHASES = ("chain_shifts_ms", "chain_h2d_ms", "chain_launch_ms",
          "chain_h2d_copies")


def cpu_profiled(fn, launches, spans):
    """``fake_profiled`` inside a real torch.profiler session on the CPU,
    as the card's profiled segment runs its calls."""
    with profile(activities=[ProfilerActivity.CPU]):
        return fake_profiled(fn, launches, spans)


@pytest.fixture
def fresh_recorder():
    rec = profiling.RECORDER
    rec.reset()
    yield rec
    rec.reset()


def test_a_traced_run_reports_the_chain_phases(tiny, monkeypatch,
                                               fresh_recorder):
    monkeypatch.setattr(chain, "profiled", cpu_profiled)
    line, _ = run.run("chain640.b16", 2**33 + 4, 0.3, True, device="cpu")
    metrics = json.loads(line)["metrics"]
    assert set(PHASES) <= set(metrics)
    assert metrics["chain_h2d_copies"] == {"value": 7.0, "unit": "copies"}
    for name in PHASES[:3]:
        assert metrics[name]["unit"] == "ms"
        assert metrics[name]["value"] > 0
    # only the profiled segment's calls: the window ran with it off
    calls = fresh_recorder.counts["chain.call"]
    assert calls == TINY["chain"]["profile_calls"]
    assert not fresh_recorder.on


@pytest.mark.parametrize("trace", [False, True])
def test_a_run_without_a_profiler_session_leaves_the_recorder_empty(
        tiny, monkeypatch, fresh_recorder, trace):
    for mod in (chain, engine):
        monkeypatch.setattr(mod, "profiled", fake_profiled)
    line, _ = run.run("chain640.b16", 2**31 + 29, 0.3, trace, device="cpu")
    rec = fresh_recorder
    assert not rec.on and rec.totals == rec.counters == {}
    metrics = json.loads(line)["metrics"]
    assert not set(PHASES) & set(metrics)
    if not trace:
        cell = harness.load_cell("chain640.b16")
        assert set(metrics) == {m["name"] for m in cell.end_to_end}


@pytest.mark.parametrize("name", PHASES)
def test_a_program_without_the_recorder_gives_none(monkeypatch,
                                                   fresh_recorder, name):
    """The parent's program: its profiling module has no RECORDER."""
    with profiling.recording(), profiling.span("chain.call"):
        for phase in ("chain.shifts", "chain.h2d", "chain.launch"):
            with profiling.span(phase):
                pass
        profiling.count("chain.h2d_copies", 7)
    records = {"trace": harness.Trace()}
    read = harness.metric_reader(name)
    assert read(records) is not None
    monkeypatch.delattr(profiling, "RECORDER")
    assert read(records) is None

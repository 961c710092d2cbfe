"""``chain_draws_native``: the program's counter ``chain.draws_native``
a chain call, read from the recorder after a traced run's profiled
segment; None where the recorder holds no such counter or the program has
no recorder."""

import json

import pytest
from torch.profiler import ProfilerActivity, profile

from port_bench import harness, run
from port_bench.drivers import chain

from conftest import fake_profiled

from image_processor_pipeline_tpu_torch.ops import native_draws
from image_processor_pipeline_tpu_torch.utils import profiling

NAME = "chain_draws_native"


@pytest.fixture
def fresh_recorder():
    rec = profiling.RECORDER
    rec.reset()
    yield rec
    rec.reset()


def calls(n, draws_native):
    """``n`` chain calls' spans in the recorder, each counting the native
    draw functions it used."""
    with profiling.recording():
        for _ in range(n):
            with profiling.span("chain.call"):
                if draws_native:
                    profiling.count("chain.draws_native", draws_native)
                profiling.count("chain.h2d_copies", 7)


def test_two_native_draws_a_call_read_2(fresh_recorder):
    calls(5, draws_native=2)
    read = harness.metric_reader(NAME)
    assert read({"trace": harness.Trace()}) == 2.0


def test_a_recorder_without_the_counter_reads_none(fresh_recorder):
    calls(5, draws_native=0)
    read = harness.metric_reader(NAME)
    assert read({"trace": harness.Trace()}) is None
    assert read({}) is None


def test_a_program_without_the_recorder_reads_none(monkeypatch,
                                                    fresh_recorder):
    calls(3, draws_native=2)
    monkeypatch.delattr(profiling, "RECORDER")
    assert harness.metric_reader(NAME)({"trace": harness.Trace()}) is None


def test_a_traced_run_reports_the_native_draws(tiny, monkeypatch,
                                               fresh_recorder):
    """On the CPU, with the library built, a traced line carries the
    metric at 2.0 draw calls a call."""
    assert native_draws.available(), native_draws.build_error()

    def cpu_profiled(fn, launches, spans):
        with profile(activities=[ProfilerActivity.CPU]):
            return fake_profiled(fn, launches, spans)

    monkeypatch.setattr(chain, "profiled", cpu_profiled)
    line, _ = run.run("chain640.b16", 2**33 + 6, 0.3, True, device="cpu")
    metrics = json.loads(line)["metrics"]
    assert metrics[NAME] == {"value": 2.0, "unit": "draw_calls"}

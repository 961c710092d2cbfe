"""``chain_factors_native_share``: the program's counter
``chain.factors_native`` a chain call, read from the recorder after a
traced run's profiled segment; None where the recorder holds no such
counter (the CPU, another mode, or a program whose packed path takes its
shear factors from torch) or the program has no recorder."""

import json

import pytest
from torch.profiler import ProfilerActivity, profile

from port_bench import harness, run
from port_bench.drivers import chain

from conftest import fake_profiled

from image_processor_pipeline_tpu_torch.utils import profiling

NAME = "chain_factors_native_share"


@pytest.fixture
def fresh_recorder():
    rec = profiling.RECORDER
    rec.reset()
    yield rec
    rec.reset()


def calls(n, native):
    """``n`` packed chain calls' spans in the recorder, the first
    ``native`` of them with their factors from the native pass."""
    with profiling.recording():
        for i in range(n):
            with profiling.span("chain.call"):
                profiling.count("chain.draws_native", 2)
                if i < native:
                    profiling.count("chain.factors_native")
                profiling.count("chain.h2d_copies")
                profiling.count("chain.packed")


@pytest.mark.parametrize("n,native,want", [(5, 5, 1.0), (4, 1, 0.25)])
def test_the_share_of_calls_with_native_factors(fresh_recorder, n, native,
                                                want):
    calls(n, native)
    read = harness.metric_reader(NAME)
    assert read({"trace": harness.Trace()}) == want


def test_a_recorder_without_the_counter_reads_none(fresh_recorder):
    """A program whose packed path takes its factors from torch."""
    calls(5, native=0)
    read = harness.metric_reader(NAME)
    assert read({"trace": harness.Trace()}) is None
    assert read({}) is None


def test_a_program_without_the_recorder_reads_none(monkeypatch,
                                                    fresh_recorder):
    calls(3, native=3)
    monkeypatch.delattr(profiling, "RECORDER")
    assert harness.metric_reader(NAME)({"trace": harness.Trace()}) is None


def test_a_traced_cpu_run_leaves_the_metric_out(tiny, monkeypatch,
                                                fresh_recorder):
    """On the CPU the chain takes ``geometry.shear_params``: the traced
    line has no ``chain_factors_native_share``."""

    def cpu_profiled(fn, launches, spans):
        with profile(activities=[ProfilerActivity.CPU]):
            return fake_profiled(fn, launches, spans)

    monkeypatch.setattr(chain, "profiled", cpu_profiled)
    line, _ = run.run("chain640.b16", 2**33 + 21, 0.3, True, device="cpu")
    metrics = json.loads(line)["metrics"]
    assert NAME not in metrics
    assert metrics["chain_h2d_copies"] == {"value": 7.0, "unit": "copies"}

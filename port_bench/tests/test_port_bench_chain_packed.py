"""``chain_packed_share``: the program's counter ``chain.packed`` a chain
call, read from the recorder after a traced run's profiled segment; None
where the recorder holds no such counter (the CPU, another mode, a build
without the native library, or a program without the packed path) or the
program has no recorder."""

import json

import pytest
from torch.profiler import ProfilerActivity, profile

from port_bench import harness, run
from port_bench.drivers import chain

from conftest import fake_profiled

from image_processor_pipeline_tpu_torch.utils import profiling

NAME = "chain_packed_share"


@pytest.fixture
def fresh_recorder():
    rec = profiling.RECORDER
    rec.reset()
    yield rec
    rec.reset()


def calls(n, packed):
    """``n`` chain calls' spans in the recorder, the first ``packed`` of
    them served by the packed path."""
    with profiling.recording():
        for i in range(n):
            with profiling.span("chain.call"):
                profiling.count("chain.draws_native", 2)
                if i < packed:
                    profiling.count("chain.h2d_copies")
                    profiling.count("chain.packed")
                else:
                    profiling.count("chain.h2d_copies", 7)


@pytest.mark.parametrize("n,packed,want", [(5, 5, 1.0), (4, 1, 0.25)])
def test_the_share_of_packed_calls(fresh_recorder, n, packed, want):
    calls(n, packed)
    read = harness.metric_reader(NAME)
    assert read({"trace": harness.Trace()}) == want


def test_a_recorder_without_the_counter_reads_none(fresh_recorder):
    calls(5, packed=0)
    read = harness.metric_reader(NAME)
    assert read({"trace": harness.Trace()}) is None
    assert read({}) is None


def test_a_program_without_the_recorder_reads_none(monkeypatch,
                                                    fresh_recorder):
    calls(3, packed=3)
    monkeypatch.delattr(profiling, "RECORDER")
    assert harness.metric_reader(NAME)({"trace": harness.Trace()}) is None


def test_a_traced_cpu_run_leaves_the_metric_out(tiny, monkeypatch,
                                                fresh_recorder):
    """On the CPU the chain copies its rows one array at a time: the
    traced line has no ``chain_packed_share`` and counts 7 copies."""

    def cpu_profiled(fn, launches, spans):
        with profile(activities=[ProfilerActivity.CPU]):
            return fake_profiled(fn, launches, spans)

    monkeypatch.setattr(chain, "profiled", cpu_profiled)
    line, _ = run.run("chain640.b16", 2**33 + 20, 0.3, True, device="cpu")
    metrics = json.loads(line)["metrics"]
    assert NAME not in metrics
    assert metrics["chain_h2d_copies"] == {"value": 7.0, "unit": "copies"}

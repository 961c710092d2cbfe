"""The result line: its keys and their order, with the card's timing
stubbed, and what the command prints last on each stream."""

import json
import os

import pytest

from port_bench import harness, run
from port_bench.drivers import chain, engine

from conftest import fake_profiled


@pytest.mark.parametrize("name", ["chain640.b16", "rotsym640.jpeg",
                                  "fusedchain640.clutter"])
@pytest.mark.parametrize("trace", [False, True])
def test_last_line_keys(tiny, monkeypatch, name, trace):
    for mod in (chain, engine):
        monkeypatch.setattr(mod, "profiled", fake_profiled)
    line, checks = run.run(name, 2**31 + 17, 0.3, trace, device="cpu")
    out = json.loads(line)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    dev = {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(out["device"]) == dev | ({"busy_s", "window_s"} if trace
                                        else set())
    cell = harness.load_cell(name)
    wanted = cell.per_layer if trace else cell.end_to_end
    assert set(out["metrics"]) <= {m["name"] for m in wanted}
    if trace:
        assert out["device"]["busy_s"] > 0
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in out["breakdown"].values())
    else:
        assert "setup_s" in out["metrics"]
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(out["checks"]) == {c.name for c in checks}


def test_the_command_prints_the_line_last_and_the_checks_last(
        monkeypatch, capsys):
    checks = [harness.Check("x.bytes_differ", 0, 0)]
    monkeypatch.setattr(run, "run", lambda *a, **k: ('{"correct": true}',
                                                     checks))
    # the configuration's env is set first (restored at teardown)
    monkeypatch.delenv("OMP_NUM_THREADS", raising=False)
    assert run.main(["--workload", "chain640.b16", "--seed", "8589934597",
                     "--seconds", "1", "--trace", "0"]) == 0
    assert os.environ["OMP_NUM_THREADS"] == "1"
    out, err = capsys.readouterr()
    assert out.strip().splitlines()[-1] == '{"correct": true}'
    assert err.strip().splitlines()[-1] == \
        "check x.bytes_differ: 0 (limit 0) ok"


def test_breakdown_names_idle_time_by_the_open_spans():
    trace = harness.Trace(device=[("k", 10.0, 20.0), ("k", 30.0, 40.0)],
                          spans=[("save", 0.0, 25.0), ("load", 22.0, 60.0)],
                          window=(0.0, 100.0))
    assert harness.busy_seconds(trace) == pytest.approx(20e-6)
    gaps = dict(harness.breakdown(trace)["idle_gaps"])
    # idle: [0, 10], [20, 30], [40, 100]
    assert gaps["save"] == pytest.approx(15e-6)
    assert gaps["load"] == pytest.approx(28e-6)
    assert gaps["none"] == pytest.approx(40e-6)

"""Shared pieces of the benchmark's tests: the repository on the path,
the ``cuda`` marker, and the cells cut to a size the CPU runs in seconds
(the same configurations and traffic files, fewer and smaller images)."""

import copy
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from port_bench import harness  # noqa: E402

#: cells held back from BENCHMARK.json, in its layout, with their entries
HELD_BACK = REPO / "port_bench" / "held_back.json"
_load = harness.load_cell


def _load_cell(name: str) -> harness.Cell:
    """A cell of BENCHMARK.json, else of held_back.json."""
    try:
        return _load(name)
    except harness.BenchError:
        return _load(name, HELD_BACK)


#: what each kind of cell is cut to here
TINY = {
    "engine": {"pool_inputs": 8, "pass_inputs": 4,
               "dataset": {"width": 64, "height": 48}},
    "chain": {"batch": 2, "pool_batches": 2, "warmup_calls": 1,
              "check_calls": 2, "profile_calls": 2},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the port's kernels have no CPU "
        "mode); skips without one")


def tiny_cell(name: str, **options) -> harness.Cell:
    """The cell ``name`` of BENCHMARK.json cut to a CPU test's size;
    ``options`` are added to every engine step's options."""
    cell = copy.deepcopy(_load_cell(name))
    for k, v in TINY[cell.config["driver"]].items():
        if isinstance(v, dict):
            cell.traffic[k].update(v)
        else:
            cell.traffic[k] = v
    for step in cell.config.get("steps", ()):
        step["options"].update(options)
    return cell


@pytest.fixture
def tiny(monkeypatch):
    """harness.load_cell answering with tiny cells; returns a function
    that sets the options added to the engine's steps."""
    extra = {}
    monkeypatch.setattr(harness, "load_cell",
                        lambda name: tiny_cell(name, **extra))
    return extra.update


def all_cells():
    import json

    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    return [w["name"] for w in spec["workloads"]]


def fake_profiled(fn, launches, spans):
    """A profiled segment on the CPU: ``fn`` runs, and the trace holds one
    device operation per counted launch and the spans below."""
    result = fn()
    trace = harness.Trace(
        device=[(k, 100.0 + i, 101.0 + i)
                for k, sizes in launches.items() for i in range(len(sizes))]
        + [("memcpy", 10.0, 20.0)],
        spans=[("save", 0.0, 50.0), ("load", 40.0, 60.0)],
        window=(0.0, 1000.0),
        launches={k: list(v) for k, v in launches.items()})
    return trace, result

"""``engine_cpu_ms_per_image``: the process's CPU seconds over the engine's
window, an image written."""

import json
import math

import pytest

from port_bench import harness, run
from port_bench.drivers import engine

from conftest import fake_profiled


def test_the_reader_divides_the_window_cpu_by_the_images():
    read = harness.metric_reader("engine_cpu_ms_per_image")
    assert read({"window_cpu_s": (2.0, 3.5), "images": 30}) == \
        pytest.approx(50.0)
    # no pass in the window, or no readings: nothing to read
    assert read({"window_cpu_s": (2.0, 2.0), "images": 0}) is None
    assert read({"images": 30}) is None


def test_a_traced_tiny_engine_run_reports_it(tiny, monkeypatch):
    monkeypatch.setattr(engine, "profiled", fake_profiled)
    line, _ = run.run("rotsym640.jpeg", 2**31 + 23, 0.3, True, device="cpu")
    out = json.loads(line)
    value = out["metrics"]["engine_cpu_ms_per_image"]
    assert value["unit"] == "ms"
    assert 0 < value["value"] and math.isfinite(value["value"])

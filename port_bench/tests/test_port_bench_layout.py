"""BENCHMARK.json against its contract, and every name in it against the
file that holds it."""

import json
import re

import pytest

from conftest import REPO, all_cells
from port_bench import counts, harness

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "port_bench/run.py"]
    assert SPEC["paths"] == ["port_bench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entries_keep_to_their_keys_names_and_lengths():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source",
                           "workloads"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}}
    for section, allowed in keys.items():
        names = [e["name"] for e in SPEC[section]]
        assert len(names) == len(set(names)), section
        for e in SPEC[section]:
            assert set(e) <= allowed, (section, e["name"])
            assert NAME.match(e["name"]), e["name"]
            for k in ("why", "layer", "source"):
                if k in e and section in ("configs", "workloads",
                                          "per_layer"):
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")
                assert e["source"] in SOURCES


def test_bounds_and_what_every_cell_reports():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for cell in all_cells():
        c = harness.load_cell(cell)
        names = {m["name"] for m in c.end_to_end}
        assert "setup_s" in names and len(names) >= 2, cell
        assert c.per_layer, cell
        for m in c.per_layer:
            assert m["moves"] in names, (cell, m["name"])
    for w in SPEC["workloads"]:
        assert w["chips"] == 1


@pytest.mark.parametrize("spec_file", ["BENCHMARK.json",
                                       "port_bench/held_back.json"])
def test_every_name_resolves_to_its_file(spec_file):
    spec = json.loads((REPO / spec_file).read_text())
    for w in spec["workloads"]:
        cell = w["name"]
        c = harness.load_cell(cell, REPO / spec_file)
        drv = harness.driver(c.config["driver"])
        for fn in ("setup", "window", "records", "check", "close"):
            assert callable(getattr(drv, fn)), (cell, fn)
        assert callable(harness.generator(c.traffic["generator"]).make)
        for step in c.config.get("steps", ()):
            ref = __import__(f"port_bench.reference.steps.{step['transform']}",
                             fromlist=["apply"])
            assert callable(ref.apply) and callable(ref.outputs)
    for m in spec["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))
    for c in spec["configs"]:
        assert (REPO / c["file"]).is_file()
        assert c["file"].startswith("port_bench/")
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert {"source", "assumed", "reduced", "driver"} <= set(cfg)


@pytest.mark.parametrize("spec_file", ["BENCHMARK.json",
                                       "port_bench/held_back.json"])
def test_a_metric_reader_that_finds_nothing_returns_none(spec_file):
    for m in json.loads((REPO / spec_file).read_text())["per_layer"]:
        assert harness.metric_reader(m["name"])({}) is None, m["name"]


@pytest.mark.parametrize("fn, args, expected", [
    (counts.chain_bytes, (512, 64, 3), 117_705_728),
    (counts.rotate_bytes, (768, 32, 4), 151_191_680),
])
def test_byte_counts_hold_the_bring_up_table(fn, args, expected):
    assert fn(*args) == expected

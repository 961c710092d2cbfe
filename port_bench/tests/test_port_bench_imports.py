"""Nothing the benchmark runs loads JAX or the JAX package, and a run ends
without a result where it must."""

import ast
import shutil
import subprocess
import sys
import types

import pytest

from conftest import REPO, all_cells, fake_profiled
from port_bench import harness

BENCH = REPO / "port_bench"


def _imported_tops(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        tops = set(_imported_tops(path))
        assert not tops & set(harness.FORBIDDEN), (path, tops)


def test_loading_every_module_loads_no_forbidden_module():
    code = (
        "import sys, importlib, pathlib\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from port_bench import harness, run, control\n"
        "for p in sorted(pathlib.Path(harness.BENCH_DIR).rglob('*.py')):\n"
        "    rel = p.relative_to(harness.BENCH_DIR.parent)\n"
        "    if 'tests' in rel.parts: continue\n"
        "    if rel.parts[1] == 'metrics':\n"
        "        harness.metric_reader(p.stem)\n"
        "    else:\n"
        "        importlib.import_module('.'.join(rel.with_suffix('').parts))\n"
        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_like",
                        types.ModuleType("jaxtyping_like"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "image_processor_pipeline_tpu.ops",
                        types.ModuleType("image_processor_pipeline_tpu.ops"))
    assert harness.forbidden_modules() == ["image_processor_pipeline_tpu.ops"]


@pytest.mark.parametrize("when", ["before", "records", "check"])
def test_a_run_that_loaded_jax_gives_no_result(tiny, monkeypatch, when):
    """jax loaded before the window, by the traced segment after it, or
    by the reference's check last of all: no result line."""
    from port_bench import run
    from port_bench.drivers import chain

    def plant(fn):
        def loading(*a, **k):
            monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
            return fn(*a, **k)
        return loading

    if when == "before":
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    else:
        monkeypatch.setattr(chain, when, plant(getattr(chain, when)))
        monkeypatch.setattr(chain, "profiled", fake_profiled)
    with pytest.raises(harness.BenchError, match="jax"):
        run.run("chain640.b16", 5, 0.05, when == "records", device="cpu")


def test_without_a_card_the_command_exits_nonzero_and_prints_nothing():
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", all_cells()[0],
         "--seed", "2147483661", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_checkout_of_the_benchmark_alone_exits_nonzero(tmp_path):
    """Past the look for a card (``device="cpu"``), a directory with only
    BENCHMARK.json and port_bench/ fails: the program is not there."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("from port_bench import run; "
            f"run.run({all_cells()[0]!r}, 7, 1.0, False, device='cpu')")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "image_processor_pipeline_tpu_torch" in out.stderr
    assert out.stdout.strip() == ""

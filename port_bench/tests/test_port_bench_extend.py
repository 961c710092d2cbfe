"""A cell and a per-layer metric are added as files and BENCHMARK.json
entries alone: in a copy of the benchmark, a new traffic file and a new
metric reader run with no file of the harness edited."""

import hashlib
import json
import shutil
import subprocess
import sys

from conftest import REPO


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_stub_cell_and_metric_run_without_editing_the_harness(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path / "port_bench")

    bench = tmp_path / "port_bench"
    traffic = json.loads((bench / "workloads" / "chain640.b16.json")
                         .read_text())
    traffic.update(batch=2, pool_batches=2, warmup_calls=1, check_calls=1,
                   profile_calls=1)
    (bench / "workloads" / "chain640.stub.json").write_text(
        json.dumps(traffic))
    (bench / "metrics" / "stub_calls.py").write_text(
        "def read(records):\n"
        "    trace = records.get('trace')\n"
        "    return None if trace is None else float(len(trace.device))\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "chain640.stub", "config": "chain640",
                              "traffic": "stub", "chips": 1,
                              "why": "a stub"})
    for m in spec["end_to_end"]:
        if m["name"] == "chain_images_per_s":
            m["workloads"].append("chain640.stub")
    spec["per_layer"].append({
        "name": "stub_calls", "unit": "records", "better": "higher",
        "source": "device_trace", "layer": "device",
        "moves": "chain_images_per_s", "workloads": ["chain640.stub"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    # the copy's own harness, on the CPU, its profiler stubbed
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {str(REPO)!r}]\n"
        "from port_bench import harness, run\n"
        "from port_bench.drivers import chain\n"
        "assert harness.__file__.startswith(sys.path[0])\n"
        "def fake(fn, launches, spans):\n"
        "    fn()\n"
        "    return harness.Trace(device=[('k', 1.0, 2.0)],\n"
        "                         window=(0.0, 10.0)), None\n"
        "chain.profiled = fake\n"
        "line, _ = run.run('chain640.stub', 2**32 + 5, 0.2, True,\n"
        "                  device='cpu')\n"
        "print(line)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["metrics"]["stub_calls"] == {"value": 1.0,
                                               "unit": "records"}
    after = _digests(bench)
    assert {k: v for k, v in after.items() if k in before} == before

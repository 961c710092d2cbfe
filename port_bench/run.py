"""Run one cell of the port's benchmark once.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds BENCHMARK.json, port_bench/ and the
package image_processor_pipeline_tpu_torch.  The cell's configuration
names its runner (port_bench/drivers/<kind>.py); its traffic file is
port_bench/workloads/<cell>.json; each per-layer metric is read by
port_bench/metrics/<metric>.py.  The run sets up (inputs from the seed,
kernels built, every shape warmed up), measures for --seconds, checks
what the window produced against the plain reference, and prints one JSON
line last on standard output: the end-to-end metrics with --trace 0, the
per-layer metrics from spans, counters and a profiled segment with
--trace 1.  A configuration's ``env`` (the environment its launcher
gives the process) is set before torch is imported.  It exits non-zero
with no result when the card is missing, when a module of JAX or of the
JAX package was loaded by the time the result is due, or on any error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench import harness  # noqa: E402


def run(workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: float = None):
    """One run; returns (result line, checks).  ``device="cpu"`` skips the
    look for a card (the harness's tests drive a run on the CPU)."""
    import torch

    t_start = T_START if t_start is None else t_start
    cell = harness.load_cell(workload)
    if device == "cuda":
        kind = harness.require_cards(cell.chips)
        torch.cuda.reset_peak_memory_stats()
    else:
        kind = "cpu"
    drv = harness.driver(cell.config["driver"])
    st = drv.setup(seed, cell.config, cell.traffic, device)
    try:
        setup_s = time.perf_counter() - t_start
        res = drv.window(st, seconds, trace)
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        dev = {"platform": "gpu" if device == "cuda" else "cpu",
               "kind": kind, "count": cell.chips,
               "memory_peak_bytes": int(peak)}
        metrics, brk = {}, None
        if trace:
            rec = dict(drv.records(st), kind=kind)
            for m in cell.per_layer:
                value = harness.metric_reader(m["name"])(rec)
                if value is not None:
                    metrics[m["name"]] = {"value": float(value),
                                          "unit": m["unit"]}
            dev["busy_s"] = harness.busy_seconds(rec["trace"])
            dev["window_s"] = harness.window_seconds(rec["trace"])
            brk = harness.breakdown(rec["trace"])
        else:
            values = dict(res["e2e"], setup_s=setup_s)
            for m in cell.end_to_end:
                if m["name"] in values:
                    metrics[m["name"]] = {"value": float(values[m["name"]]),
                                          "unit": m["unit"]}
        if "written_bytes" in res:
            print(f"wrote {res['written_bytes']} bytes of outputs in the "
                  "window's passes", file=sys.stderr)
        checks = drv.check(st)
    finally:
        drv.close(st)
    # last: the traced segment and the reference ran after the window
    found = harness.forbidden_modules()
    if found:
        raise harness.BenchError("modules of JAX or of the JAX package "
                                 f"were loaded: {found}")
    correct = all(c.ok for c in checks) and res["failed"] == 0
    line = harness.result_line(correct, res["attempted"], res["failed"],
                               metrics, dev, checks, brk)
    return line, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    try:
        # the configuration's environment (the launcher's settings) before
        # torch and numpy are imported, which read it once
        cell = harness.load_cell(a.workload)
        os.environ.update(cell.config.get("env", {}))
        line, checks = run(a.workload, a.seed, a.seconds, bool(a.trace))
    except harness.BenchError as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return 2
    sys.stdout.flush()
    print(line, flush=True)
    print(harness.check_lines(checks), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

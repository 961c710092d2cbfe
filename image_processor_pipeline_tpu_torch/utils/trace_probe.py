"""How often a traced engine step's trace holds every GPU record it should.

The traced step is ``RandomRotations(method="shear")`` over 8 PNGs of
640 x 480: one batch, one launch of ``shear_tile_kernel`` among some 85
kernels and 100 GPU records.  It is traced two ways:

  bare          a plain ``torch.profiler.profile`` session around the step,
                the card synchronised before it ends;
  device_trace  the step's own ``trace_dir`` (utils/profiling.py: the
                profiler warmed up with small launches first).

Two experiments, each printing ``PROBE`` JSON lines; the last line sums
them up:

  fresh  a few runs of each way in each of several fresh processes;
  long   in this process, after one CUDA-only session around many small
         launches, runs of the two ways in turn.

Exits 1 when a ``device_trace`` trace misses the kernel.  Needs a CUDA
card:

    python -m image_processor_pipeline_tpu_torch.utils.trace_probe \\
        [--processes 2] [--runs 3] [--long 8] [--big 50000]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import tempfile
from pathlib import Path

VARIANTS = ("bare", "device_trace")
KERNEL = "shear_tile_kernel"


def read_trace(trace_dir: Path) -> dict:
    """One trace's kernel and GPU record counts, whether it names the
    kernel, and its clocks: ``launch_to_kernel_ms`` the least and most
    time from a launch call on the host to its kernel's start on the card
    (matched by correlation id; negative when the two clocks disagree),
    ``host_span_ms`` the host events' span and ``kernels_from_ms`` where
    the kernels start and end within it."""
    traces = list(trace_dir.glob("*.pt.trace.json"))
    if len(traces) != 1:
        return {"traces": len(traces), "kernels": 0, "gpu_events": 0,
                "names_kernel": False}
    events = [e for e in json.loads(traces[0].read_text()).get(
        "traceEvents", []) if e.get("ph") == "X"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    gpu = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    launches = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    skew = [(k["ts"] - launches[k["args"]["correlation"]]) / 1e3
            for k in kernels
            if k.get("args", {}).get("correlation") in launches]
    host = [e for e in events if e.get("cat") not in (
        "kernel", "gpu_memcpy", "gpu_memset")]
    out = {"traces": 1, "kernels": len(kernels), "gpu_events": len(gpu),
           "names_kernel": any(KERNEL in e.get("name", "")
                               for e in kernels)}
    if skew:
        out["launch_to_kernel_ms"] = [min(skew), max(skew)]
    if host:
        t0 = min(e["ts"] for e in host)
        out["host_span_ms"] = (max(e["ts"] + e.get("dur", 0)
                                   for e in host) - t0) / 1e3
        if kernels:
            out["kernels_from_ms"] = [
                (min(k["ts"] for k in kernels) - t0) / 1e3,
                (max(k["ts"] + k.get("dur", 0) for k in kernels) - t0) / 1e3]
    return out


@contextlib.contextmanager
def _bare(trace_dir: Path):
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    trace_dir.mkdir(parents=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 on_trace_ready=tensorboard_trace_handler(str(trace_dir))):
        yield
        torch.cuda.synchronize()


def _traced_run(root: Path, variant: str, tag: str) -> dict:
    """Run the traced step one way; the trace's ``read_trace``."""
    from image_processor_pipeline_tpu_torch import ProcessingStep
    from image_processor_pipeline_tpu_torch.transforms import RandomRotations

    trace_dir = root / "traces" / tag
    step = ProcessingStep(
        "traced", RandomRotations(), input_dirs=[root / "imgs"],
        output_dirs=[root / "out" / tag], seed=3, device="cuda", workers=8,
        trace_dir=trace_dir if variant == "device_trace" else None,
        options={"method": "shear", "num_rotations": 1})
    with (_bare(trace_dir) if variant == "bare"
          else contextlib.nullcontext()):
        step.run(progress=False)
    return dict(variant=variant, **read_trace(trace_dir))


def _long(root: Path, rounds: int, big: int) -> list:
    import torch
    from torch.profiler import ProfilerActivity, profile

    x = torch.zeros(1, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(big):
            x.add_(1)
        torch.cuda.synchronize()
    prof.events()
    runs = [_traced_run(root, variant, f"long_{variant}_{i}")
            for i in range(rounds) for variant in VARIANTS]
    print("PROBE " + json.dumps({"long": runs}), flush=True)
    return runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--long", type=int, default=8)
    ap.add_argument("--big", type=int, default=50000,
                    help="small launches in the long experiment's first "
                         "session")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        runs = [_traced_run(args.child, variant, f"{variant}_{i}")
                for i in range(args.runs) for variant in VARIANTS]
        print("PROBE " + json.dumps({"fresh": runs}))
        return 0

    import numpy as np
    import torch
    from PIL import Image

    from image_processor_pipeline_tpu_torch import kernels

    if not torch.cuda.is_available():
        raise SystemExit("trace_probe needs a CUDA card")
    kernels.library()  # built once, before any trace
    runs = {"fresh": [], "long": []}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        rng = np.random.default_rng(0)
        (tmp / "imgs").mkdir()
        for i in range(8):
            Image.fromarray(rng.integers(0, 256, (480, 640, 3),
                                         dtype=np.uint8)).save(
                tmp / "imgs" / f"im_{i:02d}.png")
        for p in range(args.processes):
            root = tmp / f"p{p}"
            root.mkdir()
            (root / "imgs").symlink_to(tmp / "imgs")
            proc = subprocess.run(
                [sys.executable, "-m", __spec__.name, "--child", str(root),
                 "--runs", str(args.runs)], capture_output=True, text=True,
                timeout=600)
            lines = [line for line in proc.stdout.splitlines()
                     if line.startswith("PROBE ")]
            if proc.returncode or len(lines) != 1:
                raise RuntimeError(f"process {p} failed:\n"
                                   f"{proc.stdout[-2000:]}"
                                   f"{proc.stderr[-4000:]}")
            print(lines[0], flush=True)
            runs["fresh"] += json.loads(lines[0][6:])["fresh"]
        if args.long:
            runs["long"] = _long(tmp, args.long, args.big)
    summary = {
        f"{exp} {variant}": {
            "runs": len(got),
            "names_kernel": sum(r["names_kernel"] for r in got),
            "gpu_events": [r["gpu_events"] for r in got]}
        for exp in runs for variant in VARIANTS
        for got in [[r for r in runs[exp] if r["variant"] == variant]]}
    print(json.dumps(summary))
    return 0 if all(r["names_kernel"] for exp in runs.values()
                    for r in exp if r["variant"] == "device_trace") else 1


if __name__ == "__main__":
    sys.exit(main())

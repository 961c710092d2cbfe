"""Runner of ``chain`` configurations: the flagship augment chain
(``models.chains.augment_chain``) in a closed loop, one call after
another, each ending in ``torch.cuda.synchronize()``.

Call ``i`` takes canvas batch ``i % pool_batches`` of the pool made at
set-up and the seeds ``base + i * B + arange(B)``.  The rate is the
images of all calls over the host-clock time from the window's start to
the last call's end; each call's time, from the previous call's end to
its own (95th percentile: a per-layer metric), on the same clock.  The
window adds no work of its own to the calls.  A sample of calls,
drawn from the seed, keeps its outputs; once the window has closed the
plain reference (``reference/chain.py``) recomputes them from the same
canvases, boxes and seeds, byte for byte.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from image_processor_pipeline_tpu_torch import kernels
from image_processor_pipeline_tpu_torch.models import chains
from port_bench import counts
from port_bench.harness import Check, Spans, generator, profiled
from port_bench.reference import chain as reference

#: the chain's kernel, as the profiler names it
K1 = "chain_cluster_kernel"


@dataclass
class State:
    cfg: Dict[str, Any]
    traffic: Dict[str, Any]
    device: torch.device
    canvases: List[torch.Tensor]
    boxes: np.ndarray
    base: int
    rng: np.random.Generator
    spans: Spans = field(default_factory=Spans)
    kept: List[tuple] = field(default_factory=list)
    calls: int = 0
    batch_ms_p95: Optional[float] = None


def _call(st: State, i: int, seed_base: int):
    B = st.traffic["batch"]
    k = i % len(st.canvases)
    seeds = seed_base + i * B + np.arange(B, dtype=np.int64)
    out = chains.augment_chain(st.canvases[k], st.boxes[k], seeds,
                               st.cfg["crop"], st.cfg["rotation"])
    return out, (k, seeds)


def setup(seed: int, cfg, traffic, device) -> State:
    """Build the kernels, make the pool and warm every shape up."""
    device = torch.device(device)
    t0 = time.perf_counter()
    if device.type == "cuda":
        kernels.library()
    t1 = time.perf_counter()
    canvases, boxes = generator(traffic["generator"]).make(seed, traffic,
                                                          device)
    rng = np.random.default_rng([seed, 3])
    st = State(cfg, traffic, device, canvases, boxes,
               base=int(rng.integers(0, 1 << 40)), rng=rng)
    # warm-up calls on seeds the window never uses
    for i in range(traffic["warmup_calls"]):
        _call(st, i, st.base + (1 << 41))
    _sync(device)
    print(f"chain set-up: kernels {t1 - t0:.3f} s, pool and warm-up "
          f"{time.perf_counter() - t1:.3f} s", file=sys.stderr)
    return st


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(st: State, seconds: float, trace: bool) -> Dict[str, Any]:
    """The measured window: calls until ``seconds`` have passed."""
    undo = []
    if trace:
        st.spans.timed = True
        undo = [st.spans.wrap(chains, "_crop_params", "draws"),
                st.spans.wrap(chains, "_flip_and_params", "draws")]
    keep = st.traffic["check_calls"]
    ends = []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    i = 0
    try:
        while True:
            out, args = _call(st, i, st.base)
            _sync(st.device)
            # a uniform sample of ``keep`` calls (reservoir)
            if i < keep:
                st.kept.append((out, args))
            else:
                j = int(st.rng.integers(0, i + 1))
                if j < keep:
                    st.kept[j] = (out, args)
            i += 1
            t1 = time.perf_counter()
            ends.append(t1)
            if t1 >= deadline:
                break
    finally:
        for u in undo:
            u()
    st.calls = i
    B = st.traffic["batch"]
    e2e = {"chain_images_per_s": B * i / (t1 - t0)}
    ms = 1e3 * np.diff([t0] + ends)
    st.batch_ms_p95 = float(np.percentile(ms, 95))
    print(f"chain: {i} calls; ms a call p50 {np.percentile(ms, 50):.3f}"
          f" p95 {st.batch_ms_p95:.3f} p99 {np.percentile(ms, 99):.3f}"
          f" max {ms.max():.3f}", file=sys.stderr)
    print("chain: images/s each 2 s: " + " ".join(
        f"{B * n / 2:.0f}" for n in np.bincount(
            ((np.asarray(ends) - t0) // 2).astype(int))), file=sys.stderr)
    return {"e2e": e2e, "attempted": B * i, "failed": 0}


def records(st: State) -> Dict[str, Any]:
    """The traced run's records: the draw spans of the window, and a
    profiled segment of ``profile_calls`` calls with the harness's spans
    (draws, launch, sync) and K1's launches."""
    B, S = st.traffic["batch"], st.cfg["crop"]
    C = st.traffic["channels"]
    launches = {K1: []}
    orig = chains.augment_fused_full

    def counted(*a, **k):
        launches[K1].append(counts.chain_bytes(S, B, C))
        return orig(*a, **k)

    undo = [st.spans.wrap(chains, "_crop_params", "draws"),
            st.spans.wrap(chains, "_flip_and_params", "draws")]
    chains.augment_fused_full = counted
    st.spans.timed = False

    def run():
        for i in range(st.traffic["profile_calls"]):
            with st.spans.span("launch"):
                _call(st, i, st.base + (1 << 42))
            with st.spans.span("sync"):
                _sync(st.device)

    try:
        trace, _ = profiled(run, launches, st.spans)
    finally:
        chains.augment_fused_full = orig
        for u in undo:
            u()
    # the window's draw spans (two functions a call), per call
    draws = st.spans.seconds.get("draws", [])
    draw_ms = 1e3 * sum(draws) / st.calls if st.calls and draws else None
    return {"trace": trace, "chain_draw_ms": draw_ms,
            "chain_batch_ms_p95": st.batch_ms_p95}


def check(st: State, dtype=torch.float32) -> List[Check]:
    """The kept calls' outputs against the reference, byte for byte, in
    blocks of 64 images; ``dtype`` other than float32 puts the reference
    at that precision in the program's place (the control)."""
    differ = gap = 0
    crop = st.cfg["crop"]
    for out, (k, seeds) in st.kept:
        for lo in range(0, len(seeds), 64):
            args = (st.canvases[k][lo:lo + 64], st.boxes[k][lo:lo + 64],
                    seeds[lo:lo + 64], crop)
            ref = reference.chain(*args)
            got = out[lo:lo + 64] if dtype == torch.float32 \
                else reference.chain(*args, dtype)
            if got.shape != ref.shape:
                differ, gap = differ + ref.numel(), 255
                continue
            d = (got.to(torch.int16) - ref.to(torch.int16)).abs()
            differ += int((d != 0).sum())
            gap = max(gap, int(d.max()))
    return [Check("chain.bytes_differ", differ, 0),
            Check("chain.max_gap", gap, 0)]


def close(st: State):
    st.kept.clear()
    st.canvases.clear()

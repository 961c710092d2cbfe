"""Runner of ``engine`` configurations: a ``ProcessingPipeline`` of the
configuration's ``ProcessingStep``s over a seeded dataset of files.

Set-up makes the dataset (the traffic file's generator,
``traffic/<generator>.py``) under a temporary directory, split into
groups of ``pass_inputs`` images, and runs one whole pass to build and
warm everything.  A configuration with ``"auto_fuse": true`` has each
pass's steps fused by the port's ``fuse.fuse_steps(steps, tier="byte")``
before they are wrapped and run, as ``ProcessingPipeline.run(
auto_fuse=True)`` would fuse them; a pass that still runs more than one
step ends the run without a result.  The window then runs passes back to
back, pass ``p`` over group ``p % groups`` with new step seeds into a
fresh output root; no pass starts after the deadline, and the window
closes when its last pass ends.  Every image file a step saves is
counted (the harness wraps ``save_item``), and the rate is the images of
the window's passes over the window's length.  Once the window has
closed, a sample of each pass's inputs, drawn from the seed, keeps its
outputs and the rest is deleted.  A traced run profiles one more
pass, over the next group.  Then the
plain reference (``reference/steps/<transform>.py``) makes those files
again from the same inputs and seeds, and each is compared: decoded
pixels for images, text for labels.  Of a fused configuration only the
last step's files are compared: the fused step writes no others.
"""

from __future__ import annotations

import importlib
import resource
import shutil
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List

import numpy as np
import torch

from image_processor_pipeline_tpu_torch import ProcessingPipeline, ProcessingStep
from image_processor_pipeline_tpu_torch import fuse, kernels
from image_processor_pipeline_tpu_torch import transforms as port_transforms
from image_processor_pipeline_tpu_torch.io import images as port_images
from image_processor_pipeline_tpu_torch.ops import ccl as port_ccl
from image_processor_pipeline_tpu_torch.ops import rotate as port_rotate
from port_bench import counts
from port_bench.harness import BenchError, Check, Spans, generator, profiled
from port_bench.reference import images as ref_images

#: the rotation kernel, as the profiler names it
K2 = "shear_tile_kernel"
#: the harness's span around each ``ops/ccl.py:label_components`` call
CCL_SPAN = "ccl"
IMAGE_SUFFIXES = {".jpg", ".jpeg", ".png"}


def step_reference(transform: str):
    """The reference of an engine step: reference/steps/<transform>.py."""
    return importlib.import_module(f"port_bench.reference.steps.{transform}")


@dataclass
class Pass:
    index: int
    group: int
    seeds: List[int]
    steps: List[Dict[str, Any]]
    images: int
    kept: List[str]


@dataclass
class State:
    cfg: Dict[str, Any]
    traffic: Dict[str, Any]
    device: torch.device
    root: Path
    dirs: List[tuple]
    rng: np.random.Generator
    spans: Spans = field(default_factory=Spans)
    saves: List[tuple] = field(default_factory=list)
    lock: threading.Lock = field(default_factory=threading.Lock)
    passes: List[Pass] = field(default_factory=list)
    #: the process's CPU seconds (user + system, every thread) at the
    #: window's start and at the end of its last pass
    cpu_start: float = 0.0
    cpu_end: float = 0.0


def _count_saves(st: State, transform):
    """Record (return time, image files) of each successful save; a
    ``save_item`` returns one path or a list of them."""
    orig = transform.save_item

    def counted(out, item, output_dirs, options):
        saved = orig(out, item, output_dirs, options)
        paths = [saved] if isinstance(saved, (str, Path)) else saved or ()
        n = sum(1 for p in paths
                if Path(p).suffix.lower() in IMAGE_SUFFIXES)
        with st.lock:
            st.saves.append((time.perf_counter(), n))
        return saved

    transform.save_item = counted


def _span_methods(st: State, transform):
    for attr, name in (("probe_item", "load"), ("load_item", "load"),
                       ("launch_batch", "dispatch"),
                       ("shrink_output", "fetch"), ("save_item", "save")):
        st.spans.wrap(transform, attr, name)


def _step_dirs(st: State, root: Path, group: int, sc):
    """(input dirs, output dirs) of a step: ``dataset:<imgs|labels>`` names
    the pass's input group, any other entry a directory under ``root``."""
    imgs, labels = st.dirs[group]
    dataset = {"dataset:imgs": imgs, "dataset:labels": labels}
    return ([dataset.get(d, root / d) for d in sc["inputs"]],
            [root / d for d in sc["outputs"]])


def _run_pass(st: State, index: int, root: Path, traced=False) -> Pass:
    group = index % len(st.dirs)
    seeds = [int(st.rng.integers(0, 1 << 31)) for _ in st.cfg["steps"]]
    first = len(st.saves)
    steps = []
    for sc, seed in zip(st.cfg["steps"], seeds):
        transform = getattr(port_transforms, sc["transform"])()
        inputs, outputs = _step_dirs(st, root, group, sc)
        steps.append(ProcessingStep(
            sc["name"], transform, input_dirs=inputs, output_dirs=outputs,
            pairing_method=sc["pairing"], seed=seed,
            options=dict(sc["options"]), workers=st.cfg["workers"],
            device=str(st.device)))
    if st.cfg.get("auto_fuse", False):
        # fused here, not by run(auto_fuse=True): that would replace the
        # transforms wrapped below by new ones at run time
        steps = fuse.fuse_steps(steps, verbose=False, tier="byte")
        if len(steps) > 1:
            raise BenchError(
                f"auto_fuse left {len(steps)} steps "
                f"({', '.join(s.name for s in steps)}): the configuration "
                "is measured fused or not at all")
    pipe = ProcessingPipeline()
    for step in steps:
        _count_saves(st, step.process_function)
        if traced:
            _span_methods(st, step.process_function)
        pipe.add_step(step)
    pipe.run(progress=False)
    # the StageMetrics of the steps that ran
    steps = [dict(s.metrics.as_dict(), name=s.name, workers=s.workers,
                  statuses=dict(s.status_counter)) for s in steps]
    with st.lock:
        images = sum(n for _, n in st.saves[first:])
    return Pass(index, group, seeds, steps, images, [])


def _item_names(st: State, group: int):
    imgs, labels = st.dirs[group]
    return [(p.name, q.name) for p, q in
            zip(sorted(imgs.iterdir()), sorted(labels.iterdir()))]


def _expected(st: State, group: int):
    """Per input item: [(step index, output dir, file name)] of every file
    the pass writes for it, and per step its item listing (sorted input
    names, as the engine pairs them)."""
    steps = st.cfg["steps"]
    items = _item_names(st, group)
    # the files each output directory receives, per input item
    by_dir: Dict[str, List[List[str]]] = {}
    listings = []
    for k, sc in enumerate(steps):
        ref = step_reference(sc["transform"])
        if sc["inputs"][0].startswith("dataset:"):
            per_item = [[names] for names in items]
        else:
            per_item = [[(n,) for n in names]
                        for names in by_dir[sc["inputs"][0]]]
        listings.append(sorted(x for group_ in per_item for x in group_))
        outs = [[ref.outputs(names, sc["options"]) for names in group_]
                for group_ in per_item]
        for d, out_dir in enumerate(sc["outputs"]):
            by_dir[out_dir] = [[nm for o in item for dd, nm in o if dd == d]
                               for item in outs]
    return items, listings, by_dir


def _keep(st: State, p: Pass, root: Path):
    """Move the files of a sample of the pass's inputs out of its root."""
    items, _, by_dir = _expected(st, p.group)
    k = min(st.traffic["check_inputs_per_pass"], len(items))
    chosen = sorted(st.rng.choice(len(items), k, replace=False).tolist())
    dest = st.root / "kept" / str(p.index)
    for out_dir, per_item in by_dir.items():
        (dest / out_dir).mkdir(parents=True, exist_ok=True)
        for i in chosen:
            for name in per_item[i]:
                src = root / out_dir / name
                if src.exists():
                    src.replace(dest / out_dir / name)
    p.kept = [items[i][0] for i in chosen]


def _cpu_seconds() -> float:
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


def setup(seed: int, cfg, traffic, device) -> State:
    """Make the dataset and run one pass to build and warm up."""
    device = torch.device(device)
    t0 = time.perf_counter()
    if device.type == "cuda":
        kernels.library()
    t1 = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="port_bench_"))
    try:
        ds = traffic["dataset"]
        groups = traffic["pool_inputs"] // traffic["pass_inputs"]
        dirs, mean = generator(traffic["generator"]).make(
            root / "data", traffic["pool_inputs"], groups, seed, ds, device,
            cfg["workers"])
        st = State(cfg, traffic, device, root, dirs,
                   np.random.default_rng([seed, 4]))
        t2 = time.perf_counter()
        for w in range(traffic["warmup_passes"]):
            warm = root / f"warm{w}"
            _run_pass(st, w, warm)
            shutil.rmtree(warm)
        st.saves.clear()
        print(f"engine set-up: kernels {t1 - t0:.3f} s, dataset "
              f"{t2 - t1:.3f} s (mean JPEG {mean:.0f} bytes), warm-up "
              f"{time.perf_counter() - t2:.3f} s", file=sys.stderr)
    except BaseException:
        shutil.rmtree(root, ignore_errors=True)
        raise
    return st


def window(st: State, seconds: float, trace: bool) -> Dict[str, Any]:
    """Passes back to back; none starts after ``seconds``.  The rate is
    every image the window's passes saved over the time from the window's
    start to the end of its last pass.  The harness's own work on the
    outputs (the sample kept, the rest deleted) waits until it closes."""
    t0 = time.perf_counter()
    st.cpu_start = st.cpu_end = _cpu_seconds()
    deadline = t0 + seconds
    roots = []
    while time.perf_counter() < deadline:
        index = len(st.passes)
        root = st.root / f"pass{index}"
        t, cpu = time.perf_counter(), st.cpu_end
        p = _run_pass(st, index, root)
        t_end = time.perf_counter()
        st.cpu_end = _cpu_seconds()
        walls = ", ".join(f"{s['name']} {s['wall_seconds']:.3f}"
                          for s in p.steps)
        print(f"engine pass {index}: {t_end - t:.3f} s ({walls}), "
              f"{p.images} images, CPU {st.cpu_end - cpu:.3f} s",
              file=sys.stderr)
        roots.append(root)
        st.passes.append(p)
    for p, root in zip(st.passes, roots):
        _keep(st, p, root)
    per = np.zeros(int((t_end - t0) // 2) + 1)
    for t, n in st.saves:
        per[min(int((t - t0) // 2), len(per) - 1)] += n
    print("engine: images/s each 2 s: " + " ".join(
        f"{n / 2:.0f}" for n in per), file=sys.stderr)
    t_kept = time.perf_counter()
    written = sum(f.stat().st_size for root in roots + [st.root / "kept"]
                  for f in root.rglob("*") if f.is_file())
    t_sized = time.perf_counter()
    for root in roots:
        shutil.rmtree(root)
    print(f"engine: after the window: sample kept {t_kept - t_end:.3f} s, "
          f"sizes {t_sized - t_kept:.3f} s, outputs deleted "
          f"{time.perf_counter() - t_sized:.3f} s", file=sys.stderr)
    images = sum(p.images for p in st.passes)
    attempted = sum(s["items"] for p in st.passes for s in p.steps)
    ok = sum(s["statuses"].get("Success", 0) for p in st.passes
             for s in p.steps)
    return {"e2e": {"written_images_per_s": images / (t_end - t0)},
            "attempted": attempted, "failed": attempted - ok,
            "written_bytes": written}


def _wrap_ccl(st: State, calls: List[tuple]):
    """Put a span (``CCL_SPAN``) around each ``ops/ccl.py:label_components``
    call, opened once the card has finished the work queued before it, so
    that the span's time is the labelling's own (it ends on a read-back of
    its flag, so its kernels have all run when it closes; in the window
    the labelling's first read-back waits on that queued work instead);
    the call is made with ``return_iters=True`` and ``calls`` receives
    (mask shape, per-item sweep counts on the device).  Returns a callable
    that puts the original back."""
    orig = port_ccl.label_components

    def labelled(fg, max_iters=4096, return_iters=False):
        if fg.is_cuda:
            torch.cuda.synchronize(fg.device)
        with st.spans.span(CCL_SPAN):
            lbl, iters = orig(fg, max_iters, return_iters=True)
        calls.append((tuple(fg.shape), iters, max_iters))
        return (lbl, iters) if return_iters else lbl

    port_ccl.label_components = labelled
    return lambda: setattr(port_ccl, "label_components", orig)


def _sweeps(iters, max_iters: int) -> int:
    """Sweeps a labelling ran: its items' largest count, rounded up to the
    host's look at the flag every ``CHECK_EVERY`` sweeps, as the loop runs
    them."""
    every = port_ccl.CHECK_EVERY
    n = int(iters.max()) if iters.numel() else 0
    return min(max_iters, -(-n // every) * every)


def records(st: State) -> Dict[str, Any]:
    """The traced run's records: the window's StageMetrics, images and
    CPU seconds, and one more pass under the profiler with the harness's
    spans, K2's launches and each component labelling's shape and sweeps
    (``ccl``: read once the pass has ended).  The profiled pass takes the
    next group's inputs, as a pass of the window does."""
    t0 = time.perf_counter()
    launches = {K2: []}
    orig = port_rotate.launch_shear

    def counted(src, quad, sh1, sh2, offsets=None, channels=None, **k):
        c = channels if channels is not None else int(src.shape[3])
        launches[K2].append(counts.rotate_bytes(int(sh1.shape[1]),
                                                int(src.shape[0]), c))
        return orig(src, quad, sh1, sh2, offsets, channels, **k)

    port_rotate.launch_shear = counted
    undo = st.spans.wrap(port_images, "fill_pending_images", "decode")
    calls: List[tuple] = []
    undo_ccl = _wrap_ccl(st, calls)
    root = st.root / "traced"
    try:
        trace, _ = profiled(lambda: _run_pass(st, len(st.passes), root,
                                              traced=True), launches,
                            st.spans)
    finally:
        port_rotate.launch_shear = orig
        undo()
        undo_ccl()
        shutil.rmtree(root, ignore_errors=True)
    print(f"engine: profiled pass and its trace read "
          f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
    return {"trace": trace,
            "ccl": [{"shape": shape, "sweeps": _sweeps(iters, most)}
                    for shape, iters, most in calls],
            "steps": [s for p in st.passes for s in p.steps],
            "images": sum(p.images for p in st.passes),
            "window_cpu_s": (st.cpu_start, st.cpu_end)}


def _reference_files(st: State, p: Pass, dtype):
    """{(output dir, name): bytes} the reference makes for the pass's
    kept inputs, step after step from its own files."""
    items, listings, _ = _expected(st, p.group)
    imgs, labels = st.dirs[p.group]
    made: Dict[tuple, bytes] = {}
    files = {}
    for name in p.kept:
        stem_items = [it for it in items if it[0] == name]
        files.update({("dataset:imgs", it[0]): (imgs / it[0]).read_bytes()
                      for it in stem_items})
        files.update({("dataset:labels", it[1]):
                      (labels / it[1]).read_bytes() for it in stem_items})
    for k, sc in enumerate(st.cfg["steps"]):
        ref = step_reference(sc["transform"])
        index = {names: i for i, names in enumerate(listings[k])}
        if sc["inputs"][0].startswith("dataset:"):
            todo = [names for names in listings[k] if names[0] in p.kept]
            args = lambda names: [(n, files[(d, n)]) for d, n in
                                  zip(sc["inputs"], names)]
        else:
            d = sc["inputs"][0]
            todo = [(n,) for (dd, n) in files if dd == d]
            args = lambda names: [(names[0], files[(d, names[0])])]
        for names in todo:
            seed = (p.seeds[k] + index[names]) & 0x7FFFFFFF
            for (di, nm), data in ref.apply(args(names), seed, sc["options"],
                                            dtype).items():
                files[(sc["outputs"][di], nm)] = data
                made[(sc["outputs"][di], nm)] = data
    return made


def _compare(a: bytes, b: bytes, name: str) -> int:
    """0 when equal; else the largest pixel gap (255 for a shape or text
    difference)."""
    if Path(name).suffix.lower() not in IMAGE_SUFFIXES:
        return 0 if a == b else 255
    x, y = ref_images.decode(a), ref_images.decode(b)
    if x.shape != y.shape:
        return 255
    return int(np.abs(x.astype(np.int16) - y.astype(np.int16)).max())


def check(st: State, dtype=torch.float32) -> List[Check]:
    """Every kept file against the reference's; ``dtype`` other than
    float32 puts the reference at that precision in the program's place
    (the control).  A file the program did not write counts as differing
    by 255.  Of a fused configuration, only the last step's files."""
    t0 = time.perf_counter()
    differ = gap = 0
    final = set(st.cfg["steps"][-1]["outputs"]) \
        if st.cfg.get("auto_fuse", False) else None
    for p in st.passes:
        ref = _reference_files(st, p, torch.float32)
        if dtype != torch.float32:
            got = _reference_files(st, p, dtype)
        kept = st.root / "kept" / str(p.index)
        for (d, name), data in ref.items():
            if final is not None and d not in final:
                continue
            if dtype == torch.float32:
                path = kept / d / name
                g = _compare(path.read_bytes(), data, name) \
                    if path.exists() else 255
            else:
                g = _compare(got[(d, name)], data, name)
            differ += g > 0
            gap = max(gap, g)
    failed = sum(s["items"] - s["statuses"].get("Success", 0)
                 for p in st.passes for s in p.steps)
    print(f"engine: reference check {time.perf_counter() - t0:.3f} s",
          file=sys.stderr)
    return [Check("engine.files_differ", differ, 0),
            Check("engine.max_gap", gap, 0),
            Check("engine.items_failed", failed, 0)]


def close(st: State):
    shutil.rmtree(st.root, ignore_errors=True)

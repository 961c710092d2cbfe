"""Pipeline orchestration: ProcessingPipeline + ProcessingStep (port of
image_processor_pipeline_tpu/pipeline.py to PyTorch).

External-contract parity with the reference orchestrator
(reference pipeline.py:16-28, 92-235, 237-499, 502-566):

  - ProcessingStep(name, process_function, input_dirs, output_dirs,
    pairing_method, pairing_function, fixed_input, root_dir, sample_k,
    save_log, workers, options) and .run()
  - ProcessingPipeline(root_dir), .add_step(step, position),
    .run(from_step_index, only_one), auto-chaining of un-pinned inputs
  - per-item status protocol (Success / no_output / Type Error / Error /
    Submission Error, reference pipeline.py:439-470) and the JSON run
    report at <output_dirs[0].parent>/<step name>.json (pipeline.py:472-499)

Internal execution model is brand new: a ``process_function`` may be either
a plain per-file host callable with the reference calling convention
(*input_paths, output_dirs=[...], **options) -> Path | List[Path] | None,
or a :class:`~image_processor_pipeline_tpu_torch.transforms.base.BatchTransform`,
in which case items are decoded host-side, bucketed by canvas shape
(io/batching.py), executed as batched calls on the step's ``device``, and
fanned back out to per-item saves — replacing the reference's per-file
ProcessPoolExecutor (pipeline.py:358-433) with on-device data parallelism.

A step runs on ``device="cuda"`` unless told otherwise, and raises when no
card is there; ``device="cpu"`` runs the same functions on CPU tensors.
``options["device_decode"]`` and ``options["device_encode"]`` ("auto":
on when the step's device is a CUDA card) ship sparse JPEG coefficients
between host and device instead of pixels (ops/jpeg.py); an explicit True
raises when the native IO engine they need could not be built.  Options
of the JAX engine whose modules are not ported yet (``mesh``,
``host_sharded``, ``trace_dir``, ``native_compute=True``) raise
NotImplementedError naming the option; ``native_compute="auto"`` means
the device path.
``ProcessingPipeline.run(auto_fuse=...)`` rewrites the step list with the
port's own fuser (fuse.py) exactly as the JAX engine does.

Known reference defects are fixed, not reproduced (SURVEY.md §2.7 #4,5,6,11).
"""

from __future__ import annotations

import json
import random
import time
import warnings
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

from image_processor_pipeline_tpu_torch.pairing import MODES, generate_processing_inputs
from image_processor_pipeline_tpu_torch.utils.profiling import StageMetrics, Timer
from image_processor_pipeline_tpu_torch.utils.utils import check_path

try:  # tqdm is optional; plain iteration otherwise
    from tqdm.auto import tqdm
except Exception:  # pragma: no cover
    def tqdm(it, **kw):
        return it


class PathJSONEncoder(json.JSONEncoder):
    """JSON encoder rendering Paths as strings (reference pipeline.py:569-584)."""

    def default(self, o):
        if isinstance(o, Path):
            return str(o)
        return super().default(o)


class ProcessingStep:
    """One pipeline stage: maps a process function over paired input files.

    Parameters mirror the reference step contract (pipeline.py:16-28); the
    extra ``seed`` makes all random draws (pairing and device RNG)
    reproducible, which the reference never achieved (SURVEY.md §7 #5).
    """

    def __init__(
        self,
        name: str,
        process_function: Union[Callable, "BatchTransform"],
        input_dirs: Optional[Sequence[Union[str, Path]]] = None,
        output_dirs: Optional[Sequence[Union[str, Path]]] = None,
        pairing_method: str = "one_input",
        pairing_function: Optional[Callable] = None,
        fixed_input: bool = False,
        root_dir: Optional[Union[str, Path]] = None,
        sample_k: Optional[int] = None,
        save_log: bool = False,
        workers: int = 1,
        options: Optional[Dict[str, Any]] = None,
        seed: Optional[int] = None,
        overwrite: str = "allow",
        trace_dir: Optional[Union[str, Path]] = None,
        retries: int = 0,
        resume: bool = False,
        host_sharded: bool = False,
        mesh: Any = None,
        device: Any = "cuda",
    ):
        if pairing_method not in MODES:
            raise ValueError(
                f"pairing_method must be one of {MODES}, got {pairing_method!r}"
            )
        if pairing_method == "custom" and pairing_function is None:
            raise ValueError("custom pairing requires a pairing_function")
        self.name = name
        self.process_function = process_function
        self.input_dirs = list(input_dirs) if input_dirs else []
        self.output_dirs = list(output_dirs) if output_dirs else []
        self.pairing_method = pairing_method
        self.pairing_function = pairing_function
        self.fixed_input = fixed_input
        self.root_dir = Path(root_dir) if root_dir is not None else None
        self.sample_k = sample_k
        self.save_log = save_log
        self.workers = self._normalize_workers(workers)
        self.options = dict(options) if options else {}
        self.seed = seed
        if overwrite not in ("allow", "error"):
            raise ValueError("overwrite must be 'allow' or 'error'")
        self.overwrite = overwrite
        self.trace_dir = trace_dir
        self.retries = max(0, int(retries))
        self.resume = bool(resume)
        self.host_sharded = bool(host_sharded)
        #: multi-device data parallelism is not ported yet: anything but
        #: None or False raises NotImplementedError
        self.mesh = mesh
        #: where batched transforms compute: "cuda" (the default; raises
        #: without a card) or "cpu"
        self.device = device
        self._check_unported()
        self.metrics = StageMetrics()

        self.input_paths: List[Path] = []
        self.output_paths: List[Path] = []
        self.process_logs: List[Dict[str, Any]] = []
        self.status_counter: Counter = Counter()
        self._resolve_paths()

    @staticmethod
    def _normalize_workers(workers: Optional[int]) -> int:
        """-1 → all cores; None → 1 (fixes reference defect SURVEY.md §2.7 #6)."""
        import os

        max_cpus = os.cpu_count() or 1
        if workers is None:
            return 1
        if workers == -1:
            return max_cpus
        if workers > max_cpus:
            warnings.warn(
                f"workers={workers} exceeds cpu count {max_cpus}; clamping"
            )
            return max_cpus
        return max(1, workers)

    def _resolve_paths(self) -> None:
        """Resolve relative dirs against root_dir (reference pipeline.py:92-111)."""
        if self.root_dir is not None:
            self.input_paths = [check_path(p, self.root_dir) for p in self.input_dirs]
            self.output_paths = [check_path(p, self.root_dir) for p in self.output_dirs]
        else:
            self.input_paths = [Path(p) for p in self.input_dirs]
            self.output_paths = [Path(p) for p in self.output_dirs]

    def set_root(self, root_dir: Optional[Path]) -> None:
        if self.root_dir is None and root_dir is not None:
            self.root_dir = Path(root_dir)
        self._resolve_paths()

    def _check_unported(self) -> None:
        """Raise for every option of the JAX engine whose module this port
        lacks so far, naming the option; none is silently ignored."""
        unported = []
        if self.mesh not in (None, False):
            unported.append("mesh")
        if self.host_sharded:
            unported.append("host_sharded")
        if self.trace_dir:
            unported.append("trace_dir")
        if self.options.get("native_compute") is True:
            unported.append("options['native_compute']=True")
        if unported:
            raise NotImplementedError(
                f"step {self.name!r}: not ported to PyTorch yet: "
                + ", ".join(unported))
        codec = [n for n in ("device_decode", "device_encode")
                 if self.options.get(n) is True]
        if codec:
            from image_processor_pipeline_tpu_torch.io import native

            if not native.available():
                raise RuntimeError(
                    f"step {self.name!r}: "
                    + ", ".join(f"options[{n!r}]=True" for n in codec)
                    + " needs the native IO engine, which is unavailable: "
                    + str(native.build_error()))

    def _device(self):
        """The step's torch device; raises when it names a CUDA card and
        none is there (no fallback to the CPU)."""
        import torch

        device = torch.device(self.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"step {self.name!r} has device={str(self.device)!r} but "
                "torch.cuda.is_available() is false; pass device='cpu' to "
                "run on the host")
        if device.type not in ("cuda", "cpu"):
            raise ValueError(f"device must be 'cuda' or 'cpu', got {device}")
        return device

    # ------------------------------------------------------------------
    # inventory + pairing
    # ------------------------------------------------------------------

    def _get_files_from_inputs(self) -> List[List[Path]]:
        """Sorted file lists per input dir (reference pipeline.py:122-146)."""
        from image_processor_pipeline_tpu_torch.io.images import list_files

        if not self.input_paths:
            raise ValueError(f"step {self.name!r} has no input dirs")
        lists = [list_files(d) for d in self.input_paths]
        for d, fl in zip(self.input_paths, lists):
            if not fl:
                raise ValueError(f"input directory is empty: {d}")
        return lists

    # ------------------------------------------------------------------
    # run
    # ------------------------------------------------------------------

    def run(self, progress: bool = True) -> Counter:
        print(f"[step] {self.name}: starting")
        t0 = time.perf_counter()
        self._check_unported()
        for d in self.output_paths:
            d = Path(d)
            # overwrite protection (the reference leaves this as a TODO at
            # pipeline.py:556-558)
            if self.overwrite == "error" and d.is_dir() and any(d.iterdir()):
                raise FileExistsError(
                    f"output directory {d} is not empty and step "
                    f"{self.name!r} has overwrite='error'"
                )
            d.mkdir(parents=True, exist_ok=True)

        file_lists = self._get_files_from_inputs()
        rng = random.Random(self.seed) if self.seed is not None else random.Random()
        iterator, total = generate_processing_inputs(
            file_lists,
            self.pairing_method,
            self.pairing_function,
            self.sample_k,
            rng,
        )

        self.process_logs = []
        self.metrics = StageMetrics(name=self.name)

        # Items carry their position in the ORIGINAL pairing order; device
        # seeds derive from this index, so a resumed run draws the same
        # per-item randomness as the uninterrupted run would have.
        indexed = enumerate(iterator)
        if self.resume:
            indexed, skipped = self._filter_resumed(indexed)
            if skipped:
                print(f"[step] {self.name}: resume — skipping {skipped} "
                      "item(s) already recorded as Success")
                if total is not None:
                    total = max(0, total - skipped)

        from image_processor_pipeline_tpu_torch.transforms.base import BatchTransform
        from image_processor_pipeline_tpu_torch.io import native as _native_io

        # auto-tiled PNG divides the cores by this step's saver width
        # (io/native.py:set_encoder_concurrency); the previous value comes
        # back after the step, so a caller's own setting survives it
        prev_concurrency = _native_io.set_encoder_concurrency(self.workers)
        try:
            if isinstance(self.process_function, BatchTransform):
                self._run_batched(indexed, total, progress)
            else:
                self._run_host(indexed, total, progress)
        finally:
            _native_io.set_encoder_concurrency(prev_concurrency)

        self.status_counter = Counter(log["status"] for log in self.process_logs)
        dt = time.perf_counter() - t0
        self.metrics.items = len(self.process_logs)
        self.metrics.wall_seconds = dt

        # output-collision detection (the reference leaves name collisions
        # between items unchecked — SURVEY.md §5.2); two items writing the
        # same path means one silently overwrote the other.
        seen: Dict[Path, int] = {}
        collisions = 0
        for log in self.process_logs:
            for out in log["outputs"] or ():
                seen[out] = seen.get(out, 0) + 1
        collisions = sum(n - 1 for n in seen.values() if n > 1)
        self.metrics.output_collisions = collisions
        if collisions:
            warnings.warn(
                f"step {self.name!r}: {collisions} output-path collision(s) —"
                " multiple items wrote the same file"
            )
        n = len(self.process_logs)
        rate = n / dt if dt > 0 else 0.0
        print(
            f"[step] {self.name}: {dict(self.status_counter)} "
            f"({n} items in {dt:.2f}s, {rate:.1f} items/s)"
        )
        if self.save_log:
            self._save_process_logs_to_json()
        return self.status_counter

    # -- host path ------------------------------------------------------

    def _run_host(self, iterator, total, progress) -> None:
        """Per-file host execution (reference pipeline.py:304-437 semantics).

        The reference fans out over a ProcessPoolExecutor AND materializes
        the full arg list up front (reference pipeline.py:360); host
        transforms here are light bookkeeping ops (copy, label remap, video
        demux), so a thread pool is the right tool — and the iterator is
        consumed LAZILY through a bounded in-flight window (same discipline
        as the batched device path), so a 100k-item stage holds O(window)
        items, not the whole list.
        """
        def one(args):
            last_exc = None
            for attempt in range(self.retries + 1):
                try:
                    return self.process_function(
                        *args, output_dirs=self.output_paths, **self.options
                    )
                except Exception as e:  # noqa: BLE001 — retry budget
                    last_exc = e
            raise last_exc

        bar = tqdm(total=total, desc=self.name, smoothing=0) if progress else None
        it = iter(iterator)
        if self.workers <= 1:
            for _idx, args in it:
                entry = self._log_entry(args)
                try:
                    result = one(args)
                    self._build_log(entry, result)
                except Exception as e:  # noqa: BLE001 — per-item fault tolerance
                    entry["status"] = "Error"
                    entry["error_message"] = f"{type(e).__name__}: {e}"
                self.process_logs.append(entry)
                self._maybe_flush()
                if bar:
                    bar.update(1)
        else:
            from collections import deque

            window = max(4 * self.workers, 16)
            with ThreadPoolExecutor(max_workers=self.workers) as ex:
                pending = deque()

                def submit_next():
                    # a failed ex.submit logs the item and PULLS THE NEXT
                    # one, so submission errors can neither shrink the
                    # in-flight window nor leave tail items unlogged
                    while True:
                        try:
                            _idx, args = next(it)
                        except StopIteration:
                            return False
                        entry = self._log_entry(args)
                        try:
                            pending.append((ex.submit(one, args), entry))
                            return True
                        except Exception as e:  # noqa: BLE001
                            entry["status"] = "Submission Error"
                            entry["error_message"] = (
                                f"{type(e).__name__}: {e}")
                            self.process_logs.append(entry)

                for _ in range(window):
                    if not submit_next():
                        break
                while pending:
                    fut, entry = pending.popleft()
                    try:
                        self._build_log(entry, fut.result())
                    except Exception as e:  # noqa: BLE001
                        entry["status"] = "Error"
                        entry["error_message"] = f"{type(e).__name__}: {e}"
                    self.process_logs.append(entry)
                    self._maybe_flush()
                    if bar:
                        bar.update(1)
                    submit_next()
        if bar:
            bar.close()

    # -- device path ----------------------------------------------------

    def _run_batched(self, iterator, total, progress) -> None:
        """Streaming batched device execution for BatchTransforms.

        Three overlapped phases with bounded memory (suitable for 100k-item
        runs, unlike the reference which materializes the full arg list at
        pipeline.py:360):

          decode   a sliding window of ``2*max_batch`` items probes (or
                   decodes) ahead on a thread pool;
          device   full buckets are stacked, copied to the step's device
                   and dispatched without blocking (a CUDA stream queues
                   them in order);
          encode   saver threads wait on each batch's own copy event and
                   write outputs while the device runs the next batch; at
                   most a few batches are in flight at once.

        Per-item RNG seeds derive from the step seed + item index, so
        results are independent of batching, order, and thread timing.
        """
        import threading
        from collections import defaultdict, deque

        import torch

        transform = self.process_function
        from image_processor_pipeline_tpu_torch.io.batching import Bucketizer
        from image_processor_pipeline_tpu_torch.io.images import fill_pending_images
        from image_processor_pipeline_tpu_torch.ops import jpeg as djpeg
        from image_processor_pipeline_tpu_torch.transforms.base import host_zeros

        device = self._device()
        # the sticky device_encode/device_decode disables are per-RUN
        # state: a reused transform instance (resume pass, same object in
        # two steps) must not inherit a previous run's dense-content trip
        djpeg.reset_codec_gates(transform)
        _tune_allocator()
        timer = Timer()
        base_seed = self.seed if self.seed is not None else random.getrandbits(31)
        max_batch = transform.max_batch
        window = max(2 * max_batch, 16)
        max_inflight = 4

        bar = (
            tqdm(total=total, desc=self.name, smoothing=0) if progress else None
        )
        logs_lock = threading.Lock()

        def finish_entry(entry):
            with logs_lock:
                self.process_logs.append(entry)
                self._maybe_flush()
                if bar:
                    bar.update(1)

        pool_cls = _engine_pool_cls(self.workers, device)
        decode_pool = pool_cls(max_workers=max(1, self.workers))
        save_pool = pool_cls(max_workers=max(1, self.workers))
        groups = defaultdict(list)
        inflight = deque()

        def saver(chunk, n_valid, out_dev):
            with timer.measure("save"):
                if transform.shrinks_output:
                    # meter by output residency: a batch whose only tensor
                    # is a stashed underscore key (symmetry's _input_dev)
                    # still fetches real bytes in its shrink hook
                    resident = any(isinstance(x, torch.Tensor)
                                   for x in _leaves(out_dev, private=True))
                    full = _tree_bytes(out_dev) if resident else 0
                    out_dev = transform.shrink_output(
                        out_dev, chunk, self.options)
                    if resident:
                        with logs_lock:
                            self.metrics.d2h_bytes_full += full
                            self.metrics.d2h_bytes_fetched += (
                                _tree_bytes(out_dev))
                outs = transform.materialize_batch(out_dev, n_valid)
                for item, out in zip(chunk[:n_valid], outs):
                    entry = item["_entry"]
                    if "_load_error" in item:
                        entry["status"] = "Error"
                        entry["error_message"] = item["_load_error"]
                        finish_entry(entry)
                        continue
                    for attempt in range(self.retries + 1):
                        try:
                            result = transform.save_item(
                                out, item, self.output_paths, self.options
                            )
                            self._build_log(entry, result)
                            if entry["status"] in ("Success", "no_output"):
                                # clear a previous attempt's error; keep the
                                # message _build_log recorded for Type Error
                                entry["error_message"] = None
                            break
                        except Exception as e:  # noqa: BLE001
                            entry["status"] = "Error"
                            entry["error_message"] = f"{type(e).__name__}: {e}"
                    finish_entry(entry)

        def dispatch(key, chunk, n_valid):
            self.metrics.batches += 1
            with timer.measure("decode"):
                # probed items decode here, a whole bucket into one stacked
                # array (pinned host memory when the step runs on a card);
                # device_decode (auto on a card, explicit True/False
                # override — ops/jpeg.py:device_decode_enabled) moves
                # IDCT/upsample/color onto the device, the host decoding
                # entropy only and shipping sparse coefficients; a
                # majority-dense run trips the sticky disable
                dd = (not transform.needs_host_image(
                          chunk, self.options, device)
                      and djpeg.device_decode_enabled(
                          self.options, transform, device))
                dd_stats: dict = {}
                fill_pending_images(
                    chunk, n_threads=self.workers,
                    alloc=lambda shape: host_zeros(shape, device),
                    device_decode=dd, device=device, stats=dd_stats)
                if dd and dd_stats.get("n"):
                    djpeg.note_decode_dense(
                        transform, dd_stats["dense"], dd_stats["n"])
            with timer.measure("device"):
                out_dev = transform.launch_batch(
                    key, chunk, self.options, device=device)
                # async device→host copy: it overlaps the next batch's
                # compute (deferred to the saver when the transform
                # shrinks its output on the device first)
                if not transform.shrinks_output:
                    transform.start_host_copy(out_dev)
            inflight.append(save_pool.submit(saver, chunk, n_valid, out_dev))
            while len(inflight) > max_inflight:
                inflight.popleft().result()

        def load(args):
            item = transform.probe_item(args, self.options)
            if item is None:
                item = transform.load_item(args, self.options)
            return item
        it = iter(iterator)
        futs = deque()

        def submit_next():
            try:
                idx, args = next(it)
            except StopIteration:
                return False
            futs.append(
                (args, idx, decode_pool.submit(_safe_load, load, args))
            )
            return True

        with timer.measure("load"):
            for _ in range(window):
                if not submit_next():
                    break
            while futs:
                args, idx, fut = futs.popleft()
                item, err = fut.result()
                submit_next()
                entry = self._log_entry(args)
                if err is not None:
                    entry["status"] = "Error"
                    entry["error_message"] = err
                    finish_entry(entry)
                    continue
                item["_seed"] = (base_seed + idx) & 0x7FFFFFFF
                item["_entry"] = entry
                item["_args"] = args
                key = transform.bucket_key(item, self.options)
                groups[key].append(item)
                if len(groups[key]) >= max_batch:
                    dispatch(key, groups.pop(key), max_batch)
                else:
                    # bound pending memory when a dataset sprays many
                    # distinct canvas buckets: flush the fullest group
                    # early as a partial batch
                    pending = sum(len(v) for v in groups.values())
                    if pending > 8 * max_batch and len(groups) > 1:
                        big = max(groups, key=lambda k: len(groups[k]))
                        rest = groups.pop(big)
                        n_valid = len(rest)
                        bsz = Bucketizer.batch_ladder(
                            n_valid, max_batch,
                            self.options.get("batch_ladder", "pow2"),
                        )[0]
                        chunk = rest[:bsz]
                        while len(chunk) < bsz:
                            chunk.append(chunk[-1])
                        dispatch(big, chunk, min(n_valid, bsz))
                        if n_valid > bsz:
                            groups[big] = rest[bsz:]

            # flush ragged remainders in ladder-sized chunks
            ladder_mode = self.options.get("batch_ladder", "pow2")
            for key, rest in groups.items():
                pos = 0
                for bsz in Bucketizer.batch_ladder(
                    len(rest), max_batch, ladder_mode
                ):
                    chunk = rest[pos:pos + bsz]
                    n_valid = len(chunk)
                    while len(chunk) < bsz:
                        chunk.append(chunk[-1])
                    dispatch(key, chunk, n_valid)
                    pos += n_valid

        while inflight:
            inflight.popleft().result()
        decode_pool.shutdown()
        save_pool.shutdown()
        if bar:
            bar.close()
        self.metrics.host_load_seconds = (
            timer.totals.get("load", 0.0) + timer.totals.get("decode", 0.0)
        )
        self.metrics.device_seconds = timer.totals.get("device", 0.0)
        self.metrics.host_save_seconds = timer.totals.get("save", 0.0)

    def _filter_resumed(self, indexed):
        """Item-granular resume: drop inputs the previous run's JSON report
        recorded as Success (the reference can only resume at stage
        granularity, pipeline.py:555-566).  Requires save_log=True on the
        earlier run.  Skipped items are re-logged as Success with their
        recorded outputs so the new report stays complete.

        Operates on (original_index, args) pairs and PRESERVES the surviving
        items' original indices, so per-item device seeds are identical to
        the uninterrupted run's.
        """
        if not self.output_paths:
            return indexed, 0
        report = self._report_path()
        if not report.is_file():
            return indexed, 0
        try:
            payload = json.loads(report.read_text())
        except (OSError, json.JSONDecodeError):
            return indexed, 0
        entries = payload if isinstance(payload, list) else payload.get(
            "items", [])
        done = {}
        for item in entries:
            if item.get("status") == "Success":
                done[tuple(str(i) for i in item["inputs"])] = item
        if not done:
            return indexed, 0

        kept = []
        skipped = 0
        for idx, args in indexed:
            key = tuple(str(a) for a in args)
            prev = done.get(key)
            if prev is not None and all(
                Path(o).exists() for o in prev.get("outputs") or ()
            ):
                skipped += 1
                self.process_logs.append({
                    "inputs": list(args),
                    "outputs": [Path(o) for o in prev["outputs"]],
                    "status": "Success",
                    "error_message": None,
                })
            else:
                kept.append((idx, args))
        return iter(kept), skipped

    # -- logging --------------------------------------------------------

    _FLUSH_EVERY = 32

    def _maybe_flush(self) -> None:
        """Periodic durable report write during the run (crash resilience
        for resume=True); failures never take down the run."""
        if not self.save_log or not self.output_paths:
            return
        if len(self.process_logs) % self._FLUSH_EVERY:
            return
        try:
            self._flush_report()
        except OSError:  # disk hiccups must not kill the stage
            pass

    @staticmethod
    def _log_entry(args) -> Dict[str, Any]:
        # outputs starts as None and stays None for every non-Success status
        # (reference pipeline.py:324 initializes "outputs": null and only
        # _build_log's Success branches assign a list).
        return {
            "inputs": [a for a in args],
            "outputs": None,
            "status": None,
            "error_message": None,
        }

    @staticmethod
    def _build_log(entry: Dict[str, Any], returned) -> None:
        """Validate the transform's return (reference pipeline.py:439-470).

        Matches the reference's truthiness semantics: None AND an empty
        list both log as 'no_output'."""
        if not returned:
            entry["status"] = "no_output"
        elif isinstance(returned, Path):
            entry["outputs"] = [returned]
            entry["status"] = "Success"
        elif isinstance(returned, (list, tuple)) and all(
            isinstance(p, Path) for p in returned
        ):
            entry["outputs"] = list(returned)
            entry["status"] = "Success"
        else:
            msg = (
                f"invalid return type {type(returned).__name__}; expected "
                "Path, List[Path], or None"
            )
            warnings.warn(msg)
            entry["status"] = "Type Error"
            entry["error_message"] = msg

    def _report_path(self) -> Path:
        """Report target: <output[0].parent>/<name with suffix .json>.
        The reference uses Path(name).with_suffix(".json") (pipeline.py:488),
        which REPLACES a trailing dotted segment in the step name — e.g.
        "crop.v2" reports to crop.json, not crop.v2.json."""
        parent = Path(self.output_paths[0]).parent
        name = Path(self.name).with_suffix(".json").name
        return parent / name

    def _flush_report(self) -> None:
        """Durable incremental report write (atomic temp+rename): a run
        killed mid-stage leaves a valid report of everything finished so
        far, and ``resume=True`` picks up from there instead of redoing the
        whole stage."""
        target = self._report_path()
        tmp = target.with_name(target.name + ".tmp")
        tmp.write_text(
            json.dumps(self.process_logs, indent=4, ensure_ascii=False,
                       cls=PathJSONEncoder)
        )
        tmp.replace(target)

    def _save_process_logs_to_json(self) -> Path:
        """Dump per-item logs next to the first output dir
        (reference pipeline.py:472-499: <output[0].parent>/<name>.json).

        The main file is the reference's exact schema — a BARE LIST of
        {inputs, outputs, status, error_message} entries — so existing
        consumers parse it unchanged; the framework's extras (statuses
        summary, stage metrics) go to a sibling <name>.metrics.json."""
        if not self.output_paths:
            raise ValueError("save_log requires at least one output dir")
        target = self._report_path()
        self._flush_report()
        metrics_target = target.parent / f"{target.stem}.metrics.json"
        metrics_target.write_text(json.dumps({
            "step": self.name,
            "statuses": dict(self.status_counter),
            "metrics": self.metrics.as_dict(),
        }, indent=2, cls=PathJSONEncoder))
        print(f"[step] {self.name}: log saved to {target}")
        return target


_malloc_tuned = False


def _tune_allocator() -> None:
    """Keep glibc from mmap/munmap-cycling the engine's large buffers.

    Every batch allocates tens of MB of fresh numpy arrays (decode
    canvases, stacked batches, flip outputs); above glibc's default
    128KB threshold each goes through mmap and is unmapped on free, so
    the engine re-faults ~1000 pages per item forever (measured: 168k
    page faults per 167-item chunk vs the reference loop's ~330 — and
    under host-level memory pressure those faults dominate wall time
    10-20x).  Raising M_MMAP_THRESHOLD/M_TRIM_THRESHOLD makes the heap
    retain and reuse those pages: first-touch faults only.  Trade-off is
    retained RSS on the order of the largest working set, which is
    bounded by the engine's window.  IPP_MALLOC_TUNE=0 disables."""
    global _malloc_tuned
    if _malloc_tuned:
        return
    _malloc_tuned = True
    import os

    if os.environ.get("IPP_MALLOC_TUNE", "1") == "0":
        return
    try:
        import ctypes

        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        libc.mallopt(-3, 1 << 29)  # M_MMAP_THRESHOLD = 512MB
        libc.mallopt(-1, 1 << 29)  # M_TRIM_THRESHOLD = 512MB
    except Exception:  # noqa: BLE001 — non-glibc platforms
        pass


class _SyncExecutor:
    """Inline stand-in for ThreadPoolExecutor on hosts with no parallelism
    to exploit (single CPU core, a step on the CPU, workers<=1).

    The engine's decode/save pools exist to overlap host IO with device
    compute; with one core and no accelerator nothing can overlap, and the
    GIL ping-pong between the three threads measured +60% wall on the e2e
    enhance row (78.7 -> 49.4 ms/item).  Futures resolve at submit time so
    every engine code path (windows, inflight bounds, error capture) runs
    unchanged."""

    class _Fut:
        __slots__ = ("_r", "_e")

        def __init__(self, fn, a, k):
            self._e = None
            try:
                self._r = fn(*a, **k)
            except BaseException as e:  # noqa: BLE001 — future semantics
                self._r, self._e = None, e

        def result(self, timeout=None):
            if self._e is not None:
                raise self._e
            return self._r

    def __init__(self, max_workers=None):
        pass

    def submit(self, fn, *args, **kwargs):
        return self._Fut(fn, args, kwargs)

    def shutdown(self, wait=True):
        pass


def _engine_pool_cls(workers: int, device):
    """ThreadPoolExecutor, or _SyncExecutor when there is provably nothing
    to overlap (1 core + a step on the CPU + workers<=1)."""
    import os

    if (max(1, workers) == 1 and (os.cpu_count() or 1) == 1
            and device.type == "cpu"):
        return _SyncExecutor
    return ThreadPoolExecutor


def _leaves(tree, private: bool = False):
    """The array leaves (tensors and numpy arrays/scalars) of an output
    dict, its nested dicts, lists and tuples; top-level underscore keys
    (zero-copy references a transform stashed for its shrink hook, and
    the host copies) are skipped unless ``private``."""
    if isinstance(tree, dict):
        items = tree.items() if private else (
            (k, v) for k, v in tree.items() if not str(k).startswith("_"))
        for _, v in items:
            yield from _leaves(v, True)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v, True)
    elif hasattr(tree, "dtype"):
        yield tree


def _tree_bytes(tree) -> int:
    """Bytes of the array leaves of ``tree`` (see _leaves)."""
    total = 0
    for x in _leaves(tree):
        total += (x.numel() * x.element_size() if hasattr(x, "numel")
                  else x.size * x.dtype.itemsize)
    return total


def _safe_load(load, args):
    try:
        item = load(args)
        if item is None:
            return None, "load_item returned None"
        return item, None
    except Exception as e:  # noqa: BLE001
        return None, f"{type(e).__name__}: {e}"


class ProcessingPipeline:
    """Ordered list of steps with auto-chaining (reference pipeline.py:502-566)."""

    def __init__(self, root_dir: Optional[Union[str, Path]] = None):
        self.root_dir = Path(root_dir) if root_dir is not None else None
        self.steps: List[ProcessingStep] = []

    def add_step(self, step: ProcessingStep, position: Optional[int] = None) -> None:
        step.set_root(self.root_dir)
        if position is None:
            position = len(self.steps)
        self.steps.insert(position, step)

        # auto-chain: a step without inputs adopts its predecessor's outputs
        if not step.input_dirs and position > 0:
            prev = self.steps[position - 1]
            step.input_paths = list(prev.output_paths)
        # rewire the successor unless it pinned its inputs
        if position + 1 < len(self.steps):
            nxt = self.steps[position + 1]
            if not nxt.fixed_input:
                nxt.input_paths = list(step.output_paths)

    def run(self, from_step_index: int = 0, only_one: bool = False,
            progress: bool = True,
            report_path: Optional[Union[str, Path]] = None,
            auto_fuse: Union[bool, str] = False) -> List[Counter]:
        """Run the selected steps; optionally write an aggregated JSON
        report (per-step statuses + metrics) to ``report_path``.

        ``auto_fuse=True`` collapses eligible runs of consecutive
        deterministic steps into single fused steps before running
        (byte-identical final outputs; the elided intermediate
        directories are NOT written — see fuse.py for the conservative
        eligibility rules).  ``auto_fuse="rng"`` additionally fuses RNG
        stages (final-position EnhanceImage tails, sub-pool symmetry
        sampling, overlays → border crop) whose fused outputs are equally
        DISTRIBUTED but not byte-equal to the unfused run.  The returned
        counter list matches the steps actually run, so it may be shorter
        than ``self.steps``."""
        todo = (
            self.steps[from_step_index:from_step_index + 1]
            if only_one
            else self.steps[from_step_index:]
        )
        if auto_fuse not in (False, True, "byte", "rng"):
            # a typo ('RNG', 'full', ...) must not silently run the byte
            # tier — the caller believes RNG stages will fuse
            raise ValueError(
                f"auto_fuse must be False, True, 'byte' or 'rng', "
                f"got {auto_fuse!r}")
        if auto_fuse:
            from image_processor_pipeline_tpu_torch.fuse import fuse_steps

            todo = fuse_steps(
                todo, verbose=progress,
                tier="rng" if auto_fuse == "rng" else "byte")
        #: the steps this run actually executed (fused runs replace their
        #: constituents) — callers pairing names with the returned
        #: counters must use this, not self.steps
        self.last_run_steps = todo
        results = []
        t0 = time.perf_counter()
        for step in todo:
            results.append(step.run(progress=progress))
        if report_path is not None:
            payload = {
                "wall_seconds": round(time.perf_counter() - t0, 3),
                "steps": [
                    {
                        "name": s.name,
                        "statuses": dict(s.status_counter),
                        "metrics": s.metrics.as_dict(),
                        "input_dirs": s.input_paths,
                        "output_dirs": s.output_paths,
                    }
                    for s in todo
                ],
            }
            report_path = Path(report_path)
            report_path.parent.mkdir(parents=True, exist_ok=True)
            report_path.write_text(
                json.dumps(payload, indent=2, cls=PathJSONEncoder)
            )
        return results

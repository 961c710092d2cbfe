"""Smoke run of the PyTorch port (image_processor_pipeline_tpu_torch) on one
CUDA card.  Run from the repository root:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from csrc/ and prints what ptxas
and cuobjdump say of them, holds each byte for byte against its plain
PyTorch version on the card (the chain kernel on both of its paths, for
packed, 3- and 4-channel canvases; the rotation kernel on its tiled and
direct paths, whole images and crops read from 3- and 4-channel
canvases, and random shift vectors), drives the flagship chain
(AugmentChain, 640 px input, 512 px crop) through them in the modes
cuda_full, cuda_shear and cuda_fused, and the batched rotation op on
single-channel masks, checks each output against its plain twin on the
card and that no main path took the rotation's direct gather or
cuda_shear's torch crop, drives the chain's gather mode against the same mode on the CPU and against
cuda_shear's footprint, times each kernel's launch alone against its
bytes bound and its plain version, the chain kernel's two paths and
cluster sizes and the rotation kernel's two paths in turns,
and the chains with CUDA events, profiles one launch of each kernel and
the chains' device work, counts
how often the card's float32 tan/sin move a shift vector against the
CPU's and holds each chain kernel mode on the card against the same mode
on the CPU over the angles that move, holds the probe kernel's four moves (utils/rev_probe.py) against
torch.flip, torch.roll and clone, drives the probe's own entry point and
times a kernel that does nothing (the launch-alone floor under the moves),
holds the engine's failure contract on the card (phase failure_contract:
a FusedChain step with a probe fault, a truncated JPEG, transient and
permanent save faults and every save failing; a crop step in a process of
its own SIGKILLed with batches in flight, then resumed: each item once,
the files those of an uninterrupted run), and drives the engine: over a dataset of 640 x 480 PNGs with YOLO labels
made from a seed in a temporary directory, ProcessingPipeline A
(SquareCropAroundBBox, then copy_img_with_labels) and B (RandomRotations
with method="shear", which launches the rotation kernel, then
GenerateSymmetries), all on the card, with every item's status, the file
counts, each crop against its source window, one rotation batch against
the plain twin and against the same batch on the CPU, the kernel's
launches and the step's idle share checked or printed; then, over 64 of
A's crops, pipelines C (ColorMaskTransparency, then KeepLargestComponent:
BASELINE.json's config 3), D (one FusedChain step of Rotate with
method="shear", Flip, ColorMask, Cleanup and Enhance, which launches the
rotation kernel once a batch) and E (EnhanceImage, BorderCrop, FitCrop
over JPEG copies of the crops), with one batch of every new step held
byte for byte against the same batch on the CPU, D's batch against the
plain twin in the kernel's place, and the connected-component sweeps and
host read-backs a batch printed; then BASELINE.json's config 4 (RGBA
overlays pasted onto JPEG copies of the dataset's images, then a border
crop; and OverlaysBorderCrop), config 5 (a clip written with cv2, its
frames extracted, then FusedChain([Rotate(shear), Flip, Enhance]) on 896
px canvases) and the composites RotationsSymmetries and RotationsChain
with method="shear", each step's launches read on its own, one batch of
every new step held against the same batch on the CPU, and the rotation
kernel alone at the frames' canvas; then the symmetry fan-out pipelines,
each with and without auto_fuse; then the codec phase: whether the native
IO engine builds (its compiler message when it does not; the card's
machine has no libjpeg headers, so there the host codec is Pillow's), the
port's JPEG coefficient coder (libipp_jcoef.so from native/ipp_jcoef.cpp
with g++ and no codec library; the phase fails if it does not build),
pipeline J (crop_square to .jpg, rotations by shear to JPEG, symmetry)
over 68 JPEGs made from a seed, once with the codec gates on "auto" (both
coefficient transports: the coder's entropy decode and encode on the host,
the device halves on the card, each spied on, and fewer bytes fetched)
and once off, the two runs' files byte for byte (on the card: the coder
and the device halves against Pillow's codec) and the rotation kernel's
launches, items/s and d2h bytes of both runs and the coder's seconds; the
coder alone over the dataset, and a round trip of Pillow's q75 and q95
files through it, byte for byte; and the device JPEG halves on a [32,
512, 512, 3] batch on the card against the CPU, timed; then the entry
points: the CLI (python -m
image_processor_pipeline_tpu_torch run, JAX's example config with
rotations by shear, in a process of its own, with and without
--auto-fuse) against the same pipeline built in-process, files and
reports byte for byte; sharded_augment_step at B=64, 640 -> 512 over a
one-card mesh and over [cuda:0, cuda:0] (the rotation kernel through
cuda_shear, the chain kernel through cuda_full) against the plain modes
on the CPU; the engine's mesh (None, two entries of the card, 1) on a
FusedChain and RandomRotations, same files; two CLI processes on the
card in a gloo group over a host-sharded step, their files and merged
report against the one-process run; a trace_dir run whose trace names
the rotation kernel; and the multi-device dry run; then the native
compute phase: libipp_cpu.so built from native/ipp_cpu.cpp with g++ on
this machine, and the pipelines above again with
options["native_compute"]=True (the C++ twins on the host's cores) over
the same inputs, each step's twin spied on, their files held byte for
byte against the CUDA runs' (pipeline B's nearest rotations against
Pillow's rotate + getbbox exactly and a CUDA run's at >= 0.97 of pixels;
RotSymChain fused against unfused and its originals' files against the
CUDA run's), each step's items/s native against CUDA.  Every profile
runs in a torch.profiler window that opens after a warm-up
(utils/profiling.py:warmed_profile).  It prints the card's name and power
limit, a JSON line of the kernels and, last, a JSON status line.  Any
failed phase raises, so the status line is printed only when every phase
passed.  Without a CUDA card it exits non-zero.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

CSRC = "image_processor_pipeline_tpu_torch/csrc/"
PALLAS = "image_processor_pipeline_tpu/ops/pallas/"
# kernel name (kernels.launch_counts) -> (source, TPU kernel it replaces)
KERNELS = {
    "augment_full": (CSRC + "augment_full.cu", PALLAS + "augment.py:275"),
    "shear_rotate_packed": (CSRC + "shear_rotate.cu", PALLAS + "rotate.py:103"),
    "shear_rotate": (CSRC + "shear_rotate.cu", PALLAS + "rotate.py:29"),
    "augment_fused": (CSRC + "augment_full.cu", PALLAS + "augment.py:40"),
}
# every flip code and the rotation's boundary angles, then random ones
ANGLES = (0.0, 44.99, 45.0, 45.01, 90.0, 135.0, 180.0, 270.0, 315.0, 358.9)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
BATCHES = (8, 64)
# the engine phase: images of the dataset (256 take some 100 s on 8 cores,
# nearly all of it PNG encoding on the host), their size, rotations an image
ENGINE_IMAGES = 128
ENGINE_H, ENGINE_W = 480, 640
ENGINE_ROTATIONS = 4
# the symmetry step takes this many of the 640 rotation files (all of them
# took 46 s, nearly all of it PNG encoding), and pipelines C, D and E this
# many of the 128 crops
ENGINE_SYMMETRY_ITEMS = 160
ENGINE_STEP_ITEMS = 64
# two HSV ranges (OpenCV scale) that mask a real share of the dataset's
# gradients: the dark pixels and the green hues
ENGINE_MASK_RANGES = [(0, 0, 0, 180, 255, 110), (35, 60, 60, 85, 255, 255)]
# config 4 pastes one overlay for every four images of the dataset (as
# benchmarks/eval_configs.py does), config 5 takes a clip of this many
# frames, and the composites this many of pipeline A's crops (32 took 17
# s, nearly all of it PNG encoding: RotationsSymmetries writes 20 files an
# item)
OVERLAYS = ENGINE_IMAGES // 4
CLIP_FRAMES, CLIP_W, CLIP_H = 24, 640, 480
COMPOSITE_ITEMS = 16
# the fan-out fusion phase: this many of pipeline A's crops and of
# pipeline C's colour-masked RGBA PNGs of them; the batch held against the
# CPU is two of the inputs, or for a rotation head one centre cut of this
# side (one 480 px crop through RotSymChain took 134 s on 8 CPU cores:
# 20 canvases of 768, some 500 connected-component sweeps)
FANOUT_ITEMS = 8
FANOUT_CPU_CUT = 160
# the codec phase: pipeline J over this many JPEGs of the engine's size
# (and four odd ones), twice
CODEC_IMAGES = 64


def kernel_inputs(SIN, S, B, seed, dev):
    """Random canvases and draws covering the boundary angles and all flip
    codes, as the augment_fused_full arguments before the filter stack:
    the canvas as uint8 [B, SIN, SIN, 4] (alpha random)."""
    rng = np.random.default_rng(seed)
    imgs = torch.as_tensor(rng.integers(0, 256, (B, SIN, SIN, 4), np.uint8),
                           device=dev)
    angles = np.asarray(ANGLES[:B] + tuple(rng.uniform(1, 359, B)),
                        np.float32)[:B]
    as_dev = lambda a, t: torch.as_tensor(np.asarray(a, t), device=dev)
    return (imgs,
            as_dev(rng.integers(0, SIN - S + 1, B), np.int32),
            as_dev(rng.integers(0, SIN - S + 1, B), np.int32),
            as_dev(angles, np.float32),
            as_dev(rng.uniform(0.7, 1.3, (B, 8)), np.float32),
            as_dev(np.arange(B) % 4, np.int32))


def crop_inputs(S, C, B, seed, dev):
    """Random [B, S, S, C] uint8 images, angles covering the boundary
    angles, enhance parameters and every flip code (augment_fused's
    arguments before the filter stack)."""
    rng = np.random.default_rng(seed)
    imgs = torch.as_tensor(rng.integers(0, 256, (B, S, S, C), np.uint8),
                           device=dev)
    angles = np.asarray(ANGLES[:B] + tuple(rng.uniform(1, 359, B)),
                        np.float32)[:B]
    as_dev = lambda a, t: torch.as_tensor(np.asarray(a, t), device=dev)
    return (imgs, as_dev(angles, np.float32),
            as_dev(rng.uniform(0.7, 1.3, (B, 8)), np.float32),
            as_dev(np.arange(B) % 4, np.int32))


def time_calls(fn, calls=50, windows=5):
    """Milliseconds per call, one CUDA-event window of ``calls`` calls
    after a warm-up call, ``windows`` times; fn(i) takes the call index.
    Host time between launches counts: this times what a caller waits."""
    fn(0)
    torch.cuda.synchronize()
    per_call = []
    for w in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(calls):
            fn(1 + w * calls + i)
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / calls)
    return per_call


def device_ms(launch, calls=30):
    """Device milliseconds per launch: ``calls`` launches queued behind a
    sleeping kernel, so that the CUDA-event window holds device time alone
    and none of the host's time between launches."""
    launch()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)  # some 25 ms, far more than the queueing
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        launch()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def check_equal(got, ref, what):
    """Raise unless got == ref byte for byte; returns the max abs error."""
    torch.cuda.synchronize()
    if got.shape != ref.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != "
                             f"{tuple(ref.shape)}")
    err = int((got.int() - ref.int()).abs().max())
    if not torch.equal(got, ref):
        raise AssertionError(f"{what}: max abs err {err}, "
                             f"{(got != ref).sum().item()} bytes differ")
    return err


def check_not_degenerate(out, what):
    alpha = out[..., 3]
    if not (bool((alpha == 0).any()) and bool((alpha == 255).any())
            and float(out[..., :3].float().std()) > 0):
        raise AssertionError(f"{what}: degenerate output")


def drive(kernels, expected, fn):
    """Run fn() with every launch count set to 0 just before and read just
    after; raise unless the counts are ``expected`` (others 0; None leaves
    the check to the caller)."""
    kernels.reset_launch_counts()
    result = fn()
    counts = dict(kernels.launch_counts)
    torch.cuda.synchronize()
    want = {name: (expected or counts).get(name, 0) for name in counts}
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    return result, counts


def count_direct_tiles(kernels, dev, fn):
    """(fn(), the rotation kernel's tiles that gathered from device memory
    meanwhile): kernels.direct_tiles is set for the call."""
    kernels.direct_tiles = torch.zeros(1, dtype=torch.int32, device=dev)
    try:
        out = fn()
        return out, int(kernels.direct_tiles)
    finally:
        kernels.direct_tiles = None


def plain_rotate_batch(images, angles, shifts=None):
    """rotate_square_shear_batch's contract through the plain version, to
    put in the kernel wrapper's place."""
    from image_processor_pipeline_tpu_torch.ops import geometry

    if shifts is None:
        shifts = geometry.shear_params(angles, images.shape[1])
    return geometry.rotate_square_shear_by(images, *shifts)


def shift_vector_deltas(geometry, dev, n=200_000, S=512, chunk=20_000):
    """F6: angles whose (quad, sh1, sh2) from geometry.shear_params differ
    between the card and the CPU, over n angles from uniform(1, 359).
    Returns (counts, the angles that move as float32 [k])."""
    angles = np.random.default_rng(6).uniform(1, 359, n).astype(np.float32)
    diff = {"quad": 0, "sh1": 0, "sh2": 0, "any": 0, "max_step": 0}
    moved = []
    for i in range(0, n, chunk):
        a = torch.as_tensor(angles[i:i + chunk])
        cpu = geometry.shear_params(a, S)
        gpu = [t.cpu() for t in geometry.shear_params(a.to(dev), S)]
        rows = [(c != g).reshape(len(a), -1).any(1) for c, g in zip(cpu, gpu)]
        for name, r in zip(("quad", "sh1", "sh2"), rows):
            diff[name] += int(r.sum())
        any_row = rows[0] | rows[1] | rows[2]
        diff["any"] += int(any_row.sum())
        moved.append(a[any_row].numpy())
        for c, g in zip(cpu[1:], gpu[1:]):
            diff["max_step"] = max(diff["max_step"],
                                   int((c - g).abs().max()))
    return diff, np.concatenate(moved)


def chain_modes_card_against_cpu(chains, angles, dev):
    """F6 for the chain: AugmentChain's batch at 640 -> 512 with the given
    angles (in place of the drawn ones) in each kernel mode on the card,
    against the same mode on the CPU, byte for byte.  The shift vectors
    come from the host's angles, so the card's tanf/sinf cannot move
    them."""
    real = chains._crop_params

    def crop_params(*args, **kw):
        y0, x0, _ = real(*args, **kw)
        return y0, x0, angles[:len(y0)]

    images, xywhn, seeds = chains.AugmentChain(
        640, device=dev).example_inputs(len(angles))
    cpu_images = images.cpu()
    chains._crop_params = crop_params
    try:
        for mode in ("cuda_full", "cuda_fused", "cuda_shear"):
            check_equal(
                chains.augment_chain(images, xywhn, seeds,
                                     rotation=mode).cpu(),
                chains.augment_chain(cpu_images, xywhn, seeds, rotation=mode),
                f"F6: chain {mode} on the card != on the CPU")
    finally:
        chains._crop_params = real


def sass_counts(so_path):
    """Static SASS instruction counts of each kernel in the library (by
    cuobjdump): {kernel: (total, [(loop size, opcodes seen), ...])}, a loop
    being the instructions from a backward branch's target to the branch."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    dump = subprocess.run([tool, "-sass", str(so_path)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    counts = {}
    for func in re.split(r"\n\s*Function : ", dump)[1:]:
        name = func.split("\n", 1)[0].strip()
        short = re.search(r"(chain_cluster_kernel|gather_luma_kernel|"
                          r"finish_kernel|shear_tile_kernel)"
                          r"(?:I((?:Li\d+E)+)E)?", name)
        if not short:
            continue
        ins = [(int(a, 16), op.strip()) for a, op in
               re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", func)]
        loops = []
        for at, op in ins:
            m = re.search(r"\bBRA\s.*?(0x[0-9a-f]+)", op)
            if m and int(m.group(1), 16) < at:
                body = [o for a, o in ins if int(m.group(1), 16) <= a <= at]
                loops.append((len(body), " ".join(body)))
        args = re.findall(r"Li(\d+)E", short.group(2) or "")
        label = short.group(1) + (f"<{','.join(args)}>" if args else "")
        counts[label] = (len(ins), loops)
    return counts


def innermost(loops, opcode):
    """Size of the smallest loop whose body holds ``opcode``."""
    sizes = [n for n, body in loops if opcode in body]
    if not sizes:
        raise AssertionError(f"no loop holds {opcode}")
    return min(sizes)


def chain_bytes(S, B, C_in):
    """Bytes the chain function must move for B images of crop S: each crop
    pixel's C_in bytes read once, each RGBA pixel written once, the shift
    vectors, the item rows and the enhance parameters."""
    return B * (S * S * (C_in + 4) + 2 * 4 * S + 16 + 32)


def rotate_bytes(S, B, C):
    """Bytes of the batched rotation: each pixel read and written once, the
    shift vectors and the D4 codes."""
    return B * (2 * S * S * C + 2 * 4 * S + 4)


def engine_image(rng, yy, xx):
    """One RGB image on the grid ``yy``, ``xx`` (a gradient with one filled
    rectangle for each box) and its YOLO label text, one to three boxes,
    each in a window that a square crop of the shorter side can hold."""
    H, W = yy.shape
    p0, p1, p2 = rng.integers(0, 256, 3)
    img = np.stack([(yy // 2 + xx // 3 + p0) % 256, (xx // 2 + p1) % 256,
                    (yy // 3 + xx // 5 + p2) % 256], -1).astype(np.uint8)
    lines = []
    for _ in range(int(rng.integers(1, 4))):
        cx, cy = rng.uniform(0.3, 0.7, 2)
        bw, bh = rng.uniform(0.05, 0.2), rng.uniform(0.05, 0.3)
        x1, x2 = int((cx - bw / 2) * W), int((cx + bw / 2) * W)
        y1, y2 = int((cy - bh / 2) * H), int((cy + bh / 2) * H)
        img[y1:y2, x1:x2] = rng.integers(0, 256, 3)
        lines.append(f"{rng.integers(0, 5)} {cx:.6f} {cy:.6f} {bw:.6f} "
                     f"{bh:.6f}")
    return img, "\n".join(lines) + "\n"


def write_engine_dataset(root, n, seed, workers):
    """``n`` RGB PNGs of ENGINE_H x ENGINE_W (engine_image) under root/imgs
    and their YOLO label files under root/labels."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    (root / "imgs").mkdir(parents=True)
    (root / "labels").mkdir()
    yy, xx = np.mgrid[0:ENGINE_H, 0:ENGINE_W]
    jobs = []
    for i in range(n):
        img, lines = engine_image(rng, yy, xx)
        (root / "labels" / f"im_{i:04d}.txt").write_text(lines)
        jobs.append((img, root / "imgs" / f"im_{i:04d}.png"))
    with ThreadPoolExecutor(workers) as ex:
        list(ex.map(lambda job: Image.fromarray(job[0]).save(job[1]), jobs))
    return root / "imgs", root / "labels"


def busy_ms(events):
    """Milliseconds covered by the union of the device events' intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, edge = 0, None
    for start, end in spans:
        if edge is None or start > edge:
            busy += end - start
            edge = end
        elif end > edge:
            busy += end - edge
            edge = end
    return busy / 1e3


def step_line(step, card):
    m = step.metrics
    return (f"engine step {step.name}: {dict(step.status_counter)}, "
            f"{m.items} items in {m.wall_seconds:.3f} s "
            f"({m.items_per_second:.1f} items/s), {m.batches} batches; "
            f"StageMetrics load {m.host_load_seconds:.3f} s, device "
            f"{m.device_seconds:.3f} s, save {m.host_save_seconds:.3f} s "
            f"(save is summed over {step.workers} saver threads); "
            f"card {card}")


def require_success(step, n_items):
    if dict(step.status_counter) != {"Success": n_items}:
        errors = [log for log in step.process_logs
                  if log["status"] != "Success"][:3]
        raise AssertionError(f"engine step {step.name}: statuses "
                             f"{dict(step.status_counter)}, expected "
                             f"{n_items} Success; first failures {errors}")


def count_files(directory, n, what):
    found = sum(1 for p in Path(directory).iterdir() if p.is_file())
    if found != n:
        raise AssertionError(f"engine: {found} files in {what}, expected {n}")
    return found


def save_as_jpg(path, output_dirs, **options):
    """Host step: one image file written again as a JPEG of the same stem
    (the border crop takes JPEG files only)."""
    from PIL import Image

    out = Path(output_dirs[0]) / f"{Path(path).stem}.jpg"
    with Image.open(path) as im:
        im.convert("RGB").save(out, quality=95)
    return out


def one_batch(transform, inputs, options, seed, device):
    """The outputs of one batch of ``transform`` on ``device``, on the
    host: ``inputs`` are the items' argument tuples (one bucket), item i
    gets the seed the engine would give it, ``seed`` + i."""
    chunk = [transform.load_item(args, options) for args in inputs]
    for i, item in enumerate(chunk):
        item["_seed"] = (seed + i) & 0x7FFFFFFF
    key = transform.bucket_key(chunk[0], options)
    out = transform.launch_batch(key, chunk, options, device)
    return {k: v.cpu() for k, v in out.items()}


def check_batches_equal(got, ref, what):
    if sorted(got) != sorted(ref):
        raise AssertionError(f"{what}: outputs {sorted(got)} != {sorted(ref)}")
    for k in ref:
        check_equal(got[k], ref[k], f"{what}[{k!r}]")


def profiled(fn):
    """Run ``fn()`` in a profiler window that opens after the profiler's
    warm-up (utils/profiling.py:warmed_profile: in one long process a bare
    session can lose its first GPU records); returns the window's device
    events and ``fn``'s result."""
    from torch.profiler import ProfilerActivity

    from image_processor_pipeline_tpu_torch.utils.profiling import (
        device_events, warmed_profile)

    with warmed_profile([ProfilerActivity.CUDA]) as prof:
        result = fn()
    return device_events(prof), result


def profiled_step(run):
    """Run ``run()`` in a warmed profiler window; returns the device
    events."""
    return profiled(run)[0]


def idle_line(step, events, card):
    busy = busy_ms(events)
    wall = step.metrics.wall_seconds * 1e3
    by_name = {}
    for e in events:
        by_name[e.name] = (by_name.get(e.name, 0)
                           + e.time_range.elapsed_us() / 1e3)
    top = sorted(((name[:48], ms) for name, ms in by_name.items()),
                 key=lambda kv: -kv[1])[:5]
    return (f"profiler, engine step {step.name}: wall {wall:.1f} ms, device "
            f"busy {busy:.1f} ms, idle share {1 - busy / wall:.4f}; largest "
            + ", ".join(f"{name} {ms:.1f}" for name, ms in top)
            + f"; card {card}"), by_name


def mask_chain_crop_pipelines(root, dev, card, workers, launches):
    """The engine's pipelines C, D and E on ``dev`` over ENGINE_STEP_ITEMS
    of pipeline A's crops under ``root``, with their checks; adds pipeline
    D's launches of the rotation kernel to ``launches`` and returns the
    kernel's measurements at the Rotate stage's shape."""
    from image_processor_pipeline_tpu_torch import (ProcessingPipeline,
                                                    ProcessingStep, kernels)
    from image_processor_pipeline_tpu_torch.ops import ccl
    from image_processor_pipeline_tpu_torch.transforms import (
        BorderCrop, ColorMaskTransparency, EnhanceImage, FitCrop,
        FusedChain, KeepLargestComponent, fused)

    k = ENGINE_STEP_ITEMS
    crops_dir = root / "A" / "crops" / "imgs"
    mask_options = {"color_ranges_to_exclude_hsv": ENGINE_MASK_RANGES}
    clean_options = {"min_component_size": 500}
    border_options = {"crop_margins": (0.1, 24, 0.05, 12)}
    chain = FusedChain([
        fused.Rotate(method="shear"), fused.Flip(),
        fused.ColorMask(ENGINE_MASK_RANGES), fused.Cleanup(),
        fused.Enhance()])
    common = {"workers": workers, "save_log": True}
    pipe_c = ProcessingPipeline(root_dir=root / "C")
    pipe_c.add_step(ProcessingStep(
        "color_mask", ColorMaskTransparency(), input_dirs=[crops_dir],
        output_dirs=["mask"], seed=21, sample_k=k, options=mask_options,
        device=dev, **common))
    pipe_c.add_step(ProcessingStep(
        "cleanup", KeepLargestComponent(), output_dirs=["clean"],
        seed=22, options=clean_options, device=dev, **common))
    pipe_d = ProcessingPipeline(root_dir=root / "D")
    pipe_d.add_step(ProcessingStep(
        "fused_chain", chain, input_dirs=[crops_dir], output_dirs=["out"],
        seed=23, sample_k=k, device=dev, **common))
    pipe_e = ProcessingPipeline(root_dir=root / "E")
    pipe_e.add_step(ProcessingStep(
        "to_jpg", save_as_jpg, input_dirs=[crops_dir],
        output_dirs=["jpg"], seed=24, sample_k=k, **common))
    pipe_e.add_step(ProcessingStep(
        "enhance", EnhanceImage(), output_dirs=["enhance"], seed=25,
        pairing_method="sample", device=dev, **common))
    pipe_e.add_step(ProcessingStep(
        "border_crop", BorderCrop(), output_dirs=["border"], seed=26,
        options=border_options, device=dev, **common))
    pipe_e.add_step(ProcessingStep(
        "fit_crop", FitCrop(), output_dirs=["fit"], seed=27, device=dev,
        **common))

    # every labeling of a run: its most sweeps an item, kept on the card
    sweeps = []
    real_label = ccl.label_components

    def counting_label(fg, **kw):
        labels, iters = real_label(fg, return_iters=True, **kw)
        sweeps.append(iters.max())
        return labels

    def with_sweeps(run):
        """(device events, sweeps and host read-backs of each batch)."""
        del sweeps[:]
        ccl.label_components = counting_label
        try:
            events = profiled_step(run)
        finally:
            ccl.label_components = real_label
        every = ccl.CHECK_EVERY
        ran = [-(-int(m) // every) * every for m in sweeps]
        return events, ran, [r // every for r in ran]

    t0 = time.perf_counter()
    mask_step, clean_step = pipe_c.steps
    pipe_c.run(from_step_index=0, only_one=True, progress=False)
    clean_events, clean_sweeps, clean_reads = with_sweeps(
        lambda: pipe_c.run(from_step_index=1, progress=False))
    chain_step = pipe_d.steps[0]
    ((chain_events, chain_sweeps, chain_reads), counts), chain_direct = \
        count_direct_tiles(kernels, dev, lambda: drive(
            kernels, None,
            lambda: with_sweeps(lambda: pipe_d.run(progress=False))))
    pipe_e.run(progress=False)
    new_s = time.perf_counter() - t0
    for step in (*pipe_c.steps, chain_step, *pipe_e.steps):
        require_success(step, k)
        print(step_line(step, card))
    files = {f"{pipe}/{name}": count_files(root / pipe / name, k, name)
             for pipe, name in (("C", "mask"), ("C", "clean"),
                                ("D", "out"), ("E", "jpg"),
                                ("E", "enhance"), ("E", "border"),
                                ("E", "fit"))}
    print(f"engine files of pipelines C, D, E: {files} in {new_s:.1f} s")
    want = {name: 0 for name in counts} | {
        "shear_rotate_packed": chain_step.metrics.batches}
    if counts != want or chain_step.metrics.batches < k // 8:
        raise AssertionError(f"pipeline D launch counts {counts}, "
                             f"expected {want}")
    if chain_direct:
        raise AssertionError(f"pipeline D: {chain_direct} tiles took the "
                             f"direct gather")
    launches["shear_rotate_packed"] += counts["shear_rotate_packed"]
    print(f"pipeline D: shear_rotate_packed launched "
          f"{counts['shear_rotate_packed']} times, once for each of the "
          f"fused chain's {chain_step.metrics.batches} batches; direct "
          f"tiles {chain_direct}")
    for step, events, ran, reads in (
            (clean_step, clean_events, clean_sweeps, clean_reads),
            (chain_step, chain_events, chain_sweeps, chain_reads)):
        line, by_name = idle_line(step, events, card)
        print(line)
        print(f"  connected components in step {step.name}: sweeps a "
              f"batch {ran}, host read-backs a batch {reads} (one every "
              f"{ccl.CHECK_EVERY} sweeps)")
        if len(ran) != step.metrics.batches \
                or min(ran) < ccl.CHECK_EVERY:
            raise AssertionError(f"{step.name}: {len(ran)} labelings for "
                                 f"{step.metrics.batches} batches")
    if not any("shear_tile_kernel" in name for name in by_name):
        raise AssertionError("profiler saw no shear_tile_kernel in "
                             "pipeline D")

    # outputs are not degenerate
    from PIL import Image

    masked = [np.asarray(Image.open(p))[..., 3]
              for p in sorted((root / "C/clean").iterdir())]
    share = float(np.mean([(a == 0).mean() for a in masked]))
    if not (any((a == 0).any() for a in masked)
            and all((a == 255).any() for a in masked)):
        raise AssertionError("pipeline C: alpha is degenerate")
    same = sum(
        np.array_equal(np.asarray(Image.open(p).convert("RGB")),
                       np.asarray(Image.open(crops_dir / p.name)))
        for p in (root / "D/out").iterdir())
    if same:
        raise AssertionError(f"pipeline D: {same} files equal their "
                             f"inputs")
    fit_sizes = {Image.open(p).size
                 for p in (root / "E/fit").iterdir()}
    print(f"pipeline C: transparent share of the cleaned files "
          f"{share:.3f}; pipeline D: no output equals its input; "
          f"pipeline E: fit-crop sizes {sorted(fit_sizes)}")

    # one batch of each new step: the card against the CPU, byte for
    # byte; and pipeline D's against the plain twin in the kernel's place
    def first(directory, n=8):
        return [(p,) for p in sorted(Path(directory).iterdir())[:n]]

    flagged = [(p, i % 2 == 0, i % 3 == 0)
               for i, (p,) in enumerate(first(root / "E/jpg"))]
    chain_on_card = None
    for name, transform, inputs, options, seed in (
            ("color_mask", mask_step.process_function, first(crops_dir),
             mask_options, 21),
            ("cleanup", clean_step.process_function,
             first(root / "C/mask"), clean_options, 22),
            ("fused_chain", chain, first(crops_dir), {}, 23),
            ("enhance", pipe_e.steps[1].process_function, flagged, {},
             25),
            ("border_crop", pipe_e.steps[2].process_function,
             first(root / "E/enhance"), border_options, 26),
            ("fit_crop", pipe_e.steps[3].process_function,
             first(root / "E/border"), {}, 27)):
        on_card = one_batch(transform, inputs, options, seed, dev)
        check_batches_equal(
            on_card, one_batch(transform, inputs, options, seed, "cpu"),
            f"engine step {name} device_fn, card != CPU")
        shapes = {k_: tuple(v.shape) for k_, v in on_card.items()}
        print(f"engine: one {name} batch, device_fn on the card == on "
              f"the CPU, byte for byte: {shapes}")
        if name == "fused_chain":
            chain_on_card = on_card
    real_batch = fused.rotate_ops.rotate_square_shear_batch
    fused.rotate_ops.rotate_square_shear_batch = plain_rotate_batch
    try:
        with_plain = one_batch(chain, first(crops_dir), {}, 23, dev)
    finally:
        fused.rotate_ops.rotate_square_shear_batch = real_batch
    check_batches_equal(chain_on_card, with_plain,
                        "pipeline D device_fn, kernel != plain twin")
    print("engine: one fused_chain batch, device_fn with the kernel == "
          "with geometry.rotate_square_shear_by in its place, byte for "
          "byte")

    # the kernel alone at the Rotate stage's shape, one batch of 8
    return rotation_kernel_alone(
        chain_on_card["image"].shape[1], dev, card, "the Rotate stage",
        counts["shear_rotate_packed"], k)


def rotation_kernel_alone(S, dev, card, where, launches_a_step, items,
                          B=8):
    """K2 alone on a batch of B random RGBA canvases of S, held against its
    plain twin: its device ms a launch, its byte bound and the plain
    twin's ms a call."""
    from image_processor_pipeline_tpu_torch.ops import geometry, rotate

    rng = np.random.default_rng(S + B)
    imgs = torch.as_tensor(rng.integers(0, 256, (B, S, S, 4), np.uint8),
                           device=dev)
    shifts = geometry.shear_params(torch.as_tensor(
        rng.uniform(1, 359, B).astype(np.float32), device=dev), S)
    err, direct = count_direct_tiles(
        rotate.kernels, dev, lambda: check_equal(
            rotate.launch_shear(imgs, *shifts),
            geometry.rotate_square_shear_by(imgs, *shifts),
            f"shear_rotate_packed at {where}'s shape"))
    if direct:
        raise AssertionError(f"shear_rotate_packed at {where}'s shape: "
                             f"{direct} direct tiles")
    alone = {
        "shape": [B, S, S, 4],
        "ms": device_ms(lambda: rotate.launch_shear(imgs, *shifts)),
        "plain_ms": statistics.median(time_calls(
            lambda i: geometry.rotate_square_shear_by(imgs, *shifts),
            calls=5, windows=3)),
        "bound_ms": rotate_bytes(S, B, 4) / HBM_BYTES_PER_S * 1e3,
        "launches_a_step": launches_a_step, "max_abs_err": err}
    print(f"shear_rotate_packed at {where}'s shape {alone['shape']}: "
          f"== plain, 0 direct tiles; kernel {alone['ms']:.4f} ms of device "
          f"time a launch, bound {alone['bound_ms']:.4f} ms "
          f"({rotate_bytes(S, B, 4)} bytes at 3.35 TB/s, share "
          f"{alone['bound_ms'] / alone['ms']:.3f}), plain "
          f"{alone['plain_ms']:.4f} ms a call, {launches_a_step} launches "
          f"a step of {items} items; card {card}")
    return alone


def write_overlays(directory, n, seed):
    """``n`` RGBA overlays of 80 x 80 as benchmarks/eval_configs.py makes
    them: an opaque square of one colour in a transparent frame."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    directory.mkdir(parents=True)
    for i in range(n):
        ov = np.zeros((80, 80, 4), np.uint8)
        ov[10:70, 10:70] = [*rng.integers(0, 256, 3), 255]
        Image.fromarray(ov).save(directory / f"ov{i:03d}.png")
    return directory


def write_clip(directory, n, seed):
    """A clip of ``n`` CLIP_W x CLIP_H frames (gradients, a moving block
    and noise) written with cv2: mp4v, or MJPG in an .avi where this cv2
    cannot write mp4v; raises when it writes neither."""
    import cv2

    directory.mkdir(parents=True)
    for name, fourcc in (("clip.mp4", "mp4v"), ("clip.avi", "MJPG")):
        path = directory / name
        writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc),
                                 10, (CLIP_W, CLIP_H))
        if writer.isOpened():
            break
        writer.release()
        path.unlink(missing_ok=True)
    else:
        raise RuntimeError("cv2 writes neither mp4v nor MJPG here")
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:CLIP_H, 0:CLIP_W]
    for i in range(n):
        frame = np.stack([(yy // 2 + 7 * i) % 256, (xx // 3) % 256,
                          (xx // 5 + yy // 4 + 11 * i) % 256], -1)
        frame = (frame + rng.integers(0, 24, frame.shape)).astype(np.uint8)
        y, x = 10 * i, 20 * i
        frame[y:y + 120, x:x + 160] = rng.integers(0, 256, 3)
        writer.write(np.ascontiguousarray(frame[..., ::-1]))  # BGR
    writer.release()
    return path, fourcc


def overlay_video_pipelines(root, dev, card, workers, launches):
    """BASELINE.json config 4 (overlays over JPEG copies of the dataset's
    images, then a border crop; and OverlaysBorderCrop), config 5 (frames
    of a clip into FusedChain([Rotate(shear), Flip, Enhance])) and the
    composites RotationsSymmetries and RotationsChain over pipeline A's
    crops, all on ``dev``, with their checks; adds the rotation kernel's
    launches to ``launches`` and returns the kernel's measurements at the
    frames' canvas."""
    from PIL import Image

    from image_processor_pipeline_tpu_torch import (ProcessingPipeline,
                                                    ProcessingStep, kernels)
    from image_processor_pipeline_tpu_torch.transforms import (
        BorderCrop, FusedChain, OverlaysBorderCrop, PasteOverlayOntoBackground,
        RotationsChain, RotationsSymmetries, frame_extraction, fused)

    common = {"workers": workers, "save_log": True}
    margins = {"crop_margins": (0.05, 0.05, 0.05, 0.05)}
    comp_options = {"method": "shear", "num_rotations": ENGINE_ROTATIONS}
    crops_dir = root / "A" / "crops" / "imgs"
    t0 = time.perf_counter()
    ov_dir = write_overlays(root / "data" / "overlays", OVERLAYS, 41)
    clip, fourcc = write_clip(root / "data" / "video", CLIP_FRAMES, 42)
    print(f"overlay and video data: {OVERLAYS} RGBA overlays of 80 x 80, a "
          f"{fourcc} clip of {CLIP_FRAMES} frames of {CLIP_W} x {CLIP_H} "
          f"({clip.stat().st_size} bytes) in {time.perf_counter() - t0:.1f} "
          f"s")

    pipe_o = ProcessingPipeline(root_dir=root / "O")   # config 4
    pipe_o.add_step(ProcessingStep(
        "backgrounds", save_as_jpg, input_dirs=[root / "data" / "imgs"],
        output_dirs=["bg"], **common))
    pipe_o.add_step(ProcessingStep(
        "paste", PasteOverlayOntoBackground(), input_dirs=[ov_dir, "bg"],
        output_dirs=["paste/imgs", "paste/labels"], pairing_method="modulo",
        seed=31, fixed_input=True, device=dev, **common))
    pipe_o.add_step(ProcessingStep(
        "border_crop4", BorderCrop(), input_dirs=["paste/imgs"],
        output_dirs=["crop"], seed=32, fixed_input=True, options=margins,
        device=dev, **common))
    pipe_o.add_step(ProcessingStep(
        "overlays_border_crop", OverlaysBorderCrop(),
        input_dirs=[ov_dir, "bg"], output_dirs=["ob/imgs", "ob/labels"],
        pairing_method="modulo", seed=31, fixed_input=True, options=margins,
        device=dev, **common))
    video_chain = FusedChain([fused.Rotate(method="shear"), fused.Flip(),
                              fused.Enhance()])
    pipe_v = ProcessingPipeline(root_dir=root / "V")   # config 5
    pipe_v.add_step(ProcessingStep(
        "frames", frame_extraction, input_dirs=[clip.parent],
        output_dirs=["frames"], options={"file_basename": "clip"},
        **common))
    pipe_v.add_step(ProcessingStep(
        "video_chain", video_chain,
        input_dirs=[f"frames/{clip.stem}/0-raw"], output_dirs=["aug"],
        seed=33, fixed_input=True, device=dev, **common))
    tail = [fused.Flip(), fused.ColorMask(ENGINE_MASK_RANGES),
            fused.Enhance()]
    pipe_r = ProcessingPipeline(root_dir=root / "R")   # the composites
    pipe_r.add_step(ProcessingStep(
        "rotations_symmetries", RotationsSymmetries(),
        input_dirs=[crops_dir], output_dirs=["rotsym"], seed=34,
        sample_k=COMPOSITE_ITEMS, options=comp_options, device=dev,
        **common))
    pipe_r.add_step(ProcessingStep(
        "rotations_chain", RotationsChain(tail), input_dirs=[crops_dir],
        output_dirs=["rotchain"], seed=35, sample_k=COMPOSITE_ITEMS,
        fixed_input=True, options=comp_options, device=dev, **common))

    # each step alone, its launch counts set to 0 just before and read
    # just after: the overlay steps launch no kernel, the others the
    # rotation kernel once a batch, with no direct tile
    events = {}

    def run_step(pipe, index, profiled=False):
        step = pipe.steps[index]

        def run():
            return pipe.run(from_step_index=index, only_one=True,
                            progress=False)

        (result, counts), direct = count_direct_tiles(
            kernels, dev, lambda: drive(
                kernels, None, (lambda: profiled_step(run)) if profiled
                else run))
        if profiled:
            events[step.name] = result
        rotates = step.name in ("video_chain", "rotations_symmetries",
                                "rotations_chain")
        want = {name: 0 for name in counts} | (
            {"shear_rotate_packed": step.metrics.batches} if rotates else {})
        if counts != want or direct:
            raise AssertionError(f"step {step.name}: launch counts {counts},"
                                 f" expected {want}; direct tiles {direct}")
        if rotates:
            launches["shear_rotate_packed"] += counts["shear_rotate_packed"]
            print(f"step {step.name}: shear_rotate_packed launched "
                  f"{counts['shear_rotate_packed']} times, once for each of "
                  f"its {step.metrics.batches} batches; direct tiles "
                  f"{direct}")
        return step

    t0 = time.perf_counter()
    steps = [run_step(pipe_o, i) for i in range(4)]
    steps += [run_step(pipe_v, 0), run_step(pipe_v, 1, profiled=True)]
    steps += [run_step(pipe_r, 0), run_step(pipe_r, 1)]
    phase_s = time.perf_counter() - t0
    n_ov, n_bg = OVERLAYS, ENGINE_IMAGES
    slots = ENGINE_ROTATIONS + 1
    for step, items in zip(steps, (n_bg, n_ov, n_ov, n_ov, 1, CLIP_FRAMES,
                                   COMPOSITE_ITEMS, COMPOSITE_ITEMS)):
        require_success(step, items)
        print(step_line(step, card))
    files = {f"{pipe}/{name}": count_files(root / pipe / name, n, name)
             for pipe, name, n in (
                 ("O", "bg", n_bg), ("O", "paste/imgs", n_ov),
                 ("O", "paste/labels", n_ov), ("O", "crop", n_ov),
                 ("O", "ob/imgs", n_ov), ("O", "ob/labels", n_ov),
                 ("V", f"frames/{clip.stem}/0-raw", CLIP_FRAMES),
                 ("V", "aug", CLIP_FRAMES),
                 ("R", "rotsym", COMPOSITE_ITEMS * slots * 4),
                 ("R", "rotchain", COMPOSITE_ITEMS * slots))}
    print(f"files of configs 4, 5 and the composites: {files} in "
          f"{phase_s:.1f} s")
    chain_step = steps[5]
    line, by_name = idle_line(chain_step, events[chain_step.name], card)
    print(line)
    if not any("shear_tile_kernel" in name for name in by_name):
        raise AssertionError("profiler saw no shear_tile_kernel in the "
                             "video chain")

    # outputs are not degenerate: each composite differs from its
    # background inside its label's box far more than outside it; the
    # fused crop is the unfused one's size with the same label; rotated
    # frames and slots differ from their sources
    o = root / "O"
    inside, outside = [], []
    for log in pipe_o.steps[1].process_logs:
        bg_path = Path(log["inputs"][1])
        name = f"{Path(log['inputs'][0]).stem}{bg_path.suffix}"
        label = (o / "paste/labels" / f"{Path(name).stem}.txt").read_text()
        if label.endswith("\n") or label != (
                o / "ob/labels" / f"{Path(name).stem}.txt").read_text():
            raise AssertionError(f"config 4: label of {name}: {label!r}")
        cx, cy, w, h = (float(v) for v in label.split()[1:])
        got = np.asarray(Image.open(o / "paste/imgs" / name)).astype(int)
        bg = np.asarray(Image.open(bg_path)).astype(int)
        H, W = bg.shape[:2]
        box = np.zeros((H, W), bool)
        box[int((cy - h / 4) * H):int((cy + h / 4) * H),
            int((cx - w / 4) * W):int((cx + w / 4) * W)] = True
        if not (0 < w <= 1 and 0 < h <= 1) or not box.any():
            raise AssertionError(f"config 4: {name}: box {label!r}")
        diff = np.abs(got - bg).mean(-1)
        inside.append(float(diff[box].mean()))
        outside.append(float(diff[~box].mean()))
        if Image.open(o / "ob/imgs" / name).size \
                != Image.open(o / "crop" / name).size:
            raise AssertionError(f"config 4: {name}: the fused crop's size "
                                 f"is not the unfused one's")
    if not np.median(inside) > 4 * np.median(outside):
        raise AssertionError(f"config 4: composites hardly differ from their "
                             f"backgrounds: inside {inside}, outside "
                             f"{outside}")
    frames = sorted((root / "V/aug").iterdir())
    for p in frames:
        a = np.asarray(Image.open(p))
        if a.shape[2] != 4 or not ((a[..., 3] == 0).any()
                                   and (a[..., 3] == 255).any()):
            raise AssertionError(f"config 5: {p.name} is degenerate")
    comp_same = 0
    for p in sorted((root / "R/rotchain").glob("*_r001.png")):
        a = np.asarray(Image.open(p))
        b = np.asarray(Image.open(str(p).replace("_r001", "_r000")))
        comp_same += a.shape == b.shape and np.array_equal(a, b)
    for p in sorted((root / "R/rotsym").glob("*_r001_o.png")):
        a = np.asarray(Image.open(p))
        b = np.asarray(Image.open(str(p).replace("_r001", "_r000")))
        comp_same += a.shape == b.shape and np.array_equal(a, b)
    if comp_same:
        raise AssertionError(f"composites: {comp_same} rotations equal "
                             f"their originals")
    print(f"config 4: mean abs difference to the background, median over "
          f"the composites, inside the label box {np.median(inside):.1f}, "
          f"outside {np.median(outside):.2f}; fused crops the unfused "
          f"ones' sizes, labels equal, no trailing newline; config 5: "
          f"{len(frames)} RGBA frames with transparent corners; composites: "
          f"no rotation equals its original")

    # one batch of every new step: the card against the CPU, byte for
    # byte (the paste's batch holds the overlay resize)
    ovs = sorted(ov_dir.iterdir())[:8]
    bgs = sorted((o / "bg").iterdir())[:8]
    pairs = list(zip(ovs, bgs))
    frame_files = sorted((root / "V" / "frames" / clip.stem
                          / "0-raw").iterdir())
    crops = sorted(crops_dir.iterdir())
    video_on_card = None
    for name, transform, inputs, options, seed in (
            ("paste", pipe_o.steps[1].process_function, pairs, {}, 31),
            ("overlays_border_crop", pipe_o.steps[3].process_function,
             pairs, margins, 31),
            ("video_chain", video_chain, [(p,) for p in frame_files[:8]],
             {}, 33),
            ("rotations_symmetries", pipe_r.steps[0].process_function,
             [(p,) for p in crops[:2]], comp_options, 34),
            ("rotations_chain", pipe_r.steps[1].process_function,
             [(p,) for p in crops[:2]], comp_options, 35)):
        on_card = one_batch(transform, inputs, options, seed, dev)
        check_batches_equal(
            on_card, one_batch(transform, inputs, options, seed, "cpu"),
            f"step {name} device_fn, card != CPU")
        shapes = {k: tuple(v.shape) for k, v in on_card.items()}
        print(f"one {name} batch, device_fn on the card == on the CPU, "
              f"byte for byte: {shapes}")
        if name == "video_chain":
            video_on_card = on_card

    # the kernel alone at the frames' canvas, one batch of 8
    return rotation_kernel_alone(
        video_on_card["image"].shape[1], dev, card, "the video chain",
        chain_step.metrics.batches, CLIP_FRAMES)


def same_decoded_files(a, b, what):
    """Raise unless directories ``a`` and ``b`` hold the same file names
    with equal decoded pixels; returns the number of files."""
    from PIL import Image

    names = sorted(p.name for p in Path(a).iterdir())
    if names != sorted(p.name for p in Path(b).iterdir()) or not names:
        raise AssertionError(f"{what}: file names differ or none: "
                             f"{len(names)} files")
    for name in names:
        got, want = (np.asarray(Image.open(Path(d) / name)) for d in (a, b))
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"{what}: {name} differs")
    return len(names)


def fanout_fusion_pipelines(root, dev, card, workers, launches, crops_dir,
                            masked_dir, n=FANOUT_ITEMS):
    """The five symmetry fan-out shapes, each run on ``dev`` with
    auto_fuse=False and with auto_fuse=True in roots of their own, over
    ``n`` of ``crops_dir``'s crops (the rotation-headed ones) or ``n`` of
    ``masked_dir``'s colour-masked RGBA PNGs: every item a Success, the
    fused run's final files those of the unfused run, no elided directory
    written, the rotation kernel launched once a batch of each
    rotation-headed fused step with no direct tile, one batch of each new
    class on ``dev`` equal to the same batch on the CPU.  Adds the kernel's
    launches to ``launches``; returns its measurements at the two
    rotation-headed steps' shapes."""
    from image_processor_pipeline_tpu_torch import (ProcessingPipeline,
                                                    ProcessingStep, kernels)
    from image_processor_pipeline_tpu_torch.io.batching import bucket_dim
    from image_processor_pipeline_tpu_torch.ops import ccl
    from image_processor_pipeline_tpu_torch.transforms import (
        ColorMaskTransparency, FitCrop, GenerateSymmetries,
        KeepLargestComponent, RandomRotations)

    base = root / "F"
    inputs = {}
    for name, src in (("crops", crops_dir), ("masked", masked_dir)):
        inputs[name] = base / "data" / name
        inputs[name].mkdir(parents=True)
        for p in sorted(Path(src).iterdir())[:n]:
            shutil.copy(p, inputs[name] / p.name)
    kinds = {
        "rot": (RandomRotations, {"method": "shear",
                                  "num_rotations": ENGINE_ROTATIONS}),
        "sym": (GenerateSymmetries, {}),
        "mask": (ColorMaskTransparency,
                 {"color_ranges_to_exclude_hsv": ENGINE_MASK_RANGES}),
        "clean": (KeepLargestComponent, {"min_component_size": 500}),
        "fit": (FitCrop, {})}
    # pipeline -> (its input, its steps as (kind, output dir), the classes
    # the fuser gives: the JAX fuser's for the same list)
    shapes = {
        "rotsymchain": ("crops", [("rot", "rot"), ("sym", "sym"),
                                  ("mask", "mask"), ("clean", "clean"),
                                  ("fit", "out")], ["RotSymChain"]),
        "rotchainsym": ("crops", [("rot", "rot"), ("mask", "mask"),
                                  ("clean", "clean"), ("sym", "out")],
                        ["RotationsChainSymmetries"]),
        "chainsym": ("masked", [("mask", "mask"), ("clean", "clean"),
                                ("sym", "out")], ["ChainSymmetries"]),
        "symchain": ("masked", [("mask", "mask"), ("sym", "sym"),
                                ("clean", "clean"), ("fit", "out")],
                     ["ColorMaskTransparency", "SymmetriesChain"]),
        "symchainsym": ("masked", [("mask", "mask"), ("sym", "sym"),
                                   ("clean", "clean"), ("sym", "out")],
                        ["ColorMaskTransparency",
                         "SymmetriesChainSymmetries"])}

    def build(name, run_root):
        src, specs, _ = shapes[name]
        pipe = ProcessingPipeline(root_dir=run_root)
        for i, (kind, out) in enumerate(specs):
            cls, options = kinds[kind]
            pipe.add_step(ProcessingStep(
                f"{name}_{kind}{i}", cls(),
                input_dirs=[inputs[src]] if i == 0 else None,
                output_dirs=[out], seed=60 + i, options=options, device=dev,
                workers=workers))
        return pipe

    sweeps = []
    real_label = ccl.label_components

    def counting_label(fg, **kw):
        labels, iters = real_label(fg, return_iters=True, **kw)
        sweeps.append(iters.max())
        return labels

    t_phase = time.perf_counter()
    fused_steps, rotsym_events = {}, None
    for name, (_, specs, classes) in shapes.items():
        walls, runs = {}, {}
        for fuse in (False, True):
            run_root = base / name / ("fused" if fuse else "plain")
            pipe = build(name, run_root)

            def run(pipe=pipe, fuse=fuse):
                # the wall leaves out the profiler's trace processing
                t0 = time.perf_counter()
                counts = pipe.run(progress=False, auto_fuse=fuse)
                walls[fuse] = time.perf_counter() - t0
                return counts

            del sweeps[:]
            ccl.label_components = counting_label
            # the fused RotSymChain step runs under the profiler (its wall
            # with it, which can only make the fused run look slower)
            profiled = name == "rotsymchain" and fuse
            try:
                (events, counts), direct = count_direct_tiles(
                    kernels, dev, lambda: drive(
                        kernels, None, (lambda: profiled_step(run))
                        if profiled else run))
            finally:
                ccl.label_components = real_label
            steps = pipe.last_run_steps
            runs[fuse] = (run_root, steps)
            for step in steps:
                if set(step.status_counter) != {"Success"}:
                    require_success(step, step.metrics.items)
            require_success(steps[0], n)
            got = [type(s.process_function).__name__ for s in steps]
            if fuse and got != classes:
                raise AssertionError(f"{name}: fused to {got}, expected "
                                     f"{classes}")
            if not fuse and len(steps) != len(specs):
                raise AssertionError(f"{name}: the unfused run ran {got}")
            rotating = [s for s in steps
                        if isinstance(s.process_function, RandomRotations)]
            # (kernels launch on a card only)
            want = {k: 0 for k in counts} | (
                {"shear_rotate_packed": rotating[0].metrics.batches}
                if rotating and torch.device(dev).type == "cuda" else {})
            if counts != want or direct:
                raise AssertionError(f"{name} (auto_fuse={fuse}): launch "
                                     f"counts {counts}, expected {want}; "
                                     f"direct tiles {direct}")
            launches["shear_rotate_packed"] += counts["shear_rotate_packed"]
            if fuse:
                step = steps[-1]
                fused_steps[name] = step
                print(step_line(step, card))
                every = ccl.CHECK_EVERY
                ran = [-(-int(m) // every) * every for m in sweeps]
                print(f"  connected components in step {step.name}: sweeps "
                      f"a batch {ran} over {step.metrics.batches} batches "
                      f"of up to {step.process_function.max_batch} items")
                if rotating:
                    print(f"  {name}: shear_rotate_packed launched "
                          f"{counts['shear_rotate_packed']} times, once for "
                          f"each of the fused step's "
                          f"{step.metrics.batches} batches; direct tiles "
                          f"{direct}")
                if profiled:
                    rotsym_events = events
        plain_root, plain_steps = runs[False]
        fused_root, fused_steps_run = runs[True]
        n_files = same_decoded_files(plain_root / "out", fused_root / "out",
                                     f"{name}: fused != unfused")
        kept = {str(p) for s in fused_steps_run for p in s.output_paths}
        elided = [out for _, out in specs
                  if str(fused_root / out) not in kept]
        written = [out for out in elided if (fused_root / out).exists()]
        if written or len(elided) < 2:
            raise AssertionError(f"{name}: elided {elided}, written {written}")
        print(f"fan-out pipeline {name}: unfused {len(plain_steps)} steps "
              f"{walls[False]:.3f} s, fused {[s.name for s in fused_steps_run]}"
              f" {walls[True]:.3f} s"
              + (" (under the profiler)" if name == "rotsymchain" else "")
              + f"; {n_files} final files equal (names and "
              f"decoded pixels), elided directories {elided} not written; "
              f"card {card}")
    line, _ = idle_line(fused_steps["rotsymchain"], rotsym_events, card)
    print(line)
    print(f"fan-out fusion runs: {time.perf_counter() - t_phase:.1f} s")

    # one batch of each new class: the card against the CPU, byte for byte
    from PIL import Image

    first = sorted(inputs["crops"].iterdir())[0]
    cut = base / "data" / "cut" / first.name
    cut.parent.mkdir()
    with Image.open(first) as im:
        c = (min(im.size) - FANOUT_CPU_CUT) // 2
        im.crop((c, c, c + FANOUT_CPU_CUT, c + FANOUT_CPU_CUT)).save(cut)
    alone = {}
    for name, step in fused_steps.items():
        transform = step.process_function
        rotates = isinstance(transform, RandomRotations)
        batch = [(cut,)] if rotates else [
            (p,) for p in sorted(step.input_paths[0].iterdir())[:2]]
        k = len(batch)
        on_card = one_batch(transform, batch, step.options, step.seed, dev)
        check_batches_equal(
            on_card, one_batch(transform, batch, step.options, step.seed,
                               "cpu"),
            f"{type(transform).__name__} device_fn, card != CPU")
        shapes_ = {key: tuple(v.shape) for key, v in on_card.items()}
        print(f"one {type(transform).__name__} batch of {k}, device_fn on "
              f"the card == on the CPU, byte for byte: {shapes_}")
        if rotates:
            S = bucket_dim(math.ceil(math.hypot(
                *Image.open(step.input_paths[0] / first.name).size)))
            alone[name] = rotation_kernel_alone(
                S, dev, card, type(transform).__name__,
                step.metrics.batches, n,
                B=transform.max_batch * ENGINE_ROTATIONS)
    print(f"fan-out fusion phase: {time.perf_counter() - t_phase:.1f} s")
    return alone


def write_codec_dataset(root, n, seed, workers):
    """``n`` JPEGs of ENGINE_W x ENGINE_H at q90 with 4:2:0 chroma (the
    engine dataset's gradients and filled boxes, under noise of one grey
    level) and their YOLO labels under root/imgs and root/labels, and four
    odd files of the same kind: 4:4:4, 4:2:2, grayscale and progressive."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    (root / "imgs").mkdir(parents=True)
    (root / "labels").mkdir()
    yy, xx = np.mgrid[0:ENGINE_H, 0:ENGINE_W]
    odd = {n: {"subsampling": 0}, n + 1: {"subsampling": 1},
           n + 2: {"gray": True}, n + 3: {"progressive": True}}
    jobs = []
    for i in range(n + len(odd)):
        img, lines = engine_image(rng, yy, xx)
        img = np.clip(img + rng.integers(-1, 2, img.shape), 0, 255).astype(
            np.uint8)
        (root / "labels" / f"im_{i:04d}.txt").write_text(lines)
        jobs.append((img, root / "imgs" / f"im_{i:04d}.jpg",
                     dict(odd.get(i, {}))))

    def save(job):
        img, path, kw = job
        im = Image.fromarray(img)
        if kw.pop("gray", False):
            im = im.convert("L")
        im.save(path, quality=90, **kw)

    with ThreadPoolExecutor(workers) as ex:
        list(ex.map(save, jobs))
    return root / "imgs", root / "labels"


def pipeline_j(root, imgs, labels, dev, codec, workers, decode_tally):
    """Pipeline J under ``root`` on ``dev`` with the codec options
    ``codec``: crop_square (.jpg at q95), rotations (method "shear", 4 an
    image, output_format "jpeg" at q75), symmetry (.jpg at q95).  Runs the
    steps one by one, the rotations step under the profiler; returns the
    steps, each with ``decode`` (its items through the sparse read, the
    dense re-read and the host decode, from ``decode_tally``) and the
    rotations step's device events."""
    from image_processor_pipeline_tpu_torch import (ProcessingPipeline,
                                                    ProcessingStep)
    from image_processor_pipeline_tpu_torch.transforms import (
        GenerateSymmetries, RandomRotations, SquareCropAroundBBox)

    pipe = ProcessingPipeline(root_dir=root)
    common = {"workers": workers, "device": dev, "save_log": True}
    pipe.add_step(ProcessingStep(
        "crop_square", SquareCropAroundBBox(), input_dirs=[imgs, labels],
        output_dirs=["crops/imgs", "crops/labels"], pairing_method="zip",
        seed=21, options=dict(codec), **common))
    pipe.add_step(ProcessingStep(
        "rotations", RandomRotations(), input_dirs=[root / "crops" / "imgs"],
        output_dirs=["rot"], seed=22, options=dict(
            codec, method="shear", num_rotations=ENGINE_ROTATIONS,
            output_format="jpeg"), **common))
    pipe.add_step(ProcessingStep(
        "symmetry", GenerateSymmetries(), output_dirs=["sym"], seed=23,
        options=dict(codec), **common))
    events = None
    for i, step in enumerate(pipe.steps):
        decode_tally.clear()
        if step.name == "rotations":
            events = profiled_step(lambda: pipe.run(
                from_step_index=i, only_one=True, progress=False))
        else:
            pipe.run(from_step_index=i, only_one=True, progress=False)
        step.decode = {k: decode_tally.get(k, 0)
                       for k in ("sparse", "dense", "host")}
    return pipe.steps, events


def codec_device_halves(dev, card, B=32, S=512):
    """encode_start_sparse and decode_finish_sparse (ops/jpeg.py) on one
    [B, S, S, 3] batch at q95 with encode_shrink's cap, on the card and on
    the CPU, byte for byte, and the round trip through both; their device
    milliseconds a call, the bytes each must move and its torch launches a
    call.  Returns the measurements."""
    from image_processor_pipeline_tpu_torch.ops import jpeg

    rng = np.random.default_rng(31)
    yy, xx = np.mgrid[0:S, 0:S]
    rgb = np.stack([engine_image(rng, yy, xx)[0] for _ in range(B)])
    rgb = np.clip(rgb + rng.integers(-1, 2, rgb.shape), 0, 255).astype(
        np.uint8)
    cap = max(1024, int(S * S * 3 // 2 * 0.25))
    qt = jpeg.quality_qtabs(95).astype(np.int32)
    kw_enc = dict(cap_h=S, cap_w=S, cap_nnz=cap)
    kw_dec = dict(samp=(2, 2), cap_h=S, cap_w=S, cap_by_c=S // 16,
                  cap_bx_c=S // 16)
    args = {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        args[where] = [torch.as_tensor(a, device=d) for a in (
            rgb, np.full(B, S, np.int32), np.full(B, S, np.int32), qt,
            np.repeat(qt[None], B, 0))]
    enc = {w: jpeg.encode_start_sparse(*a[:4], **kw_enc)
           for w, a in args.items()}
    for name, x, y in zip(("idx", "val", "nnz"), enc["card"], enc["cpu"]):
        check_equal(x.cpu(), y, f"encode_start_sparse {name}, card != CPU")
    nnz = enc["cpu"][2]
    if int(nnz.max()) > cap:
        raise AssertionError(f"codec halves: an item overflowed the cap "
                             f"{cap}: nnz {nnz.tolist()}")
    dec = {w: jpeg.decode_finish_sparse(e[0], e[1], args[w][4], args[w][1],
                                        args[w][2], **kw_dec)
           for w, e in enc.items()}
    check_equal(dec["card"].cpu(), dec["cpu"],
                "decode_finish_sparse of encode_start_sparse, card != CPU")
    err = (dec["cpu"].int() - torch.as_tensor(rgb).int()).abs()
    a = args["card"]
    idx, val, _ = enc["card"]
    calls = {
        "encode_start_sparse": lambda: jpeg.encode_start_sparse(*a[:4],
                                                                **kw_enc),
        "decode_finish_sparse": lambda: jpeg.decode_finish_sparse(
            idx, val, a[4], a[1], a[2], **kw_dec)}
    moved = {"encode_start_sparse": B * S * S * 3 + B * cap * 6 + B * 4,
             "decode_finish_sparse": B * cap * 6 + B * S * S * 3}
    out = {}
    for name, fn in calls.items():
        ms = device_ms(fn, calls=10)
        fn()
        torch.cuda.synchronize()
        n_launch = sum(1 for e in profiled_step(fn)
                       if "emcpy" not in e.name and "emset" not in e.name)
        bound = moved[name] / HBM_BYTES_PER_S * 1e3
        out[name] = {"ms": ms, "bytes": moved[name], "bound_ms": bound,
                     "torch_launches": n_launch, "shape": [B, S, S, 3]}
        print(f"codec {name} [{B}, {S}, {S}, 3] q95, cap {cap}: {ms:.4f} ms "
              f"of device time a call (CUDA-event window of 10 calls), "
              f"{moved[name]} bytes, bound {bound:.4f} ms at 3.35 TB/s "
              f"(share {bound / ms:.4f}), {n_launch} torch launches a call; "
              f"card {card}")
    print(f"codec device halves: encode_start_sparse and decode_finish_sparse"
          f" on the card == on the CPU, byte for byte (idx, val, nnz and "
          f"the round trip); nnz {int(nnz.min())}..{int(nnz.max())} of cap "
          f"{cap}; round trip against the input: max abs err "
          f"{int(err.max())}, mean {float(err.float().mean()):.4f}")
    return out


#: the coder's entry points the engine calls, timed in the codec phase
CODER_CALLS = ("read_jpeg_coefs_sparse_batch", "read_jpeg_coefs_batch",
               "write_jpeg_coefs_sparse")
#: the device halves of the transports, counted in the codec phase
TRANSPORT_CALLS = ("decode_finish_sparse", "decode_finish",
                   "encode_start_sparse")


def spied(module, names, record):
    """Wrap ``module``'s functions ``names`` so that each call adds its
    seconds and one call to ``record[name]``; returns a function that puts
    the originals back.  Callers reach them through the module, so the
    engine's calls are seen."""
    import threading

    lock = threading.Lock()
    real = {name: getattr(module, name) for name in names}

    def wrap(name):
        def call(*a, **k):
            t0 = time.perf_counter()
            try:
                return real[name](*a, **k)
            finally:
                dt = time.perf_counter() - t0
                with lock:
                    calls, secs = record.get(name, (0, 0.0))
                    record[name] = (calls + 1, secs + dt)
        return call

    for name in names:
        setattr(module, name, wrap(name))

    def restore():
        for name, fn in real.items():
            setattr(module, name, fn)
    return restore


def host_build_line(module):
    """How a host library of the port came to be loaded in this run:
    compiled, in the seconds utils/native_build.py timed, or loaded as an
    earlier process built it."""
    from image_processor_pipeline_tpu_torch.utils import native_build

    name = module._SO.name
    secs = native_build.BUILD_SECONDS.get(name)
    how = (f"built in {secs:.1f} s" if secs is not None
           else "loaded as an earlier process built it")
    return (f"{name} {how} from {module.SOURCE.name} (g++ "
            f"{' '.join(module.CXX_FLAGS)} {' '.join(module.LIBS)})")


def coder_round_trip(base, card):
    """The coder alone, no libjpeg in the loop: Pillow's baseline 4:2:0
    files at q75 and q95, read and written back at their quality, equal
    their source byte for byte.  Returns the files checked."""
    from PIL import Image

    from image_processor_pipeline_tpu_torch.io import jcoef

    rng = np.random.default_rng(33)
    yy, xx = np.mgrid[0:ENGINE_H, 0:ENGINE_W]
    base.mkdir(parents=True)
    n = 0
    for q in (75, 95):
        for h, w in ((ENGINE_H, ENGINE_W), (479, 639), (17, 33), (8, 200)):
            img = engine_image(rng, yy, xx)[0][:h, :w]
            src, out = base / f"src_{q}_{h}x{w}.jpg", base / "out.jpg"
            Image.fromarray(np.ascontiguousarray(img)).save(src, quality=q)
            cap = (-(-h // 16) * 2, -(-w // 16) * 2)
            cap_c = (cap[0] // 2, cap[1] // 2)
            res = jcoef.read_jpeg_coefs(src, cap, cap_c)
            if res is None:
                raise AssertionError(f"coder round trip: {src.name} did not "
                                     f"read")
            cy, cc, _, info = res
            ok = jcoef.write_jpeg_coefs(out, cy, cc, h, w, q)
            if not ok or out.read_bytes() != src.read_bytes():
                a, b = src.read_bytes(), out.read_bytes()
                at = next((i for i in range(min(len(a), len(b)))
                           if a[i] != b[i]), min(len(a), len(b)))
                raise AssertionError(
                    f"coder round trip: {src.name} written back differs "
                    f"from Pillow's file (written {ok}, sizes {len(a)} / "
                    f"{len(b)}, first difference at byte {at}: "
                    f"{a[max(at - 8, 0):at + 8].hex()} / "
                    f"{b[max(at - 8, 0):at + 8].hex()})")
            n += 1
    print(f"codec: coder round trip, Pillow's baseline 4:2:0 files at q75 "
          f"and q95 (4 sizes each) read and written back by the coder == "
          f"their source, byte for byte: {n} files; card {card}")
    return n


def codec_pipelines(root, dev, card, workers, launches):
    """Pipeline J over CODEC_IMAGES JPEGs (and four odd ones) on ``dev``,
    once with the codec gates on "auto" and once with device_decode and
    device_encode False.  The coefficient coder (io/jcoef.py) must build;
    the "auto" run must take both transports (the device halves called,
    items through the sparse read, only the odd files on the host decode)
    and fetch fewer bytes than the run with the gates off; every item a
    Success, the two runs' files byte-identical, the file counts right,
    the rotation kernel launched once a rotations batch with no direct
    tile; then the coder alone (a round trip of Pillow's files, and its
    read and write seconds over the dataset) and the device halves alone.
    Adds the kernel's launches to ``launches``; returns the phase's
    measurements."""
    from image_processor_pipeline_tpu_torch import kernels
    from image_processor_pipeline_tpu_torch.io import images as io_images
    from image_processor_pipeline_tpu_torch.io import jcoef, native
    from image_processor_pipeline_tpu_torch.ops import jpeg

    t_phase = time.perf_counter()
    status = ("available" if native.available()
              else f"unavailable: {native.build_error()}")
    print(f"native_io: {status}".replace("\n", " | "))
    if not jcoef.available():
        raise AssertionError(f"codec: the JPEG coefficient coder is "
                             f"unavailable: {jcoef.build_error()}")
    print(f"codec: {host_build_line(jcoef)}")
    base = root / "J"
    imgs, labels = write_codec_dataset(base / "data", CODEC_IMAGES, 19,
                                       workers)
    n = CODEC_IMAGES + 4
    n_odd = 4

    # each group decode's items by where they went; a group the hybrid
    # decode gave back (a canvas it cannot take) is host decoded
    tally = {}
    real_group = io_images._decode_group_device

    def tallied(items, *a, stats=None, **k):
        stats = {} if stats is None else stats
        before = dict(stats)
        got = real_group(items, *a, stats=stats, **k)
        for key in ("sparse", "dense", "host"):
            tally[key] = tally.get(key, 0) + stats.get(key, 0) \
                - before.get(key, 0)
        if got is None:
            tally["host"] = tally.get("host", 0) + len(items)
        return got

    runs, coder, halves_called = {}, {}, {}
    io_images._decode_group_device = tallied
    try:
        for label, codec in (("auto", {}),
                             ("off", {"device_decode": False,
                                      "device_encode": False})):
            coder[label], halves_called[label] = {}, {}
            restore = [spied(jcoef, CODER_CALLS, coder[label]),
                       spied(jpeg, TRANSPORT_CALLS, halves_called[label])]
            t0 = time.perf_counter()
            try:
                ((steps, events), direct), counts = drive(
                    kernels, None, lambda: count_direct_tiles(
                        kernels, dev, lambda: pipeline_j(
                            base / label, imgs, labels, dev, codec, workers,
                            tally)))
            finally:
                for undo in restore:
                    undo()
            runs[label] = steps
            crop, rot, sym = steps
            for step, items in ((crop, n), (rot, n), (sym, n * 5)):
                require_success(step, items)
                m = step.metrics
                print(f"codec pipeline J ({label}): {step_line(step, card)}"
                      f"; d2h_bytes_full {m.d2h_bytes_full}, "
                      f"d2h_bytes_fetched {m.d2h_bytes_fetched}; decode "
                      f"{step.decode}")
            line, _ = idle_line(rot, events, card)
            print(f"codec pipeline J ({label}): {line}")
            want = {name: 0 for name in counts} | {
                "shear_rotate_packed": rot.metrics.batches}
            if counts != want or direct:
                raise AssertionError(
                    f"codec pipeline J ({label}): launch counts {counts}, "
                    f"expected {want}; direct tiles {direct}")
            launches["shear_rotate_packed"] += counts["shear_rotate_packed"]
            called = {k: c for k, (c, _) in halves_called[label].items()}
            print(f"codec pipeline J ({label}): shear_rotate_packed launched "
                  f"{counts['shear_rotate_packed']} times, once for each of "
                  f"the rotations step's {rot.metrics.batches} batches; "
                  f"direct tiles {direct}; the transports' device halves "
                  f"called {called}; {time.perf_counter() - t0:.1f} s")
    finally:
        io_images._decode_group_device = real_group

    # the "auto" run took both transports; the run with the gates off
    # took neither and never called the coder
    auto_steps, off_steps = runs["auto"], runs["off"]
    called = halves_called["auto"]
    if not (called.get("decode_finish_sparse", (0,))[0] > 0
            and called.get("encode_start_sparse", (0,))[0] > 0):
        raise AssertionError(f"codec pipeline J (auto): the transports did "
                             f"not run: device halves called {called}")
    if halves_called["off"] or coder["off"]:
        raise AssertionError(f"codec pipeline J (off): transports ran: "
                             f"{halves_called['off']}, coder {coder['off']}")
    crop_decode = auto_steps[0].decode
    if not (crop_decode["sparse"] > 0 and crop_decode["host"] <= n_odd):
        raise AssertionError(f"codec pipeline J (auto): crop_square's "
                             f"decode {crop_decode}, expected the sparse "
                             f"read for all but at most the {n_odd} odd "
                             f"files")
    for a_step, o_step in zip(auto_steps, off_steps):
        am, om = a_step.metrics, o_step.metrics
        if not (am.d2h_bytes_full == om.d2h_bytes_full
                and 0 < am.d2h_bytes_fetched < om.d2h_bytes_fetched):
            raise AssertionError(
                f"codec pipeline J: step {a_step.name} fetched "
                f"{am.d2h_bytes_fetched} of {am.d2h_bytes_full} bytes on "
                f"auto, {om.d2h_bytes_fetched} of {om.d2h_bytes_full} off")

    files = {}
    for d, want_n in (("crops/imgs", n), ("crops/labels", n), ("rot", n * 5),
                      ("sym", None)):
        got = {p.name: p.read_bytes()
               for p in sorted((base / "auto" / d).iterdir())}
        off = {p.name: p.read_bytes()
               for p in sorted((base / "off" / d).iterdir())}
        if got != off:
            bad = sorted(k for k in got if got[k] != off.get(k))[:3]
            raise AssertionError(f"codec pipeline J: {d} differs between "
                                 f"the gates on auto and off ({len(got)} / "
                                 f"{len(off)} files; first differing "
                                 f"{bad})")
        if want_n is not None and len(got) != want_n or not got:
            raise AssertionError(f"codec pipeline J: {len(got)} files in "
                                 f"{d}, expected {want_n}")
        files[d] = len(got)
    print(f"codec pipeline J: the files of the gates on auto (the coder "
          f"and the device halves) == off (the host codec: "
          f"{'the native IO engine' if native.available() else 'Pillow'}),"
          f" byte for byte: {files}")
    for a_step, o_step in zip(auto_steps, off_steps):
        am, om = a_step.metrics, o_step.metrics
        print(f"codec pipeline J, step {a_step.name}: items/s auto "
              f"{am.items_per_second:.1f} / off {om.items_per_second:.1f}; "
              f"d2h_bytes_full {am.d2h_bytes_full}, d2h_bytes_fetched "
              f"auto {am.d2h_bytes_fetched} / off {om.d2h_bytes_fetched} "
              f"({am.d2h_bytes_fetched / om.d2h_bytes_fetched:.4f}); card "
              f"{card}")
    print(f"codec pipeline J (auto): the coder's calls and seconds, summed "
          f"over the threads that made them: "
          + ", ".join(f"{k} {c} calls {s:.3f} s"
                      for k, (c, s) in sorted(coder["auto"].items()))
          + f"; card {card}")

    # the coder alone over the dataset: one threaded read of every file,
    # then each file's coefficients written back in one thread
    paths = sorted(imgs.iterdir())
    cap = (ENGINE_H // 8, ENGINE_W // 8)
    t0 = time.perf_counter()
    sparse = jcoef.read_jpeg_coefs_sparse_batch(paths, cap, cap,
                                                n_threads=workers)
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dense = jcoef.read_jpeg_coefs_batch(paths, cap, cap, n_threads=1)
    read1_s = time.perf_counter() - t0
    out = base / "coder_out.jpg"
    t0 = time.perf_counter()
    n_written = 0
    for i in range(len(paths)):
        info = dense[3][i]
        if int(info[0]) <= 0 or int(info[2]) != 3 \
                or (int(info[3]), int(info[4])) != (2, 2):
            continue  # the writer writes 4:2:0 only
        if not jcoef.write_jpeg_coefs(out, dense[0][i], dense[1][i],
                                      int(info[0]), int(info[1]), 90):
            raise AssertionError(f"coder: writing {paths[i].name} back "
                                 f"failed")
        n_written += 1
    write_s = time.perf_counter() - t0
    failed = [p.name for p, info in zip(paths, sparse[4]) if info[0] < 0]
    print(f"codec: the coder alone over the {len(paths)} files of "
          f"{ENGINE_W} x {ENGINE_H}: sparse batch read {read_s:.3f} s on "
          f"{workers} threads ({read_s / len(paths) * 1e3:.2f} ms a file), "
          f"dense batch read {read1_s:.3f} s on 1 thread "
          f"({read1_s / len(paths) * 1e3:.2f} ms a file), write back at q90 "
          f"{write_s:.3f} s for {n_written} 4:2:0 files on 1 thread "
          f"({write_s / max(n_written, 1) * 1e3:.2f} ms a file); items the "
          f"sparse read refused: {failed}; card {card}")
    round_trip = coder_round_trip(base / "round_trip", card)
    halves = codec_device_halves(dev, card)
    print(f"codec phase: {time.perf_counter() - t_phase:.1f} s")
    return {"native_io": status, "coder": "available",
            "device_halves": halves,
            "d2h": {label: {s.name: [s.metrics.d2h_bytes_full,
                                     s.metrics.d2h_bytes_fetched]
                            for s in steps}
                    for label, steps in runs.items()},
            "items_per_second": {label: {s.name: s.metrics.items_per_second
                                         for s in steps}
                                 for label, steps in runs.items()},
            "coder_seconds": {"auto_run": coder["auto"],
                              "alone": {"files": len(paths),
                                        "read_sparse_s": read_s,
                                        "read_threads": workers,
                                        "read_dense_1_thread_s": read1_s,
                                        "write_s": write_s,
                                        "written": n_written}},
            "round_trip_files": round_trip}


REPO = Path(__file__).resolve().parent
# the entry_points phase: the CLI's rotations draw this many an image, the
# engine-mesh steps take this many crops (odd: the mesh pads), and the
# trace this many
CLI_ROTATIONS = 5
MESH_ITEMS = 63
TRACE_ITEMS = 8
# python -m's own mechanism (runpy.run_module with run_name "__main__"),
# so a run of the CLI also prints the kernels' launch counts in its
# process when it exits
CLI_CODE = (
    "import json, runpy, sys\n"
    "from image_processor_pipeline_tpu_torch import kernels\n"
    "try:\n"
    "    runpy.run_module('image_processor_pipeline_tpu_torch',\n"
    "                     run_name='__main__', alter_sys=True)\n"
    "finally:\n"
    "    print('LAUNCH_COUNTS ' + json.dumps(kernels.launch_counts),\n"
    "          flush=True)\n")


def run_clis(arg_lists):
    """Run ``python -m image_processor_pipeline_tpu_torch *args`` from the
    repository root for each argument list, all at once; raise unless
    every one exits 0.  Returns (output, wall seconds of them all, the
    kernels' launch counts in that process) for each."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", CLI_CODE, *args], cwd=REPO, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for args in arg_lists]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    results = []
    for args, p, out in zip(arg_lists, procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"CLI {args} exited {p.returncode}:\n"
                                 f"{out[-4000:]}")
        counts = [json.loads(line.split(" ", 1)[1])
                  for line in out.splitlines()
                  if line.startswith("LAUNCH_COUNTS ")]
        if len(counts) != 1:
            raise AssertionError(f"CLI {args}: no launch counts:\n{out}")
        results.append((out, wall, counts[0]))
    return results


def step_lines(out):
    """The engine's per-step summary lines a CLI run printed."""
    return [line for line in out.splitlines()
            if line.startswith("[step]") and "items/s" in line]


def tree_bytes(root, dirs):
    """{dir: {name: bytes}} of the files under each of ``dirs``."""
    return {d: {p.name: p.read_bytes() for p in sorted((root / d).iterdir())}
            for d in dirs}


def stripped_report(path, *roots):
    """A step's report entries with each of ``roots`` taken out, in input
    order."""
    text = Path(path).read_text()
    for root in roots:
        text = text.replace(str(root), "ROOT")
    return sorted(json.loads(text), key=lambda e: e["inputs"])


def entry_points(root, dev, card, workers, launches, imgs_dir, labels_dir):
    """The entry points over the engine's 128 PNGs of 640 x 480: the CLI
    (JAX's example config, rotations by shear, in a process of its own,
    with and without --auto-fuse) against the same pipeline built in this
    process; sharded_augment_step at B=64, 640 -> 512 over a one-card mesh
    and over [cuda:0, cuda:0] (K2 through cuda_shear, K1 through
    cuda_full) against the plain modes on the CPU; the engine's mesh
    (None, two entries of the card, 1) on FusedChain and RandomRotations;
    two CLI processes on the card in a gloo group over a host-sharded
    step against the one-process files; a trace_dir run; the dry run.
    Adds the kernels' launches to ``launches``; returns the measurements."""
    from image_processor_pipeline_tpu_torch import ProcessingStep, kernels
    from image_processor_pipeline_tpu_torch.__main__ import EXAMPLE
    from image_processor_pipeline_tpu_torch.config import build_pipeline
    from image_processor_pipeline_tpu_torch.models import chains
    from image_processor_pipeline_tpu_torch.parallel import dryrun
    from image_processor_pipeline_tpu_torch.parallel.mesh import (
        make_mesh, sharded_augment_step)
    from image_processor_pipeline_tpu_torch.transforms import RandomRotations
    from image_processor_pipeline_tpu_torch.transforms.fused import (
        Enhance, Flip, FusedChain, Rotate)
    from image_processor_pipeline_tpu_torch.utils.trace_probe import read_trace

    t_phase = time.perf_counter()
    base = root / "EP"
    base.mkdir()
    n = ENGINE_IMAGES
    found = {}

    def add(counts):
        for name in ("augment_full", "shear_rotate_packed"):
            launches[name] += counts[name]

    # ---- the CLI against the same pipeline built in this process --------
    rot_options = {"num_rotations": CLI_ROTATIONS, "method": "shear"}

    def config(run_root, **rotate):
        crop, rot = EXAMPLE["steps"]
        return {"root_dir": str(run_root), "steps": [
            dict(crop, input_dirs=[str(imgs_dir), str(labels_dir)],
                 workers=workers),
            dict(rot, workers=workers, save_log=True,
                 options=dict(rot_options), **rotate)]}

    dirs = ("crops/imgs", "crops/labels", "rotated")
    ref_root = base / "inprocess"
    pipe = build_pipeline(config(ref_root))
    t0 = time.perf_counter()
    counters, counts = drive(kernels, None, lambda: pipe.run(progress=False))
    ref_wall = time.perf_counter() - t0
    crop_step, rot_step = pipe.steps
    require_success(crop_step, n)
    require_success(rot_step, n)
    want = {name: 0 for name in counts} | {
        "shear_rotate_packed": rot_step.metrics.batches}
    if counts != want:
        raise AssertionError(f"in-process CLI pipeline: launch counts "
                             f"{counts}, expected {want}")
    add(counts)
    ref = tree_bytes(ref_root, dirs)
    ref_reports = {name: stripped_report(ref_root / name, ref_root)
                   for name in ("crops/crop.json", "rotate.json")}
    if [len(ref[d]) for d in dirs] != [n, n, n * (CLI_ROTATIONS + 1)]:
        raise AssertionError(f"in-process CLI pipeline: file counts "
                             f"{[len(ref[d]) for d in dirs]}")
    print(f"entry_points: the example pipeline built in this process: "
          f"{2 * n} items in {ref_wall:.3f} s ({2 * n / ref_wall:.1f} "
          f"items/s); {step_line(rot_step, card)}; shear_rotate_packed "
          f"launched {counts['shear_rotate_packed']} times")
    found["inprocess"] = {"wall_s": ref_wall, "items": 2 * n,
                          "rotations_items_per_s":
                              rot_step.metrics.items_per_second}
    # both CLI runs at once (separate roots), sharing the host's cores
    cli_runs = (("cli", []), ("cli_auto_fuse", ["--auto-fuse"]))
    for label, _ in cli_runs:
        (base / f"{label}.json").write_text(
            json.dumps(config(base / label)))
    results = run_clis([["run", str(base / f"{label}.json"), "--strict",
                         "--no-progress", *flags]
                        for label, flags in cli_runs])
    for (label, flags), (out, wall, counts) in zip(cli_runs, results):
        run_root = base / label
        if counts != want:
            raise AssertionError(f"{label}: launch counts {counts}, "
                                 f"expected {want}")
        add(counts)
        if tree_bytes(run_root, dirs) != ref:
            raise AssertionError(f"{label}: its files differ from the "
                                 f"pipeline built in this process")
        for name, entries in ref_reports.items():
            if stripped_report(run_root / name, run_root) != entries:
                raise AssertionError(f"{label}: report {name} differs")
        print(f"entry_points: python -m image_processor_pipeline_tpu_torch "
              f"run cfg.json --strict {' '.join(flags)}: exit 0, "
              f"{2 * n} items in {wall:.3f} s of process wall for both CLI "
              f"runs at once, start-up included ({2 * n / wall:.1f} items/s "
              f"a run); files and reports == "
              f"in-process, byte for byte ({[len(ref[d]) for d in dirs]} "
              f"files); shear_rotate_packed launched "
              f"{counts['shear_rotate_packed']} times in its process; "
              f"card {card}")
        for line in step_lines(out):
            print(f"  {label}: {line}")
        found[label] = {"wall_s": wall, "items": 2 * n,
                        "items_per_s": 2 * n / wall}

    # ---- sharded_augment_step: K2 (cuda_shear) and K1 (cuda_full) -------
    chain = chains.AugmentChain(input_size=640, device=dev)
    images, xywhn, seeds = chain.example_inputs(64)
    B = len(seeds)
    t0 = time.perf_counter()
    cpu_images = images.cpu()
    plain = {None: chains.augment_chain(cpu_images, xywhn, seeds, 512,
                                        "shear"),
             "cuda_full": chains.augment_chain(cpu_images, xywhn, seeds,
                                               512, "full_reference")}
    print(f"entry_points: plain 'shear' and 'full_reference' on the CPU at "
          f"B=64, 640 -> 512 in {time.perf_counter() - t0:.1f} s")
    kernel_of = {None: "shear_rotate_packed", "cuda_full": "augment_full"}
    found["sharded_step"] = {}
    for mesh_label, devices in (("1 card", [dev]),
                                ("[cuda:0, cuda:0]", [dev, dev])):
        mesh = make_mesh(devices=devices)
        for rotation, kernel in kernel_of.items():
            step = sharded_augment_step(mesh, crop=512, rotation=rotation)
            (got, count), counts = drive(
                kernels, {kernel: len(devices)},
                lambda: step(images, xywhn, seeds))
            add(counts)
            err = check_equal(got.cpu(), plain[rotation],
                              f"sharded_augment_step({mesh_label}, "
                              f"{rotation}) != the plain mode on the CPU")
            if int(count) != B:
                raise AssertionError(f"sharded_augment_step({mesh_label}, "
                                     f"{rotation}): count {int(count)} != {B}")
            ms = time_calls(lambda i: step(images, xywhn, seeds), calls=10,
                            windows=3)
            label = f"{mesh_label}, {rotation or 'None (cuda_shear)'}"
            found["sharded_step"][label] = {
                "ms": statistics.median(ms), "ms_range": [min(ms), max(ms)],
                "launches": counts[kernel], "max_abs_err": err}
            print(f"entry_points: sharded_augment_step over {mesh_label}, "
                  f"rotation {rotation or 'None -> cuda_shear'}: B={B}, "
                  f"count {int(count)}, == the plain mode on the CPU byte "
                  f"for byte, {kernel} launched {counts[kernel]} times; "
                  f"{statistics.median(ms):.3f} ms a call (median of 3 "
                  f"windows of 10, {min(ms):.3f}-{max(ms):.3f}); card {card}")
    del images, cpu_images, plain

    # ---- the engine's mesh ------------------------------------------------
    subset = base / "mesh_in"
    subset.mkdir()
    for p in sorted((ref_root / "crops/imgs").iterdir())[:MESH_ITEMS]:
        shutil.copy(p, subset / p.name)
    found["engine_mesh"] = {}
    for t_label, make, options in (
            ("FusedChain(Rotate(shear), Flip, Enhance)",
             lambda: FusedChain([Rotate(method="shear"), Flip(), Enhance()]),
             {}),
            ("RandomRotations(shear, 2)", RandomRotations,
             {"method": "shear", "num_rotations": 2})):
        files = {}
        for m_label, mesh in (("None", None),
                              ("[cuda:0, cuda:0]", make_mesh(
                                  devices=[dev, dev])), ("1", 1)):
            out_dir = base / "mesh" / f"{len(found['engine_mesh'])}_{len(files)}"
            step = ProcessingStep(
                "mesh_step", make(), input_dirs=[subset],
                output_dirs=[out_dir], seed=21, mesh=mesh, device=dev,
                workers=workers, options=options)
            _, counts = drive(kernels, None,
                              lambda: step.run(progress=False))
            require_success(step, MESH_ITEMS)
            shards = 2 if m_label.startswith("[") else 1
            want = {name: 0 for name in counts} | {
                "shear_rotate_packed": shards * step.metrics.batches}
            if counts != want:
                raise AssertionError(f"engine mesh {m_label}, {t_label}: "
                                     f"launch counts {counts}, expected "
                                     f"{want}")
            add(counts)
            files[m_label] = tree_bytes(out_dir, ["."])
            found["engine_mesh"][f"{t_label}, mesh={m_label}"] = {
                "items_per_s": step.metrics.items_per_second,
                "wall_s": step.metrics.wall_seconds,
                "batches": step.metrics.batches,
                "launches": counts["shear_rotate_packed"]}
            print(f"entry_points: engine mesh={m_label}, {t_label}: "
                  f"{step_line(step, card)}; shear_rotate_packed launched "
                  f"{counts['shear_rotate_packed']} times")
        first = files["None"]
        if any(f != first for f in files.values()) or not first["."]:
            raise AssertionError(f"engine mesh, {t_label}: the three "
                                 f"runs' files differ")
        print(f"entry_points: engine mesh, {t_label}: mesh None, "
              f"[cuda:0, cuda:0] and 1 wrote the same "
              f"{len(first['.'])} files, byte for byte")

    # ---- two processes on the card, host-sharded, over gloo ---------------
    two_root = base / "two"
    two_cfg = base / "two.json"
    two_cfg.write_text(json.dumps({"root_dir": str(two_root), "steps": [
        dict(EXAMPLE["steps"][1], input_dirs=[str(ref_root / "crops/imgs")],
             workers=workers, save_log=True, host_sharded=True,
             options=dict(rot_options))]}))
    port = 29500 + os.getpid() % 1000
    results = run_clis([
        ["run", str(two_cfg), "--strict", "--no-progress", "--coordinator",
         f"127.0.0.1:{port}", "--num-processes", "2", "--process-id",
         str(pid)] for pid in range(2)])
    counts = {name: sum(r[2][name] for r in results)
              for name in results[0][2]}
    add(counts)
    if counts["shear_rotate_packed"] < 2 or counts["augment_full"]:
        raise AssertionError(f"two processes: launch counts {counts}")
    if tree_bytes(two_root, ["rotated"]) != {"rotated": ref["rotated"]}:
        raise AssertionError("two processes: the union of their files "
                             "differs from the one-process run's")
    merged = stripped_report(two_root / "rotate.json", two_root, ref_root)
    if merged != ref_reports["rotate.json"]:
        raise AssertionError("two processes: the merged report is not the "
                             "one-process report (every item once)")
    found["two_processes"] = {"wall_s": results[0][1], "per_process": []}
    for pid, (out, wall, c) in enumerate(results):
        lines = step_lines(out)
        print(f"entry_points: process {pid} of 2 (gloo, host_sharded): "
              f"{lines[-1] if lines else out[-300:]}; shear_rotate_packed "
              f"launched {c['shear_rotate_packed']} times")
        rate = re.search(r"\(([0-9]+) items in ([0-9.]+)s, ([0-9.]+) "
                         r"items/s\)", lines[-1])
        found["two_processes"]["per_process"].append({
            "items": int(rate.group(1)), "step_s": float(rate.group(2)),
            "items_per_s": float(rate.group(3))})
    print(f"entry_points: two processes: {n} items in {results[0][1]:.3f} s "
          f"of process wall, start-up included ({n / results[0][1]:.1f} "
          f"items/s); the union of their files == the one-process run's, "
          f"the merged report holds every item once; card {card}")

    # ---- trace_dir ----------------------------------------------------------
    trace_dir = base / "trace"
    step = ProcessingStep(
        "traced", RandomRotations(), input_dirs=[subset],
        output_dirs=[base / "traced"], seed=3, device=dev,
        sample_k=TRACE_ITEMS, workers=workers, trace_dir=trace_dir,
        options={"method": "shear", "num_rotations": 1})
    _, counts = drive(kernels, None, lambda: step.run(progress=False))
    require_success(step, TRACE_ITEMS)
    add(counts)
    trace = read_trace(trace_dir)
    print(f"entry_points: trace_dir run: {trace}; shear_rotate_packed "
          f"launched {counts['shear_rotate_packed']} times")
    if trace["traces"] != 1 or not trace["names_kernel"]:
        raise AssertionError("trace_dir: the step's trace does not name "
                             "shear_tile_kernel")
    found["trace_bytes"] = next(trace_dir.glob("*.pt.trace.json")).stat(
        ).st_size

    # ---- the dry run over two entries of the card --------------------------
    _, counts = drive(kernels, None, lambda: dryrun.dryrun_multichip(
        2, devices=[dev, dev]))
    if counts["shear_rotate_packed"] < 2:
        raise AssertionError(f"dryrun_multichip: launch counts {counts}")
    add(counts)
    found["phase_s"] = time.perf_counter() - t_phase
    print(f"entry_points phase: {found['phase_s']:.1f} s")
    return found


# ---- the native compute phase ---------------------------------------------
# the nearest rotations of pipeline B's native run: this many of pipeline
# A's crops, each rotated ENGINE_ROTATIONS times (16 took 27 s of the
# phase's 67, nearly all of it PNG encoding of the symmetries)
NATIVE_ROTATION_ITEMS = 8
#: the bindings of ops/native_cpu.py, spied on in the native phase
NATIVE_BINDINGS = ("colormask_batch", "enhance_batch", "flips_batch",
                   "chain_batch", "ccl_batch", "rotations_batch",
                   "overlay_batch")


def tree_files(root, dirs):
    """{relative path: bytes} of the files under each of ``dirs`` of
    ``root``, the JSON reports left out (they carry timings)."""
    return {p.relative_to(root): p.read_bytes()
            for d in dirs for p in sorted((Path(root) / d).rglob("*"))
            if p.is_file() and p.suffix != ".json"}


def same_trees(cuda_root, native_root, dirs, what):
    """The native run's files under ``dirs`` are the CUDA run's, names
    and bytes; returns their number."""
    want, got = tree_files(cuda_root, dirs), tree_files(native_root, dirs)
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: native files "
                             f"{sorted(set(got) ^ set(want))[:6]} differ")
    bad = [str(k) for k in want if got[k] != want[k]]
    if bad or not want:
        raise AssertionError(f"{what}: {len(bad)} of {len(want)} files "
                             f"differ from the CUDA run's, e.g. {bad[:3]}")
    return len(want)


def cuda_metrics(report_dir, step_name):
    """The StageMetrics a CUDA run with save_log wrote for ``step_name``."""
    path = Path(report_dir) / f"{step_name}.metrics.json"
    return json.loads(path.read_text())["metrics"]


def native_line(step, cuda, card):
    """One step's items/s and load, compute and save seconds, native
    against CUDA (None: no comparable CUDA run)."""
    m = step.metrics
    line = (f"native step {step.name}: {m.items} items, native "
            f"{m.items_per_second:.1f} items/s (load "
            f"{m.host_load_seconds:.3f} s, compute {m.device_seconds:.3f} s, "
            f"save {m.host_save_seconds:.3f} s)")
    if cuda is not None:
        line += (f" against CUDA {cuda['items_per_second']:.1f} items/s "
                 f"(load {cuda['host_load_seconds']:.3f} s, compute "
                 f"{cuda['device_seconds']:.3f} s, save "
                 f"{cuda['host_save_seconds']:.3f} s)")
    return line + f"; {step.workers} workers, host numbers; card {card}"


def native_compute_pipelines(root, dev, card, workers, imgs_dir, labels_dir):
    """The engine's pipelines again with options["native_compute"]=True
    (the C++ twins of native/ipp_cpu.cpp on ``workers`` host threads),
    over the inputs the CUDA runs under ``root`` read: A, C, D, E, config 4,
    config 5 and RotSymChain's slot 0 byte for byte against the CUDA runs'
    files; B's nearest rotations against Pillow's rotate + getbbox
    exactly and against a CUDA run at >= 0.97 of pixels equal, its
    symmetries byte for byte; RotSymChain fused == unfused.  Each step's
    twin must take every batch (the spies), and no batch may decline to
    the card."""
    from PIL import Image

    from image_processor_pipeline_tpu_torch import (ProcessingPipeline,
                                                    ProcessingStep, kernels)
    from image_processor_pipeline_tpu_torch.ops import native_cpu
    from image_processor_pipeline_tpu_torch.transforms import (
        BorderCrop, ColorMaskTransparency, EnhanceImage, FitCrop, FusedChain,
        GenerateSymmetries, KeepLargestComponent, OverlaysBorderCrop,
        PasteOverlayOntoBackground, RandomRotations, SquareCropAroundBBox,
        copy_img_with_labels, fused)
    from image_processor_pipeline_tpu_torch.transforms.rotations import (
        draw_angles)

    t_phase = time.perf_counter()
    if not native_cpu.available():
        raise AssertionError(f"libipp_cpu.so does not build: "
                             f"{native_cpu.build_error()}")
    print(f"native: {host_build_line(native_cpu)}")

    # the spies: each binding's calls, and each step's batches the twin
    # took (native_fn returned outputs) or declined
    calls = dict.fromkeys(NATIVE_BINDINGS, 0)
    real = {name: getattr(native_cpu, name) for name in NATIVE_BINDINGS}

    def spy(name):
        def counted(*a, **kw):
            calls[name] += 1
            return real[name](*a, **kw)
        return counted

    for name in NATIVE_BINDINGS:
        setattr(native_cpu, name, spy(name))
    taken = {}

    def native_step(name, transform, **kw):
        """A ProcessingStep with native_compute=True whose transform
        counts the batches its twin takes and declines."""
        tally = taken.setdefault(name, {"took": 0, "declined": 0})
        attr = ("launch_batch_native" if isinstance(
            transform, GenerateSymmetries) else "native_fn")
        inner = getattr(transform, attr)

        def counted(*a, **k):
            out = inner(*a, **k)
            tally["took" if out is not None else "declined"] += 1
            return out

        setattr(transform, attr, counted)
        options = dict(kw.pop("options", {}), native_compute=True)
        kw.setdefault("save_log", True)
        return ProcessingStep(name, transform, options=options, device=dev,
                              workers=workers, **kw)

    def run(pipe, bindings):
        """Run ``pipe`` with the launch counts and the spies read around
        it: no kernel launched, every batch of every step taken by its
        twin, and each binding of ``bindings`` called at least that many
        times."""
        before = dict(calls)
        drive(kernels, {}, lambda: pipe.run(progress=False))
        for step in pipe.steps:
            require_success(step, step.metrics.items)
            tally = taken.get(step.name)
            if tally is not None and (tally["declined"]
                                      or tally["took"] != step.metrics.batches):
                raise AssertionError(f"native step {step.name}: twin took "
                                     f"{tally['took']} of "
                                     f"{step.metrics.batches} batches")
        for name, least in bindings.items():
            if calls[name] - before[name] < least:
                raise AssertionError(f"native: {name} called "
                                     f"{calls[name] - before[name]} times, "
                                     f"expected at least {least}")

    nroot = root / "N"
    crops_dir = root / "A" / "crops" / "imgs"
    lines, checked = [], {}
    try:
        # A: crop_square + copy over the dataset
        pipe = ProcessingPipeline(root_dir=nroot / "A")
        pipe.add_step(native_step(
            "crop_square", SquareCropAroundBBox(),
            input_dirs=[imgs_dir, labels_dir],
            output_dirs=["crops/imgs", "crops/labels"],
            pairing_method="zip", seed=11))
        pipe.add_step(ProcessingStep(
            "copy", copy_img_with_labels,
            output_dirs=["copy/imgs", "copy/labels"], pairing_method="zip",
            workers=workers))
        run(pipe, {})
        checked["A"] = same_trees(root / "A", nroot / "A",
                                  ["crops", "copy"], "pipeline A")
        lines.append(native_line(pipe.steps[0], cuda_metrics(
            root / "A" / "crops", "crop_square"), card))

        # B: nearest rotations (Pillow-exact twin) against a CUDA run of
        # the same step and Pillow itself, then symmetry over the CUDA
        # run's rotations
        src = nroot / "B" / "in"
        src.mkdir(parents=True)
        picked = sorted(crops_dir.iterdir())[:NATIVE_ROTATION_ITEMS]
        for p in picked:
            shutil.copy(p, src / p.name)
        rot_options = {"method": "nearest", "num_rotations": ENGINE_ROTATIONS}
        cuda_rot = ProcessingStep(
            "rotations", RandomRotations(), input_dirs=[src],
            output_dirs=[nroot / "B" / "cuda" / "rot"], seed=12,
            options=rot_options, device=dev, workers=workers, save_log=True)
        cuda_sym = ProcessingStep(
            "symmetry", GenerateSymmetries(),
            input_dirs=[nroot / "B" / "cuda" / "rot"],
            output_dirs=[nroot / "B" / "cuda" / "sym"], seed=13,
            device=dev, workers=workers, save_log=True)
        for step in (cuda_rot, cuda_sym):
            step.run(progress=False)
            require_success(step, step.metrics.items)
        pipe = ProcessingPipeline(root_dir=nroot / "B" / "native")
        pipe.add_step(native_step(
            "rotations", RandomRotations(), input_dirs=[src],
            output_dirs=["rot"], seed=12, options=rot_options))
        pipe.add_step(native_step(
            "symmetry", GenerateSymmetries(),
            input_dirs=[nroot / "B" / "cuda" / "rot"], output_dirs=["sym"],
            seed=13))
        run(pipe, {"rotations_batch": 1})
        checked["B sym"] = same_trees(nroot / "B" / "cuda",
                                      nroot / "B" / "native", ["sym"],
                                      "pipeline B symmetry")
        exact = matched = total = 0
        for i, p in enumerate(picked):
            angles = draw_angles(np.asarray([(12 + i) & 0x7FFFFFFF],
                                            np.uint32), ENGINE_ROTATIONS,
                                 1.0, 359.0)[0]
            with Image.open(p) as im:
                rgba = im.convert("RGBA")
            for j, a in enumerate(angles):
                name = f"{p.stem}_r{j + 1:03d}.png"
                pil = rgba.rotate(float(a), expand=True,
                                  resample=Image.NEAREST)
                ref = np.asarray(pil.crop(pil.getbbox()))
                got = np.asarray(Image.open(nroot / "B/native/rot" / name))
                if got.shape != ref.shape or not np.array_equal(got, ref):
                    raise AssertionError(f"native rotation {name} is not "
                                         f"Pillow's rotate + getbbox")
                exact += 1
                on_card = np.asarray(Image.open(nroot / "B/cuda/rot" / name))
                if on_card.shape == got.shape:
                    matched += int((on_card == got).all(axis=-1).sum())
                    total += got.shape[0] * got.shape[1]
        share = matched / max(total, 1)
        if share < 0.97 or total == 0:
            raise AssertionError(f"native rotations match the CUDA run's on "
                                 f"{share:.4f} of pixels, under 0.97")
        checked["B rot"] = exact
        print(f"native pipeline B: {exact} nearest rotations equal Pillow's "
              f"rotate(expand=True) + getbbox crop exactly; CUDA run's "
              f"pixels equal on {share:.4f} of the same-shape files; "
              f"{checked['B sym']} symmetry files byte for byte")
        lines += [native_line(s, cuda_metrics(nroot / "B" / "cuda", s.name),
                              card) for s in pipe.steps]

        # C: colour mask + cleanup; D: the fused chain; E: enhance, border
        # crop and fit crop over the CUDA run's JPEG copies
        k = ENGINE_STEP_ITEMS
        pipe_c = ProcessingPipeline(root_dir=nroot / "C")
        pipe_c.add_step(native_step(
            "color_mask", ColorMaskTransparency(), input_dirs=[crops_dir],
            output_dirs=["mask"], seed=21, sample_k=k,
            options={"color_ranges_to_exclude_hsv": ENGINE_MASK_RANGES}))
        pipe_c.add_step(native_step(
            "cleanup", KeepLargestComponent(), output_dirs=["clean"],
            seed=22, options={"min_component_size": 500}))
        run(pipe_c, {"colormask_batch": 1, "ccl_batch": 1})
        chain = FusedChain([
            fused.Rotate(method="shear"), fused.Flip(),
            fused.ColorMask(ENGINE_MASK_RANGES), fused.Cleanup(),
            fused.Enhance()])
        pipe_d = ProcessingPipeline(root_dir=nroot / "D")
        pipe_d.add_step(native_step(
            "fused_chain", chain, input_dirs=[crops_dir],
            output_dirs=["out"], seed=23, sample_k=k))
        run(pipe_d, {"chain_batch": 1})
        pipe_e = ProcessingPipeline(root_dir=nroot / "E")
        pipe_e.add_step(native_step(
            "enhance", EnhanceImage(), input_dirs=[root / "E" / "jpg"],
            output_dirs=["enhance"], seed=25, pairing_method="sample"))
        pipe_e.add_step(native_step(
            "border_crop", BorderCrop(), output_dirs=["border"], seed=26,
            options={"crop_margins": (0.1, 24, 0.05, 12)}))
        pipe_e.add_step(native_step(
            "fit_crop", FitCrop(), output_dirs=["fit"], seed=27))
        run(pipe_e, {"enhance_batch": 1})
        for pipe_name, pipe, dirs in (
                ("C", pipe_c, ["mask", "clean"]), ("D", pipe_d, ["out"]),
                ("E", pipe_e, ["enhance", "border", "fit"])):
            checked[pipe_name] = same_trees(root / pipe_name,
                                            nroot / pipe_name, dirs,
                                            f"pipeline {pipe_name}")
            lines += [native_line(s, cuda_metrics(root / pipe_name, s.name),
                                  card) for s in pipe.steps]

        # config 4 over the CUDA run's JPEG backgrounds; config 5 over its
        # extracted frames
        margins = {"crop_margins": (0.05, 0.05, 0.05, 0.05)}
        ov_dir = root / "data" / "overlays"
        pipe_o = ProcessingPipeline(root_dir=nroot / "O")
        pipe_o.add_step(native_step(
            "paste", PasteOverlayOntoBackground(),
            input_dirs=[ov_dir, root / "O" / "bg"],
            output_dirs=["paste/imgs", "paste/labels"],
            pairing_method="modulo", seed=31, fixed_input=True))
        pipe_o.add_step(native_step(
            "border_crop4", BorderCrop(), input_dirs=["paste/imgs"],
            output_dirs=["crop"], seed=32, fixed_input=True,
            options=margins))
        pipe_o.add_step(native_step(
            "overlays_border_crop", OverlaysBorderCrop(),
            input_dirs=[ov_dir, root / "O" / "bg"],
            output_dirs=["ob/imgs", "ob/labels"], pairing_method="modulo",
            seed=31, fixed_input=True, options=margins))
        run(pipe_o, {"overlay_batch": 2})
        frames = sorted((root / "V" / "frames").glob("*/0-raw"))[0]
        pipe_v = ProcessingPipeline(root_dir=nroot / "V")
        pipe_v.add_step(native_step(
            "video_chain", FusedChain([fused.Rotate(method="shear"),
                                       fused.Flip(), fused.Enhance()]),
            input_dirs=[frames], output_dirs=["aug"], seed=33,
            fixed_input=True))
        run(pipe_v, {"chain_batch": 1})
        checked["config 4"] = same_trees(root / "O", nroot / "O",
                                         ["paste", "crop", "ob"], "config 4")
        checked["config 5"] = same_trees(root / "V", nroot / "V", ["aug"],
                                         "config 5")
        lines += [native_line(s, cuda_metrics(
            (root / "O" / s.output_dirs[0]).parent, s.name), card)
            for s in pipe_o.steps]
        lines.append(native_line(pipe_v.steps[0], cuda_metrics(
            root / "V", "video_chain"), card))

        # RotSymChain: its twin is the nearest method's (a shear head
        # declines, as in the JAX package), so the fused native run is
        # held against the unfused native run byte for byte, and its
        # slot-0 files (the originals, no rotation) against the CUDA
        # fan-out run's
        fan_src = root / "F" / "data" / "crops"
        kinds = (
            ("rot", RandomRotations, {"method": "nearest",
                                      "num_rotations": ENGINE_ROTATIONS}),
            ("sym", GenerateSymmetries, {}),
            ("mask", ColorMaskTransparency,
             {"color_ranges_to_exclude_hsv": ENGINE_MASK_RANGES}),
            ("clean", KeepLargestComponent, {"min_component_size": 500}),
            ("fit", FitCrop, {}))
        runs = {}
        for fuse in (False, True):
            run_root = nroot / "F" / ("fused" if fuse else "plain")
            pipe = ProcessingPipeline(root_dir=run_root)
            for i, (kind, cls, options) in enumerate(kinds):
                out = "out" if kind == "fit" else kind
                pipe.add_step(native_step(  # no log: a logged step
                    f"rotsymchain_{kind}{i}", cls(),  # never fuses
                    input_dirs=[fan_src] if i == 0 else None,
                    output_dirs=[out], seed=60 + i, options=options,
                    save_log=False))
            before = dict(calls)
            drive(kernels, {}, lambda: pipe.run(progress=False,
                                                auto_fuse=fuse))
            ran = pipe.last_run_steps
            for step in ran:
                require_success(step, step.metrics.items)
            got = [type(s.process_function).__name__ for s in ran]
            if fuse and got != ["RotSymChain"]:
                raise AssertionError(f"native rotsymchain fused to {got}")
            if calls["rotations_batch"] == before["rotations_batch"] or (
                    fuse and calls["chain_batch"] == before["chain_batch"]):
                raise AssertionError("native rotsymchain: the rotations "
                                     "or chain twin did not run")
            runs[fuse] = (run_root, ran)
        (plain_root, _), (fused_root, fused_run) = runs[False], runs[True]
        checked["RotSymChain"] = same_trees(plain_root, fused_root, ["out"],
                                            "native RotSymChain fused")
        slot0 = {p.name: p.read_bytes()
                 for p in (root / "F/rotsymchain/fused/out").glob("*_r000_*")}
        mine = {p.name: p.read_bytes()
                for p in (fused_root / "out").glob("*_r000_*")}
        if not slot0 or mine != slot0:
            raise AssertionError("native RotSymChain: the originals' files "
                                 "differ from the CUDA run's")
        checked["RotSymChain r000"] = len(slot0)
        lines.append(native_line(fused_run[0], None, card)
                     + " (the CUDA run rotated by shear: its line is the "
                     "fan-out phase's)")
    finally:
        for name in NATIVE_BINDINGS:
            setattr(native_cpu, name, real[name])
    for line in lines:
        print(line)
    print(f"native binding calls: {calls}")
    print(f"native compute phase: files held {checked}; "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {"files": checked, "binding_calls": calls,
            "phase_s": time.perf_counter() - t_phase}


# ---- the chain's gather mode ---------------------------------------------

def gather_mode_on_card(chains, inputs, shear_out):
    """The chain's 'gather' mode at 640 -> 512 at each batch: the card's
    output == the CPU's, byte for byte (cos and sin come from the host),
    and its footprint against 'cuda_shear' at IoU > 0.8 (the JAX bar).
    Returns {B: IoU}."""
    ious = {}
    for B, (images, xywhn, seeds) in inputs.items():
        got = chains.augment_chain(images, xywhn, seeds, rotation="gather")
        check_equal(got.cpu(), chains.augment_chain(
            images.cpu(), xywhn, seeds, rotation="gather"),
            f"gather B={B}: card != CPU")
        check_not_degenerate(got, f"gather B={B}")
        nz_g = got[..., :3].sum(-1) > 0
        nz_s = shear_out[B][..., :3].sum(-1) > 0
        ious[B] = float((nz_g & nz_s).sum()) / max(1, int((nz_g | nz_s).sum()))
        if not ious[B] > 0.8:
            raise AssertionError(f"gather B={B}: footprint IoU {ious[B]:.4f} "
                                 f"against cuda_shear")
        print(f"chain gather B={B} 640->512: card == CPU, byte for byte; "
              f"footprint IoU against cuda_shear {ious[B]:.4f} (> 0.8)")
    return ious


# ---- the engine's failure contract on the card ----------------------------

# the SIGKILL + resume check: a crop step on the card over this many small
# PNGs, each save slowed by this many seconds
RESUME_ITEMS = 120
RESUME_SAVE_S = 0.05
RESUME_WORKER = """
import sys, time
sys.path.insert(0, {repo!r})
from pathlib import Path
from image_processor_pipeline_tpu_torch import ProcessingStep
from image_processor_pipeline_tpu_torch.transforms import SquareCropAroundBBox


class SlowSaves(SquareCropAroundBBox):
    max_batch = 8

    def save_item(self, out, item, output_dirs, options):
        time.sleep({save_s!r})
        return super().save_item(out, item, output_dirs, options)


root = Path({root!r})
step = ProcessingStep(
    "crop", SlowSaves(), input_dirs=[root / "imgs", root / "labels"],
    output_dirs=[root / "out" / "imgs", root / "out" / "labels"],
    pairing_method="zip", save_log=True, resume=True, seed=4,
    device={device!r}, workers=4)
print("READY", flush=True)
step.run(progress=False)
print("FINISHED", flush=True)
"""


def write_resume_dataset(root, n, seed):
    """``n`` RGB PNGs of 24 x 32 or 32 x 24 with one YOLO box each."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    (root / "imgs").mkdir(parents=True)
    (root / "labels").mkdir()
    for i in range(n):
        h, w = (24, 32) if i % 2 else (32, 24)
        Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(
            root / "imgs" / f"im_{i:03d}.png")
        (root / "labels" / f"im_{i:03d}.txt").write_text(
            f"{i % 5} 0.5 0.5 {rng.uniform(0.1, 0.4):.6f} "
            f"{rng.uniform(0.1, 0.4):.6f}\n")


def sigkill_then_resume(root, dev):
    """A device step on the card in a process of its own, SIGKILLed once
    its report shows 0 < done < RESUME_ITEMS, then run again with
    resume=True: the report holds each input once, all Success, the rerun
    says it skips, and the files equal an uninterrupted run's on the card,
    byte for byte.  Returns what it saw."""
    import signal

    from image_processor_pipeline_tpu_torch import ProcessingStep
    from image_processor_pipeline_tpu_torch.transforms import (
        SquareCropAroundBBox)

    run = root / "run"
    write_resume_dataset(run, RESUME_ITEMS, 9)
    script = RESUME_WORKER.format(repo=str(REPO), root=str(run),
                                  save_s=RESUME_SAVE_S, device=str(dev))
    report = run / "out" / "crop.json"
    proc = subprocess.Popen([sys.executable, "-c", script], text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        if "READY" not in proc.stdout.readline():
            raise AssertionError("resume worker did not start")
        deadline = time.monotonic() + 120
        while not report.is_file():
            if proc.poll() is not None:
                raise AssertionError("resume worker ended before a flush:\n"
                                     + proc.stdout.read()[-2000:])
            if time.monotonic() > deadline:
                raise AssertionError("resume worker wrote no report in time")
            time.sleep(0.01)
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    partial = json.loads(report.read_text())
    done = {e["inputs"][0] for e in partial if e["status"] == "Success"}
    if not 0 < len(done) < RESUME_ITEMS:
        raise AssertionError(f"killed with {len(done)} items done")
    print(f"failure_contract: SIGKILL with batches in flight: the report is "
          f"valid JSON with {len(done)} of {RESUME_ITEMS} items done")
    again = subprocess.run([sys.executable, "-c", script], text=True,
                           capture_output=True, timeout=300)
    if again.returncode != 0:
        raise AssertionError(f"resume run exited {again.returncode}:\n"
                             f"{(again.stdout + again.stderr)[-3000:]}")
    if "resume — skipping" not in again.stdout:
        raise AssertionError("the resume run did not say it skips")
    skipped = [line for line in again.stdout.splitlines()
               if "resume — skipping" in line]
    print(f"failure_contract: the resume run printed {skipped[0].strip()!r}")
    final = json.loads(report.read_text())
    inputs = [e["inputs"][0] for e in final]
    if len(final) != RESUME_ITEMS or len(set(inputs)) != RESUME_ITEMS \
            or any(e["status"] != "Success" for e in final):
        raise AssertionError(f"resumed report: {len(final)} entries, "
                             f"{len(set(inputs))} inputs, statuses "
                             f"{sorted({e['status'] for e in final})}")
    print(f"failure_contract: the report holds {RESUME_ITEMS} entries, all "
          f"Success, each input once")
    clean = root / "clean"
    ProcessingStep(
        "crop", SquareCropAroundBBox(), input_dirs=[run / "imgs",
                                                    run / "labels"],
        output_dirs=[clean / "imgs", clean / "labels"], pairing_method="zip",
        seed=4, device=dev, workers=4).run(progress=False)
    for sub in ("imgs", "labels"):
        got = {p.name: p.read_bytes()
               for p in sorted((run / "out" / sub).iterdir())}
        want = {p.name: p.read_bytes() for p in sorted((clean / sub).iterdir())}
        if len(want) != RESUME_ITEMS or got != want:
            raise AssertionError(f"resumed {sub} != an uninterrupted run's "
                                 f"({len(got)} against {len(want)} files)")
    print(f"failure_contract: the resumed files == an uninterrupted card "
          f"run's, byte for byte ({RESUME_ITEMS} crops and labels)")
    return {"done_at_kill": len(done), "items": RESUME_ITEMS}


def failure_contract(dev):
    """The engine's failure contract on the card (tests/test_engine_chaos.py
    and tests/test_crash_resume.py): a FusedChain([Enhance()]) step over 8
    JPEGs with a probe fault, a truncated JPEG, a transient save fault
    with retries=1, a permanent one with retries=2 and every save failing;
    then SIGKILL and resume of a crop step.  Each check's outcome on its
    own line; any failure raises.  Returns the phase's numbers."""
    from collections import Counter

    from PIL import Image

    from image_processor_pipeline_tpu_torch import ProcessingStep
    from image_processor_pipeline_tpu_torch.transforms.fused import (
        Enhance, FusedChain)

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="ipp_failure_") as tmp:
        root = Path(tmp)
        rng = np.random.default_rng(42)
        imgs = root / "imgs"
        imgs.mkdir()
        for i in range(8):
            h, w = int(rng.integers(50, 90)), int(rng.integers(50, 90))
            Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(
                imgs / f"im{i}.jpg")
        attempts = Counter()

        def stem(item):
            return Path(item["_args"][0]).stem

        class ProbeFault(FusedChain):
            def probe_item(self, inputs, options):
                if Path(inputs[0]).stem == "im3":
                    raise RuntimeError("injected probe fault")
                return super().probe_item(inputs, options)

        class TransientSave(FusedChain):
            def save_item(self, out, item, output_dirs, options):
                attempts[stem(item)] += 1
                if stem(item) == "im2" and attempts["im2"] == 1:
                    raise IOError("injected transient save fault")
                return super().save_item(out, item, output_dirs, options)

        class PermanentSave(FusedChain):
            def save_item(self, out, item, output_dirs, options):
                if stem(item) == "im2":
                    raise IOError("injected permanent save fault")
                return super().save_item(out, item, output_dirs, options)

        class AlwaysFails(FusedChain):
            def save_item(self, out, item, output_dirs, options):
                raise RuntimeError("injected")

        def run(tag, transform, src=imgs, **kw):
            step = ProcessingStep(
                "chaos", transform([Enhance()]), input_dirs=[src],
                output_dirs=[root / tag], pairing_method="one_input", seed=3,
                device=dev, save_log=True, **kw)
            return step, step.run(progress=False)

        _, c = run("probe", ProbeFault)
        if c != Counter(Success=7, Error=1):
            raise AssertionError(f"probe fault: {dict(c)}")
        print(f"failure_contract: probe fault on im3: {dict(c)} (7 Success, "
              f"1 Error)")
        cut = root / "cut"
        shutil.copytree(imgs, cut)
        data = (cut / "im5.jpg").read_bytes()
        (cut / "im5.jpg").write_bytes(data[: len(data) // 2])
        _, c = run("truncated", FusedChain, src=cut)
        if c["Success"] + c["Error"] != 8 or c["Success"] < 7:
            raise AssertionError(f"truncated JPEG: {dict(c)}")
        print(f"failure_contract: one JPEG cut in half: {dict(c)} (Success "
              f"+ Error = 8, Success >= 7)")
        _, c = run("transient", TransientSave, retries=1)
        if c != Counter(Success=8) or attempts["im2"] != 2:
            raise AssertionError(f"transient save fault: {dict(c)}, "
                                 f"attempts {dict(attempts)}")
        print(f"failure_contract: transient save fault, retries=1: "
              f"{dict(c)}, im2 saved on attempt {attempts['im2']}")
        step, c = run("permanent", PermanentSave, retries=2)
        entries = json.loads(step._report_path().read_text())
        bad = [e for e in entries if e["status"] == "Error"]
        if c != Counter(Success=7, Error=1) or len(bad) != 1 \
                or "injected permanent save fault" not in bad[0][
                    "error_message"] or bad[0]["outputs"] is not None:
            raise AssertionError(f"permanent save fault: {dict(c)}, report "
                                 f"errors {bad}")
        print(f"failure_contract: permanent save fault, retries=2: "
              f"{dict(c)}; the report's entry says "
              f"{bad[0]['error_message']!r} with outputs null")
        _, c = run("all", AlwaysFails)
        if c != Counter(Error=8):
            raise AssertionError(f"every save failing: {dict(c)}")
        print(f"failure_contract: every save failing: {dict(c)}, the run "
              f"completes")
        resume = sigkill_then_resume(root, dev)
    seconds = time.perf_counter() - t_phase
    print(f"failure_contract phase: {seconds:.1f} s")
    return dict(resume, seconds=seconds)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this smoke run needs a CUDA card")
    from image_processor_pipeline_tpu_torch import kernels
    from image_processor_pipeline_tpu_torch.models import chains
    from image_processor_pipeline_tpu_torch.ops import augment, geometry
    from image_processor_pipeline_tpu_torch.ops import rotate
    from image_processor_pipeline_tpu_torch.utils import rev_probe

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"device: {kind} ({sms} SMs); torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(f"card (name, power limit): {card}")

    # ---- build ------------------------------------------------------------
    t0 = time.perf_counter()
    kernels.library()
    print(f"build: {time.perf_counter() - t0:.1f} s for {kernels.SOURCES} "
          f"(nvcc {' '.join(kernels.NVCC_FLAGS)})")
    for line in kernels.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    # the host libraries of the codec and native phases, built here, so
    # that their compiles are timed before any phase loads them
    from image_processor_pipeline_tpu_torch.io import jcoef
    from image_processor_pipeline_tpu_torch.ops import native_cpu

    for module in (jcoef, native_cpu):
        if module.available():
            print(f"build: {host_build_line(module)}")
        else:
            print(f"build: {module._SO.name} failed: "
                  f"{module.build_error()}".replace("\n", " | "))
    sass = sass_counts(kernels.BUILD / "libipp_cuda.so")
    for label, (total, loops) in sass.items():
        print(f"  sass: {label}: {total} instructions, loops of "
              f"{sorted((n for n, _ in loops), reverse=True)[:4]}")
    for C in (3, 4):
        _, loops = sass[f"chain_cluster_kernel<{C}>"]
        stage = innermost(loops, "LDG.E.128")  # 16 pixels
        finish = innermost(loops, "STG")       # 4 pixels
        print(f"  sass per pixel, cluster kernel C={C}: staging and luma "
              f"{stage} / 16 = {stage / 16:.1f}, gather and finish "
              f"{finish} / 4 = {finish / 4:.1f}, in all "
              f"{stage / 16 + finish / 4:.1f}; two-pass kernels (one pixel "
              f"a thread, whole kernels): gather_luma "
              f"{sass['gather_luma_kernel'][0]} + finish "
              f"{sass['finish_kernel'][0]}")
    for cin, cout in ((3, 3), (4, 3), (1, 1)):
        total, _ = sass[f"shear_tile_kernel<{cin},{cout}>"]
        tw = 128 if cin == 1 else 64  # csrc/shear_rotate.cu:tile_width
        px = 8 * tw // 32
        print(f"  sass, shear_tile_kernel<{cin},{cout}> (64 x {tw} tiles): "
              f"{total} instructions for a thread's {px} pixels, "
              f"{total / px:.1f} a pixel (static count; both gather paths, "
              f"the walk and the staging included)")
    for S in (64, 512):
        for K in (8, 16):
            print(f"max active clusters at S={S}, C=3, K={K}: "
                  f"{augment.max_active_clusters(S, 3, K)}; chain_path "
                  f"{augment.chain_path(S, K)}, "
                  f"{augment.cluster_smem_bytes(S, K)} bytes of shared "
                  f"memory a CTA")

    filt = (chains._FILTER_LOWERS, chains._FILTER_UPPERS,
            chains._FILTER_ZONES)
    max_err = dict.fromkeys(KERNELS, 0)
    over = max(S for S in range(1, 2048)
               if augment.chain_path(S) == "cluster") + 1

    # ---- augment_full (K1), both paths, three canvas forms ----------------
    for SIN, S, B, shift in ((640, 512, 16, 0), (640, 512, 64, 0),
                             (640, 512, 16, -70), (96, 64, 8, 0),
                             (96, 64, 8, -70), (128, 97, 8, 0),
                             (over + 41, over, 2, 0),
                             (over + 41, over, 2, -70)):
        u4, y0, x0, angles, prms, flips = kernel_inputs(
            SIN, S, B, seed=SIN + S + B, dev=dev)
        # shift != 0 moves the crop offsets off the canvas: negative ones
        # count from the end, then all are clamped (lax.dynamic_slice)
        y0, x0 = y0 + shift, x0 - shift
        shifts = augment._shifts(angles, S)
        packed = u4.view(torch.int32)[..., 0]
        u3 = u4[..., :3].contiguous()
        ref = augment.augment_full_reference(
            packed, y0, x0, angles, prms, flips, *filt, crop=S, shifts=shifts)
        path = augment.chain_path(S)
        for form, canvas in (("packed", packed), ("u8 C=4", u4),
                             ("u8 C=3", u3)):
            kernels.reset_launch_counts()
            got = augment.augment_fused_full(canvas, y0, x0, angles, prms,
                                             flips, *filt, crop=S)
            if kernels.launch_counts["augment_full"] != 1:
                raise AssertionError("augment_full: not one wrapper launch")
            max_err["augment_full"] = max(max_err["augment_full"], check_equal(
                got, ref, f"kernel augment_full ({path}, {form}) != plain at "
                f"SIN={SIN} S={S} B={B} shift={shift}"))
        print(f"kernel augment_full == plain, byte for byte: SIN={SIN} S={S} "
              f"B={B}, chain_path {path}, offsets shifted by {shift}, packed, "
              f"u8 C=4 and u8 C=3 canvases, every flip code, angles "
              f"{ANGLES} + random")

    # ---- shear_rotate (K2, K4) against its plain version ------------------
    # both paths of the kernel; kernels.direct_tiles
    # counts the tiles that gathered from device memory: none on "tiled"
    # with shear_params vectors, all of them on "direct"
    def direct_count(fn):
        return count_direct_tiles(kernels, dev, fn)

    for S, C, B in ((512, 4, 16), (512, 3, 16), (512, 1, 16), (512, 2, 16),
                    (64, 2, 16), (97, 1, 16), (768, 1, 16), (768, 3, 8)):
        imgs, angles, _, _ = crop_inputs(S, C, B, seed=S + C, dev=dev)
        shifts = geometry.shear_params(angles, S)
        if set(shifts[0].tolist()) != {0, 1, 2, 3}:
            raise AssertionError(f"S={S} C={C}: not every quad covered")
        ref = geometry.rotate_square_shear_by(imgs, *shifts)
        name = "shear_rotate_packed" if C in (3, 4) else "shear_rotate"
        for path in rotate.PATHS:
            got, n_direct = direct_count(lambda: rotate.launch_shear(
                imgs, *shifts, path=path))
            max_err[name] = max(max_err[name], check_equal(
                got, ref, f"kernel {name} ({path}) != plain at S={S} C={C} "
                f"B={B}"))
            if (n_direct > 0) != (path == "direct"):
                raise AssertionError(f"{name} {path}: {n_direct} direct tiles")
        got = rotate.shear_rotate(imgs, *shifts)
        check_equal(got, ref, f"shear_rotate != plain at S={S} C={C}")
        print(f"kernel {name} == plain, byte for byte: S={S} C={C} B={B}, "
              f"tiled and direct, every quad, angles {ANGLES} + random")
    # K2 reading its crop from 3- and 4-channel canvases (cuda_shear's form)
    for SIN, S, B, shift in ((640, 512, 16, 0), (640, 512, 8, -70),
                             (128, 97, 8, 70)):
        u4, y0, x0, angles, _, _ = kernel_inputs(SIN, S, B, seed=SIN + B,
                                                 dev=dev)
        y0, x0 = y0 + shift, x0 - shift
        shifts = geometry.shear_params(angles, S)
        for canvas in (u4, u4[..., :3].contiguous()):
            ref = geometry.rotate_square_shear_by(
                augment._crop(canvas[..., :3], y0, x0, S), *shifts)
            for path in rotate.PATHS:
                got, n_direct = direct_count(lambda: rotate.launch_shear(
                    canvas, *shifts, offsets=(y0, x0), channels=3,
                    path=path))
                max_err["shear_rotate_packed"] = max(
                    max_err["shear_rotate_packed"], check_equal(
                        got, ref, f"shear_rotate_crop ({path}) != plain at "
                        f"SIN={SIN} S={S} C={canvas.shape[3]} shift={shift}"))
                if (n_direct > 0) != (path == "direct"):
                    raise AssertionError(f"crop {path}: {n_direct} direct "
                                         f"tiles")
        print(f"kernel shear_rotate_packed reading the crop from the canvas "
              f"== _crop then plain, byte for byte: SIN={SIN} S={S} B={B}, "
              f"offsets shifted by {shift}, 3- and 4-channel canvases, tiled "
              f"and direct")
    # arbitrary vectors and quads outside [0, 4): tiles whose sources
    # spread beyond the window take the direct path
    for C in (1, 2, 3, 4):
        S, B = 256, 8
        rng = np.random.default_rng(40 + C)
        imgs = torch.as_tensor(rng.integers(0, 256, (B, S, S, C), np.uint8),
                               device=dev)
        quad = torch.tensor([-1, 0, 1, 2, 3, 7, 4, -9], dtype=torch.int32,
                            device=dev)
        sh1, sh2 = (torch.as_tensor(rng.integers(-S, S + 1, (B, S)),
                                    dtype=torch.int32, device=dev)
                    for _ in range(2))
        got, n_direct = direct_count(lambda: rotate.shear_rotate(
            imgs, quad, sh1, sh2))
        check_equal(got, geometry.rotate_square_shear_by(imgs, quad, sh1, sh2),
                    f"shear_rotate, random vectors, C={C}")
        if n_direct == 0:
            raise AssertionError("random vectors: no tile took the direct "
                                 "path")
        print(f"kernel shear_rotate (C={C}) == plain on random shift vectors "
              f"and quads outside [0, 4): {n_direct} tiles took the direct "
              f"path")

    # ---- augment_fused (K3), both paths ------------------------------------
    for S, B in ((512, 16), (512, 64), (64, 8), (97, 8), (over, 2)):
        crops, angles, prms, flips = crop_inputs(S, 3, B, seed=S + B, dev=dev)
        got = augment.augment_fused(crops, angles, prms, *filt, flips=flips)
        ref = augment.augment_finish_reference(
            crops, angles, prms, *filt, flips=flips,
            shifts=augment._shifts(angles, S))
        max_err["augment_fused"] = max(max_err["augment_fused"], check_equal(
            got, ref, f"kernel augment_fused != plain at S={S} B={B}"))
        print(f"kernel augment_fused == plain, byte for byte: S={S} B={B}, "
              f"chain_path {augment.chain_path(S)}, every flip code, angles "
              f"{ANGLES} + random")

    # ---- main paths, each read on its own ---------------------------------
    # AugmentChain in each kernel mode at B=8 and 64, three calls each, and
    # the batched rotation op on single-channel masks, the op's path for
    # C not in {3, 4} (where the TPU package launches _shear_kernel)
    inputs = {batch: chains.AugmentChain(640, device=dev).example_inputs(batch)
              for batch in BATCHES}
    # each path also counts the shear kernel's direct tiles (none allowed)
    # and the chain's calls of its torch crop (none allowed in cuda_shear,
    # whose kernel reads the canvas)
    launches = {}
    outputs = {}
    direct = {}
    crop_calls = []
    real_crop = chains._crop
    for mode, kernel in (("cuda_full", "augment_full"),
                         ("cuda_shear", "shear_rotate_packed"),
                         ("cuda_fused", "augment_fused")):
        chain = chains.AugmentChain(input_size=640, rotation=mode, device=dev)
        chains._crop = lambda *a, **k: crop_calls.append(mode) \
            or real_crop(*a, **k)
        try:
            (outputs[mode], counts), direct[mode] = direct_count(
                lambda: drive(kernels, {kernel: 6}, lambda: {
                    batch: [chain(images, xywhn, seeds + i * batch)
                            for i in range(3)]
                    for batch, (images, xywhn, seeds) in inputs.items()}))
        finally:
            chains._crop = real_crop
        launches[kernel] = counts[kernel]
    masks = {batch: crop_inputs(512, 1, batch, seed=batch, dev=dev)[:2]
             for batch in BATCHES}
    (rotated, counts), direct["masks"] = direct_count(lambda: drive(
        kernels, {"shear_rotate": 6}, lambda: {
            batch: [rotate.rotate_square_shear_batch(m, a + 7.0 * i)
                    for i in range(3)]
            for batch, (m, a) in masks.items()}))
    launches["shear_rotate"] = counts["shear_rotate"]
    if direct["cuda_shear"] or direct["masks"]:
        raise AssertionError(f"main paths took the direct gather: {direct}")
    if "cuda_shear" in crop_calls:
        raise AssertionError("cuda_shear called the torch crop")
    print(f"main paths: the shear kernel's direct tiles {direct}; torch crop "
          f"calls by mode {({m: crop_calls.count(m) for m in direct})}")

    twins = {"cuda_full": "full_reference", "cuda_shear": "shear"}
    for batch, (images, xywhn, seeds) in inputs.items():
        for i in range(3):
            for mode, twin in twins.items():
                ref = chains.augment_chain(images, xywhn, seeds + i * batch,
                                           rotation=twin)
                check_equal(outputs[mode][batch][i], ref,
                            f"B={batch} call {i}: {mode} != {twin} on the "
                            f"card")
            check_equal(outputs["cuda_fused"][batch][i],
                        outputs["cuda_full"][batch][i],
                        f"B={batch} call {i}: cuda_fused != cuda_full on "
                        f"the card")
            for mode in outputs:
                out = outputs[mode][batch][i]
                if out.shape != (batch, 512, 512, 4) \
                        or out.dtype != torch.uint8:
                    raise AssertionError(f"{mode} B={batch}: bad output "
                                         f"{tuple(out.shape)} {out.dtype}")
                check_not_degenerate(out, f"{mode} B={batch}")
        m, a = masks[batch]
        for i, out in enumerate(rotated[batch]):
            ref = geometry.rotate_square_shear(m, a + 7.0 * i)
            check_equal(out, ref, f"B={batch} call {i}: rotated masks != "
                        f"rotate_square_shear on the card")
        for mode, twin in (*twins.items(), ("cuda_fused", "cuda_full")):
            print(f"main path AugmentChain(640, {mode}) B={batch}: 3 calls, "
                  f"output ({batch}, 512, 512, 4) uint8 == {twin} on the "
                  f"card")
        print(f"main path rotate_square_shear_batch masks ({batch}, 512, 512,"
              f" 1): 3 calls == geometry.rotate_square_shear on the card")
    # the chain's gather mode against the CPU
    gather_iou = gather_mode_on_card(
        chains, inputs, {B: outputs["cuda_shear"][B][0] for B in BATCHES})
    print(f"main-path kernel launches (each path read on its own): "
          f"{launches}")
    del outputs, rotated
    torch.cuda.synchronize()

    # ---- each kernel's launch alone, at the main path's shapes ------------
    # arguments made outside the timed window; K1 reads the 3-channel
    # canvas, as the chain gives it
    def launch_args(B):
        images, xywhn, seeds = inputs[B]
        u4, y0, x0, angles, prms, flips = kernel_inputs(640, 512, B, seed=B,
                                                        dev=dev)
        full = augment.chain_args(images, y0, x0, augment._shifts(angles, 512),
                                  prms, flips, *filt, 512)
        crops = images[:, :512, :512].contiguous()
        fshifts = geometry.applied_shifts(*augment._shifts(angles, 512), 512)
        zeros = torch.zeros_like(flips)
        fused = augment.chain_args(crops, zeros, zeros, fshifts, prms, flips,
                                   *filt, 512)
        mask = crops[..., :1].contiguous()
        # the rotation's main-path forms: K2 reads the crop from the
        # 3-channel canvas (cuda_shear), K4 rotates single-channel masks
        rshifts = geometry.shear_params(angles, 512)
        plain = {
            "augment_full": lambda i: augment.augment_full_reference(
                images, y0, x0, angles, prms, flips, *filt, crop=512,
                shifts=full[2]),
            "augment_fused": lambda i: augment.augment_finish_reference(
                crops, angles, prms, *filt, flips=flips, shifts=fshifts),
            "shear_rotate_packed": lambda i: geometry.rotate_square_shear_by(
                augment._crop(images[..., :3], y0, x0, 512), *rshifts),
            "shear_rotate": lambda i: geometry.rotate_square_shear_by(
                mask, *rshifts)}
        launch = {
            "augment_full": lambda **kw: augment.launch_chain(
                "augment_full", *full, **kw),
            "augment_fused": lambda **kw: augment.launch_chain(
                "augment_fused", *fused, **kw),
            "shear_rotate_packed": lambda **kw: rotate.launch_shear(
                images, *rshifts, offsets=(y0, x0), channels=3, **kw),
            "shear_rotate": lambda **kw: rotate.launch_shear(
                mask, *rshifts, **kw)}
        bounds = {"augment_full": chain_bytes(512, B, 3),
                  "augment_fused": chain_bytes(512, B, 3),
                  "shear_rotate_packed": rotate_bytes(512, B, 3) + 8 * B,
                  "shear_rotate": rotate_bytes(512, B, 1)}
        return launch, plain, bounds

    dev_ms, plain_ms, bound_ms = {}, {}, {}
    for B in BATCHES:
        launch, plain, bounds = launch_args(B)
        for name in KERNELS:
            dev_ms[name, B] = device_ms(launch[name])
            bound_ms[name, B] = bounds[name] / HBM_BYTES_PER_S * 1e3
            plain_ms[name, B] = statistics.median(
                time_calls(plain[name], calls=10, windows=3))
            print(f"{name} B={B} S=512: kernel {dev_ms[name, B]:.4f} ms of "
                  f"device time a launch (launch alone), bound "
                  f"{bound_ms[name, B]:.4f} ms ({bounds[name]} bytes at "
                  f"3.35 TB/s, share {bound_ms[name, B] / dev_ms[name, B]:.3f})"
                  f", plain {plain_ms[name, B]:.4f} ms a call; card {card}")
        # the chain kernel's paths and cluster sizes, in turns
        for name in ("augment_full", "augment_fused"):
            turns = []
            for path, K in (("cluster", 8), ("two_pass", 0), ("cluster", 16),
                            ("cluster", 16), ("two_pass", 0), ("cluster", 8)):
                kw = {"path": path} | ({"cluster": K} if K else {})
                turns.append((f"{path}" + (f" K={K}" if K else ""),
                              device_ms(lambda: launch[name](**kw))))
            print(f"{name} B={B} S=512 in turns (device ms a launch): "
                  + ", ".join(f"{p} {t:.4f}" for p, t in turns)
                  + f"; default K={augment.CLUSTER}; card {card}")
            best = {p: min(t for q, t in turns if q == p) for p, _ in turns}
            if B == 64 and min(best["cluster K=8"], best["cluster K=16"]) \
                    >= best["two_pass"]:
                raise AssertionError(f"{name} B=64: the cluster path is not "
                                     f"faster than the two-pass path")
        # the rotation kernel's two paths, in turns
        for name, C in (("shear_rotate_packed", 3), ("shear_rotate", 1)):
            turns = [(path, device_ms(lambda: launch[name](path=path)))
                     for path in ("tiled", "direct", "direct", "tiled")]
            print(f"{name} (C={C}) B={B} S=512 in turns (device ms a "
                  f"launch): " + ", ".join(f"{p} {t:.4f}" for p, t in turns)
                  + f"; card {card}")
            best = {p: min(t for q, t in turns if q == p) for p, _ in turns}
            if B == 64 and best["tiled"] >= best["direct"]:
                raise AssertionError(f"{name} B=64: the tiled path is not "
                                     f"faster than the direct path")

    # ---- one launch, no memset; the chain's device work --------------------
    def traced_calls(fn, calls):
        """The device activities of ``calls`` calls of ``fn`` in one warmed
        profiler window, and the wall a call (the calls alone: the window
        opens after the warm-up and closes on a synchronisation)."""
        fn()
        torch.cuda.synchronize()

        def timed():
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / calls

        return profiled(timed)

    def one_call_events(fn):
        """The device activities of one call of ``fn``: one attempt, in a
        warmed window."""
        return traced_calls(fn, 1)[0]

    launch, _, _ = launch_args(64)
    for name in ("augment_full", "augment_fused"):
        events = one_call_events(launch[name])
        names = [e.name for e in events]
        n_kernels = sum("chain_cluster_kernel" in n for n in names)
        n_memset = sum("emset" in n for n in names)
        print(f"profiler, one {name} launch at B=64 S=512: device events "
              f"{names}")
        if n_kernels != 1 or n_memset != 0 or len(names) != 1:
            raise AssertionError(f"{name}: not one kernel launch and no "
                                 f"memset: {names}")
    for name in ("shear_rotate_packed", "shear_rotate"):
        events = one_call_events(launch[name])
        names = [e.name for e in events]
        print(f"profiler, one {name} launch_shear call at B=64 S=512: device "
              f"events {names}")
        if len(names) != 1 or "shear_tile_kernel" not in names[0]:
            raise AssertionError(f"{name}: not one device activity: {names}")
    for B in BATCHES:
        images, xywhn, seeds = inputs[B]
        for mode in ("cuda_full", "cuda_shear", "cuda_fused"):
            events, wall = traced_calls(lambda: chains.augment_chain(
                images, xywhn, seeds, rotation=mode), 10)
            busy = sum(e.time_range.elapsed_us() for e in events) / 1e4
            parts = {}
            for e in events:
                parts[e.name[:40]] = (parts.get(e.name[:40], 0)
                                      + e.time_range.elapsed_us() / 1e4)
            top = sorted(parts.items(), key=lambda kv: -kv[1])[:4]
            cat = sum(ms for n, ms in parts.items() if "Cat" in n)
            print(f"profiler, chain {mode} B={B} (10 calls): wall "
                  f"{wall:.4f} ms a call, device busy {busy:.4f} ms, idle "
                  f"share {1 - busy / wall:.4f}; largest "
                  + ", ".join(f"{n} {ms:.4f}" for n, ms in top)
                  + f"; cat kernels {cat:.4f} ms; card {card}")
            if mode == "cuda_full" and B == 64 and cat > 0.05:
                raise AssertionError("cuda_full still copies the canvas")

    # ---- chains, wall time a call ------------------------------------------
    def summary(per_call, batch):
        med = statistics.median(per_call)
        return (f"median {med:.4f} ms/call ({batch / med * 1e3:.1f} img/s), "
                f"windows {min(per_call):.4f}..{max(per_call):.4f} ms")

    for batch, (images, xywhn, seeds) in inputs.items():
        for mode in ("cuda_full", "full_reference", "cuda_shear", "shear",
                     "cuda_fused", "fused_reference", "gather"):
            per_call = time_calls(lambda i: chains.augment_chain(
                images, xywhn, seeds + i * batch, rotation=mode), calls=20)
            print(f"chain {mode} B={batch} 640->512: "
                  f"{summary(per_call, batch)}; card {card}")
    torch.cuda.synchronize()

    # ---- F6: the card's tan/sin against the CPU's in shear_params ----------
    t0 = time.perf_counter()
    f6, moved = shift_vector_deltas(geometry, dev)
    print(f"F6 shear_params at S=512 over 200000 angles from uniform(1, 359),"
          f" card against CPU: angles with a different quad {f6['quad']}, "
          f"sh1 {f6['sh1']}, sh2 {f6['sh2']}, any {f6['any']}; largest "
          f"shift difference {f6['max_step']} "
          f"({time.perf_counter() - t0:.1f} s)")
    if len(moved) == 0:
        raise AssertionError("F6: no angle moves a shift on this card")
    t0 = time.perf_counter()
    chain_modes_card_against_cpu(chains, moved, dev)
    print(f"F6 chain: AugmentChain(640 -> 512) at B={len(moved)} over the "
          f"{len(moved)} angles that move, cuda_full, cuda_fused and "
          f"cuda_shear on the card == the same modes on the CPU, byte for "
          f"byte ({time.perf_counter() - t0:.1f} s)")

    # ---- P1: the probe kernel's four moves ----------------------------------
    # byte for byte against torch.flip / torch.roll / clone, on the probe's
    # [512, 512] block (16-byte vectors) and on an odd shape (single words)
    p1_err = 0
    for rows, cols in ((rev_probe.S, rev_probe.S), (37, 101)):
        x = torch.as_tensor(np.random.default_rng(rows).integers(
            -2**31, 2**31, (rows, cols), dtype=np.int64).astype(np.int32),
            device=dev)
        for name in rev_probe.MOVES:
            for shift in ((7, -3, cols + 5) if name == "roll" else (7,)):
                kernels.reset_launch_counts()
                got = rev_probe.move(x, name, shift)
                if kernels.launch_counts["rev_probe"] != 1:
                    raise AssertionError("rev_probe: not one wrapper launch")
                p1_err = max(p1_err, check_equal(
                    got, rev_probe.plain_move(x, name, shift),
                    f"kernel rev_probe {name} != plain at [{rows}, {cols}] "
                    f"shift {shift}"))
        print(f"kernel rev_probe == plain (torch.flip, torch.roll, clone), "
              f"byte for byte: int32 [{rows}, {cols}], moves "
              f"{tuple(rev_probe.MOVES)}")
    # its main path is the probe's own entry point
    _, counts = drive(kernels, {"rev_probe": 4 * 202}, rev_probe.main)
    launches["rev_probe"] = counts["rev_probe"]
    x = torch.arange(rev_probe.S ** 2, dtype=torch.int32,
                     device=dev).reshape(rev_probe.S, rev_probe.S)
    p1_ms, p1_lib_ms = {}, {}
    for name in rev_probe.MOVES:
        turns = [(which, device_ms(fn, calls=200)) for which, fn in (
            ("kernel", lambda: rev_probe.launch_move(x, name)),
            ("torch", lambda: rev_probe.plain_move(x, name)),
            ("torch", lambda: rev_probe.plain_move(x, name)),
            ("kernel", lambda: rev_probe.launch_move(x, name)))]
        p1_ms[name] = min(ms for which, ms in turns if which == "kernel")
        p1_lib_ms[name] = min(ms for which, ms in turns if which == "torch")
        print(f"rev_probe {name} int32 [512, 512] in turns (device ms a "
              f"launch): " + ", ".join(f"{w} {ms:.5f}" for w, ms in turns)
              + f"; card {card}")
    p1_bound_ms = 2 * 4 * rev_probe.S ** 2 / HBM_BYTES_PER_S * 1e3
    # what a launch alone costs: a kernel that does nothing, in the same
    # window form, one CTA and the grid of the probe's vector kernels
    p1_grid = rev_probe.S ** 2 // 4 // 256
    empty_ms = {blocks: min(device_ms(
        lambda: rev_probe.launch_empty(dev, blocks), calls=200)
        for _ in range(2)) for blocks in (1, p1_grid)}
    p1_floor_ms = max(p1_bound_ms, empty_ms[1])
    print(f"rev_probe bound {p1_bound_ms:.6f} ms (2 x {4 * rev_probe.S ** 2} "
          f"bytes at 3.35 TB/s); an empty kernel's launch alone "
          f"{empty_ms[1]:.5f} ms with 1 CTA, {empty_ms[p1_grid]:.5f} ms with "
          f"{p1_grid} CTAs; floor max(byte bound, launch alone) "
          f"{p1_floor_ms:.5f} ms, set by the launch; share of the floor "
          + ", ".join(f"{name} {p1_floor_ms / ms:.3f}"
                      for name, ms in p1_ms.items())
          + f"; card {card}")

    # ---- the engine's failure contract on the card -------------------------
    failure = failure_contract(dev)

    # ---- the engine: pipelines A and B over a directory of files ----------
    import PIL

    from image_processor_pipeline_tpu_torch import (ProcessingPipeline,
                                                    ProcessingStep)
    from image_processor_pipeline_tpu_torch.io import images as io_images
    from image_processor_pipeline_tpu_torch.io.labels import read_yolo_labels
    from image_processor_pipeline_tpu_torch.transforms import (
        GenerateSymmetries, RandomRotations, SquareCropAroundBBox,
        copy_img_with_labels, crop_square, rotations)

    print(f"codec: the native IO engine where it builds, else Pillow "
          f"{PIL.__version__} (host decode and encode)")
    workers = os.cpu_count() or 1
    n = ENGINE_IMAGES
    crop_seed, rot_seed, sym_seed = 11, 12, 13
    rot_options = {"method": "shear", "num_rotations": ENGINE_ROTATIONS}
    with tempfile.TemporaryDirectory(prefix="ipp_smoke_") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        imgs_dir, labels_dir = write_engine_dataset(root / "data", n, 5,
                                                    workers)
        print(f"engine dataset: {n} RGB PNGs of {ENGINE_W} x {ENGINE_H} "
              f"with 1 to 3 boxes each, made from seed 5 in "
              f"{time.perf_counter() - t0:.1f} s; {workers} workers a step")
        pipe_a = ProcessingPipeline(root_dir=root / "A")
        pipe_a.add_step(ProcessingStep(
            "crop_square", SquareCropAroundBBox(),
            input_dirs=[imgs_dir, labels_dir],
            output_dirs=["crops/imgs", "crops/labels"], pairing_method="zip",
            seed=crop_seed, workers=workers, save_log=True, device=dev))
        pipe_a.add_step(ProcessingStep(
            "copy", copy_img_with_labels,
            output_dirs=["copy/imgs", "copy/labels"], pairing_method="zip",
            workers=workers, save_log=True))
        pipe_b = ProcessingPipeline(root_dir=root / "B")
        pipe_b.add_step(ProcessingStep(
            "rotations", RandomRotations(),
            input_dirs=[root / "A" / "crops" / "imgs"], output_dirs=["rot"],
            seed=rot_seed, workers=workers, save_log=True,
            options=rot_options, device=dev))
        pipe_b.add_step(ProcessingStep(
            "symmetry", GenerateSymmetries(), output_dirs=["sym"],
            seed=sym_seed, workers=workers, save_log=True, device=dev,
            sample_k=ENGINE_SYMMETRY_ITEMS))

        def run_engine():
            pipe_a.run(progress=False)
            events = profiled_step(lambda: pipe_b.run(
                from_step_index=0, only_one=True, progress=False))
            pipe_b.run(from_step_index=1, progress=False)
            return events

        crop_step, copy_step = pipe_a.steps
        rot_step, sym_step = pipe_b.steps
        t0 = time.perf_counter()
        (rot_events, counts), engine_direct = direct_count(
            lambda: drive(kernels, None, run_engine))
        engine_s = time.perf_counter() - t0
        n_rot = n * (ENGINE_ROTATIONS + 1)
        for step, items in ((crop_step, n), (copy_step, n), (rot_step, n),
                            (sym_step, ENGINE_SYMMETRY_ITEMS)):
            require_success(step, items)
            print(step_line(step, card))
        files = {
            "A/crops/imgs": count_files(root / "A/crops/imgs", n, "crops"),
            "A/crops/labels": count_files(root / "A/crops/labels", n,
                                          "crop labels"),
            "A/copy/imgs": count_files(root / "A/copy/imgs", n, "copies"),
            "A/copy/labels": count_files(root / "A/copy/labels", n,
                                         "copied labels"),
            "B/rot": count_files(root / "B/rot", n_rot, "rotations"),
            "B/sym": count_files(root / "B/sym", 4 * ENGINE_SYMMETRY_ITEMS,
                                 "symmetries")}
        print(f"engine files: {files} in {engine_s:.1f} s")
        want = {name: 0 for name in counts} | {
            "shear_rotate_packed": rot_step.metrics.batches}
        if counts != want or rot_step.metrics.batches < n // 8:
            raise AssertionError(f"engine launch counts {counts}, expected "
                                 f"{want}")
        if engine_direct:
            raise AssertionError(f"engine: {engine_direct} tiles took the "
                                 f"direct gather")
        launches["shear_rotate_packed"] += counts["shear_rotate_packed"]
        print(f"engine: shear_rotate_packed launched "
              f"{counts['shear_rotate_packed']} times, once for each of the "
              f"rotations step's {rot_step.metrics.batches} batches; direct "
              f"tiles {engine_direct}")
        line, by_name = idle_line(rot_step, rot_events, card)
        shear_ms = sum(ms for name, ms in by_name.items()
                       if "shear_tile_kernel" in name)
        print(f"{line}; shear_tile_kernel {shear_ms:.3f} ms in all")
        if shear_ms <= 0:
            raise AssertionError("profiler saw no shear_tile_kernel")

        # each crop is a window of its source at the offsets the step drew
        names = sorted(p.name for p in imgs_dir.iterdir())
        picked = list(range(0, n, max(1, n // 64)))
        labels = [read_yolo_labels(labels_dir / f"{Path(names[i]).stem}.txt")
                  for i in picked]
        cls = np.zeros((len(picked), crop_square.MAX_BOXES), np.int32)
        box = np.zeros((len(picked), crop_square.MAX_BOXES, 4), np.float32)
        for row, (c, b) in enumerate(labels):
            cls[row, :len(c)], box[row, :len(c)] = c, b
        geom = crop_square._geom(
            np.full(len(picked), ENGINE_H, np.int32),
            np.full(len(picked), ENGINE_W, np.int32), cls, box,
            np.asarray([len(c) for c, _ in labels], np.int32),
            np.asarray([(crop_seed + i) & 0x7FFFFFFF for i in picked],
                       np.uint32))
        for row, i in enumerate(picked):
            y0, x0, s = (int(geom[k][row]) for k in ("y0", "x0", "crop_size"))
            src = io_images.decode_image(imgs_dir / names[i], "RGB")
            got = io_images.decode_image(root / "A/crops/imgs" / names[i],
                                         "RGB")
            if got.shape != (s, s, 3) or not np.array_equal(
                    got, src[y0:y0 + s, x0:x0 + s]):
                raise AssertionError(f"engine: crop {names[i]} is not its "
                                     f"source's window at ({y0}, {x0})")
        print(f"engine: {len(picked)} crops are their sources' "
              f"{ENGINE_H} x {ENGINE_H} windows at the offsets drawn from "
              f"seed {crop_seed} + index (first offsets "
              f"{[(int(geom['y0'][r]), int(geom['x0'][r])) for r in range(4)]})")

        # one rotation batch through device_fn, kernel against plain twin
        transform = rot_step.process_function
        crops = sorted((root / "A/crops/imgs").iterdir())[:8]
        chunk = [transform.load_item((p,), rot_options) for p in crops]
        for i, item in enumerate(chunk):
            item["_seed"] = (rot_seed + i) & 0x7FFFFFFF
        key = transform.bucket_key(chunk[0], rot_options)
        kernel_out = transform.launch_batch(key, chunk, rot_options, dev)

        real_batch = rotations.rotate_ops.rotate_square_shear_batch
        rotations.rotate_ops.rotate_square_shear_batch = plain_rotate_batch
        try:
            plain_out = transform.launch_batch(key, chunk, rot_options, dev)
        finally:
            rotations.rotate_ops.rotate_square_shear_batch = real_batch
        for k in kernel_out:
            check_equal(kernel_out[k].to(dev), plain_out[k].to(dev),
                        f"engine rotations device_fn[{k!r}], kernel != plain "
                        f"twin")
        shape = tuple(kernel_out["images"].shape)
        print(f"engine: one rotations batch, device_fn with the kernel == "
              f"with geometry.rotate_square_shear_by in its place, byte for "
              f"byte: images {shape}, heights, widths, angles")

        # the kernel alone at the rotations step's shape
        B, R, S, _, C = shape
        eimgs = kernel_out["images"].reshape(B * R, S, S, C).contiguous()
        eshifts = geometry.shear_params(
            kernel_out["angles"].reshape(-1).to(dev), S)
        engine_kernel = {
            "shape": [B * R, S, S, C],
            "ms": device_ms(lambda: rotate.launch_shear(eimgs, *eshifts)),
            "plain_ms": statistics.median(time_calls(
                lambda i: geometry.rotate_square_shear_by(eimgs, *eshifts),
                calls=5, windows=3)),
            "bound_ms": rotate_bytes(S, B * R, C) / HBM_BYTES_PER_S * 1e3}
        print(f"shear_rotate_packed at the rotations step's shape "
              f"{engine_kernel['shape']}: kernel {engine_kernel['ms']:.4f} ms "
              f"of device time a launch, bound "
              f"{engine_kernel['bound_ms']:.4f} ms, plain "
              f"{engine_kernel['plain_ms']:.4f} ms a call; card {card}")
        del kernel_out, plain_out, eimgs

        # F6: the shift vectors come from the host, so a rotations batch on
        # the card equals the same batch on the CPU, byte for byte
        two = [(p,) for p in crops[:2]]
        check_batches_equal(
            one_batch(transform, two, rot_options, rot_seed, dev),
            one_batch(transform, two, rot_options, rot_seed, "cpu"),
            "engine rotations device_fn, card != CPU")
        print("engine: one rotations batch (2 images, 8 canvases of 768), "
              "device_fn on the card == on the CPU, byte for byte")

        stage_kernel = mask_chain_crop_pipelines(root, dev, card, workers,
                                                 launches)
        video_kernel = overlay_video_pipelines(root, dev, card, workers,
                                               launches)
        fanout_kernel = fanout_fusion_pipelines(
            root, dev, card, workers, launches, root / "A" / "crops" / "imgs",
            root / "C" / "mask")
        codec = codec_pipelines(root, dev, card, workers, launches)
        entry = entry_points(root, dev, card, workers, launches, imgs_dir,
                             labels_dir)
        native = native_compute_pipelines(root, dev, card, workers,
                                          imgs_dir, labels_dir)

    print(f"smoke run: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches[name],
        "max_abs_err": max_err[name],
        "ms": dev_ms[name, 64], "plain_ms": plain_ms[name, 64],
        "bound_ms": bound_ms[name, 64], "bound_by": "bytes",
        "library_ms": None, "batch": 64, "crop": 512,
        "device_ms": {f"B={B}": dev_ms[name, B] for B in BATCHES},
        "bound_ms_by_batch": {f"B={B}": bound_ms[name, B] for B in BATCHES},
        "plain_ms_by_batch": {f"B={B}": plain_ms[name, B] for B in BATCHES},
    } | ({"gather_iou": {f"B={B}": iou for B, iou in gather_iou.items()},
          "failure_contract": failure}
         if name == "augment_full" else {})
      | ({"engine": engine_kernel, "fused_chain": stage_kernel,
          "video_chain": video_kernel, "codec": codec,
          "entry_points": entry, "native_compute": native} | fanout_kernel
         if name == "shear_rotate_packed" else {})
        for name, (source, replaces) in KERNELS.items()] + [{
        "name": "rev_probe", "route": "cuda", "source": CSRC + "rev_probe.cu",
        "replaces": "benchmarks/rev_probe.py:25",
        "launches": launches["rev_probe"], "max_abs_err": p1_err,
        "ms": statistics.mean(p1_ms.values()),
        "plain_ms": statistics.mean(p1_lib_ms.values()),
        "bound_ms": p1_bound_ms, "bound_by": "bytes",
        "library_ms": statistics.mean(p1_lib_ms.values()),
        "block": [rev_probe.S, rev_probe.S],
        "ms_by_move": p1_ms, "library_ms_by_move": p1_lib_ms,
        "launch_ms": empty_ms[1], "floor_ms": p1_floor_ms,
        "floor_by": "launch" if empty_ms[1] > p1_bound_ms else "bytes"}]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

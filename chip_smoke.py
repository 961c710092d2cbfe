"""Smoke run of the PyTorch port (image_processor_pipeline_tpu_torch) on one
CUDA card.  Run from the repository root:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from csrc/, holds each byte for
byte against its plain PyTorch version on the card, drives the flagship
chain (AugmentChain, 640 px input, 512 px crop) through them in the modes
cuda_full, cuda_shear and cuda_fused, and the batched rotation op on
single-channel masks, checks each output against its plain twin on the
card, times kernels and chains against their plain versions with CUDA
events, counts how often the card's float32 tan/sin move a shift vector
against the CPU's, and prints the card's name and power limit, a JSON line
of the kernels and, last, a JSON status line.  Any failed phase raises, so
the status line is printed only when every phase passed.  Without a CUDA
card it exits non-zero.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

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


def kernel_inputs(SIN, S, B, seed, dev):
    """Random canvases and draws covering the boundary angles and all flip
    codes, as the augment_fused_full arguments before the filter stack."""
    rng = np.random.default_rng(seed)
    from image_processor_pipeline_tpu_torch.ops.augment import pack_rgba

    imgs = torch.as_tensor(rng.integers(0, 256, (B, SIN, SIN, 3), np.uint8),
                           device=dev)
    angles = np.asarray(ANGLES[:B] + tuple(rng.uniform(1, 359, B)),
                        np.float32)[:B]
    as_dev = lambda a, t: torch.as_tensor(np.asarray(a, t), device=dev)
    return (pack_rgba(imgs),
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
    after a warm-up call, ``windows`` times; fn(i) takes the call index."""
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


def check_equal(got, ref, what):
    """Raise unless got == ref byte for byte; returns the max abs error."""
    torch.cuda.synchronize()
    err = int((got.int() - ref.int()).abs().max())
    if got.shape != ref.shape or not torch.equal(got, ref):
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
    after; raise unless the counts are ``expected`` (others 0)."""
    kernels.reset_launch_counts()
    result = fn()
    counts = dict(kernels.launch_counts)
    torch.cuda.synchronize()
    want = {name: expected.get(name, 0) for name in counts}
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    return result, counts


def shift_vector_deltas(geometry, dev, n=200_000, S=512, chunk=20_000):
    """F6: angles whose (quad, sh1, sh2) from geometry.shear_params differ
    between the card and the CPU, over n angles from uniform(1, 359)."""
    angles = np.random.default_rng(6).uniform(1, 359, n).astype(np.float32)
    diff = {"quad": 0, "sh1": 0, "sh2": 0, "any": 0, "max_step": 0}
    for i in range(0, n, chunk):
        a = torch.as_tensor(angles[i:i + chunk])
        cpu = geometry.shear_params(a, S)
        gpu = [t.cpu() for t in geometry.shear_params(a.to(dev), S)]
        rows = [(c != g).reshape(len(a), -1).any(1) for c, g in zip(cpu, gpu)]
        for name, r in zip(("quad", "sh1", "sh2"), rows):
            diff[name] += int(r.sum())
        diff["any"] += int((rows[0] | rows[1] | rows[2]).sum())
        for c, g in zip(cpu[1:], gpu[1:]):
            diff["max_step"] = max(diff["max_step"],
                                   int((c - g).abs().max()))
    return diff


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this smoke run needs a CUDA card")
    from image_processor_pipeline_tpu_torch import kernels
    from image_processor_pipeline_tpu_torch.models import chains
    from image_processor_pipeline_tpu_torch.ops import augment, geometry
    from image_processor_pipeline_tpu_torch.ops import rotate

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"device: {kind}; torch {torch.__version__}, "
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

    filt = (chains._FILTER_LOWERS, chains._FILTER_UPPERS,
            chains._FILTER_ZONES)
    max_err = dict.fromkeys(KERNELS, 0)

    # ---- augment_full (K1) against its plain version ----------------------
    for SIN, S, B, shift in ((640, 512, 16, 0), (96, 64, 8, 0),
                             (96, 64, 8, -70)):
        packed, y0, x0, angles, prms, flips = kernel_inputs(
            SIN, S, B, seed=SIN, dev=dev)
        # shift != 0 moves the crop offsets off the canvas: negative ones
        # count from the end, then all are clamped (lax.dynamic_slice)
        y0, x0 = y0 + shift, x0 - shift
        got = augment.augment_fused_full(packed, y0, x0, angles, prms, flips,
                                         *filt, crop=S)
        ref = augment.augment_full_reference(
            packed, y0, x0, angles, prms, flips, *filt, crop=S,
            shifts=augment._shifts(angles, S))
        if got.shape != (B, S, S, 4):
            raise AssertionError(f"augment_full: shape {tuple(got.shape)}")
        max_err["augment_full"] = max(max_err["augment_full"], check_equal(
            got, ref, f"kernel augment_full != plain at SIN={SIN} S={S}"))
        print(f"kernel augment_full == plain, byte for byte: SIN={SIN} "
              f"S={S} B={B}, offsets shifted by {shift}, every flip code, "
              f"angles {ANGLES} + random")

    # ---- shear_rotate (K2, K4) against its plain version ------------------
    for S, C, B in ((512, 4, 16), (512, 3, 16), (512, 1, 16), (64, 2, 16),
                    (768, 1, 16)):
        imgs, angles, _, _ = crop_inputs(S, C, B, seed=S + C, dev=dev)
        shifts = geometry.shear_params(angles, S)
        if set(shifts[0].tolist()) != {0, 1, 2, 3}:
            raise AssertionError(f"S={S} C={C}: not every quad covered")
        got = rotate.shear_rotate(imgs, *shifts)
        ref = geometry.rotate_square_shear_by(imgs, *shifts)
        name = "shear_rotate_packed" if C in (3, 4) else "shear_rotate"
        max_err[name] = max(max_err[name], check_equal(
            got, ref, f"kernel {name} != plain at S={S} C={C} B={B}"))
        print(f"kernel {name} == plain, byte for byte: S={S} C={C} B={B}, "
              f"every quad, angles {ANGLES} + random")

    # ---- augment_fused (K3) against its plain version ---------------------
    for S, B in ((512, 16), (64, 8)):
        crops, angles, prms, flips = crop_inputs(S, 3, B, seed=S, dev=dev)
        got = augment.augment_fused(crops, angles, prms, *filt, flips=flips)
        ref = augment.augment_finish_reference(
            crops, angles, prms, *filt, flips=flips,
            shifts=augment._shifts(angles, S))
        if got.shape != (B, S, S, 4):
            raise AssertionError(f"augment_fused: shape {tuple(got.shape)}")
        max_err["augment_fused"] = max(max_err["augment_fused"], check_equal(
            got, ref, f"kernel augment_fused != plain at S={S} B={B}"))
        print(f"kernel augment_fused == plain, byte for byte: S={S} B={B}, "
              f"every flip code, angles {ANGLES} + random")

    # ---- main paths, each read on its own ---------------------------------
    # AugmentChain in each kernel mode at B=8 and 64, three calls each, and
    # the batched rotation op on single-channel masks, the op's path for
    # C not in {3, 4} (where the TPU package launches _shear_kernel)
    inputs = {batch: chains.AugmentChain(640, device=dev).example_inputs(batch)
              for batch in (8, 64)}
    launches = {}
    outputs = {}
    for mode, kernel in (("cuda_full", "augment_full"),
                         ("cuda_shear", "shear_rotate_packed"),
                         ("cuda_fused", "augment_fused")):
        chain = chains.AugmentChain(input_size=640, rotation=mode, device=dev)
        outputs[mode], counts = drive(kernels, {kernel: 6}, lambda: {
            batch: [chain(images, xywhn, seeds + i * batch)
                    for i in range(3)]
            for batch, (images, xywhn, seeds) in inputs.items()})
        launches[kernel] = counts[kernel]
    masks = {batch: crop_inputs(512, 1, batch, seed=batch, dev=dev)[:2]
             for batch in (8, 64)}
    rotated, counts = drive(kernels, {"shear_rotate": 6}, lambda: {
        batch: [rotate.rotate_square_shear_batch(m, a + 7.0 * i)
                for i in range(3)]
        for batch, (m, a) in masks.items()})
    launches["shear_rotate"] = counts["shear_rotate"]

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
    print(f"main-path kernel launches (each path read on its own): "
          f"{launches}")
    del outputs, rotated
    torch.cuda.synchronize()

    # ---- timing -----------------------------------------------------------
    def summary(per_call, batch):
        med = statistics.median(per_call)
        return (f"median {med:.4f} ms/call ({batch / med * 1e3:.1f} img/s), "
                f"windows {min(per_call):.4f}..{max(per_call):.4f} ms")

    for batch, (images, xywhn, seeds) in inputs.items():
        for mode in ("cuda_full", "full_reference", "cuda_shear", "shear",
                     "cuda_fused", "fused_reference"):
            per_call = time_calls(lambda i: chains.augment_chain(
                images, xywhn, seeds + i * batch, rotation=mode))
            print(f"chain {mode} B={batch} 640->512: "
                  f"{summary(per_call, batch)}; card {card}")
    kernel_ms = {}
    for B in (8, 64):
        args = kernel_inputs(640, 512, B, seed=B, dev=dev)
        crops, angles, prms, flips = crop_inputs(512, 3, B, seed=B, dev=dev)
        mask = crop_inputs(512, 1, B, seed=B, dev=dev)[0]
        for name, kernel, plain in (
                ("augment_full",
                 lambda i: augment.augment_fused_full(*args, *filt, crop=512),
                 lambda i: augment.augment_full_reference(*args, *filt,
                                                          crop=512)),
                ("shear_rotate_packed",
                 lambda i: rotate.rotate_square_shear_batch(crops, angles),
                 lambda i: geometry.rotate_square_shear(crops, angles)),
                ("shear_rotate",
                 lambda i: rotate.rotate_square_shear_batch(mask, angles),
                 lambda i: geometry.rotate_square_shear(mask, angles)),
                ("augment_fused",
                 lambda i: augment.augment_fused(crops, angles, prms, *filt,
                                                 flips=flips),
                 lambda i: augment.augment_finish_reference(
                     crops, angles, prms, *filt, flips=flips))):
            for which, fn in (("kernel", kernel), ("plain", plain)):
                per_call = time_calls(fn)
                kernel_ms[name, B, which] = statistics.median(per_call)
                print(f"{name} {which} B={B} S=512: "
                      f"{summary(per_call, B)}; card {card}")
    torch.cuda.synchronize()

    # ---- F6: the card's tan/sin against the CPU's in shear_params ----------
    t0 = time.perf_counter()
    f6 = shift_vector_deltas(geometry, dev)
    print(f"F6 shear_params at S=512 over 200000 angles from uniform(1, 359),"
          f" card against CPU: angles with a different quad {f6['quad']}, "
          f"sh1 {f6['sh1']}, sh2 {f6['sh2']}, any {f6['any']}; largest "
          f"shift difference {f6['max_step']} "
          f"({time.perf_counter() - t0:.1f} s)")

    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches[name],
        "max_abs_err": max_err[name],
        "ms": kernel_ms[name, 8, "kernel"],
        "plain_ms": kernel_ms[name, 8, "plain"],
    } for name, (source, replaces) in KERNELS.items()]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

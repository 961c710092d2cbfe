"""Four data moves of one int32 block, by a hand-written CUDA kernel: the
port of the TPU probe benchmarks/rev_probe.py (k_copy, k_roll, k_rev_lane,
k_rev_sublane and its ``main``).

The TPU probe asks whether its compiler lowers a reverse inside a kernel
and what that costs next to a copy and a roll.  ``move`` is the port's
wrapper around ``csrc/rev_probe.cu``: for a CUDA tensor it launches the
kernel or raises; for a CPU tensor it runs the plain version
(``torch.flip``, ``torch.roll``, ``clone``), which is what the kernel is
held against, not what it is made of.

    python -m image_processor_pipeline_tpu_torch.utils.rev_probe

checks the four moves on the card against numpy and prints microseconds a
move from CUDA-event windows.
"""

from __future__ import annotations

import torch

from image_processor_pipeline_tpu_torch import kernels

S = 512
ROLL_SHIFT = 7
#: move name -> the kernel's move code (csrc/rev_probe.cu)
MOVES = {"copy": 0, "roll": 1, "rev_cols": 2, "rev_rows": 3}


def plain_move(x, name: str, shift: int = ROLL_SHIFT):
    """The plain PyTorch version of ``move`` (any device)."""
    if name == "copy":
        return x.clone()
    if name == "roll":
        return torch.roll(x, shift, 1)
    if name == "rev_cols":
        return torch.flip(x, (1,))
    if name == "rev_rows":
        return torch.flip(x, (0,))
    raise ValueError(f"unknown move {name!r}; choose from {tuple(MOVES)}")


def move(x, name: str, shift: int = ROLL_SHIFT):
    """``name`` in MOVES applied to the int32 block ``x`` [rows, cols]
    (contiguous): a copy, a circular roll by ``shift`` along the columns
    (``np.roll(x, shift, 1)``), ``x[:, ::-1]`` or ``x[::-1, :]``, as a new
    tensor.  CPU tensors run the plain version; CUDA tensors launch the
    kernel (no fallback); other devices raise."""
    if name not in MOVES:
        raise ValueError(f"unknown move {name!r}; choose from {tuple(MOVES)}")
    if not isinstance(x, torch.Tensor) or x.dtype != torch.int32 \
            or x.ndim != 2 or x.numel() == 0:
        raise ValueError("x must be a non-empty int32 [rows, cols] tensor")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.device.type == "cpu":
        return plain_move(x, name, shift)
    if x.device.type != "cuda":
        raise ValueError(f"move runs on cpu or cuda, not {x.device}")
    return launch_move(x, name, shift)


def launch_move(x, name: str, shift: int = ROLL_SHIFT):
    """Launch csrc/rev_probe.cu's ipp_rev_probe on ``x``'s card and count
    the launch."""
    rows, cols = x.shape
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = kernels.library().ipp_rev_probe(
            x.data_ptr(), out.data_ptr(), rows, cols, MOVES[name],
            int(shift) % cols, stream)
    kernels.check(code)
    kernels.launch_counts["rev_probe"] += 1
    return out


def launch_empty(device, blocks: int = 1) -> None:
    """Launch csrc/rev_probe.cu's kernel that does nothing, ``blocks`` CTAs
    of 256 threads, on ``device``'s current stream: what a launch alone
    costs, the floor under any move of a block this small.  Not a move: it
    is not counted in ``kernels.launch_counts``."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        kernels.check(kernels.library().ipp_empty_launch(int(blocks), stream))


def device_us(fn, calls: int = 200) -> float:
    """Device microseconds per call of ``fn``: ``calls`` calls queued behind
    a sleeping kernel inside one CUDA-event window, so that the window
    holds device time alone."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / calls


def main() -> None:
    import numpy as np

    if not torch.cuda.is_available():
        raise SystemExit("rev_probe: needs a CUDA card")
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)}")
    x = torch.arange(S * S, dtype=torch.int32, device=dev).reshape(S, S)
    xn = x.cpu().numpy()
    refs = {"copy": xn, "roll": np.roll(xn, ROLL_SHIFT, 1),
            "rev_cols": xn[:, ::-1], "rev_rows": xn[::-1, :]}
    for name, ref in refs.items():
        ok = bool((move(x, name).cpu().numpy() == ref).all())
        print(f"[{name}] {'OK' if ok else 'WRONG RESULT'}")
        if not ok:
            raise SystemExit(f"rev_probe: {name} disagrees with numpy")
    for name in refs:
        kernel = device_us(lambda: launch_move(x, name))
        print(f"[{name}] {kernel:.2f} us/move ({S}x{S} int32)")


if __name__ == "__main__":
    main()

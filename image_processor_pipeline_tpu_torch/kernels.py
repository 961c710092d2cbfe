"""Build and bind the port's hand-written CUDA kernels.

The sources in ``csrc/`` are compiled at first use by ``nvcc``, one
process per source started together, and linked into one shared library
with a plain C interface under ``_build/``, loaded with ctypes (no PyTorch
headers, so a build takes seconds).  An flock serialises the build across
processes; the library is rebuilt when any file under ``csrc/``, a shared
header included, is newer than it.

``launch_counts`` counts, per kernel, the wrapper calls that launched it on
the device, so a run can show that its main path went through the kernel;
``direct_tiles``, when set, counts the rotation kernel's tiles that took
its direct path.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"
SOURCES = ("augment_full.cu", "shear_rotate.cu", "rev_probe.cu")
_SO = BUILD / "libipp_cuda.so"

# sm_90a (Hopper); --fmad=false keeps every multiply and add separately
# rounded, as the plain torch versions are; IEEE division (no fast math)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC",
)

# one entry per kernel path, named after the TPU kernel it replaces:
# augment_full (_augment_full_kernel), augment_fused (_augment_kernel),
# shear_rotate_packed (_shear_kernel_packed, C in {3, 4}), shear_rotate
# (_shear_kernel, any other C) and rev_probe (the four probe kernels of
# benchmarks/rev_probe.py)
launch_counts = {"augment_full": 0, "augment_fused": 0,
                 "shear_rotate_packed": 0, "shear_rotate": 0,
                 "rev_probe": 0}
# an int32 [1] tensor on the card, or None: while it is set, the shear
# kernel adds one to it for each tile it gathers straight from device
# memory instead of from its shared-memory window (csrc/shear_rotate.cu)
direct_tiles = None

_lock = threading.Lock()
_lib = None
build_log = ""


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(nvcc, os.X_OK):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built with the CUDA "
            "toolkit on the machine that has the card")
    return nvcc


def _stale(csrc: Path, so: Path) -> bool:
    """True when the library ``so`` is missing or older than any file
    under ``csrc``: a header shared by several sources changes them all."""
    if not so.exists():
        return True
    built = so.stat().st_mtime
    return any(p.stat().st_mtime > built
               for p in csrc.rglob("*") if p.is_file())


def _build() -> Path:
    global build_log
    BUILD.mkdir(exist_ok=True)
    with open(BUILD / ".lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if not _stale(CSRC, _SO):
            return _SO
        nvcc, pid = _nvcc(), os.getpid()
        objs = [BUILD / f"{Path(s).stem}.{pid}.o" for s in SOURCES]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for src, obj in zip(SOURCES, objs)]
        logs, failed = [], []
        try:
            for src, proc in zip(SOURCES, procs):
                out, err = proc.communicate(timeout=600)
                logs.append(f"{src}:\n{out}{err}")
                if proc.returncode != 0:
                    failed.append(f"{src}: code {proc.returncode}\n{err}")
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        tmp = _SO.with_name(f"{_SO.name}.{pid}.tmp")
        if not failed:
            link = subprocess.run(
                [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                capture_output=True, text=True, timeout=600)
            if link.returncode != 0:
                failed.append(f"link: code {link.returncode}\n{link.stderr}")
        for obj in objs:
            obj.unlink(missing_ok=True)
        if failed:
            tmp.unlink(missing_ok=True)
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        os.replace(tmp, _SO)
        build_log = "\n".join(logs)
    return _SO


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.ipp_augment_full.argtypes = [ptr] * 8 + [i32] * 6 + [ptr]
            lib.ipp_augment_max_active_clusters.argtypes = [i32] * 3 + [ptr]
            lib.ipp_shear_rotate.argtypes = [ptr] * 8 + [i32] * 7 + [ptr]
            lib.ipp_rev_probe.argtypes = [ptr] * 2 + [i32] * 4 + [ptr]
            lib.ipp_empty_launch.argtypes = [i32, ptr]
            for fn in (lib.ipp_augment_full,
                       lib.ipp_augment_max_active_clusters,
                       lib.ipp_shear_rotate, lib.ipp_rev_probe,
                       lib.ipp_empty_launch):
                fn.restype = i32
            lib.ipp_cuda_error_string.argtypes = [i32]
            lib.ipp_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(code: int) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if code != 0:
        msg = library().ipp_cuda_error_string(code).decode()
        raise RuntimeError(f"CUDA kernel launch failed: {msg} ({code})")

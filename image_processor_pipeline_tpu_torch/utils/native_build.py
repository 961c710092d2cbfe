"""Build and load one of the port's host C++ libraries (io/native.py,
io/jcoef.py, ops/native_cpu.py, ops/native_draws.py): compile the source with ``g++`` (or
``$CXX``) into the git-ignored ``_build/`` at first use, under an flock so
that concurrent processes build it once, into a temp file renamed into
place so that no process ever loads a half-written library; rebuild it
when the source is newer; bind its symbols.  Each binding module keeps
its source, flags, libraries and symbol signatures, and its own
``available()``/``build_error()`` over what ``load`` returns.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Tuple

#: seconds each library's compile took in this process, by file name
BUILD_SECONDS: Dict[str, float] = {}


def stale(source: Path, so: Path) -> bool:
    return not so.exists() or source.stat().st_mtime > so.stat().st_mtime


def command(source: Path, out: Path, flags: Sequence[str],
            libs: Sequence[str]) -> list:
    """The compiler's command line that builds ``source`` into ``out``."""
    return [os.environ.get("CXX", "g++"), *flags, "-o", str(out),
            str(source), *libs]


def build(source: Path, so: Path, flags: Sequence[str],
          libs: Sequence[str]) -> None:
    """Compile under an flock, then rename into place; raises
    RuntimeError with the compiler's message."""
    so.parent.mkdir(exist_ok=True)
    with open(so.parent / f".{so.stem}.lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if not stale(source, so):
            return
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = command(source, tmp, flags, libs)
        t0 = time.perf_counter()
        try:
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"{cmd[0]}: {e}") from None
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"{cmd[0]} exited with code {res.returncode}:\n"
                f"{res.stderr.strip()}")
        os.replace(tmp, so)
        BUILD_SECONDS[so.name] = time.perf_counter() - t0


def load(source: Path, so: Path, flags: Sequence[str], libs: Sequence[str],
         bind: Callable) -> Tuple[Optional[ctypes.CDLL], Optional[str]]:
    """(library, None) once built, loaded and bound by ``bind`` (which
    raises AttributeError for a missing symbol); (None, why) otherwise."""
    try:
        if stale(source, so):
            build(source, so, flags, libs)
        lib = ctypes.CDLL(str(so))
        bind(lib)
    except (RuntimeError, OSError, AttributeError) as e:
        return None, str(e)
    return lib, None

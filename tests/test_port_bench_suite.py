"""The benchmark harness's own CPU tests (port_bench/tests), run from the
repository's test suite in a subprocess: they have their own conftest and
import no JAX.  They take some 30-45 s alone; the timeout leaves room for
a machine shared with the suite's other workers."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def test_port_bench_tests_pass():
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "port_bench/tests", "-q",
         "-p", "no:cacheprovider"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-2000:]

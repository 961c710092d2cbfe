"""The port's crash durability on the CPU (the counterpart of
tests/test_crash_resume.py): a step SIGKILLed mid-run leaves a valid
report of what it finished (the atomic temp + rename flush every
_FLUSH_EVERY items), and a rerun with resume=True finishes only the rest:
every item done exactly once.  One case runs the port's host step
change_label_class, the other a device step (SquareCropAroundBBox on
device="cpu") whose files must equal an uninterrupted run's, byte for
byte.  Each subprocess has its own timeout."""

import json
import signal
import subprocess
import sys
import time
from pathlib import Path

from image_processor_pipeline_tpu_torch import ProcessingStep
from image_processor_pipeline_tpu_torch.transforms import SquareCropAroundBBox
from torch_port_data import make_dataset

REPO = Path(__file__).resolve().parent.parent
N_ITEMS = 120

HOST_WORKER = """
import sys, time
sys.path.insert(0, {repo!r})
from pathlib import Path
from image_processor_pipeline_tpu_torch import ProcessingStep
from image_processor_pipeline_tpu_torch.transforms.labels import (
    change_label_class)

def slow_remap(*args, output_dirs=None, **opts):
    time.sleep(0.05)
    return change_label_class(*args, output_dirs=output_dirs, **opts)

root = Path({root!r})
step = ProcessingStep(
    "remap", slow_remap, input_dirs=[root / "labels"],
    output_dirs=[root / "out"], pairing_method="one_input",
    options={{"cls_mapping": {{0: 9}}}}, save_log=True, resume=True, seed=1,
)
print("READY", flush=True)
step.run(progress=False)
print("FINISHED", flush=True)
"""

DEVICE_WORKER = """
import sys, time
sys.path.insert(0, {repo!r})
from pathlib import Path
from image_processor_pipeline_tpu_torch import ProcessingStep
from image_processor_pipeline_tpu_torch.transforms import SquareCropAroundBBox

class SlowSaves(SquareCropAroundBBox):
    max_batch = 8

    def save_item(self, out, item, output_dirs, options):
        time.sleep(0.05)
        return super().save_item(out, item, output_dirs, options)

root = Path({root!r})
step = ProcessingStep(
    "crop", SlowSaves(), input_dirs=[root / "imgs", root / "labels"],
    output_dirs=[root / "out" / "imgs", root / "out" / "labels"],
    pairing_method="zip", save_log=True, resume=True, seed=4,
    device={device!r}, workers=2,
)
print("READY", flush=True)
step.run(progress=False)
print("FINISHED", flush=True)
"""


def kill_mid_run(script, report, timeout=120.0):
    """Start ``script``, SIGKILL it once ``report`` lists at least one
    Success (the first flush), and return the report's entries then."""
    proc = subprocess.Popen([sys.executable, "-c", script],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        assert "READY" in proc.stdout.readline()
        deadline = time.monotonic() + timeout
        while not report.is_file():
            assert proc.poll() is None, "the run ended before a flush"
            assert time.monotonic() < deadline, "no report in time"
            time.sleep(0.02)
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    return json.loads(report.read_text())  # atomic flush: valid JSON


def resume_and_check(script, report, partial, n):
    done_before = {e["inputs"][0] for e in partial
                   if e["status"] == "Success"}
    assert 0 < len(done_before) < n, len(done_before)
    proc = subprocess.run([sys.executable, "-c", script],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "resume — skipping" in proc.stdout
    final = json.loads(report.read_text())
    assert len(final) == n
    assert all(e["status"] == "Success" for e in final)
    inputs = [e["inputs"][0] for e in final]
    assert len(set(inputs)) == n  # every item exactly once
    for e in final:
        for o in e["outputs"]:
            assert Path(o).is_file()
    return final


def test_sigkill_then_resume_host_step(tmp_path):
    labels = tmp_path / "labels"
    labels.mkdir()
    for i in range(N_ITEMS):
        (labels / f"l{i:03d}.txt").write_text("0 0.5 0.5 0.2 0.2\n")
    script = HOST_WORKER.format(repo=str(REPO), root=str(tmp_path))
    report = tmp_path / "remap.json"
    partial = kill_mid_run(script, report)
    resume_and_check(script, report, partial, N_ITEMS)
    want = "9 0.5 0.5 0.2 0.2\n"
    assert all(p.read_text() == want for p in (tmp_path / "out").iterdir())
    assert len(list((tmp_path / "out").iterdir())) == N_ITEMS


def test_sigkill_then_resume_device_step(tmp_path):
    """The device step killed while batches are in flight, then resumed:
    each item once, and the files equal an uninterrupted run's."""
    root = tmp_path / "run"
    make_dataset(root, N_ITEMS, seed=8, sizes=((24, 32), (32, 24)))
    script = DEVICE_WORKER.format(repo=str(REPO), root=str(root),
                                  device="cpu")
    report = root / "out" / "crop.json"
    partial = kill_mid_run(script, report)
    resume_and_check(script, report, partial, N_ITEMS)
    clean = tmp_path / "clean"
    ProcessingStep(
        "crop", SquareCropAroundBBox(), input_dirs=[root / "imgs",
                                                    root / "labels"],
        output_dirs=[clean / "imgs", clean / "labels"], pairing_method="zip",
        seed=4, device="cpu").run(progress=False)
    for sub in ("imgs", "labels"):
        got = {p.name: p.read_bytes()
               for p in sorted((root / "out" / sub).iterdir())}
        want = {p.name: p.read_bytes() for p in sorted((clean / sub).iterdir())}
        assert len(want) == N_ITEMS and got == want, sub

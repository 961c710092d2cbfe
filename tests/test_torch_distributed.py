"""The port's multi-process data parallelism on the CPU
(``parallel/distributed.py``, ``ProcessingStep(host_sharded=True)`` and the
CLI's ``--coordinator``): the counterpart of
tests/test_distributed_multiprocess.py.  Two OS processes join a gloo
process group over TCP on localhost, run one host-sharded batched step
over a shared dataset, sum a counter over the processes and write
per-process JSON reports, which merge into one reference-schema report
covering every item exactly once.  The union of the two processes' files
equals a one-process run's, byte for byte."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from image_processor_pipeline_tpu_torch import ProcessingStep
from image_processor_pipeline_tpu_torch.parallel import distributed
from image_processor_pipeline_tpu_torch.parallel.distributed import (
    merge_host_reports)
from image_processor_pipeline_tpu_torch.transforms import (
    SquareCropAroundBBox, change_label_class)
from torch_port_data import make_dataset

REPO = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_distributed_worker.py"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def dataset(tmp_path):
    make_dataset(tmp_path, 6, seed=23)
    return tmp_path


def run_processes(commands):
    """Start every command, wait for all (killing the rest when one takes
    too long) and return their outputs."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(c, cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in commands]
    try:
        outs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"process failed:\n{out}"
    return outs


def files(directory):
    return {p.name: p.read_bytes() for p in sorted(Path(directory).iterdir())}


def one_process_run(dataset, root):
    step = ProcessingStep(
        "crop", SquareCropAroundBBox(),
        input_dirs=[dataset / "imgs", dataset / "labels"],
        output_dirs=[root / "i", root / "l"], pairing_method="zip",
        seed=11, save_log=True, device="cpu")
    assert step.run(progress=False)["Success"] == 6
    return root


def check_host_reports(report_dir):
    r0 = json.loads((report_dir / "crop.host0.json").read_text())
    r1 = json.loads((report_dir / "crop.host1.json").read_text())
    assert len(r0) == 3 and len(r1) == 3
    in0 = {e["inputs"][0] for e in r0}
    in1 = {e["inputs"][0] for e in r1}
    assert not (in0 & in1)
    return in0 | in1


def test_two_process_host_sharded_run(dataset, tmp_path):
    coordinator = f"127.0.0.1:{_free_port()}"
    outs = run_processes([
        [sys.executable, str(WORKER), coordinator, "2", str(pid),
         str(dataset)] for pid in range(2)])
    assert all("global=6" in o for o in outs), outs

    report_dir = dataset / "out"
    inputs = check_host_reports(report_dir)
    merged_path = merge_host_reports("crop", report_dir, n_hosts=2)
    assert merged_path == report_dir / "crop.json"
    merged = json.loads(merged_path.read_text())
    assert len(merged) == 6
    assert {e["status"] for e in merged} == {"Success"}
    assert sorted(e["inputs"][0] for e in merged) == sorted(inputs)
    assert all(set(e) == {"inputs", "outputs", "status", "error_message"}
               for e in merged)
    for e in merged:
        for o in e["outputs"]:
            assert Path(o).is_file(), o

    # the union of both processes' files is the one-process run's
    single = one_process_run(dataset, tmp_path / "single")
    assert files(report_dir / "i") == files(single / "i")
    assert files(report_dir / "l") == files(single / "l")


def test_merge_requires_all_hosts(tmp_path):
    (tmp_path / "s.host0.json").write_text("[]")
    with pytest.raises(FileNotFoundError):
        merge_host_reports("s", tmp_path, n_hosts=2)
    with pytest.raises(FileNotFoundError):
        merge_host_reports("t", tmp_path)


def test_merge_interleaves_the_hosts(tmp_path):
    (tmp_path / "s.host0.json").write_text(json.dumps([{"i": 0}, {"i": 2}]))
    (tmp_path / "s.host1.json").write_text(json.dumps([{"i": 1}]))
    (tmp_path / "s.host10.json.tmp").write_text("not a report")
    out = merge_host_reports("s", tmp_path, n_hosts=2, delete_shards=True)
    assert json.loads(out.read_text()) == [{"i": 0}, {"i": 1}, {"i": 2}]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "s.host10.json.tmp", "s.json"]


def test_host_sharded_requires_seed_in_multiprocess(monkeypatch, tmp_path):
    """Without a seed, RNG-consuming pairings would shard inconsistent
    orders across processes — the step must refuse to run."""
    (tmp_path / "in").mkdir()
    (tmp_path / "in" / "a.txt").write_text("0 0.5 0.5 0.2 0.2\n")
    step = ProcessingStep(
        "s", change_label_class, input_dirs=[tmp_path / "in"],
        output_dirs=[tmp_path / "out"], pairing_method="one_input",
        host_sharded=True, options={"cls_mapping": {}})
    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    monkeypatch.setattr(distributed, "process_index", lambda: 0)
    with pytest.raises(ValueError, match="seed"):
        step.run(progress=False)


def test_host_sharded_keeps_every_nth_item_and_its_seed(monkeypatch,
                                                        dataset, tmp_path):
    """Process p of n keeps items p, p+n, ... with the seeds of their
    original indices, and reports to <name>.host<p>.json."""
    runs = {}
    for pid in range(3):
        monkeypatch.setattr(distributed, "process_count", lambda: 3)
        monkeypatch.setattr(distributed, "process_index", lambda p=pid: p)
        step = ProcessingStep(
            "crop", SquareCropAroundBBox(),
            input_dirs=[dataset / "imgs", dataset / "labels"],
            output_dirs=[tmp_path / "h" / "i", tmp_path / "h" / "l"],
            pairing_method="zip", seed=11, save_log=True, host_sharded=True,
            device="cpu")
        assert step.run(progress=False)["Success"] == 2
        runs[pid] = sorted(Path(e["inputs"][0]).name
                           for e in step.process_logs)
        assert (tmp_path / "h" / f"crop.host{pid}.json").is_file()
    assert runs == {p: [f"im_{i:03d}.png" for i in (p, p + 3)]
                    for p in range(3)}
    assert not (tmp_path / "h" / "crop.json").exists()
    single = one_process_run(dataset, tmp_path / "single")
    assert files(tmp_path / "h" / "i") == files(single / "i")


def test_initialize_distributed_for_one_process_does_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("init_process_group called")

    monkeypatch.setattr(torch.distributed, "init_process_group", refuse)
    distributed.initialize_distributed()
    distributed.initialize_distributed("127.0.0.1:1", 1, 0)
    assert not distributed.is_initialized()
    assert (distributed.process_index(), distributed.process_count()) == (0, 1)
    with pytest.raises(ValueError, match="process_id"):
        distributed.initialize_distributed("127.0.0.1:1", 2, None)


def test_cli_two_process_run(dataset):
    """The CLI's --coordinator/--num-processes/--process-id flags drive a
    real two-process gloo run of a host_sharded config: both processes
    exit 0 (--strict), the per-process reports shard the items
    disjointly, the union of the files covers the dataset, and rank 0
    merged the reports."""
    cfg = {
        "root_dir": str(dataset),
        "steps": [{
            "name": "crop",
            "transform": "square_crop_around_bbox",
            "input_dirs": ["imgs", "labels"],
            "output_dirs": ["out/imgs", "out/labels"],
            "pairing_method": "zip",
            "seed": 3,
            "save_log": True,
            "host_sharded": True,
        }],
    }
    cfg_path = dataset / "pipe.json"
    cfg_path.write_text(json.dumps(cfg))
    coordinator = f"127.0.0.1:{_free_port()}"
    outs = run_processes([
        [sys.executable, "-m", "image_processor_pipeline_tpu_torch", "run",
         str(cfg_path), "--no-progress", "--strict", "--device", "cpu",
         "--coordinator", coordinator, "--num-processes", "2",
         "--process-id", str(pid)] for pid in range(2)])
    assert "merged report" in outs[0] and "merged report" not in outs[1]
    check_host_reports(dataset / "out")
    assert len(list((dataset / "out" / "imgs").iterdir())) == 6
    merged = json.loads((dataset / "out" / "crop.json").read_text())
    assert len(merged) == 6
    assert {e["status"] for e in merged} == {"Success"}

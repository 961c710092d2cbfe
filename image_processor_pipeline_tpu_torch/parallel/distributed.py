"""Multi-process scaling helpers (port of
image_processor_pipeline_tpu/parallel/distributed.py).

  - ``initialize_distributed``: ``torch.distributed.init_process_group``
    over TCP, the counterpart of ``jax.distributed.initialize``;
  - ``host_shard``: a deterministic per-process split of a file list;
  - ``merge_host_reports``: the per-process JSON reports of a
    ``host_sharded`` step merged into the reference's schema;
  - ``global_counter``: a per-process count summed over the processes.

The process group uses the **gloo** backend.  What crosses processes here
is host integers and barriers, JAX's control plane over the data-centre
network, never device tensors; and NCCL refuses two ranks on one card,
while a machine with one card runs its processes on that card.  Each
process moves its own batches to its own devices (``mesh.py``).
"""

from __future__ import annotations

import json
import re
from datetime import timedelta
from pathlib import Path
from typing import List, Optional, Sequence, Tuple, TypeVar, Union

import torch
import torch.distributed as dist

T = TypeVar("T")

#: how long a collective waits for the other processes
TIMEOUT = timedelta(minutes=10)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def _group() -> Tuple[int, int]:
    """(rank, world size) of the process group, (0, 1) without one."""
    if is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_index() -> int:
    """This process's rank, 0 without a process group."""
    return _group()[0]


def process_count() -> int:
    """The number of processes, 1 without a process group."""
    return _group()[1]


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join the process group at ``coordinator_address`` ("host:port",
    where rank 0 listens) as rank ``process_id`` of ``num_processes``.

    Does nothing when a group is already up or for one process.
    """
    if is_initialized():
        return
    if num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("a run of several processes needs "
                         "coordinator_address and process_id")
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id, timeout=TIMEOUT)


def barrier() -> None:
    """Wait for every process (nothing without a process group)."""
    if is_initialized():
        dist.barrier()


def shutdown() -> None:
    if is_initialized():
        dist.destroy_process_group()


def host_shard(items: Sequence[T],
               process_id: Optional[int] = None,
               process_count: Optional[int] = None) -> List[T]:
    """The contiguous slice of ``items`` this process is responsible for
    (by default this process's rank of the group's size, (0, 1) without
    a group).

    Deterministic given the (sorted) item list, so every process agrees on
    the partition without communication.
    """
    rank, size = _group()
    pid = rank if process_id is None else process_id
    n = size if process_count is None else process_count
    total = len(items)
    base = total // n
    rem = total % n
    start = pid * base + min(pid, rem)
    stop = start + base + (1 if pid < rem else 0)
    return list(items[start:stop])


def merge_host_reports(
    step_name: str,
    report_dir: Union[str, Path],
    n_hosts: Optional[int] = None,
    delete_shards: bool = False,
) -> Path:
    """Merge per-process run reports (<name>.host<pid>.json, written by
    host-sharded steps) into ONE report with the reference's exact schema
    — a bare list of {inputs, outputs, status, error_message} — at the
    reference's path <report_dir>/<name>.json.

    Process p holds items p, p+n, p+2n, ... of the global pairing order
    (ProcessingStep host sharding is modulo over the original index);
    round-robin over the per-process lists approximates that order.  Exact
    order is NOT guaranteed: the batched engine appends entries in
    save-completion order, so the merged report is complete and
    schema-exact but positionally unordered.
    """
    report_dir = Path(report_dir)
    stem = Path(step_name).with_suffix(".json").stem
    pat = re.compile(rf"^{re.escape(stem)}\.host(\d+)\.json$")
    shard_paths = sorted(
        (p for p in report_dir.glob(f"{stem}.host*.json")
         if pat.match(p.name)),
        key=lambda p: int(pat.match(p.name).group(1)),
    )
    if n_hosts is not None and len(shard_paths) != n_hosts:
        raise FileNotFoundError(
            f"expected {n_hosts} host reports for step {step_name!r} in "
            f"{report_dir}, found {len(shard_paths)}: "
            f"{[p.name for p in shard_paths]}"
        )
    if not shard_paths:
        raise FileNotFoundError(
            f"no host reports for step {step_name!r} in {report_dir}"
        )
    shards = [json.loads(p.read_text()) for p in shard_paths]
    merged: List[dict] = []
    for i in range(max(len(s) for s in shards)):
        merged.extend(s[i] for s in shards if i < len(s))
    out = report_dir / f"{stem}.json"
    out.write_text(json.dumps(merged, indent=4, ensure_ascii=False))
    if delete_shards:
        for p in shard_paths:
            p.unlink()
    return out


def global_counter(local_count: int, mesh=None, axis: str = "data") -> int:
    """The sum of ``local_count`` over the processes: an ``all_reduce``
    over the process group, ``local_count`` itself in one process.  A
    process's in-process mesh holds its count once (JAX psums a vector
    with the count on the first device and zeros elsewhere), so ``mesh``
    and ``axis`` change nothing; they keep JAX's signature."""
    if process_count() == 1:
        return int(local_count)
    t = torch.tensor([int(local_count)], dtype=torch.int64)
    dist.all_reduce(t)
    return int(t.item())

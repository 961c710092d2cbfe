"""Device-mesh data parallelism for the batch engine (port of
image_processor_pipeline_tpu/parallel/mesh.py).

The workload is embarrassingly parallel per image: each device augments
its own sub-batch and no tensor crosses devices in the steady state.

  - ``make_mesh``: a grid of torch devices with named axes (``data``,
    ``model``), the counterpart of ``jax.sharding.Mesh``;
  - ``shard_batch``: the counterpart of ``shard_map`` over ``data``: every
    array argument is split on its leading axis and each shard runs on its
    own device;
  - ``sharded_augment_step``: the flagship chain as one multi-device step,
    with the count of items whose alpha is non-zero summed over the shards
    (JAX's ``psum``).

Each shard's work is issued under its device's context, so it queues on
that device's current stream and the launch returns at once: shards on
different cards run at the same time.  Entries of a mesh that repeat one
device queue on that device's stream one after the other.  A mesh may
repeat a device: ``make_mesh(devices=[torch.device("cpu")] * 4)`` is the
four-wide mesh of CPU handles the tests use, as the JAX package's tests
use eight virtual CPU devices, and ``[cuda:0, cuda:0]`` splits a batch in
two on one card.

The ``model`` axis is accepted and changes no value.  In JAX it only
constrains the layout of the chain's rows (its mesh.py:94-97); here a
data shard runs whole on the first device of its ``model`` row.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import numpy as np
import torch

from image_processor_pipeline_tpu_torch.models.chains import (
    CROP, MODES, augment_chain)


class Mesh:
    """Devices on a grid with named axes: ``devices`` is an ndarray of
    ``torch.device`` of shape ``tuple(shape.values())``; ``shape`` maps
    each axis name to its size, as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, devices, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device grid for axes "
                             f"{axis_names}")
        types = {d.type for d in devices.flat}
        if len(types) != 1:
            raise ValueError(f"a mesh holds devices of one type, not "
                             f"{sorted(types)}")
        self.devices = devices
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, devices.shape))

    @property
    def device_type(self) -> str:
        return self.devices.flat[0].type

    def data_devices(self, axis: str = "data"):
        """The device of each shard of ``axis``: the first device of each
        row along the other axes."""
        k = self.axis_names.index(axis)
        rows = np.moveaxis(self.devices, k, 0).reshape(self.shape[axis], -1)
        return [row[0] for row in rows]

    def _key(self):
        return (self.axis_names, tuple(str(d) for d in self.devices.flat),
                self.devices.shape)

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return (f"Mesh({self.shape}, "
                f"{[str(d) for d in self.devices.flat]})")


def local_devices():
    """The cards of this process: cuda:0 .. cuda:device_count()-1."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    n_devices: Optional[int] = None,
    shape: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = ("data", "model"),
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a mesh over the first ``n_devices`` devices of the pool.

    The pool is this process's cards, or ``devices`` (torch devices or
    their names; a device may repeat, see the module's docstring).  The
    default shape puts everything on ``data`` with a trivial ``model``
    axis.  Asking for more devices than the pool holds raises instead of
    silently truncating, and so does a ``shape`` whose product is not the
    device count.
    """
    pool = ([torch.device(d) for d in devices] if devices is not None
            else local_devices())
    if not pool:
        raise RuntimeError(
            "torch.cuda.device_count() is 0: pass devices= to build a mesh "
            "on the host, e.g. [torch.device('cpu')] * 4")
    if n_devices is not None and n_devices > len(pool):
        raise ValueError(
            f"requested {n_devices} devices but only {len(pool)} available")
    pool = pool[: n_devices or len(pool)]
    n = len(pool)
    if shape is None:
        shape = (n, 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {tuple(shape)} != device count {n}")
    grid = np.empty(n, dtype=object)
    grid[:] = pool
    return Mesh(grid.reshape(tuple(shape)), axis_names)


def device_scope(device):
    """Make ``device`` the current CUDA device for the block (its current
    stream takes the block's launches); nothing for the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def shard_ranges(batch: int, mesh: Mesh, axis: str = "data"):
    """[(lo, hi, device)]: the rows of a batch of ``batch`` that each
    shard of ``axis`` takes.  The batch must split evenly."""
    devices = mesh.data_devices(axis)
    n = len(devices)
    if batch % n:
        raise ValueError(f"batch of {batch} does not split over the "
                         f"{n} shards of the mesh's {axis!r} axis")
    step = batch // n
    return [(i * step, (i + 1) * step, d) for i, d in enumerate(devices)]


def _gather(parts, device):
    """Concatenate the shards' outputs on ``device``: tensors along their
    leading axis, numpy arrays on the host; tuples, lists and dicts by
    element."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([p.to(device) for p in parts])
    if isinstance(first, np.ndarray):
        return np.concatenate(parts)
    if isinstance(first, dict):
        return {k: _gather([p[k] for p in parts], device) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_gather(list(p), device) for p in zip(*parts))
    raise TypeError(f"cannot gather shard outputs of type "
                    f"{type(first).__name__}")


def shard_batch(fn, mesh: Mesh, axis: str = "data"):
    """``fn`` over the batch axis split across ``axis``.

    Every tensor and numpy argument is split on its leading axis: a
    tensor shard goes to its shard's device, a numpy shard stays on the
    host (where the port makes its draws); other arguments pass whole.
    ``fn`` runs once a shard under that shard's device, and the outputs
    (tensors, numpy arrays and tuples, lists or dicts of them) are
    concatenated on the mesh's first device.
    """
    def sharded(*args):
        sizes = {len(a) for a in args
                 if isinstance(a, (torch.Tensor, np.ndarray))}
        if len(sizes) != 1:
            raise ValueError(f"array arguments must share one leading "
                             f"size, got {sorted(sizes)}")
        parts = []
        for lo, hi, dev in shard_ranges(sizes.pop(), mesh, axis):
            shard = [a[lo:hi].to(dev) if isinstance(a, torch.Tensor)
                     else a[lo:hi] if isinstance(a, np.ndarray) else a
                     for a in args]
            with device_scope(dev):
                parts.append(fn(*shard))
        return _gather(parts, mesh.data_devices(axis)[0])

    return sharded


def default_rotation(device_type: str) -> str:
    """The chain mode that stands for JAX's XLA 'shear' mode
    (models/chains.py:124-125 there) on a device type: 'cuda_shear' (the
    rotation kernel and the torch finish) on a card, 'shear' on the CPU."""
    return "cuda_shear" if device_type == "cuda" else "shear"


def sharded_augment_step(mesh: Mesh, crop: int = CROP,
                         rotation: Optional[str] = None):
    """The flagship chain as one multi-device step.

    Returns ``step(images, xywhn, seeds) -> (out, count)``: images [B, H,
    W, 3|4] uint8 (a tensor anywhere, or numpy), xywhn [B, 4] and seeds
    [B] on the host; ``out`` [B, crop, crop, 4] uint8 on the mesh's first
    device and ``count``, a 0-d int64 tensor there: the items whose alpha
    is non-zero somewhere, summed over the shards.  ``rotation=None``
    takes ``default_rotation`` of the mesh's device type (an explicit
    choice by device, not a fallback); any mode of ``models.chains.MODES``
    may be named, e.g. 'cuda_full' for the whole-chain kernel.
    """
    rotation = rotation or default_rotation(mesh.device_type)
    if rotation not in MODES:
        raise ValueError(f"unknown rotation mode {rotation!r}; choose from "
                         f"{MODES}")

    def one(images, xywhn, seeds):
        out = augment_chain(images, xywhn, seeds, crop, rotation)
        count = (out[..., 3] > 0).flatten(1).any(1).sum().reshape(1)
        return out, count

    sharded = shard_batch(one, mesh)

    def step(images, xywhn, seeds):
        images = torch.as_tensor(images)
        out, counts = sharded(images, _host(xywhn), _host(seeds))
        return out, counts.sum()

    return step


def _host(a) -> np.ndarray:
    return np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)

"""BatchTransform: the device-transform protocol the stage engine drives
(port of image_processor_pipeline_tpu/transforms/base.py:25-226).

A BatchTransform splits the reference's per-file monolith
(load → compute → save, e.g. crop_square.py:104-224) into three phases:

  load_item   host: decode inputs → numpy arrays + metadata (per item)
  device_fn   device: plain functions on one stacked batch of tensors
  save_item   host: encode/save one item's slice of the batch output

The engine (pipeline.ProcessingStep._run_batched) buckets items by
``bucket_key`` (canvas shape and anything else that changes array shapes),
stacks each bucket, and calls ``launch_batch`` with the step's device.
Per-item RNG seeds are engine-provided so results don't depend on batch
composition; the draws themselves are made on the host (``random``), so
``device_fn`` gets ``batch["seed"]`` as a numpy array and every other
field as a tensor on the device.

On a CUDA device a batch is stacked into pinned host memory and copied to
the card without blocking, its outputs are copied back into pinned memory
behind a CUDA event, and ``materialize_batch`` (typically called from a
saver thread) waits on that event alone, never on the whole device.  A
transform that shrinks its output on the device first (``shrinks_output``,
the coefficient transport of ops/jpeg.py) starts that copy from its
``shrink_output`` hook instead, in the saver thread.

With a mesh (``parallel/mesh.py``) ``launch_batch`` splits the stacked
batch over the mesh's ``data`` axis and runs ``device_fn`` on each shard
on that shard's device, the counterpart of the JAX class's
``_jitted_sharded``.  It returns the batch's shards, ``(lo, hi, device,
outputs)`` each; the engine gives each shard its own pinned copy and
event, and shrinks, fetches and saves a batch shard by shard (a batch
with no mesh is one shard).  The JAX class's ``native_fn``
/ ``launch_batch_native`` are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from image_processor_pipeline_tpu_torch import random as jrandom

#: key under which start_host_copy stashes a batch's host copies
_HOST_COPY = "_host_copy"


def host_zeros(shape, device, dtype=np.uint8) -> np.ndarray:
    """A zeroed numpy array for a batch bound for ``device``: backed by
    pinned host memory when that is a CUDA card, so that the copy to the
    card does not block.  The array keeps its memory alive."""
    shape, dtype = tuple(shape), np.dtype(dtype)
    if torch.device(device).type != "cuda":
        return np.zeros(shape, dtype)
    nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    raw = torch.zeros(nbytes, dtype=torch.uint8, pin_memory=True)
    return raw.numpy().view(dtype).reshape(shape)


def to_device(array, device) -> torch.Tensor:
    """``array`` (numpy or a tensor) as a tensor on ``device``.  For a
    CUDA card a pageable array is first staged in pinned memory and the
    copy is asynchronous: a pageable copy would synchronise the stream."""
    t = array if isinstance(array, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(array))
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    if t.device.type == "cuda":
        # a tensor already on a card (a batch the hybrid decode made
        # there) stays where it is or goes card to card
        return t.to(device, non_blocking=True)
    if not t.is_pinned():
        pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        pinned.copy_(t)
        t = pinned
    return t.to(device, non_blocking=True)


def host_arrays(out_dev: Dict) -> Dict[str, np.ndarray]:
    """The tensors of a dispatched batch's outputs as numpy arrays on the
    host: starts their copies if ``start_host_copy`` has not, then waits on
    the batch's own copy event."""
    BatchTransform.start_host_copy(out_dev)
    host, events = out_dev[_HOST_COPY]
    for event in events:
        event.synchronize()
    return {k: v.numpy() for k, v in host.items()}


class BatchTransform:
    """Subclass and implement load_item / stack_batch / device_fn / save_item."""

    max_batch: int = 64

    #: transforms whose save_item reads ``item["image"]`` (the decoded
    #: input) must set this so the engine keeps decoding on the host —
    #: the hybrid device-decode path never materializes per-item pixels
    save_needs_image = False

    def needs_host_image(self, chunk, options, device) -> bool:
        """Per-bucket refinement of ``save_needs_image``: the engine asks
        this before enabling the hybrid device decode for a chunk bound
        for ``device``.  A transform whose save path can source the input
        from the device for some buckets (symmetry's 'o' copy through the
        coefficient transport on all-.jpg buckets) overrides this to
        return False there."""
        return self.save_needs_image

    # -- host: per-item decode -------------------------------------------
    def load_item(self, inputs: Tuple, options: Dict) -> Dict[str, Any]:
        raise NotImplementedError

    def probe_item(self, inputs: Tuple, options: Dict) -> Optional[Dict[str, Any]]:
        """Optional metadata-only load (header probe, labels — no pixel
        decode).  A probed item must contain everything load_item produces
        EXCEPT ``image``, plus ``_decode = (path, mode, diag)``; the engine
        then decodes whole buckets into one stacked array
        (io/images.py:fill_pending_images) instead of per-item decodes.

        Transforms with SEVERAL pixel fields per item (e.g. overlay +
        background) instead set ``_pending = {field: (path, mode, diag,
        canvas, h, w)}`` and omit those fields
        (io/images.py:_fill_pending_multi).

        Return None to fall back to load_item (default).
        """
        return None

    # -- bucketing --------------------------------------------------------
    def bucket_key(self, item: Dict, options: Dict) -> Tuple:
        """Hashable key; items with equal keys may share one device call."""
        return item["canvas"]

    # -- device -----------------------------------------------------------
    def stack_batch(self, chunk: List[Dict], options: Dict,
                    device) -> Dict[str, np.ndarray]:
        """Stack per-item arrays into batch arrays (default: every ndarray
        field not starting with '_' is stacked), into pinned host memory
        when ``device`` is a CUDA card.

        When the batch decoder already produced the whole chunk in one
        stacked array (io/images.py:fill_pending_images fast path, exposed
        as ``chunk[0]['_prestacked_image']``), the image field is passed
        through without the np.stack copy; after the hybrid device decode
        that is a tensor already on ``device``, never copied back.
        """
        out = {}
        pre = chunk[0].get("_prestacked_image")
        if pre is not None and len(pre) == len(chunk):
            out["image"] = pre
        for k, v in chunk[0].items():
            if k.startswith("_") or k == "canvas" or k in out:
                continue
            if isinstance(v, (np.ndarray, np.generic, int, float, bool)):
                first = np.asarray(v)
                dst = host_zeros((len(chunk),) + first.shape, device,
                                 first.dtype)
                np.stack([np.asarray(it[k]) for it in chunk], axis=0, out=dst)
                out[k] = dst
        out["seed"] = np.asarray([it["_seed"] for it in chunk], np.uint32)
        return out

    #: stacked fields that stay on the host as numpy arrays (they feed the
    #: host's draws); every other field goes to the step's device
    host_fields: Tuple[str, ...] = ("seed",)

    def device_fn(self, batch: Dict[str, Any], static: Tuple) -> Dict[str, torch.Tensor]:
        """The step's computation on one batch: the ``host_fields``
        (``batch["seed"]``, uint32 [B]) are numpy arrays on the host,
        every other field a tensor on the step's device.  Returns a dict of tensors with a leading batch
        axis, on the device or (for per-item scalars computed with the
        draws) on the host."""
        raise NotImplementedError

    def static_args(self, options: Dict, key: Tuple) -> Tuple:
        """Hashable static configuration passed to device_fn."""
        return ()

    # -- host: per-item save ----------------------------------------------
    def save_item(
        self,
        out: Dict[str, np.ndarray],
        item: Dict,
        output_dirs: Sequence,
        options: Dict,
    ) -> Optional[List]:
        raise NotImplementedError

    # -- engine glue --------------------------------------------------------
    def launch_batch(self, key: Tuple, chunk: List[Dict], options: Dict,
                     device, mesh=None):
        """Stack + dispatch one batch to ``device`` WITHOUT blocking.
        ``device`` is required: the caller names the card or asks for the
        CPU, nothing is chosen for it.

        Returns the output dict of tensors; materialize with
        ``materialize_batch`` (typically from a saver thread) so encode of
        batch N overlaps device compute of batch N+1.  With ``mesh`` the
        batch is split over its ``data`` axis (the engine pads the chunk
        to a multiple of the axis) and the list of its shards comes back
        (``dispatch``).
        """
        arrays = self.stack_batch(chunk, options, device)
        static = self.static_args(options, key)
        return self.dispatch(
            arrays, lambda batch: self.device_fn(batch, static), device,
            mesh)

    def dispatch(self, arrays: Dict, fn, device, mesh=None):
        """``fn`` of the stacked ``arrays`` moved to ``device`` (the
        ``host_fields`` stay numpy on the host).  With ``mesh``, the list
        of the batch's shards, ``(lo, hi, device, outputs)`` for each
        shard of the ``data`` axis in order: ``fn`` of rows [lo, hi) on
        that shard's device."""
        from image_processor_pipeline_tpu_torch.parallel.mesh import (
            device_scope, shard_ranges)

        batch = len(arrays["seed"])
        if mesh is None:
            parts = [(0, batch, device, arrays)]
        else:
            parts = [(lo, hi, dev, {k: v[lo:hi] for k, v in arrays.items()})
                     for lo, hi, dev in shard_ranges(batch, mesh)]
        shards = []
        for lo, hi, dev, rows in parts:
            with device_scope(dev):
                shards.append((lo, hi, dev, fn(
                    {k: v if k in self.host_fields else to_device(v, dev)
                     for k, v in rows.items()})))
        return shards if mesh is not None else shards[0][3]

    #: transforms that override shrink_output set this so the engine defers
    #: the device→host copy to the saver thread (the shrink must run first)
    shrinks_output = False

    def shrink_output(self, out_dev: Dict, chunk: List[Dict],
                      options: Dict) -> Dict:
        """Optional device-side output shrink before the device→host copy
        (runs in the saver thread, where waiting on this batch is free —
        the next batch is already queued).  Default: pass through."""
        return out_dev

    @staticmethod
    def start_host_copy(out_dev: Dict) -> None:
        """Kick off the device→host copies of a dispatched batch, so they
        overlap the next batch's compute: each CUDA tensor (keys starting
        with '_' excepted) is copied into pinned host memory of its own
        without blocking, and a CUDA event is recorded behind the copies.
        The host tensors and the event are stashed in ``out_dev`` for
        ``materialize_batch``.  Host tensors need no copy.  The engine
        calls it once for each shard of a batch launched over a mesh."""
        if _HOST_COPY in out_dev:
            return
        host, cards = {}, set()
        for k, v in out_dev.items():
            if str(k).startswith("_") or not isinstance(v, torch.Tensor):
                continue
            if v.device.type == "cuda":
                dst = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                dst.copy_(v, non_blocking=True)
                host[k] = dst
                cards.add(v.device)
            else:
                host[k] = v
        # one event on each card's current stream, behind its copies
        events = []
        for card in cards:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(card))
            events.append(event)
        out_dev[_HOST_COPY] = (host, events)

    @staticmethod
    def materialize_batch(out_dev: Dict, n: int) -> List[Dict]:
        """The first ``n`` items of a batch's outputs as dicts of numpy
        arrays; waits on the batch's own copy event."""
        out_np = host_arrays(out_dev)
        return [{k: v[i] for k, v in out_np.items()} for i in range(n)]

    # helper for subclasses
    @staticmethod
    def keys_from_seeds(seeds) -> np.ndarray:
        """Per-item PRNG keys [B, 2] uint32 of uint32 seeds [B]."""
        return jrandom.PRNGKey(np.asarray(seeds).astype(np.uint32))

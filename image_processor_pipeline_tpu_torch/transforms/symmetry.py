"""Dihedral symmetries — batched device transform (port of the pixel path
of image_processor_pipeline_tpu/transforms/symmetry.py).

Behavior parity with reference symmetry.py:11-149 (generate_symmetries):
  - generators o/h/v/hv = identity / cv2.flip(1) / flip(0) / flip(-1)
    (symmetry.py:114-119)
  - extension validated against YOLO IMG_FORMATS (symmetry.py:92-94)
  - ``choose_random`` unique symmetries sampled from ``pool`` (default all
    four); ``include_original`` force-appends 'o' (symmetry.py:122-126)
  - naming ``{stem}_{sym}{input suffix}`` into output_dirs[0]
    (symmetry.py:133-134)
  - the reference's choose_random > len(pool) crash is fixed: warn and
    clamp.

The flips present in the step's pool are computed in one batched device
call (a flip is bandwidth-trivial); the host saves only the per-item
sampled subset, keeping per-item randomness independent of batch
composition.  Flips outside the pool are never computed.  On all-.jpg
buckets with the coefficient transport on, the run is codec to codec:
sparse coefficients in (hybrid device decode), flips and the JPEG front
half on the device, sparse coefficients out — the 'o' copy included, so
pixels never reach the host.  The JAX class's native flip views are not
ported yet.
"""

from __future__ import annotations

import random
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple
from warnings import warn

import numpy as np
import torch

from image_processor_pipeline_tpu_torch.transforms.base import (
    BatchTransform,
    host_arrays,
    to_device,
)
from image_processor_pipeline_tpu_torch.io import native as io_native
from image_processor_pipeline_tpu_torch.ops import geometry
from image_processor_pipeline_tpu_torch.ops import jpeg as djpeg
from image_processor_pipeline_tpu_torch.io.images import (
    decode_image,
    encode_image,
    probe_bands,
)
from image_processor_pipeline_tpu_torch.io.batching import canvas_for, pad_to_canvas
from image_processor_pipeline_tpu_torch.utils.utils import IMG_FORMATS

ALL_SYMS = ("o", "h", "v", "hv")


_FLIP_FNS = {
    "h": geometry.flip_h,
    "v": geometry.flip_v,
    "hv": geometry.flip_hv,
}


def _syms(img, h, w, which=("h", "v", "hv")):
    """The flips ``which`` of a batch: img [B, H, W, C], h, w [B]."""
    return {s: _FLIP_FNS[s](img, h, w) for s in which}


class GenerateSymmetries(BatchTransform):
    max_batch = 32

    def static_args(self, options: Dict, key: Tuple) -> Tuple:
        # only the flips the step's pool can ever select are computed
        pool = options.get("pool") or ALL_SYMS
        return tuple(s for s in ("h", "v", "hv") if s in set(pool))

    @staticmethod
    def _check_format(path: Path) -> None:
        if path.suffix.lower()[1:] not in IMG_FORMATS:
            raise ValueError(
                f"{path.name} is not an accepted YOLO image format"
            )

    def load_item(self, inputs: Tuple, options: Dict) -> Dict[str, Any]:
        path = Path(inputs[0])
        self._check_format(path)
        arr = decode_image(path)  # native bands (IMREAD_UNCHANGED parity)
        h, w = arr.shape[:2]
        canvas = canvas_for(h, w)
        return {
            "canvas": canvas,
            "image": pad_to_canvas(arr, canvas),
            "size": np.asarray([h, w], np.int32),
            "_orig": arr,
        }

    def probe_item(self, inputs: Tuple, options: Dict):
        """Metadata-only load so whole buckets decode into one stacked
        array.  Only band-safe files take this path (3-component JPEG,
        8-bit RGB/RGBA PNG); gray, palette, 16-bit and tRNS inputs return
        None and keep the exact per-item path."""
        path = Path(inputs[0])
        self._check_format(path)
        meta = probe_bands(path)
        if meta is None or meta[2] not in (3, 4):
            return None
        h, w, kind = meta
        canvas = canvas_for(h, w)
        return {
            "canvas": canvas,
            "size": np.asarray([h, w], np.int32),
            "_nch": kind,
            "_decode": (str(path), "RGB" if kind == 3 else "RGBA", False),
        }

    # save_item reads the decoded input (the 'o' symmetry writes the
    # original pixels), so the hybrid device decode stays off — EXCEPT on
    # all-.jpg buckets with the coefficient transport on, where the 'o'
    # copy is device-encoded too (needs_host_image below) and the run
    # becomes fully codec-to-codec.
    save_needs_image = True

    def needs_host_image(self, chunk, options, device) -> bool:
        if not io_native.available():
            return True
        if not djpeg.device_encode_enabled(options, self, device):
            return True
        # a cap that encode_shrink must decline (>= 1/3 the pixel bytes)
        # means the transport this skip is betting on can never run —
        # keep the host decode rather than fetch full canvases back later
        if not djpeg.transport_cap_viable(
                options.get("device_encode_cap", 0.25)):
            return True
        return not all(
            Path(it["_decode"][0]).suffix.lower() in (".jpg", ".jpeg")
            for it in chunk if "_decode" in it)

    def bucket_key(self, item: Dict, options: Dict) -> Tuple:
        nch = item["image"].shape[-1] if "image" in item else item["_nch"]
        return (*item["canvas"], nch)

    def device_fn(self, batch, static):
        return _syms(batch["image"], batch["size"][:, 0],
                     batch["size"][:, 1], static)

    def launch_batch(self, key, chunk, options, device):
        """Base dispatch, plus a zero-copy reference to the INPUT batch on
        the device so the shrink hook can device-encode the 'o' copy (and
        source the pixel fallback) when the host kept no image — the
        fully codec-to-codec path."""
        arrays = self.stack_batch(chunk, options, device)
        static = self.static_args(options, key)
        batch = {k: v if k in self.host_fields else to_device(v, device)
                 for k, v in arrays.items()}
        out = dict(self.device_fn(batch, static))
        out["_input_dev"] = batch["image"]
        return out

    # -- hybrid device JPEG encode (D2H ships coefficients, not pixels) ----
    # Symmetries write up to 4 full canvases per input at the
    # cv2-anchored q95.  On .jpg runs the JPEG front half runs on the
    # device for every computed flip and the 'o' copy (ops/jpeg.py:
    # encode_shrink) and only sparse quantized coefficients come back.
    # Byte-identical to the pixel path.
    shrinks_output = True

    def shrink_output(self, out_dev, chunk, options):
        inp = out_dev.pop("_input_dev", None)
        # did the engine skip the host decode for this chunk (device
        # decode fed the batch)?  Then the input pixels exist ONLY on the
        # device and the save path must be fed from there.
        host_missing = any(
            "image" not in it and "_orig" not in it and
            "_load_error" not in it for it in chunk)
        if inp is not None and chunk and all(
                Path(it["_args"][0]).suffix.lower() in (".jpg", ".jpeg")
                for it in chunk) and djpeg.device_encode_enabled(
                    options, self, inp.device):
            out = self._shrink_encode(
                out_dev, inp, chunk, options,
                n_valid=len({id(it) for it in chunk}),
                host_missing=host_missing)
            if out is not None:
                return out
        if host_missing and inp is not None:
            # transport declined but the host never decoded: fetch the
            # input canvases so save_item's 'o' has a pixel source —
            # correctness over bytes saved.  Non-underscore key: this copy
            # is real D2H and is metered.
            out_dev = dict(out_dev, input_pixels=inp)
        self.start_host_copy(out_dev)
        return out_dev

    def _shrink_encode(self, out_dev, inp, chunk, options, n_valid,
                       host_missing=False):
        if not io_native.available():
            return None
        sizes = np.stack([np.asarray(it["size"]) for it in chunk])
        h_np = sizes[:, 0].astype(np.int32)
        w_np = sizes[:, 1].astype(np.int32)
        planes = dict(out_dev)
        pool = set(options.get("pool") or ALL_SYMS)
        if options.get("include_original", True) or "o" in pool:
            # the 'o' copy is a re-encode of the input (reference
            # symmetry.py saves it via cv2.imwrite like the flips) — on
            # the device it's just one more FDCT plane.  Skipped when
            # neither include_original nor the pool can ever select 'o'.
            planes["o"] = inp
        if not planes:
            return None
        # STACKED encode across planes (flips preserve (h, w), so planes
        # tile the same h/w vectors), at most 64 stacked rows a call
        keys = tuple(planes)
        P, B = len(keys), len(h_np)
        gsz = max(1, 64 // B)
        out = {"jpeg_syms": keys}
        n_of = 0
        for g0 in range(0, P, gsz):
            gkeys = keys[g0:g0 + gsz]
            stacked = (torch.cat([planes[s] for s in gkeys], dim=0)
                       if len(gkeys) > 1 else planes[gkeys[0]])
            h_rep = np.tile(h_np, len(gkeys))
            w_rep = np.tile(w_np, len(gkeys))
            res = djpeg.encode_shrink(
                stacked, to_device(h_rep, inp.device),
                to_device(w_rep, inp.device), h_rep, w_rep, 95,
                cap_frac=float(options.get("device_encode_cap", 0.25)))
            if res is None:
                # decline is deterministic in (cap, canvas): no group can
                # succeed if one declines.  When the engine skipped the
                # host decode betting on the transport, count the
                # forfeited plane rows so a run of declines trips the
                # sticky gate and the host decode resumes
                if host_missing:
                    djpeg.note_declines(self, n_valid * P)
                return None
            idx, val, nnz_np, meta, pixels = res
            out["jpeg_meta"] = meta  # same (hm16, wm16, q) every group
            for k, s in enumerate(gkeys):
                lo = k * B
                out[f"jpeg_idx_{s}"] = idx[lo:lo + B]
                out[f"jpeg_val_{s}"] = val[lo:lo + B]
                out[f"jpeg_nnz_{s}"] = nnz_np[lo:lo + B]
                out[f"jpeg_pixels_{s}"] = {
                    i - lo: px for i, px in pixels.items()
                    if lo <= i < lo + B}
                n_of += sum(1 for i in pixels
                            if lo <= i < lo + B and i - lo < n_valid)
        djpeg.note_overflows(self, n_of, n_valid * P)
        self.start_host_copy(out)
        return out

    def materialize_batch(self, out_dev, n: int):
        if "jpeg_syms" not in out_dev:
            return BatchTransform.materialize_batch(out_dev, n)
        syms = out_dev["jpeg_syms"]
        fetch = host_arrays(out_dev)
        items = []
        for i in range(n):
            it = {"jpeg_syms": syms, "jpeg_meta": out_dev["jpeg_meta"]}
            for s in syms:
                px = out_dev[f"jpeg_pixels_{s}"]
                if i in px:
                    it[s] = px[i]  # overflow: ordinary pixel save path
                else:
                    it[f"jpeg_idx_{s}"] = fetch[f"jpeg_idx_{s}"][i]
                    it[f"jpeg_val_{s}"] = fetch[f"jpeg_val_{s}"][i]
                    it[f"jpeg_nnz_{s}"] = out_dev[f"jpeg_nnz_{s}"][i]
            items.append(it)
        return items

    def save_item(
        self,
        out: Dict[str, np.ndarray],
        item: Dict,
        output_dirs: Sequence[Path],
        options: Dict,
    ) -> Optional[List[Path]]:
        if not output_dirs:
            raise ValueError("no output dir provided")
        target = Path(output_dirs[0])
        path = Path(item["_args"][0])
        h, w = (int(x) for x in item["size"])

        pool = list(options.get("pool") or ALL_SYMS)
        invalid = [s for s in pool if s not in ALL_SYMS]
        if invalid:
            raise ValueError(f"pool contains invalid symmetries: {invalid}")
        choose_random = options.get("choose_random")
        choose_random = len(pool) if choose_random is None else choose_random
        if choose_random > len(pool):
            warn(
                f"choose_random={choose_random} exceeds pool size "
                f"{len(pool)}; clamping"
            )
            choose_random = len(pool)
        elif choose_random < 0:
            raise ValueError(f"choose_random ({choose_random}) must be >= 0")

        rng = random.Random(item["_seed"])
        selected = rng.sample(pool, choose_random)
        if options.get("include_original", True) and "o" not in set(selected):
            selected.append("o")

        def base():
            # input pixels: host decode, or the device input canvas on
            # codec-to-codec runs where the transport declined
            if "_orig" in item:
                return item["_orig"]
            if "image" in item:
                return item["image"][:h, :w]
            return out["input_pixels"][:h, :w]

        jpeg_syms = out.get("jpeg_syms", ())
        saved: List[Path] = []
        for sym in selected:
            p = target / path.with_stem(f"{path.stem}_{sym}").name
            try:
                if sym in jpeg_syms:
                    if f"jpeg_idx_{sym}" in out:
                        # device_encode transport: entropy-encode the
                        # device-quantized sparse coefficients (bytes
                        # identical to the q95 pixel encode)
                        djpeg.write_sparse_item(p, {
                            "jpeg_idx": out[f"jpeg_idx_{sym}"],
                            "jpeg_val": out[f"jpeg_val_{sym}"],
                            "jpeg_nnz": out[f"jpeg_nnz_{sym}"],
                            "jpeg_meta": out["jpeg_meta"],
                        }, h, w)
                        saved.append(p)
                        continue
                    arr = out[sym]  # transport overflow: pixel crop
                elif sym == "o":
                    arr = base()
                else:
                    arr = out[sym][:h, :w]
                encode_image(arr, p)
                saved.append(p)
            except Exception as e:  # noqa: BLE001 — per-sym tolerance
                warn(f"failed to save symmetry {sym!r} for {path.name}: {e}")
        return saved

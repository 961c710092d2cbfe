"""Host-side image decode/encode and directory inventory (port of
image_processor_pipeline_tpu/io/images.py).

The framework is RGB(A)-native end to end; decode converts whatever the
codec yields to RGB or RGBA uint8 HWC numpy arrays, and encode writes from
the same.

The codec is the port's own native engine (io/native.py, built at first
use from native/ipp_io.cpp against the system's libjpeg, libpng, zlib and
libdeflate): threaded batch decode into the stacked canvas, header probes,
the cv2/Pillow-parity JPEG encoder and the PNG encoders.  Where that
library cannot be built, Pillow does the same work, as in the JAX package;
it is imported inside the functions that use it, never when this module is
imported.  ``_decode_group_device`` is the hybrid JPEG decode: entropy
decode on the host, the rest on the step's device (ops/jpeg.py).

Directory inventory parity: reference pipeline.py:122-146
(_get_files_from_inputs) lists and **sorts** files, erroring on missing or
empty directories.
"""

from __future__ import annotations

import math
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from image_processor_pipeline_tpu_torch.io import native
from image_processor_pipeline_tpu_torch.io.batching import (
    bucket_dim,
    canvas_for,
    pad_to_canvas,
)

_CHANNELS = {"RGB": 3, "RGBA": 4}
_PROBED_SUFFIXES = (".jpg", ".jpeg", ".png")


def decode_image(path: Path, mode: Optional[str] = None) -> np.ndarray:
    """Decode an image file to uint8 HWC numpy (RGB, RGBA, or as requested).

    ``mode``: None keeps native bands (L/RGB/RGBA → 1/3/4 channels);
    'RGB'/'RGBA' forces a conversion (PIL convert semantics, matching the
    reference's .convert('RGBA') at rotations.py:55 / overlays.py:83-88).

    JPEG/PNG with an explicit mode go through the native engine when it is
    built; everything else through Pillow.
    """
    if mode in _CHANNELS and Path(path).suffix.lower() in _PROBED_SUFFIXES:
        res = _native_decode_exact(path, _CHANNELS[mode])
        if res is not None:
            return res
    from PIL import Image

    with Image.open(path) as im:
        if mode is not None and im.mode != mode:
            im = im.convert(mode)
        elif mode is None and im.mode not in ("L", "RGB", "RGBA"):
            im = im.convert("RGBA" if "A" in im.mode or "P" == im.mode else "RGB")
        arr = np.asarray(im)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def _native_decode_exact(path: Path, channels: int) -> Optional[np.ndarray]:
    """Native decode at exact image size (native header probe, no Pillow)."""
    meta = native.probe(Path(path))
    if meta is None:
        return None
    h, w, _ = meta
    res = native.decode_to_canvas(Path(path), (h, w), channels)
    if res is None:
        return None
    buf, hh, ww, _ = res
    if (hh, ww) != (h, w):
        return None
    return buf


def _header(path: Path):
    """(h, w, PIL mode, has transparency chunk, format, 8-bit) from the
    file's header, no pixel decode; None when Pillow cannot open it."""
    from PIL import Image

    try:
        with Image.open(path) as im:
            w, h = im.size
            deep = im.format == "PNG" and _png_depth(path) != 8
            return (h, w, im.mode, "transparency" in im.info, im.format,
                    not deep)
    except Exception:  # noqa: BLE001 — callers take the per-item path
        return None


def _png_depth(path: Path) -> int:
    """Bit depth of a PNG from its IHDR chunk (byte 24 of the file)."""
    with open(path, "rb") as f:
        head = f.read(26)
    return head[24] if len(head) >= 26 else 0


def probe(path: Path) -> Optional[Tuple[int, int, int]]:
    """Header-only dims probe: (h, w, channels) or None, for JPEG and PNG
    files; channels is 4 when an alpha channel or a transparency chunk
    will materialize, else 3.  The native probe when the engine is built,
    else Pillow's header."""
    if native.available():
        return native.probe(path)
    meta = _header(path)
    if meta is None or meta[4] not in ("JPEG", "PNG"):
        return None
    h, w, mode, trns, fmt, _ = meta
    alpha = fmt == "PNG" and ("A" in mode or trns)
    return h, w, 4 if alpha else 3


def probe_bands(path: Path) -> Optional[Tuple[int, int, int]]:
    """Band-safe header probe: (h, w, kind) where kind = 3 (3-component
    JPEG, or 8-bit RGB PNG without a transparency chunk), 4 (8-bit RGBA
    PNG), or 0 (grayscale/palette/16-bit/tRNS — callers keep their
    per-item path).  None when the file cannot be opened as JPEG or PNG.
    The native probe when the engine is built, else Pillow's header."""
    if native.available():
        return native.probe_bands(path)
    meta = _header(path)
    if meta is None or meta[4] not in ("JPEG", "PNG"):
        return None
    h, w, mode, trns, fmt, eight = meta
    kind = 0
    if fmt == "JPEG":
        kind = 3 if mode == "RGB" else 0
    elif eight and mode == "RGB" and not trns:
        kind = 3
    elif eight and mode == "RGBA":
        kind = 4
    return h, w, kind


def _pick_canvas(h: int, w: int, diag: bool) -> Tuple[int, int]:
    if diag:
        d = bucket_dim(int(math.ceil(math.hypot(h, w))))
        return (d, d)
    return canvas_for(h, w)


def decode_padded(path: Path, mode: Optional[str] = None,
                  diag: bool = False):
    """Decode into a zero-padded bucket canvas.

    Returns (buf [H, W, C] uint8, h, w, canvas) with the framework's
    padded-canvas invariant already satisfied.

    ``diag=True`` yields a square canvas bucketed to the image diagonal
    (room for expanded rotations).  The native engine decodes straight
    into the canvas; Pillow decodes then pads.
    """
    path = Path(path)
    channels = _CHANNELS.get(mode)
    if channels is not None and path.suffix.lower() in _PROBED_SUFFIXES:
        meta = native.probe(path)  # header only, native (no Pillow open)
        if meta is not None:
            h, w, _ = meta
            canvas = _pick_canvas(h, w, diag)
            res = native.decode_to_canvas(path, canvas, channels)
            if res is not None and (res[1], res[2]) == (h, w):
                return res[0], h, w, canvas
    arr = decode_image(path, mode=mode)
    h, w = arr.shape[:2]
    canvas = _pick_canvas(h, w, diag)
    ch = _CHANNELS.get(mode) or arr.shape[2]
    return pad_to_canvas(arr, canvas, channels=ch), h, w, canvas


def probe_padded(path: Path, mode: str, diag: bool = False):
    """Metadata-only twin of decode_padded: (h, w, canvas) with NO pixel
    decode (header probe).  Returns None when the file is not a JPEG or
    PNG the probe reads — callers fall back to decode_padded.
    """
    path = Path(path)
    if mode not in _CHANNELS or path.suffix.lower() not in _PROBED_SUFFIXES:
        return None
    meta = probe(path)
    if meta is None:
        return None
    h, w, _ = meta
    return h, w, _pick_canvas(h, w, diag)


def _zeros(shape) -> np.ndarray:
    return np.zeros(shape, np.uint8)


def _decode_rows(jobs, n_threads: int) -> None:
    """Run the decode jobs (callables), on a thread pool when there are
    several and ``n_threads`` > 1: Pillow decodes outside the GIL."""
    if n_threads > 1 and len(jobs) > 1:
        with ThreadPoolExecutor(max_workers=min(n_threads, len(jobs))) as ex:
            list(ex.map(lambda job: job(), jobs))
    else:
        for job in jobs:
            job()


def _decode_into(it, field, row, path, mode, diag, canvas, h, w):
    """Decode ``path`` into ``row`` ([H, W, C], zeroed) and set
    ``it[field] = row``; verifies probe-vs-decode dims and records
    ``_load_error`` (the row stays zero, so batch stacking stays
    shape-consistent) on failure."""
    it[field] = row
    row[...] = 0
    try:
        arr = decode_image(Path(path), mode=mode)
        hh, ww = arr.shape[:2]
        cv = _pick_canvas(hh, ww, diag)
        if (hh, ww) != (h, w) or tuple(cv) != tuple(canvas):
            raise ValueError(
                f"decode dims changed between probe and decode: "
                f"probed ({h}, {w}) canvas {tuple(canvas)}, "
                f"decoded ({hh}, {ww}) canvas {tuple(cv)}"
            )
        row[:h, :w] = arr
    except Exception as e:  # noqa: BLE001 — engine logs per item
        it["_load_error"] = f"{type(e).__name__}: {e}"
        row[...] = 0


def _decode_entries(entries, batch, canvas, mode, n_threads: int) -> None:
    """Decode ``entries`` [(item, field, path, diag, h, w)] into the rows
    of ``batch`` (row i = entries[i]) and set ``item[field]`` to its row:
    one native threaded batch-decode call, then the per-item path (native
    per file, else Pillow) for the items it missed (native unavailable,
    a failed file, or dims that moved since the probe)."""
    paths = [e[2] for e in entries]
    res = native.decode_batch(paths, canvas, _CHANNELS[mode], n_threads,
                              n_rows=len(batch), out=batch)
    dims = res[1] if res is not None else None
    jobs = []
    for i, (it, field, path, diag, h, w) in enumerate(entries):
        if dims is not None and dims[i, 0] == h and dims[i, 1] == w:
            it[field] = batch[i]
            continue
        jobs.append(lambda i=i, it=it, field=field, path=path, diag=diag,
                    h=h, w=w: _decode_into(it, field, batch[i], path, mode,
                                           diag, canvas, h, w))
    _decode_rows(jobs, n_threads)


def _fill_pending_multi(chunk, n_threads: int = 0,
                        alloc: Callable = _zeros) -> None:
    """Decode multi-image probed items (``_pending``) into one stacked
    array per (canvas, mode) group, with one native batch call each.

    Items carry ``_pending = {field: (path, mode, diag, canvas, h, w)}``
    and none of the named pixel fields (see BatchTransform.probe_item);
    e.g. an overlay transform pends ``overlay`` (RGBA, overlay canvas) and
    ``background`` (RGB, background canvas).  A failed decode records
    ``_load_error`` and leaves a zero canvas.
    """
    seen = {}
    for it in chunk:  # padded chunks repeat the last dict; dedup by identity
        if "_pending" in it and id(it) not in seen:
            seen[id(it)] = it
    if not seen:
        return
    groups = defaultdict(list)
    for it in seen.values():
        for field, (path, mode, diag, canvas, h, w) in it["_pending"].items():
            if field in it:
                continue
            groups[(tuple(canvas), mode)].append(
                (it, field, Path(path), diag, int(h), int(w))
            )
    for (canvas, mode), entries in groups.items():
        batch = alloc((len(entries), canvas[0], canvas[1], _CHANNELS[mode]))
        _decode_entries(entries, batch, canvas, mode, n_threads)


_reader_crash_warned = False


def _warn_reader_crash(exc: Exception) -> None:
    """Log (once per process) that a coefficient reader crashed: outputs
    stay correct via the host decode fallback, but a persistent crash
    means device_decode is silently dead — make that observable."""
    global _reader_crash_warned
    if not _reader_crash_warned:
        _reader_crash_warned = True
        print(f"[device_decode] coefficient reader crashed "
              f"({type(exc).__name__}: {exc}); falling back to host decode "
              f"(warned once)")


def _read_or_none(fn, *args, **kwargs):
    """A coefficient reader's result, or None when it crashed (warned
    once; the host decode handles those items)."""
    try:
        return fn(*args, **kwargs)
    except Exception as e:  # noqa: BLE001 — a reader crash must not kill
        _warn_reader_crash(e)  # the step
        return None


def _decode_group_device(items, canvas, mode, device, n_threads: int = 0,
                         stats=None):
    """Hybrid JPEG decode of one homogeneous bucket: host entropy decode
    (ONE native batch call) + device dequant/IDCT/upsample/color
    (ops/jpeg.py, byte-identical to the host decoder).

    Returns the stacked [n, H, W, C] batch as a uint8 tensor on
    ``device`` (the engine ships coefficients, not pixels, to the card and
    the host never touches a pixel), or None to fall back to the host
    decode path.  Items that the device path can't handle (non-YCbCr
    colorspace, exotic sampling, probe/decode dim mismatch) are decoded
    host-side and patched in.
    """
    import torch

    from image_processor_pipeline_tpu_torch.ops import jpeg as djpeg
    from image_processor_pipeline_tpu_torch.transforms.base import to_device

    cap_h, cap_w = canvas
    if cap_h % 16 or cap_w % 16:
        return None
    paths = [Path(it["_decode"][0]) for it in items]
    if any(p.suffix.lower() not in (".jpg", ".jpeg") for p in paths):
        return None
    cap_b = (cap_h // 8, cap_w // 8)
    cap_c_half = ((cap_b[0] + 1) // 2, (cap_b[1] + 1) // 2)
    n = len(items)
    channels = _CHANNELS[mode]

    # Sparse-first transport: ship (idx, val) nonzero pairs and
    # scatter-add into the dense layout on the device.  Failure ladder
    # per item:
    #   -3 (chroma grid exceeds the 4:2:0-sized default cap: 4:4:4/h2v1/
    #       h1v2 streams) → sparse retry with full-size chroma caps;
    #   -6 (nonzero count exceeds the sparse capacity) → dense reader;
    #   anything else → host decode fallback below.
    res = _read_or_none(native.read_jpeg_coefs_sparse_batch, paths, cap_b,
                        n_threads=n_threads)
    if res is None:
        return None
    idx0, val0, nnz0, qt0, infos = res
    # pools[tag] = transport arrays; rows[i] = (tag, row index in pool)
    pools = {"sp": (idx0, val0, nnz0, qt0, cap_c_half)}
    rows = {i: ("sp", i) for i in range(n) if int(infos[i][0]) >= 0}
    r3 = [i for i in range(n) if int(infos[i][0]) == -3]
    if r3:
        res3 = _read_or_none(native.read_jpeg_coefs_sparse_batch,
                             [paths[i] for i in r3], cap_b,
                             cap_blocks_c=cap_b, n_threads=n_threads)
        if res3 is not None:
            idx3, val3, nnz3, qt3, inf3 = res3
            pools["spf"] = (idx3, val3, nnz3, qt3, cap_b)
            for j, i in enumerate(r3):
                infos[i] = inf3[j]
                if int(inf3[j][0]) >= 0:
                    rows[i] = ("spf", j)
    r6 = [i for i in range(n)
          if i not in rows and int(infos[i][0]) == -6]
    if stats is not None:
        # dense-content telemetry for the engine's auto-gate hysteresis
        # (ops/jpeg.py:note_decode_dense): items whose nonzero count
        # overflowed the sparse transport and paid a dense re-read
        stats["n"] = stats.get("n", 0) + n
        stats["dense"] = stats.get("dense", 0) + len(r6)
    if r6:
        resd = _read_or_none(native.read_jpeg_coefs_batch,
                             [paths[i] for i in r6], cap_b,
                             cap_blocks_c=cap_b, n_threads=n_threads)
        if resd is not None:
            cyd, ccd, qtd, infd = resd
            pools["dn"] = (cyd, ccd, qtd)
            for j, i in enumerate(r6):
                infos[i] = infd[j]
                if int(infd[j][0]) >= 0:
                    rows[i] = ("dn", j)

    groups = {}
    failed = []
    for i, it in enumerate(items):
        h, w = (int(x) for x in it["size"])
        info = infos[i]
        ncomp = int(info[2])
        samp = (int(info[3]), int(info[4]))
        ok = (
            i in rows
            and int(info[0]) == h and int(info[1]) == w
            and ncomp in (1, 3)
            # JCS_GRAYSCALE = 1, JCS_YCbCr = 3 (jpeglib.h J_COLOR_SPACE)
            and int(info[15]) in (1, 3)
            and (ncomp == 1 or (
                samp in ((1, 1), (2, 1), (1, 2), (2, 2))
                and (int(info[7]), int(info[8])) == (1, 1)
                and (int(info[11]), int(info[12])) == (1, 1)))
        )
        if ok:
            # items from different transport pools carry differently-shaped
            # arrays, so they group separately even at equal sampling
            key = (((1, 1), True) if ncomp == 1 else (samp, False)) \
                + (rows[i][0],)
            groups.setdefault(key, []).append(i)
        else:
            failed.append(i)
    if stats is not None:
        # where the items went: the sparse transport (its -3 retry
        # included) and the host decode below
        stats["sparse"] = stats.get("sparse", 0) + sum(
            len(idx) for key, idx in groups.items() if key[-1] != "dn")
        stats["host"] = stats.get("host", 0) + len(failed)

    def dev(a):
        return to_device(np.ascontiguousarray(a), device)

    def finish(idx, samp, grayscale, tag):
        sel = np.asarray([rows[i][1] for i in idx])
        hw = np.asarray([[int(x) for x in items[i]["size"]] for i in idx],
                        np.int32)
        hj, wj = dev(hw[:, 0]), dev(hw[:, 1])
        if tag == "dn":
            cyd, ccd, qtd = pools["dn"]
            return djpeg.decode_finish(
                dev(cyd[sel]), dev(ccd[sel]), dev(qtd[sel].astype(np.int32)),
                hj, wj, samp=samp, cap_h=cap_h, cap_w=cap_w,
                grayscale=grayscale, channels=channels)
        spi, spv, spn, spq, capc = pools[tag]
        # truncate the padded capacity to the group's max nonzero count,
        # rounded up a power-of-2 ladder
        m = max(1, int(spn[sel].max()))
        capm = 1024
        while capm < m:
            capm *= 2
        capm = min(capm, spi.shape[1])
        return djpeg.decode_finish_sparse(
            dev(spi[sel, :capm]), dev(spv[sel, :capm]),
            dev(spq[sel].astype(np.int32)), hj, wj,
            samp=samp, cap_h=cap_h, cap_w=cap_w,
            cap_by_c=capc[0], cap_bx_c=capc[1],
            grayscale=grayscale, channels=channels)

    if len(groups) == 1 and not failed:
        ((samp, gray, tag), idx), = groups.items()
        # bucket order is already the batch order
        return finish(list(range(n)), samp, gray, tag)

    batch = torch.zeros((n, cap_h, cap_w, channels), dtype=torch.uint8,
                        device=device)
    for (samp, gray, tag), idx in groups.items():
        batch[torch.as_tensor(idx).to(device)] = finish(idx, samp, gray,
                                                        tag)
    for i in failed:
        it = items[i]
        h, w = (int(x) for x in it["size"])
        try:
            buf, hh, ww, cv = decode_padded(
                Path(it["_decode"][0]), mode=mode, diag=it["_decode"][2])
            if (hh, ww) != (h, w) or tuple(cv) != tuple(canvas):
                raise ValueError(
                    f"decode dims changed between probe and decode: "
                    f"probed ({h}, {w}) canvas {tuple(canvas)}, "
                    f"decoded ({hh}, {ww}) canvas {tuple(cv)}")
            batch[i] = dev(buf)
        except Exception as e:  # noqa: BLE001 — engine logs per item
            it["_load_error"] = f"{type(e).__name__}: {e}"
    return batch


def fill_pending_images(chunk, n_threads: int = 0,
                        alloc: Callable = _zeros,
                        device_decode: bool = False, device=None,
                        stats=None) -> None:
    """Decode every probed-but-not-yet-decoded item of a batch chunk into
    one stacked array per (canvas, mode) group: one native threaded
    batch-decode call each, the items it misses decoded one by one on
    ``n_threads`` threads.

    Probed items carry ``_decode = (path, mode, diag)`` and no ``image``
    field (see BatchTransform.probe_item); multi-image items carry
    ``_pending`` instead (see _fill_pending_multi).  An item whose decode
    fails gets ``_load_error`` set (the engine logs it as Error and skips
    the save) and a zero canvas so batch stacking stays shape-consistent.

    Fast path: when the WHOLE chunk is one pending homogeneous group, the
    batch decodes straight into the final stacked layout (row i = chunk[i],
    the pad rows of a ladder-padded chunk left zero) and the array is
    attached as ``chunk[0]['_prestacked_image']`` — BatchTransform.
    stack_batch then skips its np.stack copy entirely.  With
    ``device_decode`` that group goes through the hybrid decode
    (_decode_group_device) when it can: the prestacked batch is then a
    tensor on ``device`` and the items get no ``image`` field; ``stats``
    collects its ``n``/``dense`` counts.

    ``alloc(shape)`` returns the zeroed uint8 array a group decodes into;
    the engine passes one that allocates pinned host memory when the step
    runs on a CUDA card, so the batch's copy to the card is asynchronous.
    """
    _fill_pending_multi(chunk, n_threads, alloc)

    def decode_group(items, canvas, mode, n_rows=None):
        """Decode ``items`` into one [n, H, W, C] array (row i = items[i]);
        ``n_rows`` appends all-zero tail rows (ladder-padded chunks)."""
        n = len(items)
        batch = alloc((max(n_rows or n, n), canvas[0], canvas[1],
                       _CHANNELS[mode]))
        _decode_entries(
            [(it, "image", Path(it["_decode"][0]), it["_decode"][2],
              int(it["size"][0]), int(it["size"][1])) for it in items],
            batch, canvas, mode, n_threads)
        return batch

    all_pending = all(
        "image" not in it and "_decode" in it for it in chunk
    )
    keys = {
        (tuple(it["canvas"]), it["_decode"][1])
        for it in chunk if "_decode" in it
    }
    if all_pending and len(keys) == 1:
        canvas, mode = next(iter(keys))
        seen = set()
        uniq = []
        for it in chunk:
            if id(it) not in seen:
                seen.add(id(it))
                uniq.append(it)
        # ladder-padded chunks repeat the LAST dict at the tail, so
        # uniq == chunk[:len(uniq)]: decode the unique rows into the
        # head of a full-length array and leave the pad rows zero (their
        # outputs are discarded by the engine's n_valid) — the array IS
        # the stacked batch, skipping stack_batch's copy
        if all(c is u for c, u in zip(chunk, uniq)):
            if device_decode:
                batch = _decode_group_device(uniq, canvas, mode, device,
                                             n_threads, stats=stats)
                if batch is not None:
                    if len(uniq) < len(chunk):
                        import torch

                        # zero tail rows mirror decode_group's n_rows pad
                        batch = torch.cat([batch, batch.new_zeros(
                            (len(chunk) - len(uniq),) + batch.shape[1:])])
                    chunk[0]["_prestacked_image"] = batch
                    return
            chunk[0]["_prestacked_image"] = decode_group(
                uniq, canvas, mode, n_rows=len(chunk))
        else:  # interior duplicates (not engine-shaped): no prestack
            decode_group(uniq, canvas, mode)
        return

    pending = {}
    for it in chunk:  # padded chunks repeat the last dict; dedup by identity
        if "image" not in it and "_decode" in it:
            pending[id(it)] = it
    if not pending:
        return
    groups = defaultdict(list)
    for it in pending.values():
        groups[(tuple(it["canvas"]), it["_decode"][1])].append(it)
    for (canvas, mode), items in groups.items():
        decode_group(items, canvas, mode)


def encode_image(arr: np.ndarray, path: Path, **save_kwargs) -> Path:
    """Encode uint8 HWC numpy (1/3/4 channels) to ``path`` (format by suffix).

    PNG and JPEG go through the native engine when it is built (PNG is
    lossless either way; JPEG quality defaults to 95 on both paths,
    matching cv2.imwrite in the reference, and the native bytes equal
    cv2's and Pillow's at that quality); other formats, exotic kwargs and
    a host without the engine use Pillow.
    """
    arr = np.asarray(arr)
    path = Path(path)
    suffix = path.suffix.lower()
    if arr.dtype == np.uint8 and arr.ndim == 3:
        path.parent.mkdir(parents=True, exist_ok=True)
        if suffix == ".png" and not save_kwargs:
            if native.encode_png(path, arr):
                return path
        if suffix in (".jpg", ".jpeg") and set(save_kwargs) <= {"quality"}:
            rgb = arr[:, :, :3] if arr.shape[2] >= 3 else None
            if rgb is not None and native.encode_jpeg(
                    path, rgb, int(save_kwargs.get("quality", 95))):
                return path
    from PIL import Image

    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[:, :, 0]
    im = Image.fromarray(np.ascontiguousarray(arr))
    if suffix in (".jpg", ".jpeg"):
        if im.mode == "RGBA":
            im = im.convert("RGB")
        save_kwargs.setdefault("quality", 95)
    path.parent.mkdir(parents=True, exist_ok=True)
    im.save(path, **save_kwargs)
    return path


def encode_image_pil(arr: np.ndarray, path: Path, **save_kwargs) -> Path:
    """encode_image with PIL Image.save defaults: JPEG quality 75.

    The reference uses TWO encoders with different JPEG defaults: cv2.imwrite
    (quality 95 — crop_square, symmetry) and PIL Image.save (quality 75 —
    rotations.py:81,119).  Transforms whose reference encoder is PIL save
    through this wrapper (the native q75 encode is byte-identical to
    Image.save's); everything else keeps encode_image's q95 default.
    """
    if Path(path).suffix.lower() in (".jpg", ".jpeg"):
        save_kwargs.setdefault("quality", 75)
    return encode_image(arr, path, **save_kwargs)


def list_files(directory: Path, suffixes: Optional[Sequence[str]] = None) -> List[Path]:
    """Sorted list of files in a directory.

    Parity: reference pipeline.py:122-146 — raises on missing dir; the
    empty-dir check is done by the caller so partial inventories can still
    be reported.
    """
    directory = Path(directory)
    if not directory.is_dir():
        raise FileNotFoundError(f"input directory does not exist: {directory}")
    files = sorted(p for p in directory.iterdir() if p.is_file())
    if suffixes:
        sfx = {s.lower().lstrip(".") for s in suffixes}
        files = [p for p in files if p.suffix.lower().lstrip(".") in sfx]
    return files

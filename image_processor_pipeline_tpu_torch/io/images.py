"""Host-side image decode/encode and directory inventory (port of the host
pixel path of image_processor_pipeline_tpu/io/images.py).

The framework is RGB(A)-native end to end; decode converts whatever the
codec yields to RGB or RGBA uint8 HWC numpy arrays, and encode writes from
the same.

The codec is Pillow, the JAX package's own path when its native C++ engine
is not built; it is imported inside the functions that use it, never when
this module is imported.  Headers are probed by opening a file without
loading its pixels.  The native engine's twins (threaded batch decode,
tiled PNG and the parity JPEG encoders) and the hybrid device JPEG decode
are not ported yet, so JPEG bytes are Pillow's, not the JAX package's.

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

from image_processor_pipeline_tpu_torch.io.batching import (
    bucket_dim,
    canvas_for,
    pad_to_canvas,
)

CODEC = "Pillow"
_CHANNELS = {"RGB": 3, "RGBA": 4}
_PROBED_SUFFIXES = (".jpg", ".jpeg", ".png")


def decode_image(path: Path, mode: Optional[str] = None) -> np.ndarray:
    """Decode an image file to uint8 HWC numpy (RGB, RGBA, or as requested).

    ``mode``: None keeps native bands (L/RGB/RGBA → 1/3/4 channels);
    'RGB'/'RGBA' forces a conversion (PIL convert semantics, matching the
    reference's .convert('RGBA') at rotations.py:55 / overlays.py:83-88).
    """
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
    will materialize, else 3."""
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
    per-item path).  None when the file cannot be opened as JPEG or PNG."""
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
    (room for expanded rotations).
    """
    arr = decode_image(Path(path), mode=mode)
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


def _fill_pending_multi(chunk, n_threads: int = 0,
                        alloc: Callable = _zeros) -> None:
    """Decode multi-image probed items (``_pending``) into one stacked
    array per (canvas, mode) group.

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
        _decode_rows([
            (lambda i=i, e=e: _decode_into(
                e[0], e[1], batch[i], e[2], mode, e[3], canvas, e[4], e[5]))
            for i, e in enumerate(entries)], n_threads)


def fill_pending_images(chunk, n_threads: int = 0,
                        alloc: Callable = _zeros) -> None:
    """Decode every probed-but-not-yet-decoded item of a batch chunk into
    one stacked array per (canvas, mode) group, the rows decoded on
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
    stack_batch then skips its np.stack copy entirely.

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
        _decode_rows([
            (lambda i=i, it=it: _decode_into(
                it, "image", batch[i], it["_decode"][0], mode,
                it["_decode"][2], canvas, int(it["size"][0]),
                int(it["size"][1])))
            for i, it in enumerate(items)], n_threads)
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

    JPEG quality defaults to 95, matching cv2.imwrite in the reference
    (Pillow's own default is 75); PNG is lossless.
    """
    from PIL import Image

    arr = np.asarray(arr)
    path = Path(path)
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[:, :, 0]
    im = Image.fromarray(np.ascontiguousarray(arr))
    if path.suffix.lower() in (".jpg", ".jpeg"):
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
    through this wrapper; everything else keeps encode_image's q95 default.
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

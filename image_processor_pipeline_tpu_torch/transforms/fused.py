"""Fused transform chains: N reference stages → ONE device call (port of
image_processor_pipeline_tpu/transforms/fused.py).

The reference materializes every stage to disk and re-reads it in the next
stage.  A FusedChain is a single ProcessingStep whose device function
composes any number of device stages (rotate, flip, enhance, color-mask,
cleanup, crops): decode once, run the whole chain on the device, encode
once.

Stages are small declarative specs with a uniform contract on batches of
the padded-canvas representation (ops/geometry.py invariants):

    draw(keys)                 -> the stage's draws, numpy, one row an item
    apply(img, h, w, draws)    -> (img, h, w)

``keys`` [B, 2] are the items' per-stage keys, ``fold_in(PRNGKey(seed), i)``
for stage i, so a fused chain produces the same pixels as the equivalent
unfused stages with the same seeds, and the same as the JAX package's
chain.  Draws are made on the host in numpy (``random``); ``apply`` works
on tensors [B, H, W, 4] with extents h, w [B] on one device.

``Rotate(method="shear")`` rotates the batch's canvases in one
``ops/rotate.py:rotate_square_shear_batch`` call: on a CUDA card one launch
of the hand-written kernel of ``csrc/shear_rotate.cu`` (or it raises), on
the CPU its plain twin.  ``FusedChain.shrink_output`` fetches only the
batch's valid region (and no alpha for .jpg outputs), or with
``device_encode`` on and a .jpg ``output_suffix`` runs the JPEG front half
on the device and fetches sparse coefficients.  With
``native_compute=True`` the C++ chain executor (``native_fn``,
``chain_native_exec``, ops/native_cpu.py:chain_batch) runs the whole chain
on host threads from the same host draws (``stage_draw_lists``), shift
vectors included, so its files equal the device path's byte for byte.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from image_processor_pipeline_tpu_torch import random as jrandom
from image_processor_pipeline_tpu_torch.transforms.base import (
    BatchTransform,
    is_host_output,
    to_device,
)
from image_processor_pipeline_tpu_torch.transforms.filters import native_bounds
from image_processor_pipeline_tpu_torch.transforms.rotations import host_shifts
from image_processor_pipeline_tpu_torch.ops import ccl as ccl_ops
from image_processor_pipeline_tpu_torch.ops import color as color_ops
from image_processor_pipeline_tpu_torch.ops import geometry, photometric
from image_processor_pipeline_tpu_torch.ops import jpeg as djpeg
from image_processor_pipeline_tpu_torch.ops import native_cpu
from image_processor_pipeline_tpu_torch.ops import rotate as rotate_ops
from image_processor_pipeline_tpu_torch.io.images import (
    decode_padded,
    encode_image,
    encode_image_pil,
    probe_padded,
)
from image_processor_pipeline_tpu_torch.utils.utils import validate_dirs


def _per_item(values, img):
    """Host draws (one an item) on img's device, broadcastable to img."""
    t = to_device(np.ascontiguousarray(values), img.device)
    return t.reshape(t.shape + (1, 1, 1))


class Stage:
    """Base device stage.  ``needs_diag_canvas`` asks the loader for a
    canvas that fits the image diagonal (rotation expansion).

    ``pil_anchored`` records which of the reference's TWO encoders the
    stage's reference analog saves with (PIL Image.save q75 vs cv2.imwrite
    q95); FusedChain.save_item picks its JPEG encoder from the FINAL
    stage's anchor.
    """

    needs_diag_canvas = False
    #: True = reference analog saves via PIL Image.save (JPEG q75):
    #: rotations.py:119, tranfo.py:53, recadrages.py:80 (fit crop).
    #: False = cv2.imwrite (q95): symmetry.py:133, filtres_liste.py:138,
    #: pixels_isolés.py:68, recadrages.py:57 (border crop).
    pil_anchored = True

    def draw(self, keys):
        """The stage's draws for keys [B, 2] (numpy, one row an item);
        None for a stage that draws nothing."""
        return None

    def apply(self, img, h, w, draws):
        raise NotImplementedError

    def config(self) -> Tuple:
        """Hashable static config."""
        return ()


class Rotate(Stage):
    """Random-angle rotation with expansion + tight crop (reference
    rotations.py:88-109 semantics, fan-out 1).

    ``method='nearest'`` is the PIL inverse map; ``method='shear'`` centers
    the content on the square diagonal canvas and uses the Paeth 3-shear
    permutation (±1 px jitter), through the rotation kernel on a card.
    """

    needs_diag_canvas = True

    def __init__(self, angle_min: float = 1.0, angle_max: float = 359.0,
                 method: str = "nearest"):
        self.angle_min = float(angle_min)
        self.angle_max = float(angle_max)
        self.method = str(method)

    def config(self):
        return (self.angle_min, self.angle_max, self.method)

    def draw(self, keys):
        """Angles [B] float32."""
        return jrandom.uniform(keys, (), self.angle_min, self.angle_max)

    def apply(self, img, h, w, angles, shifts=None):
        """``shifts``: the shear method's (quad, sh1, sh2) on img's device,
        to use instead of the vectors computed from ``angles`` on the
        host."""
        if self.method == "shear":
            H = img.shape[1]
            if shifts is None:
                shifts = host_shifts(angles, H, img.device)
            centered = geometry.roll2(
                img, torch.div(H - h, 2, rounding_mode="floor"),
                torch.div(H - w, 2, rounding_mode="floor"))
            out = rotate_ops.rotate_square_shear_batch(centered, None,
                                                       shifts=shifts)
            return geometry.fit_crop(out, H, H)
        img, h2, w2 = geometry.rotate_expand(
            img, h, w, to_device(angles, img.device), "nearest")
        return geometry.fit_crop(img, h2, w2)


class Flip(Stage):
    """Random dihedral symmetry from a pool (reference symmetry.py:114-126)."""

    pil_anchored = False  # reference saves via cv2.imwrite (symmetry.py:133)

    def __init__(self, pool: Sequence[str] = ("o", "h", "v", "hv")):
        self.pool = tuple(pool)

    def config(self):
        return self.pool

    def draw(self, keys):
        """Pool indices [B] int32."""
        return jrandom.randint(keys, (), 0, len(self.pool))

    def apply(self, img, h, w, idx):
        # 'h' and 'v' are independent axes: two flip-where passes give
        # every pool entry's permutation
        fx = np.asarray(["h" in s for s in self.pool])[idx]
        fy = np.asarray(["v" in s for s in self.pool])[idx]
        img = torch.where(_per_item(fx, img), geometry.flip_h(img, h, w), img)
        img = torch.where(_per_item(fy, img), geometry.flip_v(img, h, w), img)
        return img, h, w


class Enhance(Stage):
    """Photometric enhance with Bernoulli blur/rgb branches (reference
    tranfo.py:38-51 with the 30% draws of pipeline.py:209-225)."""

    def __init__(self, blur_prob: float = 0.3, rgb_prob: float = 0.3):
        self.blur_prob = float(blur_prob)
        self.rgb_prob = float(rgb_prob)

    def config(self):
        return (self.blur_prob, self.rgb_prob)

    def draw(self, keys):
        """(b, c, col, sigma [B] float32, gains [B, 3] float32, do_blur,
        do_rgb [B] bool)."""
        k = jrandom.split(keys, 7)
        b = jrandom.uniform(k[:, 0], (), 0.7, 1.3)
        c = jrandom.uniform(k[:, 1], (), 0.7, 1.3)
        col = jrandom.uniform(k[:, 2], (), 0.7, 1.3)
        sigma = jrandom.uniform(k[:, 3], (), 0.5, 3.0)
        gains = jrandom.uniform(k[:, 4], (3,), 0.75, 1.25)
        do_blur = jrandom.bernoulli(k[:, 5], self.blur_prob)
        do_rgb = jrandom.bernoulli(k[:, 6], self.rgb_prob)
        return b, c, col, sigma, gains, do_blur, do_rgb

    def apply(self, img, h, w, draws):
        b, c, col, sigma, gains, do_blur, do_rgb = draws
        dev = img.device
        b, c, col, gains, do_blur, do_rgb = (
            to_device(v, dev) for v in (b, c, col, gains, do_blur, do_rgb))
        # sigma <= 3 needs only a 3-tap-radius box window
        rgb = photometric.enhance(
            img[..., :3], h, w, b, c, col, sigma, do_blur, gains, do_rgb,
            blur_max_radius=photometric.box_radius_bound(3.0),
            blur_sigma_max=3.0)
        alpha = geometry.apply_mask(img[..., 3:], h, w)
        return torch.cat([rgb, alpha], dim=-1), h, w


class ColorMask(Stage):
    """HSV exclusion ranges → alpha (reference filtres_liste.py:88-134).

    ``input_alpha`` picks what happens to transparency ALREADY carried by
    the chain (e.g. from an upstream Rotate's expansion fill):

    - ``"combine"`` (default): new alpha = min(mask alpha, input alpha) —
      chain-carried transparency survives.
    - ``"replace"``: new alpha = mask alpha — exactly the standalone
      ColorMaskTransparency step, whose re-decode drops the intermediate
      file's alpha channel and recomputes it from the RGB planes alone.
    """

    pil_anchored = False  # cv2.imwrite (filtres_liste.py:138)

    def __init__(self, filters, zones=None, use_gimp_scale: bool = False,
                 input_alpha: str = "combine"):
        scaled = [color_ops.rescale_filter(f, use_gimp_scale) for f in filters]
        zones = zones or [None] * len(filters)
        if len(zones) != len(filters):
            raise ValueError("zones must match filters")
        if input_alpha not in ("combine", "replace"):
            raise ValueError(
                f"input_alpha must be 'combine' or 'replace', "
                f"got {input_alpha!r}")
        self.lowers = tuple(tuple(f[:3]) for f in scaled)
        self.uppers = tuple(tuple(f[3:]) for f in scaled)
        self.zones = tuple(tuple(z) if z else (0, 0, 0, 0) for z in zones)
        self.input_alpha = input_alpha

    def config(self):
        return (self.lowers, self.uppers, self.zones, self.input_alpha)

    def apply(self, img, h, w, draws):
        alpha = color_ops.color_mask_alpha(
            img[..., :3], h, w, self.lowers, self.uppers, self.zones)
        if self.input_alpha == "combine":
            # masked pixels stay transparent, carried transparency survives
            alpha = torch.minimum(alpha, img[..., 3])
        return torch.cat([img[..., :3], alpha[..., None]], dim=-1), h, w


class Cleanup(Stage):
    """CCL cleanup + alpha tight crop (reference pixels_isolés.py:8-81)."""

    pil_anchored = False  # cv2.imwrite (pixels_isolés.py:68)

    def __init__(self, min_component_size: int = 500,
                 keep_large_components: bool = False):
        self.min_size = int(min_component_size)
        self.keep_large = bool(keep_large_components)

    def config(self):
        return (self.min_size, self.keep_large)

    def apply(self, img, h, w, draws):
        return ccl_ops.cleanup_and_fit(
            img, h, w, self.min_size, keep_large_components=self.keep_large
        )


class FitCrop(Stage):
    """Tight crop to nonzero content (reference recadrages.py:63-82)."""

    def apply(self, img, h, w, draws):
        return geometry.fit_crop(img, h, w)


class BorderCrop(Stage):
    """Fixed fractional margins (reference recadrages.py:13-61; absolute
    pixel margins are resolved per image on device)."""

    pil_anchored = False  # cv2.imwrite (recadrages.py:57)

    def __init__(self, margins=(0, 0, 0, 0)):
        self.margins = tuple(float(m) for m in margins)

    def config(self):
        return self.margins

    def apply(self, img, h, w, draws):
        t, b, l, r = self.margins

        def px(v, total):
            # a fraction of the side: a float32 multiply, truncated
            v = np.float32(v)
            if v >= 1.0:
                return int(v)
            frac = torch.full((), float(v), dtype=torch.float32,
                              device=total.device)
            return (total.to(torch.float32) * frac).to(torch.int32)

        return geometry.border_crop(
            img, h, w, px(t, h), px(b, h), px(l, w), px(r, w))


# Native CPU executor opcodes (native/ipp_cpu.cpp:ChainOpcode) and the
# dihedral code each Flip pool entry maps to.
_NATIVE_OPCODE = {
    "Rotate": 0, "Flip": 1, "ColorMask": 2, "Enhance": 3,
    "FitCrop": 4, "BorderCrop": 5, "Cleanup": 6,
}
_FLIP_CODE = {"o": 0, "h": 1, "v": 2, "hv": 3}


def native_program(stages) -> Optional[list]:
    """Opcode list for native/ipp_cpu.cpp:chain_one, or None when a stage
    has no native twin (the nearest-method Rotate, custom stages)."""
    ops = []
    for s in stages:
        code = _NATIVE_OPCODE.get(type(s).__name__)
        if code is None or (isinstance(s, Rotate) and s.method != "shear"):
            return None
        ops.append(code)
    return ops


def stage_draw_lists(stages, keys, H: int):
    """Every per-stage draw of one chain pass for each of the keys [N, 2]
    (stage i draws from fold_in(key, i)) — the draws the device path's
    stages make, with the shear vectors from ``host_shifts`` as the device
    path computes them.  Returns the 6 item-major arrays the native chain
    executor takes: rotation quads [N, R], sh1 and sh2 [N, R, H], flip pool
    indices [N, F], enhance factors [N, E, 7] (b, c, col, sigma, gains)
    and gates [N, E, 2] (zero-length slots where a stage kind is
    absent)."""
    keys = np.asarray(keys, np.uint32)
    N = len(keys)
    rq, r1, r2, fl, ef, eg = [], [], [], [], [], []
    for i, st in enumerate(stages):
        k = jrandom.fold_in(keys, i)
        if isinstance(st, Rotate):
            quad, sh1, sh2 = (t.numpy() for t in
                              host_shifts(st.draw(k), H, "cpu"))
            rq.append(quad)
            r1.append(sh1)
            r2.append(sh2)
        elif isinstance(st, Flip):
            fl.append(st.draw(k))
        elif isinstance(st, Enhance):
            b, c, col, sigma, gains, do_blur, do_rgb = st.draw(k)
            ef.append(np.concatenate(
                [np.stack([b, c, col, sigma], axis=-1), gains], axis=-1))
            eg.append(np.stack([do_blur, do_rgb], axis=-1).astype(np.uint8))

    def stk(xs, shape, dtype):
        return (np.stack(xs, axis=1).astype(dtype) if xs
                else np.zeros((N, 0) + shape, dtype))

    return (stk(rq, (), np.int32), stk(r1, (H,), np.int32),
            stk(r2, (H,), np.int32), stk(fl, (), np.int32),
            stk(ef, (7,), np.float32), stk(eg, (2,), np.uint8))


def chain_native_exec(stages, imgs: np.ndarray, sizes: np.ndarray, draws,
                      n_threads: int = 1):
    """Run the native C++ chain executor (ops/native_cpu.py:chain_batch)
    over stacked canvases with the given draw arrays (item-major, one
    ``stage_draw_lists`` row an image).  Returns (outs, out_sizes [N, 2])
    or None when a stage has no native twin or the library is
    unavailable."""
    ops = native_program(stages)
    if ops is None:
        return None
    rq, r1, r2, fl, ef, eg = draws
    # flip pool index → dihedral code, per Flip stage slot
    pools = [np.asarray([_FLIP_CODE[s] for s in st.pool], np.int32)
             for st in stages if isinstance(st, Flip)]
    if pools:
        fl = np.stack(
            [pools[j][fl[:, j]] for j in range(len(pools))], axis=1)
    # static mask params, cv2-saturate-rounded (ops/color.py:in_range)
    mask_F, mb, mz, mr = [], [], [], []
    for st in stages:
        if isinstance(st, ColorMask):
            bounds = native_bounds(st.lowers, st.uppers)
            mask_F.append(bounds.shape[0])
            mb.append(bounds)
            mz.append(np.asarray(st.zones, np.int32).reshape(-1, 4))
            mr.append(int(st.input_alpha == "replace"))
    bc = [st.margins for st in stages if isinstance(st, BorderCrop)]
    ccl = [(st.min_size, int(st.keep_large)) for st in stages
           if isinstance(st, Cleanup)]
    return native_cpu.chain_batch(
        imgs, sizes, np.asarray(ops, np.int32), rq, r1, r2, fl,
        np.asarray(mask_F, np.int32),
        np.concatenate(mb) if mb else np.zeros((0, 6), np.int32),
        np.concatenate(mz) if mz else np.zeros((0, 4), np.int32),
        np.asarray(mr, np.int32), ef, eg,
        np.asarray(bc, np.float32).reshape(-1, 4),
        np.asarray(ccl, np.int32).reshape(-1, 2), n_threads)


def no_draws(n: int, H: int):
    """The executor's draw arrays for ``n`` images of a draw-free
    stage list (every slot count zero)."""
    return (np.zeros((n, 0), np.int32), np.zeros((n, 0, H), np.int32),
            np.zeros((n, 0, H), np.int32), np.zeros((n, 0), np.int32),
            np.zeros((n, 0, 7), np.float32), np.zeros((n, 0, 2), np.uint8))


class FusedChain(BatchTransform):
    """One ProcessingStep that runs a whole stage list on the device.

    options:
      output_suffix: file suffix for outputs (default '.png' — the chain
        carries alpha); output names keep the input stem.
      output_bands: keep only the first N bands of the output.
    """

    max_batch = 8

    def __init__(self, stages: Sequence[Stage]):
        self.stages = list(stages)
        self._needs_diag = any(s.needs_diag_canvas for s in self.stages)

    def load_item(self, inputs: Tuple, options: Dict) -> Dict[str, Any]:
        path = Path(inputs[0])
        buf, h, w, canvas = decode_padded(
            path, mode="RGBA", diag=self._needs_diag
        )
        return {
            "canvas": canvas,
            "image": buf,
            "size": np.asarray([h, w], np.int32),
        }

    def probe_item(self, inputs: Tuple, options: Dict) -> Optional[Dict[str, Any]]:
        path = Path(inputs[0])
        meta = probe_padded(path, mode="RGBA", diag=self._needs_diag)
        if meta is None:
            return None
        h, w, canvas = meta
        return {
            "canvas": canvas,
            "size": np.asarray([h, w], np.int32),
            "_decode": (str(path), "RGBA", self._needs_diag),
        }

    def static_args(self, options: Dict, key: Tuple) -> Tuple:
        return tuple(
            (type(s).__name__, s.config()) for s in self.stages
        )

    def device_fn(self, batch, static):
        img = batch["image"]
        h, w = batch["size"][:, 0], batch["size"][:, 1]
        keys = self.keys_from_seeds(batch["seed"])
        for i, stage in enumerate(self.stages):
            draws = stage.draw(jrandom.fold_in(keys, i))
            img, h, w = stage.apply(img, h, w, draws)
        return {"image": img, "h": h, "w": w}

    # -- D2H shrink (device path) -------------------------------------------
    # The full canvas is often much larger than the content (the diag
    # canvas after rotate + fitcrop), and .jpg outputs never read the alpha
    # plane: fetching only the batch's valid region (rounded up to a 128
    # multiple) and dropping alpha for .jpg cuts the device→host bytes.
    shrinks_output = True

    def shrink_output(self, out_dev, chunk, options):
        if is_host_output(out_dev):
            return out_dev  # the executor's outputs, already on the host
        img = out_dev["image"]
        H, W = int(img.shape[1]), int(img.shape[2])
        # small wait on this batch's own extents (saver-thread context)
        h, w = djpeg.fetch([out_dev["h"], out_dev["w"]])
        hm = min(H, int(-(-max(int(h.max()), 1) // 128) * 128))
        wm = min(W, int(-(-max(int(w.max()), 1) // 128) * 128))
        suffix = str(options.get("output_suffix", ".png")).lower()
        if suffix in (".jpg", ".jpeg") and djpeg.device_encode_enabled(
                options, self, img.device):
            out = self._shrink_encode(
                out_dev, h, w, options,
                n_valid=len({id(it) for it in chunk}))
            if out is not None:
                return out
        C = (3 if suffix in (".jpg", ".jpeg")
             or options.get("output_bands") == 3 else img.shape[3])
        if (hm, wm, C) == (H, W, img.shape[3]):
            self.start_host_copy(out_dev)
            return out_dev
        out = dict(out_dev, image=img[:, :hm, :wm, :C])
        self.start_host_copy(out)
        return out

    # -- hybrid device JPEG encode (D2H ships coefficients, not pixels) -----
    # With device_encode on and a .jpg output_suffix the whole JPEG front
    # half (YCbCr, 4:2:0 downsample, islow FDCT, quantization —
    # ops/jpeg.py:encode_start_sparse) runs on the device and sparse
    # quantized coefficients come back; the saver thread does entropy
    # encode only (native/ipp_jcoef.cpp:ipp_write_jpeg_coefs_sparse).  Files
    # are byte-identical to the pixel path at the final stage's anchored
    # quality.

    def _shrink_encode(self, out_dev, h, w, options, n_valid=None):
        # same anchor condition as save_item below: cv2 q95 only when a
        # non-PIL-anchored final stage exists (empty chains save via PIL)
        quality = 95 if (self.stages
                         and not self.stages[-1].pil_anchored) else 75
        # hysteresis counts only the chunk's real items: ladder pad rows
        # are duplicates and would skew the dense ratio
        out = djpeg.shrink_transport(
            self, out_dev["image"], out_dev["h"], out_dev["w"], h, w,
            quality, options, len(h) if n_valid is None else n_valid)
        if out is None:
            return None
        out.update(h=out_dev["h"], w=out_dev["w"])
        self.start_host_copy(out)
        return out

    def materialize_batch(self, out_dev, n: int):
        if "jpeg_idx" not in out_dev:
            return BatchTransform.materialize_batch(out_dev, n)
        return djpeg.materialize_jpeg_batch(out_dev, n,
                                            per_item_keys=("h", "w"))

    # -- native CPU twin ---------------------------------------------------

    def _native_draws(self, seeds: np.ndarray, H: int):
        """Every draw the device path makes for the items' seeds, in the
        executor's layout (``stage_draw_lists`` of the items' keys)."""
        return stage_draw_lists(self.stages, self.keys_from_seeds(seeds), H)

    def native_fn(self, batch, static, options, n_threads=1):
        """Bit-exact C++ chain executor (ops/native_cpu.py:chain_batch) on
        the device path's own host draws, so its outputs equal the device
        path's byte for byte.  Declines (None) a stage list with no twin
        and a shear rotation on a canvas that is not square."""
        if native_program(self.stages) is None:
            return None
        imgs = batch["image"]
        H, W = imgs.shape[1:3]
        if any(isinstance(s, Rotate) for s in self.stages) and H != W:
            return None  # shear rotation requires the square diag canvas
        res = chain_native_exec(
            self.stages, imgs, batch["size"],
            self._native_draws(batch["seed"], H), n_threads)
        if res is None:
            return None
        outs, out_sizes = res
        return {"image": outs, "h": out_sizes[:, 0], "w": out_sizes[:, 1]}

    def save_item(self, out, item, output_dirs, options) -> Optional[Path]:
        target = validate_dirs(output_dirs, 1)
        path = Path(item["_args"][0])
        h, w = int(out["h"]), int(out["w"])
        if h <= 0 or w <= 0:
            raise RuntimeError(f"chain produced empty content for {path.name}")
        suffix = options.get("output_suffix", ".png")
        p = Path(target) / f"{path.stem}{suffix}"
        if "jpeg_meta" in out:
            # device_encode transport: entropy-encode the device-quantized
            # sparse coefficients (bytes identical to the pixel path)
            djpeg.write_sparse_item(p, out, h, w)
            return p
        img = out["image"][:h, :w]
        if suffix.lower() in (".jpg", ".jpeg"):
            img = img[..., :3]
        bands = options.get("output_bands")
        if bands:
            img = img[..., :int(bands)]
        # JPEG bytes follow the FINAL stage's reference encoder: PIL
        # Image.save q75 (enhance/rotations/fit-crop chains) vs
        # cv2.imwrite q95 (flip/colormask/cleanup/border-crop chains)
        if self.stages and not self.stages[-1].pil_anchored:
            encode_image(img, p)
        else:
            encode_image_pil(img, p)
        return p

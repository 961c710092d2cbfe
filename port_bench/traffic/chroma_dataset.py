"""Seeded chroma-key photographs: one object shot on a green or blue
backdrop, as JPEGs, for cutting objects out into RGBA overlays.

Each image has:

- a backdrop of one key colour, half the images green and half blue
  (each inside its key range), shaded by a smooth 1/f**2 field;
- specks on the backdrop (noise, dust, tape marks): small clusters of
  dark, grey-white or warm pixels outside both key ranges, a drawn share
  of the backdrop, where a thresholded blur of white noise lies highest;
- one object covering a drawn share of the frame: an ellipse whose
  outline a 1/f field roughens (the share is met by a threshold at the
  score's quantile), thin limbs reaching out of it and small round holes
  showing the backdrop, in a warm or magenta hue outside both key ranges
  with a 1/f texture;
- 0 to ``distractors[1]`` distractors, ellipses of a drawn share of the
  frame, placed where they touch neither the object nor each other.

The fields and masks are drawn on ``device`` by a ``torch.Generator`` in
a few large calls a chunk of images; the host draws the few numbers an
image (numpy, from the seed), encodes the JPEGs (Pillow, on ``workers``
threads) and writes them, with a YOLO label an image (class 0, the
object's box).

Parameters (the traffic file's ``dataset`` object; hues in OpenCV's 8-bit
units, 0-180, saturations and values as fractions of 255): ``width``,
``height``, ``quality``, ``backdrops`` (per key: ``hue``, ``saturation``,
``value`` [lo, hi] of its base colour), ``shading`` (the backdrop
value's relative standard deviation), ``speck_share`` [lo, hi] of the
backdrop, ``speck_blur`` (px), ``object_share`` [lo, hi] of the frame,
``object_hues`` (list of [lo, hi]), ``object_saturation``,
``object_value``, ``roughness``, ``limbs`` [min, max], ``limb_width``
[lo, hi] (px), ``limb_length`` [lo, hi] (of the object's radius),
``holes`` [min, max], ``hole_radius`` [lo, hi] (of the object's radius),
``distractors`` [min, max], ``distractor_share`` [lo, hi] of the frame,
``candidates`` (placements tried a distractor), ``margin`` (px kept clear
around the object and each distractor).
"""

from __future__ import annotations

import math
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

#: images drawn on the device in one call: few enough that the float64
#: fields of a chunk stay below what the engine itself holds (at 640 x 480
#: some 0.1 GB against the 0.27 GB of the engine's window), so the run's
#: peak is the engine's
CHUNK = 2
#: JPEG encodes queued on the writer threads before the draws wait
QUEUED = 32
#: the fields and geometry are float64: in float32, a pixel near a
#: threshold or a rounding edge could come out either way with the code
#: path (vectorised or not) that computed it, and a seed would not always
#: give the same files
DTYPE = torch.float64
#: the two key colours; half the images take each
KEYS = ("green", "blue")


def _spectrum_field(gen, n: int, H: int, W: int, amp, device):
    """[n, H, W] real fields of unit standard deviation whose amplitude
    spectrum is ``amp`` ([H, W // 2 + 1])."""
    shape = (n, H, W // 2 + 1)
    re = torch.randn(shape, generator=gen, device=device).to(DTYPE)
    im = torch.randn(shape, generator=gen, device=device).to(DTYPE)
    field = torch.fft.irfft2(torch.complex(re, im) * amp, s=(H, W))
    return field / field.std(dim=(-2, -1), keepdim=True).clamp(min=1e-12)


def _freq(H: int, W: int, device):
    fy = torch.fft.fftfreq(H, device=device, dtype=DTYPE)[:, None]
    fx = torch.fft.rfftfreq(W, device=device, dtype=DTYPE)[None, :]
    return torch.sqrt(fy * fy + fx * fx)


def _pink(f, slope: float, H: int, W: int):
    """Amplitude 1/f**slope, the mean left out."""
    return torch.where(f > 0, f.clamp(min=1.0 / max(H, W)) ** -slope,
                       torch.zeros((), device=f.device))


def _hsv_to_rgb(h, s, v):
    """Float RGB in [0, 1] of hue ``h`` in OpenCV units (0-180) and
    saturation, value in [0, 1]; the last axis is RGB."""
    hd = (2.0 * h) / 60.0
    out = []
    for n in (5.0, 3.0, 1.0):
        k = torch.remainder(n + hd, 6.0)
        out.append(v - v * s * torch.clamp(torch.minimum(k, 4.0 - k), 0, 1))
    return torch.stack(out, -1)


def _u(rng, lohi, size=None):
    return rng.uniform(lohi[0], lohi[1], size)


def draw_params(rng, n: int, p):
    """Per image the numbers drawn on the host: a dict of numpy arrays."""
    H, W = p["height"], p["width"]
    # exactly half of each key, in a drawn order
    key = rng.permutation(np.arange(n) % len(KEYS))
    bd = [p["backdrops"][k] for k in KEYS]
    out = {"key": key}
    for name in ("hue", "saturation", "value"):
        lo = np.array([b[name][0] for b in bd])[key]
        hi = np.array([b[name][1] for b in bd])[key]
        out["bd_" + name] = rng.uniform(lo, hi)
    out["speck_share"] = _u(rng, p["speck_share"], n)
    share = _u(rng, p["object_share"], n)
    aspect = rng.uniform(0.7, 1.4, n)
    # semi-axes whose ellipse holds the share: pi a b = share H W
    r = np.sqrt(share * H * W / math.pi)
    out["obj_share"] = share
    out["obj_ax"], out["obj_ay"] = r * np.sqrt(aspect), r / np.sqrt(aspect)
    out["obj_cx"] = rng.uniform(0.4, 0.6, n) * W
    out["obj_cy"] = rng.uniform(0.4, 0.6, n) * H
    hues = np.asarray(p["object_hues"], np.float64)
    pick = rng.integers(0, len(hues), (n, 1 + p["distractors"][1]))
    out["hue"] = rng.uniform(hues[pick, 0], hues[pick, 1])
    out["sat"] = _u(rng, p["object_saturation"], out["hue"].shape)
    out["val"] = _u(rng, p["object_value"], out["hue"].shape)
    L = p["limbs"][1]
    out["limbs"] = rng.integers(p["limbs"][0], L + 1, n)
    out["limb_angle"] = rng.uniform(0, 2 * math.pi, (n, L))
    out["limb_len"] = _u(rng, p["limb_length"], (n, L)) * r[:, None]
    out["limb_w"] = _u(rng, p["limb_width"], (n, L))
    K = p["holes"][1]
    out["holes"] = rng.integers(p["holes"][0], K + 1, n)
    ang = rng.uniform(0, 2 * math.pi, (n, K))
    rad = rng.uniform(0, 0.5, (n, K)) * r[:, None]
    out["hole_x"] = out["obj_cx"][:, None] + rad * np.cos(ang)
    out["hole_y"] = out["obj_cy"][:, None] + rad * np.sin(ang)
    out["hole_r"] = _u(rng, p["hole_radius"], (n, K)) * r[:, None]
    D, C = p["distractors"][1], p["candidates"]
    out["distractors"] = rng.integers(p["distractors"][0], D + 1, n)
    dshare = _u(rng, p["distractor_share"], (n, D))
    daspect = rng.uniform(0.6, 1.6, (n, D))
    dr = np.sqrt(dshare * H * W / math.pi)
    out["d_ax"], out["d_ay"] = dr * np.sqrt(daspect), dr / np.sqrt(daspect)
    out["d_angle"] = rng.uniform(0, math.pi, (n, D))
    reach = np.maximum(out["d_ax"], out["d_ay"]) + 1
    out["d_x"] = reach[..., None] + rng.uniform(0, 1, (n, D, C)) * np.maximum(
        W - 2 * reach[..., None], 0)
    out["d_y"] = reach[..., None] + rng.uniform(0, 1, (n, D, C)) * np.maximum(
        H - 2 * reach[..., None], 0)
    return out


def _t(a, device):
    return torch.as_tensor(np.asarray(a), dtype=DTYPE, device=device)


def _ellipse(xs, ys, cx, cy, ax, ay, angle):
    """Bool [..., H, W] inside the ellipses (centre, semi-axes, angle;
    each [...])."""
    c, s = torch.cos(angle)[..., None, None], torch.sin(angle)[..., None, None]
    dx, dy = xs - cx[..., None, None], ys - cy[..., None, None]
    u, v = (c * dx + s * dy) / ax[..., None, None], \
        (-s * dx + c * dy) / ay[..., None, None]
    return u * u + v * v <= 1.0


def _dilate(mask, px: int):
    if px <= 0:
        return mask
    return F.max_pool2d(mask[:, None].float(), 2 * px + 1, 1, px)[:, 0] > 0


def _object(gen, q, sl, H, W, p, xs, ys, device):
    """Bool [m, H, W] object masks of the images ``sl``."""
    m = sl.stop - sl.start
    f = _freq(H, W, device)
    rough = _spectrum_field(gen, m, H, W, _pink(f, 1.5, H, W), device)
    cx, cy = _t(q["obj_cx"][sl], device), _t(q["obj_cy"][sl], device)
    ax, ay = _t(q["obj_ax"][sl], device), _t(q["obj_ay"][sl], device)
    dx = (xs - cx[:, None, None]) / ax[:, None, None]
    dy = (ys - cy[:, None, None]) / ay[:, None, None]
    score = -torch.sqrt(dx * dx + dy * dy) + p["roughness"] * rough
    flat = score.flatten(1)
    k = torch.as_tensor(np.round(q["obj_share"][sl] * H * W).astype(np.int64)
                        .clip(1, H * W), device=device)
    top = torch.sort(flat, dim=1, descending=True).values
    thr = top.gather(1, (k - 1)[:, None])
    body = (flat >= thr).reshape(m, H, W)
    # limbs: segments from the centre, the unused ones of zero width
    on = torch.as_tensor(np.arange(q["limb_angle"].shape[1])[None, :]
                         < q["limbs"][sl][:, None], device=device)
    ang = _t(q["limb_angle"][sl], device)
    ln = _t(q["limb_len"][sl], device)
    wd = _t(q["limb_w"][sl], device) * on
    px, py = xs - cx[:, None, None], ys - cy[:, None, None]
    for j in range(ang.shape[1]):
        ux = torch.cos(ang[:, j])[:, None, None]
        uy = torch.sin(ang[:, j])[:, None, None]
        t = torch.minimum((px * ux + py * uy).clamp(min=0),
                          ln[:, j, None, None])
        d2 = (px - t * ux) ** 2 + (py - t * uy) ** 2
        body |= d2 <= (wd[:, j, None, None] / 2) ** 2
    on = torch.as_tensor(np.arange(q["hole_x"].shape[1])[None, :]
                         < q["holes"][sl][:, None], device=device)
    hx, hy = _t(q["hole_x"][sl], device), _t(q["hole_y"][sl], device)
    hr = _t(q["hole_r"][sl], device) * on
    for j in range(hx.shape[1]):
        body &= ((xs - hx[:, j, None, None]) ** 2
                 + (ys - hy[:, j, None, None]) ** 2
                 >= hr[:, j, None, None] ** 2)
    return body


def _distractors(q, sl, occupied, H, W, p, xs, ys, device):
    """Bool [m, D, H, W] distractor masks of the images ``sl`` (a slot left
    empty where none of its candidate placements is clear), and the
    occupied masks with them added."""
    m, D = sl.stop - sl.start, p["distractors"][1]
    out = torch.zeros((m, D, H, W), dtype=torch.bool, device=device)
    margin = p["margin"]
    for d in range(D):
        wanted = q["distractors"][sl] > d
        if not wanted.any():
            continue
        want = torch.as_tensor(wanted, device=device)
        near = _dilate(occupied, margin)
        pick = torch.zeros((m, H, W), dtype=torch.bool, device=device)
        placed = torch.zeros(m, dtype=torch.bool, device=device)
        # the first clear candidate, if any; the rest are not drawn once
        # every image that wants one has it
        for c in range(q["d_x"].shape[2]):
            if c and not bool((want & ~placed).any()):
                break
            cand = _ellipse(xs, ys, _t(q["d_x"][sl, d, c], device),
                            _t(q["d_y"][sl, d, c], device),
                            _t(q["d_ax"][sl, d], device),
                            _t(q["d_ay"][sl, d], device),
                            _t(q["d_angle"][sl, d], device))
            take = want & ~placed & ~(cand & near).flatten(1).any(1)
            pick |= cand & take[:, None, None]
            placed |= take
        out[:, d] = pick
        occupied = occupied | pick
    return out, occupied


def draw_images(gen, q, lo: int, hi: int, p, device):
    """uint8 [n, H, W, 3] images of the parameters ``q`` rows [lo, hi), on
    the host, and per image its statistics: object share, placed
    distractors and their shares, speck share of the backdrop."""
    H, W = p["height"], p["width"]
    sl = slice(lo, hi)
    m = hi - lo
    ys = torch.arange(H, device=device, dtype=DTYPE)[:, None] + 0.5
    xs = torch.arange(W, device=device, dtype=DTYPE)[None, :] + 0.5
    obj = _object(gen, q, sl, H, W, p, xs, ys, device)
    dis, occupied = _distractors(q, sl, obj, H, W, p, xs, ys, device)
    f = _freq(H, W, device)
    # backdrop: its key colour, the value shaded by a smooth field
    shade = _spectrum_field(gen, m, H, W, _pink(f, 2.0, H, W), device)
    v = _t(q["bd_value"][sl], device)[:, None, None] * (
        1 + p["shading"] * shade.clamp(-3, 3))
    del shade
    hue = _t(q["bd_hue"][sl], device)[:, None, None].expand(m, H, W)
    sat = _t(q["bd_saturation"][sl], device)[:, None, None].expand(m, H, W)
    img = _hsv_to_rgb(hue, sat, v.clamp(0, 1))
    del v
    # specks: the highest of a blurred white noise over the clear
    # backdrop, the drawn share of it
    blur = torch.exp(-2 * (math.pi * p["speck_blur"] * f) ** 2)
    noise = _spectrum_field(gen, m, H, W, blur, device)
    free = ~_dilate(occupied, 2)
    score = torch.where(free, noise, torch.full_like(noise, -math.inf))
    top = torch.sort(score.flatten(1), dim=1, descending=True).values
    backdrop = (~occupied).flatten(1).sum(1)
    share = torch.as_tensor(q["speck_share"][sl], device=device)
    k = torch.minimum((share * backdrop).round().long(),
                      free.flatten(1).sum(1)).clamp(min=1)
    thr = top.gather(1, (k - 1)[:, None])
    speck = free & (score >= thr[:, :, None])
    del noise, score, top
    # each speck dark, grey-white or warm by a smooth field; one colour
    # at a time, so that a chunk holds one RGB field besides the image
    kind = _spectrum_field(gen, m, H, W, blur, device)
    dark = speck & (kind < -0.4)
    grey = speck & ~(kind < -0.4) & (kind < 0.4)
    img = torch.where(dark[..., None], _hsv_to_rgb(
        torch.zeros_like(kind), torch.zeros_like(kind),
        0.04 + 0.05 * torch.sigmoid(kind)), img)
    img = torch.where(grey[..., None], _hsv_to_rgb(
        torch.zeros_like(kind), 0.05 * torch.sigmoid(kind),
        0.7 + 0.2 * torch.sigmoid(kind)), img)
    img = torch.where((speck & ~dark & ~grey)[..., None], _hsv_to_rgb(
        torch.full_like(kind, 15.0), 0.7 + 0.0 * kind,
        0.55 + 0.3 * torch.sigmoid(kind)), img)
    del kind, dark, grey
    # the object and the distractors: a hue each, a 1/f luma texture
    tex = _spectrum_field(gen, m, H, W, _pink(f, 1.0, H, W), device)
    hj = _spectrum_field(gen, m, H, W, _pink(f, 2.0, H, W), device)
    hues, sats, vals = (_t(q[k_][sl], device) for k_ in ("hue", "sat", "val"))
    layers = [obj] + [dis[:, d] for d in range(dis.shape[1])]
    for j, mask in enumerate(layers):
        h = torch.remainder(hues[:, j, None, None] + 3.0 * hj.clamp(-2, 2),
                            180.0)
        vv = (vals[:, j, None, None] * (1 + 0.25 * tex.clamp(-3, 3))) \
            .clamp(0.05, 1)
        rgb = _hsv_to_rgb(h, sats[:, j, None, None].expand(m, H, W), vv)
        del h, vv
        img = torch.where(mask[..., None], rgb, img)
        del rgb
    del tex, hj
    out = (img * 255).round().clamp(0, 255).to(torch.uint8).cpu().numpy()
    area = float(H * W)
    backdrop = backdrop.clamp(min=1)
    stats = {
        "object_share": (obj.flatten(1).sum(1) / area).cpu().numpy(),
        "distractor_shares": (dis.flatten(2).sum(2) / area).cpu().numpy(),
        "speck_share": (speck.flatten(1).sum(1) / backdrop).cpu().numpy(),
        "object_box": _box(obj).cpu().numpy(),
        # the clear backdrop, where specks may fall
        "free": free.cpu().numpy(),
    }
    return out, stats


def _box(mask):
    """[m, 4] float YOLO box (cx, cy, w, h, normalised) of each mask."""
    m, H, W = mask.shape
    rows, cols = mask.any(2), mask.any(1)
    iy = torch.arange(H, device=mask.device)
    ix = torch.arange(W, device=mask.device)
    y0 = torch.where(rows, iy, H).amin(1)
    y1 = torch.where(rows, iy, -1).amax(1) + 1
    x0 = torch.where(cols, ix, W).amin(1)
    x1 = torch.where(cols, ix, -1).amax(1) + 1
    return torch.stack([(x0 + x1) / (2 * W), (y0 + y1) / (2 * H),
                        (x1 - x0) / W, (y1 - y0) / H], 1).float()


def make(root: Path, n: int, groups: int, seed: int, p, device,
         workers: int, stats: list = None):
    """``n`` images and labels under ``root``, split into ``groups``
    directory pairs ``root/<g>/imgs``, ``root/<g>/labels`` of n // groups
    files each (``im_0000.jpg`` ...).  Returns the pairs and the mean
    JPEG size in bytes; ``stats``, when a list, receives each chunk's
    statistics (``draw_images``)."""
    rng = np.random.default_rng([seed, 1])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    q = draw_params(rng, n, p)
    per = n // groups
    dirs = []
    for g in range(groups):
        imgs, labels = root / str(g) / "imgs", root / str(g) / "labels"
        imgs.mkdir(parents=True)
        labels.mkdir(parents=True)
        dirs.append((imgs, labels))
    sizes, queued = [], []

    def write(arr, path):
        Image.fromarray(arr).save(path, quality=p["quality"], subsampling=2)
        return path.stat().st_size

    with ThreadPoolExecutor(max(1, workers)) as ex:
        for lo in range(0, n, CHUNK):
            hi = min(n, lo + CHUNK)
            arrs, st = draw_images(gen, q, lo, hi, p, device)
            if stats is not None:
                stats.append(st)
            for j, arr in enumerate(arrs):
                i = lo + j
                imgs, labels = dirs[min(i // per, groups - 1)]
                box = st["object_box"][j]
                (labels / f"im_{i:04d}.txt").write_text(
                    "0 " + " ".join(f"{v:.6f}" for v in box.tolist())
                    + "\n")
                queued.append(ex.submit(write, arr, imgs / f"im_{i:04d}.jpg"))
            while len(queued) > QUEUED:
                sizes.append(queued.pop(0).result())
        sizes += [f.result() for f in queued]
    return dirs, float(np.mean(sizes)) if sizes else math.nan

"""Datasets for the port's engine tests: small PNG images with YOLO labels,
made from a numpy seed in a temporary directory; and the helpers that hold
one engine's output directory against the other's.  jax is imported only
inside the helpers that run the JAX package, so the card tests can use the
datasets where jax is not installed."""

import json
from pathlib import Path

import numpy as np
from PIL import Image


def make_image(rng, h, w, channels=3):
    """A smooth image with a few random rectangles: uint8 [h, w, channels]
    (alpha, when present, is 0 outside one rectangle)."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(yy * 3 + xx) % 256, (xx * 2 + 40) % 256,
                    (yy + xx * 5) % 256], axis=-1).astype(np.uint8)
    for _ in range(3):
        y, x = rng.integers(0, h - 4), rng.integers(0, w - 4)
        img[y:y + rng.integers(2, h // 2), x:x + rng.integers(2, w // 2)] = \
            rng.integers(0, 256, 3)
    if channels == 4:
        alpha = np.zeros((h, w, 1), np.uint8)
        y, x = rng.integers(0, h // 3), rng.integers(0, w // 3)
        alpha[y:y + h // 2, x:x + w // 2] = 255
        img = np.concatenate([img, alpha], axis=-1)
    return img


def make_labels(rng, n_boxes, h, w):
    """``n_boxes`` YOLO lines whose boxes lie in the middle of the centred
    square window of the shorter side, so that a square crop holds them."""
    s = min(h, w)
    lines = []
    for _ in range(n_boxes):
        cx, cy = rng.uniform(-0.2, 0.2, 2) * s + (w / 2, h / 2)
        bw, bh = rng.uniform(0.05, 0.25, 2) * s
        lines.append(f"{rng.integers(0, 5)} {cx / w:.6f} {cy / h:.6f} "
                     f"{bw / w:.6f} {bh / h:.6f}")
    return "\n".join(lines) + "\n"


def make_dataset(root: Path, n: int, seed: int,
                 sizes=((48, 64), (64, 48), (56, 56), (40, 150))):
    """``n`` RGB PNGs under root/imgs with one to three boxes each under
    root/labels; the sizes cycle, so several canvas buckets occur."""
    rng = np.random.default_rng(seed)
    (root / "imgs").mkdir(parents=True)
    (root / "labels").mkdir()
    for i in range(n):
        h, w = sizes[i % len(sizes)]
        Image.fromarray(make_image(rng, h, w)).save(
            root / "imgs" / f"im_{i:03d}.png")
        (root / "labels" / f"im_{i:03d}.txt").write_text(
            make_labels(rng, int(rng.integers(1, 4)), h, w))
    return root / "imgs", root / "labels"


def reports(root):
    """Every step's report entries under ``root`` with the run's root taken
    out, by report file name."""
    out = {}
    for path in sorted(Path(root).rglob("*.json")):
        if path.name.endswith(".metrics.json"):
            continue
        entries = json.loads(path.read_text().replace(str(root), "ROOT"))
        out[path.name] = sorted(entries, key=lambda e: e["inputs"])
    return out


def assert_same_files(jdir, tdir, n_files, named=(), levels=1):
    """The two directories hold the same ``n_files`` names; label files are
    equal as text, images equal in shape and decoded pixels (file bytes are
    not compared: the encoders may differ).  Images in ``named`` (items a
    documented delta touches) must agree in shape, to ``levels`` grey
    levels everywhere and in 95 % of their values; with ``levels=None``
    (a lossy re-encoding of such an item) in shape only.  Returns the
    names."""
    names = sorted(p.name for p in Path(jdir).iterdir() if p.is_file())
    assert sorted(p.name for p in Path(tdir).iterdir()
                  if p.is_file()) == names
    assert len(names) == n_files, names
    for name in names:
        if name.endswith(".txt"):
            assert (tdir / name).read_text() == (jdir / name).read_text()
            continue
        got = np.asarray(Image.open(tdir / name))
        want = np.asarray(Image.open(jdir / name))
        assert got.shape == want.shape, name
        if name in named and levels is None:
            continue
        if name in named:
            assert np.abs(got.astype(int) - want).max() <= levels, name
            assert (got == want).mean() >= 0.95, name
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
    return names


def jax_box_weights(sigma, passes=3, max_radius=12):
    """The constants of the JAX gaussian_blur (photometric.py:183-193), its
    lines as they stand, to be run eagerly or under jit."""
    import jax.numpy as jnp

    sig = jnp.maximum(jnp.asarray(sigma, jnp.float32), 1e-6)
    sigma2 = sig * sig / passes
    L = jnp.sqrt(12.0 * sigma2 + 1.0)
    l = jnp.floor((L - 1.0) / 2.0)
    a = (2 * l + 1) * (l * (l + 1) - 3 * sigma2)
    a = a / (6 * (sigma2 - (l + 1) * (l + 1)))
    fr = l + a
    r = jnp.minimum(fr.astype(jnp.int32), max_radius)
    ww = (jnp.float32(1 << 24) / (fr * 2 + 1)).astype(jnp.uint32)
    fw = (jnp.uint32(1 << 24)
          - (2 * r + 1).astype(jnp.uint32) * ww) // jnp.uint32(2)
    return r, ww, fw


def blur_differs_under_jit(sigmas):
    """F5: for each sigma, whether the jitted JAX blur's box weights differ
    from the eager ones (which are Pillow's and the port's).  A blurred
    item of a jitted JAX run with such a sigma may differ from the port's
    by one grey level on a few percent of its values."""
    import jax

    sigmas = np.asarray(sigmas, np.float32)
    with jax.disable_jit():
        eager = [np.asarray(v) for v in jax_box_weights(sigmas)]
    jitted = [np.asarray(v) for v in jax.jit(jax_box_weights)(sigmas)]
    return np.any([e != j for e, j in zip(eager, jitted)], axis=0)

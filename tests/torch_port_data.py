"""Datasets for the port's engine tests: small PNG images with YOLO labels,
made from a numpy seed in a temporary directory."""

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

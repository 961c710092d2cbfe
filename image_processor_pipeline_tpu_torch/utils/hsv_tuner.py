"""Interactive HSV threshold tuner (port of
image_processor_pipeline_tpu/utils/hsv_tuner.py; reference
atomize/test_seuil.py:17-47).

A human-in-the-loop matplotlib viewer for picking cv2-scale inRange bounds:
shows original / mask / masked-result side by side.  The HSV conversion
and the range test run on ``device``, the card unless the caller asks for
the CPU; the viewer is gated on matplotlib being importable.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np


def preview_hsv_mask(
    image_path: Path,
    lower: Sequence[float],
    upper: Sequence[float],
    show: bool = True,
    device="cuda",
):
    """Render (original, mask, result) panels for one HSV range.

    The mask is computed on ``device`` ("cuda" by default; raises when no
    card is there, "cpu" on request).  Returns the (image, mask, result)
    numpy arrays; with ``show`` and matplotlib available, also opens the
    3-panel figure like the reference tuner.
    """
    import torch

    from image_processor_pipeline_tpu_torch.io.images import decode_image
    from image_processor_pipeline_tpu_torch.ops import color as color_ops

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"preview_hsv_mask: device={str(device)!r} but "
            "torch.cuda.is_available() is false; pass device='cpu' to "
            "compute on the CPU")
    img = decode_image(Path(image_path), mode="RGB")
    hsv = color_ops.rgb_to_hsv_u8(torch.from_numpy(img).to(device))
    mask = color_ops.in_range(hsv, lower, upper).cpu().numpy()
    result = np.where(mask[..., None], img, 0).astype(np.uint8)

    if show:
        try:
            import matplotlib.pyplot as plt
        except ImportError:
            print("[hsv_tuner] matplotlib not available; returning arrays only")
            return img, mask, result
        fig, axes = plt.subplots(1, 3, figsize=(15, 5))
        axes[0].imshow(img)
        axes[0].set_title("original")
        axes[1].imshow(mask, cmap="gray")
        axes[1].set_title(f"mask {tuple(lower)}..{tuple(upper)}")
        axes[2].imshow(result)
        axes[2].set_title("result")
        for ax in axes:
            ax.axis("off")
        plt.tight_layout()
        plt.show()
    return img, mask, result

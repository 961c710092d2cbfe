"""Video frame extraction — streaming host source (port of
image_processor_pipeline_tpu/transforms/video.py).

Behavior parity with reference video.py:6-48 (frame_extraction):
  - creates ``output_dirs[0]/{video stem}/0-raw/`` itself (video.py:17-20)
  - validates the suffix against YOLO VID_FORMATS
  - writes every frame as ``{file_basename}-frame_{i:04d}.jpg``, 1-indexed
  - returns the created directory (the reference's deliberate contract
    deviation, video.py:48)

Decoding is cv2.VideoCapture (FFmpeg) when cv2 is installed, else
imageio; either way a host step (``ProcessingStep``'s ``_run_host``) whose
frames feed the batched device steps downstream.  Frames are encoded with
``io/images.encode_image`` (the native encoder, else Pillow; q95).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, List, Optional

from image_processor_pipeline_tpu_torch.utils.utils import VID_FORMATS


def frame_extraction(
    video_path: Path,
    output_dirs: List[Path],
    file_basename: str = None,
    **options: Any,
) -> Optional[Path]:
    if not file_basename:
        raise ValueError("file_basename is required to name the frames")
    video_path = Path(video_path)
    if video_path.suffix[1:].lower() not in VID_FORMATS:
        raise ValueError(
            f"video format {video_path.suffix} not supported; "
            f"allowed: {sorted(VID_FORMATS)}"
        )
    output_dir = Path(output_dirs[0]) / video_path.stem / "0-raw"
    output_dir.mkdir(parents=True, exist_ok=True)

    from image_processor_pipeline_tpu_torch.io.images import encode_image

    count = 0
    for count, frame in enumerate(iter_frames(video_path), start=1):
        encode_image(frame, output_dir / f"{file_basename}-frame_{count:04d}.jpg")
    if count == 0:
        raise RuntimeError(f"could not read any frame from {video_path.name}")
    return output_dir


def iter_frames(video_path: Path):
    """Yield RGB uint8 HWC frames sequentially (streaming, bounded memory)."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        cap = cv2.VideoCapture(str(video_path))
        if not cap.isOpened():
            raise RuntimeError(f"cannot open video {video_path}")
        try:
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                yield frame[:, :, ::-1]  # BGR → RGB
        finally:
            cap.release()
        return
    try:
        import imageio.v3 as iio
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "no video backend available (cv2 or imageio required)"
        ) from e
    for frame in iio.imiter(video_path):
        yield frame

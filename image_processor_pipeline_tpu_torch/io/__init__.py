from image_processor_pipeline_tpu_torch.io.images import (
    decode_image,
    encode_image,
    list_files,
)
from image_processor_pipeline_tpu_torch.io.labels import read_yolo_labels, write_yolo_labels
from image_processor_pipeline_tpu_torch.io.batching import Bucketizer, pad_to_canvas

__all__ = [
    "decode_image",
    "encode_image",
    "list_files",
    "read_yolo_labels",
    "write_yolo_labels",
    "Bucketizer",
    "pad_to_canvas",
]

from image_processor_pipeline_tpu_torch.transforms.base import BatchTransform
from image_processor_pipeline_tpu_torch.transforms.crop_square import SquareCropAroundBBox
from image_processor_pipeline_tpu_torch.transforms.rotations import RandomRotations
from image_processor_pipeline_tpu_torch.transforms.symmetry import GenerateSymmetries, ALL_SYMS
from image_processor_pipeline_tpu_torch.transforms.copy import copy_img_with_labels, copy_files
from image_processor_pipeline_tpu_torch.transforms.labels import change_label_class

__all__ = [
    "BatchTransform",
    "SquareCropAroundBBox",
    "RandomRotations",
    "GenerateSymmetries",
    "ALL_SYMS",
    "copy_img_with_labels",
    "copy_files",
    "change_label_class",
]

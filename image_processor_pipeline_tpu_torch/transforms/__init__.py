from image_processor_pipeline_tpu_torch.transforms.base import BatchTransform
from image_processor_pipeline_tpu_torch.transforms.crop_square import SquareCropAroundBBox
from image_processor_pipeline_tpu_torch.transforms.rotations import RandomRotations
from image_processor_pipeline_tpu_torch.transforms.symmetry import GenerateSymmetries, ALL_SYMS
from image_processor_pipeline_tpu_torch.transforms.enhance import EnhanceImage
from image_processor_pipeline_tpu_torch.transforms.filters import ColorMaskTransparency
from image_processor_pipeline_tpu_torch.transforms.overlays import PasteOverlayOntoBackground
from image_processor_pipeline_tpu_torch.transforms.recadrages import BorderCrop, FitCrop
from image_processor_pipeline_tpu_torch.transforms.cleanup import KeepLargestComponent
from image_processor_pipeline_tpu_torch.transforms.video import frame_extraction
from image_processor_pipeline_tpu_torch.transforms.copy import copy_img_with_labels, copy_files
from image_processor_pipeline_tpu_torch.transforms.labels import change_label_class
from image_processor_pipeline_tpu_torch.transforms.overlays_legacy import process_overlay_pair
from image_processor_pipeline_tpu_torch.transforms.fused import FusedChain
from image_processor_pipeline_tpu_torch.transforms.rotsym import RotationsSymmetries
from image_processor_pipeline_tpu_torch.transforms.rotchain import RotationsChain
from image_processor_pipeline_tpu_torch.transforms.ovlborder import OverlaysBorderCrop
from image_processor_pipeline_tpu_torch.transforms.rotsymchain import RotSymChain
from image_processor_pipeline_tpu_torch.transforms.chainsym import ChainSymmetries
from image_processor_pipeline_tpu_torch.transforms.symchain import SymmetriesChain
from image_processor_pipeline_tpu_torch.transforms.rotchainsym import (
    RotationsChainSymmetries,
)
from image_processor_pipeline_tpu_torch.transforms.symchainsym import (
    SymmetriesChainSymmetries,
)

__all__ = [
    "BatchTransform",
    "SquareCropAroundBBox",
    "RandomRotations",
    "GenerateSymmetries",
    "ALL_SYMS",
    "EnhanceImage",
    "ColorMaskTransparency",
    "PasteOverlayOntoBackground",
    "BorderCrop",
    "FitCrop",
    "KeepLargestComponent",
    "frame_extraction",
    "copy_img_with_labels",
    "copy_files",
    "change_label_class",
    "process_overlay_pair",
    "FusedChain",
    "RotationsSymmetries",
    "RotationsChain",
    "OverlaysBorderCrop",
    "RotSymChain",
    "ChainSymmetries",
    "SymmetriesChain",
    "RotationsChainSymmetries",
    "SymmetriesChainSymmetries",
]

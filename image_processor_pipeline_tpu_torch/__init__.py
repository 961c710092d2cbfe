"""image_processor_pipeline_tpu_torch — the PyTorch/CUDA port of
image_processor_pipeline_tpu, for NVIDIA Hopper (H100, sm_90a).

Module names mirror the JAX package so each counterpart is easy to find:
``pipeline`` (the engine: ``ProcessingPipeline`` of ``ProcessingStep``s over
directories of images and YOLO labels), ``pairing``, ``io`` (decode, encode,
labels, bucketing), ``transforms`` (``SquareCropAroundBBox``,
``RandomRotations``, ``GenerateSymmetries``, ``ColorMaskTransparency``,
``KeepLargestComponent``, ``EnhanceImage``, ``BorderCrop``, ``FitCrop``,
``FusedChain`` with its stages in ``transforms.fused``,
``PasteOverlayOntoBackground``, ``OverlaysBorderCrop``,
``RotationsSymmetries``, ``RotationsChain``, the symmetry fan-out
composites ``RotSymChain``, ``ChainSymmetries``, ``SymmetriesChain``,
``RotationsChainSymmetries`` and ``SymmetriesChainSymmetries``, and the
host steps with ``frame_extraction`` and ``process_overlay_pair``),
``fuse`` (the step fuser behind ``ProcessingPipeline.run(auto_fuse=...)``),
``random``
(jax.random's threefry draws, bit-exact), ``ops.*`` (plain torch twins of
the JAX ops, ``ops.ccl`` the connected components, ``ops.compose`` the
alpha paste, ``geometry.resize`` Pillow's fixed-point resample),
``ops.augment`` and ``ops.rotate`` (the wrappers around the
hand-written CUDA kernels in ``csrc/``), ``kernels`` (nvcc build and ctypes
binding), ``models.chains`` (the flagship chain as an ``nn.Module``),
``utils`` and ``interop`` (carries the JAX package's draws across).

Steps compute on ``device="cuda"`` unless told ``device="cpu"``.  Not ported
yet: the device JPEG codec, the native C++ twins, meshes, the CLI and
``config``.
"""

from image_processor_pipeline_tpu_torch.pipeline import ProcessingPipeline, ProcessingStep
from image_processor_pipeline_tpu_torch.pairing import MODES

__version__ = "0.1.0"

__all__ = ["ProcessingPipeline", "ProcessingStep", "MODES", "__version__"]

from image_processor_pipeline_tpu_torch.utils.utils import (
    check_path,
    validate_dirs,
    save_yolo_pair,
)

__all__ = ["check_path", "validate_dirs", "save_yolo_pair"]

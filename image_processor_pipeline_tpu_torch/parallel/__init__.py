from image_processor_pipeline_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    shard_batch,
    sharded_augment_step,
)

__all__ = ["Mesh", "make_mesh", "shard_batch", "sharded_augment_step"]

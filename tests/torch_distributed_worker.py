"""Worker process for the port's multi-process test
(tests/test_torch_distributed.py).

Usage: python torch_distributed_worker.py <coordinator> <nproc> <pid> <root>

Joins a gloo process group, runs a host-sharded batched step on the CPU
over the shared dataset with an in-process mesh of two CPU entries, writes
the per-process JSON report, and sums the item counts over the processes
(``global_counter``: an all_reduce).  Imports neither jax nor the JAX
package.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    coordinator, nproc, pid, root = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4])
    )
    import torch

    torch.set_num_threads(1)
    from image_processor_pipeline_tpu_torch import ProcessingStep
    from image_processor_pipeline_tpu_torch.parallel import distributed
    from image_processor_pipeline_tpu_torch.transforms.crop_square import (
        SquareCropAroundBBox,
    )

    distributed.initialize_distributed(
        coordinator_address=coordinator, num_processes=nproc, process_id=pid
    )
    assert distributed.process_count() == nproc
    assert distributed.process_index() == pid

    step = ProcessingStep(
        name="crop",
        process_function=SquareCropAroundBBox(),
        input_dirs=[root / "imgs", root / "labels"],
        output_dirs=[root / "out/i", root / "out/l"],
        pairing_method="zip",
        seed=11,
        save_log=True,
        host_sharded=True,
        # an in-process mesh composed with the cross-process sharding
        mesh=2,
        device="cpu",
    )
    counter = step.run(progress=False)
    local = sum(counter.values())
    total = distributed.global_counter(local)
    print(f"WORKER {pid}: local={local} global={total} "
          f"items/s={step.metrics.items_per_second:.1f}", flush=True)
    assert total == 6, total
    assert "jax" not in sys.modules
    distributed.barrier()
    distributed.shutdown()


if __name__ == "__main__":
    main()

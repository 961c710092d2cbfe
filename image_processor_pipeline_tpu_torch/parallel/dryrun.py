"""Entry points of the port: the chain's forward step and a multi-device
dry run (the counterparts of the repository's ``__graft_entry__.py``
``entry`` and ``dryrun_multichip``).

    python -m image_processor_pipeline_tpu_torch.parallel.dryrun
    python -m image_processor_pipeline_tpu_torch.parallel.dryrun \\
        --multichip 8 --device cpu
"""

from __future__ import annotations

import argparse
import functools
import tempfile
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch


def entry(device="cuda"):
    """(fn, example_args): the flagship chain's forward step in the mode
    that stands for JAX's XLA 'shear' (mesh.default_rotation), with the
    example batch of ``AugmentChain`` on ``device``."""
    from image_processor_pipeline_tpu_torch.models.chains import (
        CROP, AugmentChain, augment_chain)
    from image_processor_pipeline_tpu_torch.parallel.mesh import (
        default_rotation)

    device = torch.device(device)
    chain = AugmentChain(input_size=640, device=device)
    images, xywhn, seeds = chain.example_inputs(batch=8)
    fn = functools.partial(augment_chain, crop=CROP,
                           rotation=default_rotation(device.type))
    return fn, (images, xywhn, seeds)


def dryrun_multichip(n_devices: int, device="cuda",
                     devices: Optional[Sequence] = None) -> None:
    """Run ONE multi-device chain step over an n-device mesh (data ×
    model) on tiny shapes, then one files-in/files-out engine step with
    that many devices.  The pool is the first ``n_devices`` cards (it
    raises when there are fewer), ``n_devices`` CPU handles for
    ``device="cpu"`` (the counterpart of JAX's virtual CPU devices), or
    ``devices``."""
    from PIL import Image

    from image_processor_pipeline_tpu_torch.parallel.mesh import (
        local_devices, make_mesh, sharded_augment_step)
    from image_processor_pipeline_tpu_torch.pipeline import (
        ProcessingPipeline, ProcessingStep)
    from image_processor_pipeline_tpu_torch.transforms.fused import (
        Enhance, FusedChain, Rotate)

    device = torch.device(device)
    if devices is None:
        devices = (local_devices() if device.type == "cuda"
                   else [device] * n_devices)
    # 2-D mesh: batch over 'data', image rows over 'model' when n allows
    if n_devices % 2 == 0 and n_devices > 2:
        shape = (n_devices // 2, 2)
    else:
        shape = (n_devices, 1)
    mesh = make_mesh(n_devices, shape=shape, devices=devices)

    # tiny shapes: a 64px crop from 96px inputs, batch divisible by data axis
    batch = shape[0] * 2
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, size=(batch, 96, 96, 3), dtype=np.uint8)
    xywhn = np.tile(np.asarray([0.5, 0.5, 0.2, 0.2], np.float32), (batch, 1))
    seeds = np.arange(batch, dtype=np.uint32)

    step = sharded_augment_step(mesh, crop=64)
    out, count = step(images, xywhn, seeds)
    if tuple(out.shape) != (batch, 64, 64, 4) or int(count) != batch:
        raise RuntimeError(f"dryrun_multichip: out {tuple(out.shape)}, "
                           f"count {int(count)}; expected ({batch}, 64, 64, "
                           f"4) and {batch}")
    print(f"dryrun_multichip OK: mesh {mesh.shape}, out "
          f"{tuple(out.shape)} on {out.device}")

    # engine-level data parallelism: a real files-in/files-out step with
    # a mesh fans each bucket batch over the devices
    engine_mesh = make_mesh(n_devices, devices=devices)
    with tempfile.TemporaryDirectory() as td:
        src = Path(td) / "in"
        src.mkdir()
        for i in range(n_devices + 3):  # non-multiple: exercises padding
            arr = rng.integers(0, 256, (40, 52, 3), np.uint8)
            Image.fromarray(arr).save(src / f"im{i}.png")
        pipe = ProcessingPipeline(root_dir=Path(td))
        pipe.add_step(ProcessingStep(
            name="mesh_chain",
            process_function=FusedChain([Rotate(method="shear"), Enhance()]),
            input_dirs=["in"], output_dirs=["out"], seed=5,
            mesh=engine_mesh, device=mesh.device_type,
        ))
        counters = pipe.run(progress=False)
        n_ok = counters[0]["Success"]
        if n_ok != n_devices + 3:
            raise RuntimeError(f"dryrun_multichip: engine step {counters}")
        print(f"engine mesh OK: {n_ok} items through ProcessingStep(mesh=...) "
              f"over {n_devices} devices")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multichip", type=int, metavar="N",
                    help="dry-run the multi-device step over N devices")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.multichip:
        dryrun_multichip(args.multichip, device=args.device)
    else:
        fn, example = entry(args.device)
        out = fn(*example)
        print("entry OK:", tuple(out.shape), out.dtype)


if __name__ == "__main__":
    main()

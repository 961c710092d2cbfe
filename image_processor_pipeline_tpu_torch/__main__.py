"""Command-line entry point: run declarative pipeline configs (port of
image_processor_pipeline_tpu/__main__.py).

The same JSON configs as the JAX package's CLI (config.py), run on the
card unless ``--device cpu`` says otherwise:

    python -m image_processor_pipeline_tpu_torch run config.json
        [--root DIR] [--device cuda|cpu] [--no-progress] [--auto-fuse]
        [--fuse-tier byte|rng] [--strict]
        [--coordinator HOST:PORT --num-processes N --process-id I]
    python -m image_processor_pipeline_tpu_torch validate config.json
    python -m image_processor_pipeline_tpu_torch transforms
    python -m image_processor_pipeline_tpu_torch example > config.json

Exit status: 0 on completion (per-item failures are logged per the
reference's fault-tolerance contract); ``--strict`` returns 1 when any
item ended in an Error/Type Error status.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def _cmd_run(args) -> int:
    from image_processor_pipeline_tpu_torch.parallel import distributed

    if args.coordinator:
        # multi-process data parallelism: each process runs the SAME
        # config with host_sharded steps (which require a seed) keeping
        # items i % num_processes == process_id; per-process JSON reports
        # merge via parallel.distributed.merge_host_reports
        distributed.initialize_distributed(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
        )

    from image_processor_pipeline_tpu_torch.config import (
        PipelineConfig,
        build_pipeline,
    )

    cfg = PipelineConfig.from_json_file(args.config)
    if args.root:
        cfg.root_dir = args.root
    if args.device:
        for sc in cfg.steps:
            sc.device = args.device
    pipe = build_pipeline(cfg)
    counters = pipe.run(
        progress=not args.no_progress,
        auto_fuse=args.fuse_tier if args.auto_fuse else False)
    # --auto-fuse may run FEWER steps than configured (fused runs
    # replace their constituents): pair names with what actually ran
    ran = getattr(pipe, "last_run_steps", pipe.steps)
    if args.coordinator:
        # every process wrote <step>.host<rank>.json; after a barrier,
        # rank 0 reconstructs the reference-schema <step>.json report
        distributed.barrier()
        if distributed.process_index() == 0:
            for step in ran:
                if step.host_sharded and step.save_log and step.output_paths:
                    merged = distributed.merge_host_reports(
                        step.name, Path(step.output_paths[0]).parent,
                        n_hosts=distributed.process_count())
                    print(f"{step.name}: merged report -> {merged}")
        distributed.shutdown()
    bad = 0
    for step, counter in zip(ran, counters):
        summary = ", ".join(f"{k}: {v}" for k, v in sorted(counter.items()))
        print(f"{step.name}: {summary}")
        bad += sum(v for k, v in counter.items()
                   if k not in ("Success", "no_output"))
    if args.strict and bad:
        print(f"{bad} item(s) failed", file=sys.stderr)
        return 1
    return 0


def _cmd_validate(args) -> int:
    from image_processor_pipeline_tpu_torch.config import (
        PipelineConfig,
        build_pipeline,
    )

    cfg = PipelineConfig.from_json_file(args.config)
    if args.root:
        cfg.root_dir = args.root
    pipe = build_pipeline(cfg)  # resolves every transform / pairing fn
    for step in pipe.steps:
        fn = step.process_function
        kind = type(fn).__name__ if not callable(fn) or hasattr(
            fn, "device_fn") else getattr(fn, "__name__", str(fn))
        print(f"  {step.name}: {kind} "
              f"{[str(p) for p in step.input_paths]} -> "
              f"{[str(p) for p in step.output_paths]} "
              f"({step.pairing_method})")
    print(f"OK: {len(pipe.steps)} step(s) resolved")
    return 0


def _cmd_transforms(_args) -> int:
    from image_processor_pipeline_tpu_torch.config import TRANSFORM_REGISTRY

    for key, spec in sorted(TRANSFORM_REGISTRY.items()):
        print(f"  {key:24s} {spec}")
    return 0


#: the starter config that ``example`` prints (the JAX CLI's)
EXAMPLE = {
    "root_dir": "dataset",
    "steps": [
        {
            "name": "crop",
            "transform": "square_crop_around_bbox",
            "input_dirs": ["imgs", "labels"],
            "output_dirs": ["crops/imgs", "crops/labels"],
            "pairing_method": "zip",
            "seed": 0,
            "save_log": True,
        },
        {
            "name": "rotate",
            "transform": "rotations",
            "input_dirs": ["crops/imgs"],
            "output_dirs": ["rotated"],
            "options": {"num_rotations": 5},
            "seed": 0,
        },
    ],
}


def _cmd_example(_args) -> int:
    print(json.dumps(EXAMPLE, indent=2))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m image_processor_pipeline_tpu_torch",
        description=__doc__.split("\n\n")[0],
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_run = sub.add_parser("run", help="build and run a pipeline config")
    p_run.add_argument("config", help="JSON pipeline config path")
    p_run.add_argument("--root", help="override the config's root_dir")
    p_run.add_argument("--device", choices=("cuda", "cpu"),
                       help="run every step on this device (default: "
                            "each step's 'device', 'cuda' unless set)")
    p_run.add_argument("--no-progress", action="store_true")
    # a plain store_true + a separate tier flag: an optional-value
    # --auto-fuse (nargs='?') would consume a following positional, so
    # 'run --auto-fuse cfg.json' would break
    p_run.add_argument("--auto-fuse", action="store_true",
                       help="collapse eligible consecutive deterministic "
                            "steps into one fused step (byte-identical "
                            "final outputs; intermediate dirs are not "
                            "written — see fuse.py)")
    p_run.add_argument("--fuse-tier", choices=("byte", "rng"),
                       default="byte",
                       help="with --auto-fuse: 'rng' additionally fuses "
                            "RNG stages (final-position enhance tails, "
                            "sub-pool symmetry sampling, overlays→border "
                            "crop) — equally-distributed, NOT byte-equal")
    p_run.add_argument("--strict", action="store_true",
                       help="exit 1 if any item failed")
    p_run.add_argument("--coordinator", metavar="HOST:PORT",
                       help="torch.distributed rendezvous (rank 0 listens "
                            "there) for multi-process runs (pair with "
                            "host_sharded steps)")
    p_run.add_argument("--num-processes", type=int, default=None)
    p_run.add_argument("--process-id", type=int, default=None)
    p_run.set_defaults(fn=_cmd_run)

    p_val = sub.add_parser(
        "validate", help="resolve a config without running it")
    p_val.add_argument("config")
    p_val.add_argument("--root")
    p_val.set_defaults(fn=_cmd_validate)

    p_tr = sub.add_parser("transforms", help="list built-in transforms")
    p_tr.set_defaults(fn=_cmd_transforms)

    p_ex = sub.add_parser("example", help="print an example config")
    p_ex.set_defaults(fn=_cmd_example)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

"""Declarative pipeline configs (port of
image_processor_pipeline_tpu/config.py).

The reference configures everything through constructor arguments plus a
free-form per-stage options dict (reference pipeline.py:16-28, 55).  This
module keeps that two-level shape but adds a serializable layer: a pipeline
can be described as a dataclass tree / plain dict / JSON file and built
with `build_pipeline`, so runs are reproducible from a checked-in config.

Transform names map to the registry below, which has the JAX package's
keys: a config written for its CLI runs unchanged here.  Host callables
can be referenced by dotted path; a path into the JAX package is refused
with its counterpart here named, since the port never imports that
package.  ``StepConfig.device`` ("cuda" unless a config says "cpu") is
the counterpart of the JAX CLI's ``--platform``.
"""

from __future__ import annotations

import importlib
import json
from dataclasses import dataclass, field, asdict
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

from image_processor_pipeline_tpu_torch.pipeline import ProcessingPipeline, ProcessingStep

#: the JAX package, whose dotted paths a config may not name
_JAX_PACKAGE = "image_processor_pipeline_tpu"
_PORT = "image_processor_pipeline_tpu_torch"

#: registry of built-in transforms (class → instantiated per step)
TRANSFORM_REGISTRY = {
    "square_crop_around_bbox": _PORT + ".transforms.crop_square:SquareCropAroundBBox",
    "rotations": _PORT + ".transforms.rotations:RandomRotations",
    "symmetries": _PORT + ".transforms.symmetry:GenerateSymmetries",
    "enhance": _PORT + ".transforms.enhance:EnhanceImage",
    "color_mask": _PORT + ".transforms.filters:ColorMaskTransparency",
    "overlay": _PORT + ".transforms.overlays:PasteOverlayOntoBackground",
    "border_crop": _PORT + ".transforms.recadrages:BorderCrop",
    "fit_crop": _PORT + ".transforms.recadrages:FitCrop",
    "cleanup": _PORT + ".transforms.cleanup:KeepLargestComponent",
    "frame_extraction": _PORT + ".transforms.video:frame_extraction",
    "copy_img_with_labels": _PORT + ".transforms.copy:copy_img_with_labels",
    "copy_files": _PORT + ".transforms.copy:copy_files",
    "change_label_class": _PORT + ".transforms.labels:change_label_class",
    # no-arg fused fan-out composites (the stage-parameterized chains —
    # FusedChain/RotationsChain/... — are reached by writing per-stage
    # steps and running with --auto-fuse instead)
    "rotations_symmetries": _PORT + ".transforms.rotsym:RotationsSymmetries",
    "overlay_border_crop": _PORT + ".transforms.ovlborder:OverlaysBorderCrop",
}


@dataclass
class StepConfig:
    """Every ProcessingStep.__init__ knob, JSON-serializable.

    ``transform`` and ``pairing_function`` take a registry key or a dotted
    ``module:attr`` path, so custom callables round-trip through configs.
    """

    name: str
    transform: str                       # registry key or "module:attr"
    input_dirs: List[str] = field(default_factory=list)
    output_dirs: List[str] = field(default_factory=list)
    pairing_method: str = "one_input"
    pairing_function: Optional[str] = None   # "module:attr" for 'custom'
    fixed_input: bool = False
    root_dir: Optional[str] = None           # per-step override
    sample_k: Optional[int] = None
    save_log: bool = False
    workers: int = 1
    seed: Optional[int] = None
    overwrite: str = "allow"
    trace_dir: Optional[str] = None
    retries: int = 0
    resume: bool = False
    host_sharded: bool = False
    #: in-process multi-device data parallelism: None | "auto" | int
    #: (a prebuilt Mesh is constructor-only — not JSON-serializable)
    mesh: Optional[Any] = None
    options: Dict[str, Any] = field(default_factory=dict)
    #: where the step's batched transform computes: "cuda" or "cpu"
    device: str = "cuda"


@dataclass
class PipelineConfig:
    root_dir: Optional[str] = None
    steps: List[StepConfig] = field(default_factory=list)

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=2)

    @staticmethod
    def from_dict(d: Dict) -> "PipelineConfig":
        steps = [StepConfig(**s) for s in d.get("steps", [])]
        return PipelineConfig(root_dir=d.get("root_dir"), steps=steps)

    @staticmethod
    def from_json_file(path: Union[str, Path]) -> "PipelineConfig":
        return PipelineConfig.from_dict(json.loads(Path(path).read_text()))


def _resolve_dotted(spec: str, what: str = "transform"):
    if ":" not in spec:
        raise ValueError(
            f"unknown {what} {spec!r}; registry keys: "
            f"{sorted(TRANSFORM_REGISTRY)} or use 'module:attr'"
        )
    mod_name, attr = spec.split(":", 1)
    if mod_name.split(".")[0] == _JAX_PACKAGE:
        raise ValueError(
            f"{what} {spec!r} names the JAX package, which the port never "
            f"imports; its counterpart is "
            f"{_PORT + mod_name[len(_JAX_PACKAGE):]}:{attr}")
    return getattr(importlib.import_module(mod_name), attr)


def _resolve_transform(spec: str):
    obj = _resolve_dotted(TRANSFORM_REGISTRY.get(spec, spec))
    return obj() if isinstance(obj, type) else obj


def _spec_for(fn) -> str:
    """Dotted module:attr spec for a callable/instance (registry key when
    one matches), so pipelines round-trip back into configs.

    Raises for things a config CANNOT faithfully rebuild — nested callables
    (unreachable qualnames) and transform instances whose constructor takes
    required arguments (their state would be silently dropped)."""
    import inspect
    import types

    if isinstance(fn, (types.FunctionType, type)):
        spec = f"{fn.__module__}:{fn.__qualname__}"
        if "<locals>" in fn.__qualname__ or "<lambda>" in fn.__qualname__:
            raise ValueError(
                f"{fn!r} is a nested/lambda callable and cannot be "
                "referenced from a config; use a module-level function"
            )
    else:  # transform instance → its class
        cls = type(fn)
        spec = f"{cls.__module__}:{cls.__qualname__}"
        required = [
            p.name
            for p in inspect.signature(cls.__init__).parameters.values()
            if p.name != "self"
            and p.default is inspect.Parameter.empty
            and p.kind not in (inspect.Parameter.VAR_POSITIONAL,
                               inspect.Parameter.VAR_KEYWORD)
        ]
        if required:
            raise ValueError(
                f"{cls.__qualname__} takes required constructor arguments "
                f"{required}; its instance state cannot round-trip through "
                "a config — construct it in code or wrap it in a "
                "zero-argument subclass"
            )
    for key, target in TRANSFORM_REGISTRY.items():
        if target == spec:
            return key
    return spec


def build_pipeline(config: Union[PipelineConfig, Dict, str, Path]) -> ProcessingPipeline:
    """Build a runnable ProcessingPipeline from a config."""
    if isinstance(config, (str, Path)):
        config = PipelineConfig.from_json_file(config)
    elif isinstance(config, dict):
        config = PipelineConfig.from_dict(config)
    pipe = ProcessingPipeline(root_dir=config.root_dir)
    for sc in config.steps:
        pairing_fn = (
            _resolve_dotted(sc.pairing_function, "pairing_function")
            if sc.pairing_function else None
        )
        pipe.add_step(ProcessingStep(
            name=sc.name,
            process_function=_resolve_transform(sc.transform),
            input_dirs=sc.input_dirs or None,
            output_dirs=sc.output_dirs,
            pairing_method=sc.pairing_method,
            pairing_function=pairing_fn,
            fixed_input=sc.fixed_input,
            root_dir=sc.root_dir,
            sample_k=sc.sample_k,
            save_log=sc.save_log,
            workers=sc.workers,
            seed=sc.seed,
            overwrite=sc.overwrite,
            trace_dir=sc.trace_dir,
            retries=sc.retries,
            resume=sc.resume,
            host_sharded=sc.host_sharded,
            mesh=sc.mesh,
            options=sc.options,
            device=sc.device,
        ))
    return pipe


def config_from_pipeline(pipe: ProcessingPipeline) -> PipelineConfig:
    """Inverse of build_pipeline: serialize a live pipeline back into a
    PipelineConfig (config → pipeline → config round-trips)."""
    steps = []
    for s in pipe.steps:
        pf = s.pairing_function
        steps.append(StepConfig(
            name=s.name,
            transform=_spec_for(s.process_function),
            input_dirs=[str(p) for p in s.input_dirs],
            output_dirs=[str(p) for p in s.output_dirs],
            pairing_method=s.pairing_method,
            pairing_function=_spec_for(pf) if pf else None,
            fixed_input=s.fixed_input,
            root_dir=str(s.root_dir) if s.root_dir else None,
            sample_k=s.sample_k,
            save_log=s.save_log,
            workers=s.workers,
            seed=s.seed,
            overwrite=s.overwrite,
            trace_dir=str(s.trace_dir) if s.trace_dir else None,
            retries=s.retries,
            resume=s.resume,
            host_sharded=s.host_sharded,
            # only the JSON-serializable mesh specs round-trip
            mesh=s.mesh if isinstance(s.mesh, (str, int)) else None,
            options=dict(s.options),
            device=str(s.device),
        ))
    return PipelineConfig(
        root_dir=str(pipe.root_dir) if pipe.root_dir else None, steps=steps
    )

"""Automatic stage fusion — ``ProcessingPipeline.run(auto_fuse=True)``
(port of image_processor_pipeline_tpu/fuse.py).

Stage fusion runs a whole run of steps as one batched device call and one
materialization instead of a disk round-trip per stage.  A pipeline
migrated 1:1 from the reference (reference pipeline.py:538, 564-566 runs
every transform as its own directory-to-directory stage) is written as
per-stage steps and only gets fusion if the user hand-rewrites it around
transforms.fused.FusedChain.  ``auto_fuse=True`` does that rewrite
automatically at run time, exactly as the JAX engine does, with two
differences:

- steps compute on a ``device``: a run fuses only when all its steps name
  the same one (_engine_compatible), and the fused step carries it;
- ``mesh`` and the _ENGINE_KEYS options ride onto the fused step as they
  are, so a fused step raises the NotImplementedError its unfused steps
  would.

Fusion here is deliberately CONSERVATIVE: an eligible run of steps must
be *byte-invisible* to fuse — identical final files, with only the
intermediate directories left unwritten (that is the speedup).  A run of
consecutive steps fuses iff:

- every transform translates to a DETERMINISTIC FusedChain stage:
  ColorMaskTransparency -> ColorMask, KeepLargestComponent -> Cleanup,
  FitCrop -> FitCrop.  RNG transforms (rotations, enhance, symmetries)
  never auto-fuse: FusedChain stages draw from per-stage fold_in trees
  that differ from the standalone per-step trees, so their outputs are
  equally-distributed but not byte-equal — the user opts into that by
  writing FusedChain explicitly;
- the FIRST step is ColorMaskTransparency (always writes lossless RGBA
  ``.png`` intermediates, so every downstream stage sees exactly the
  pixels the fused canvas holds — a ``.jpg`` intermediate would be
  re-quantized between standalone stages and fusing would *change*
  bytes), OR the head's input directories already exist holding ONLY
  ``.png`` files (same losslessness argument, checked on disk), OR each
  head input dir is produced by exactly one EARLIER step of the run list
  whose transform provably writes only ``.png`` (step metadata — the dir
  may not exist yet at fuse time; see _writes_png_only);
- plain ``one_input`` pairing with default engine knobs (no sample_k,
  custom pairing, fixed_input pins, save_log, resume, tracing) and
  agreeing worker/retry/overwrite/mesh settings;
- strict directory chaining: each step reads exactly its predecessor's
  single output directory, and no other step in the run list reads or
  writes any elided intermediate directory (a writer scheduled before
  the fused position would have added files the standalone downstream
  step inventories);
- no elided intermediate directory already holds files: a standalone
  downstream step inventories the directory, so stale files from an
  earlier run would have been (re)processed by the unfused pipeline.

Two fan-out shapes also fuse (the 1→1 FusedChain stage model can't hold
them, so each gets its own transform):

- an adjacent rotations → symmetries pair collapses into a single
  ``RotationsSymmetries`` step (transforms/rotsym.py) when the
  intermediate is lossless ``.png`` and the symmetry selection is
  RNG-degenerate (``choose_random`` None or >= len(pool) saves the whole
  pool deterministically).  RandomRotations IS an RNG transform, but its
  tree rides the step seed the fuser copies over the unchanged input
  inventory, so the fused outputs stay byte-identical — the exception
  that proves the rule above;
- a rotations → {ColorMask, Cleanup, FitCrop}+ run collapses into a
  single ``RotationsChain`` step (transforms/rotchain.py): the same
  seed-tree-riding argument with a deterministic FusedChain-stage tail
  instead of flips;
- a deterministic chain run ENDING in a symmetries step collapses into
  a single ``ChainSymmetries`` step (transforms/chainsym.py): the chain
  computes once and the save half encodes the selected dihedrals as
  zero-copy flip views — byte-safe when the selection is RNG-degenerate
  (whole pool), like the rotsym pair;
- a symmetries step HEADING a deterministic run collapses into a single
  ``SymmetriesChain`` step (transforms/symchain.py): entirely draw-free
  — the fan-out happens on device and each variant runs the tail; the
  head inputs must be provably lossless 8-bit RGBA ``.png``;
- a rotations → tail → symmetries run collapses into a single
  ``RotationsChainSymmetries`` step (transforms/rotchainsym.py): the
  dihedral fan-out composes at the END of a rotations chain as flip
  views of each slot's tail result — so symmetry steps now fuse at
  every position of the lattice (head, mid, and tail).

Anything ineligible is simply left as-is; fusion never changes statuses
of successful items (per-item error MESSAGES can differ — e.g. the
standalone cleanup's "no opaque pixels" vs the chain's "empty content").

Reference behavior anchors: filtres_liste.py:109-138 (mask),
pixels_isolés.py:8-81 (cleanup), recadrages.py:63-82 (fit crop).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional, Tuple

from image_processor_pipeline_tpu_torch.io import native


def _norm(p) -> Path:
    """Normalize for identity comparisons: pathlib keeps '..' segments,
    so `c/../m` would not compare equal to `m` without this."""
    return Path(os.path.normpath(os.path.join(os.getcwd(), str(p))))


#: engine-level option keys that may ride along on any fusable step; they
#: must agree across the run and are carried onto the fused step
_ENGINE_KEYS = frozenset({
    "native_compute", "device_decode", "device_encode",
    "device_encode_cap",
})


def _xl_colormask(options) -> Optional[Tuple[object, frozenset]]:
    from image_processor_pipeline_tpu_torch.transforms.fused import ColorMask

    ranges = options.get("color_ranges_to_exclude_hsv")
    if not ranges:
        return None  # the per-step "no filters" error semantics stay
    if options.get("output_prefix"):
        return None  # prefixed names don't match the chain's {stem}.png
    return (
        # input_alpha='replace': the standalone step's cv2.imread re-decode
        # DROPS the intermediate file's alpha and recomputes it from RGB
        # alone (filtres_liste.py:84) — the chain default 'combine' (min
        # with carried alpha) would diverge on RGBA inputs holding
        # transparency
        ColorMask(ranges, zones=options.get("zones"),
                  use_gimp_scale=bool(options.get("use_gimp_scale", False)),
                  input_alpha="replace"),
        frozenset({"color_ranges_to_exclude_hsv", "zones",
                   "use_gimp_scale", "output_prefix"}),
    )


def _xl_cleanup(options) -> Optional[Tuple[object, frozenset]]:
    from image_processor_pipeline_tpu_torch.transforms.fused import Cleanup

    return (
        Cleanup(int(options.get("min_component_size", 500)),
                bool(options.get("keep_large_components", False))),
        frozenset({"min_component_size", "keep_large_components"}),
    )


def _xl_fitcrop(options) -> Optional[Tuple[object, frozenset]]:
    from image_processor_pipeline_tpu_torch.transforms.fused import FitCrop

    return FitCrop(), frozenset()


def _translators():
    from image_processor_pipeline_tpu_torch.transforms.cleanup import (
        KeepLargestComponent,
    )
    from image_processor_pipeline_tpu_torch.transforms.filters import (
        ColorMaskTransparency,
    )
    from image_processor_pipeline_tpu_torch.transforms.recadrages import FitCrop

    return {
        ColorMaskTransparency: _xl_colormask,
        KeepLargestComponent: _xl_cleanup,
        FitCrop: _xl_fitcrop,
    }


def _translate(step) -> Optional[Tuple[object, frozenset]]:
    """FusedChain stage for a step's transform, or None if ineligible."""
    fn = _translators().get(type(step.process_function))
    if fn is None:
        return None
    res = fn(step.options)
    if res is None:
        return None
    stage, known = res
    # an option key we don't model means semantics we can't prove fused
    if not set(step.options) <= (known | _ENGINE_KEYS):
        return None
    return stage, known


def _plain_engine_shape(step) -> bool:
    """Engine knobs a fused step can represent faithfully — the ONE list
    every fusion pass checks (a knob missing here could let a pass fuse
    a step whose semantics the fused form cannot reproduce)."""
    return (
        step.pairing_function is None
        and step.sample_k is None
        and not step.save_log
        and not getattr(step, "resume", False)
        and not getattr(step, "host_sharded", False)
        and getattr(step, "trace_dir", None) is None
    )


def _step_plain(step) -> bool:
    """Engine shape that chain fusion can represent (and elide)."""
    return step.pairing_method == "one_input" and _plain_engine_shape(step)


def _engine_compatible(a, b) -> bool:
    return (
        a.workers == b.workers
        and getattr(a, "retries", 0) == getattr(b, "retries", 0)
        and getattr(a, "overwrite", "allow") == getattr(b, "overwrite",
                                                        "allow")
        and getattr(a, "mesh", None) == getattr(b, "mesh", None)
        and getattr(a, "device", None) == getattr(b, "device", None)
        and {k: a.options.get(k) for k in _ENGINE_KEYS}
        == {k: b.options.get(k) for k in _ENGINE_KEYS}
    )


def _rgba_png(f: Path) -> bool:
    """Header probe: True iff ``f`` is an 8-bit RGBA ``.png``.

    The suffix alone is NOT enough for head byte-safety: the fused chain
    decodes everything ``mode="RGBA"`` (opaque alpha synthesized), while
    the standalone heads see native bands — an RGB png makes cleanup
    ERROR per item (no alpha channel, reference pixels_isolés.py:16-26)
    and gives fit-crop an RGB content bbox instead of the alpha-only
    one, so fusing would write files/bytes the unfused run would not.
    Grayscale/palette/16-bit/tRNS and unreadable files are declined
    conservatively too."""
    if f.suffix.lower() != ".png":
        return False
    meta = native.probe_bands(f)
    if meta is not None:
        return meta[2] == 4
    try:  # native engine unavailable: Pillow header-only fallback
        from PIL import Image

        with Image.open(f) as im:
            return im.mode == "RGBA"
    except Exception:  # noqa: BLE001 — unreadable file: decline
        return False


def _png_only_dir(path) -> bool:
    """True iff ``path`` exists and holds at least one file, all 8-bit
    RGBA ``.png`` (header-probed — see _rgba_png).

    Heading a fused run with cleanup/fit-crop is only byte-safe when the
    head's inputs are lossless (a ``.jpg`` intermediate would be
    re-quantized between standalone stages), RGBA (band divergence —
    _rgba_png), and cleanup's per-item "not a PNG" error semantics must
    be preserved — so anything but a provably all-RGBA-png pre-existing
    directory declines.  A directory that an EARLIER step of the same
    run will produce does not exist yet at fuse time and correctly fails
    this check."""
    p = Path(path)
    try:
        files = [f for f in p.iterdir() if f.is_file()]
    except OSError:
        return False
    return bool(files) and all(_rgba_png(f) for f in files)


def _dirs_clean(paths) -> bool:
    """No elided intermediate directory may ALREADY hold files: the
    standalone downstream step's inventory is a directory listing, so
    stale files from a previous run would have been (re)processed by the
    unfused pipeline — fusing would silently skip them."""
    for p in paths:
        try:
            if any(f.is_file() for f in Path(p).iterdir()):
                return False
        except (FileNotFoundError, NotADirectoryError):
            continue  # not there yet — the normal fused case
        except OSError:
            # unreadable (e.g. PermissionError): the dir may hold
            # stale files we cannot rule out — decline; the unfused
            # downstream step would have surfaced the problem loudly
            return False
    return True


def _elided_dirs_clean(steps_to_elide) -> bool:
    return _dirs_clean(p for s in steps_to_elide for p in s.output_paths)


#: RandomRotations options the fused pair models (everything the save and
#: compute halves read); ``output_format`` is checked separately (png only)
_ROT_KEYS = frozenset({
    "num_rotations", "angle_min", "angle_max", "method", "interpolation",
    "output_prefix", "original_key", "rotation_key_format",
    "include_original", "output_format",
})
#: GenerateSymmetries options the fused pair models
_SYM_KEYS = frozenset({"pool", "choose_random", "include_original"})


def _sym_step_pool(b, rng: bool = False) -> Optional[list]:
    """The validated symmetry pool when ``b`` is an eligible
    GenerateSymmetries step for fan-out fusion, else None — the ONE
    place the symmetry-step eligibility rule lives (shared by
    _rotsym_options and _fuse_rotsymchain, so the pair and 4-step
    passes can never disagree on the same step list).

    ``rng=False`` (byte tier) requires the RNG-degenerate selection:
    ``choose_random`` None or >= len(pool) saves the whole pool
    deterministically (reference symmetry.py:122-126)."""
    from image_processor_pipeline_tpu_torch.transforms.symmetry import (
        ALL_SYMS,
        GenerateSymmetries,
    )

    if type(b.process_function) is not GenerateSymmetries:
        return None
    if not (_step_plain(b) and not b.fixed_input
            and len(b.input_paths) == 1 and len(b.output_paths) == 1
            and set(b.options) <= (_SYM_KEYS | _ENGINE_KEYS)):
        return None
    pool = list(b.options.get("pool") or ALL_SYMS)
    if any(s not in ALL_SYMS for s in pool):
        return None  # standalone symmetry raises; keep that surface
    choose_random = b.options.get("choose_random")
    if not rng and choose_random is not None and choose_random < len(pool):
        return None  # random sub-pool: per-file seed tree can't be fused
    return pool


def _rotsym_options(a, b, rng: bool = False) -> Optional[dict]:
    """Fused-step options when (a, b) is an eligible
    rotations → symmetry pair, else None.

    Byte-safety (transforms/rotsym.py docstring has the full argument):
    the rotations half re-runs with the SAME seed tree over the same
    inventory; the elided intermediate must be lossless ``.png``; and the
    symmetry half must be RNG-degenerate — ``choose_random`` None or
    >= len(pool) selects the whole pool deterministically
    (reference symmetry.py:122-126).  ``rng=True`` (the opt-in
    ``auto_fuse="rng"`` tier) relaxes the last condition: sub-pool
    sampling then draws from a per-(item, rotation) tree — equally
    DISTRIBUTED but not byte-equal to the standalone per-file tree."""
    from image_processor_pipeline_tpu_torch.transforms.rotations import (
        RandomRotations,
    )

    # exact types: RotationsSymmetries itself subclasses RandomRotations
    if type(a.process_function) is not RandomRotations:
        return None
    if not (_step_plain(a)
            and len(a.input_paths) == 1 and len(a.output_paths) == 1
            and _norm(b.input_paths[0] if b.input_paths else "")
            == _norm(a.output_paths[0])
            and _engine_compatible(a, b)):
        return None
    if _norm(b.output_paths[0]) == _norm(a.output_paths[0]):
        # the elided intermediate IS the final output dir: the unfused
        # run leaves the rotation pngs there next to the symmetries, so
        # eliding them would change the final file set
        return None
    if not set(a.options) <= (_ROT_KEYS | _ENGINE_KEYS):
        return None
    if str(a.options.get("output_format", "png")).lower() != "png":
        return None  # lossy intermediate: fusing would change bytes
    if _sym_step_pool(b, rng) is None:
        return None

    opts = {k: a.options[k] for k in _ENGINE_KEYS if k in a.options}
    for k in _ROT_KEYS - {"include_original", "output_format"}:
        if k in a.options:
            opts[k] = a.options[k]
    opts["output_format"] = "png"
    opts["rot_include_original"] = bool(
        a.options.get("include_original", True))
    if "pool" in b.options:
        opts["pool"] = b.options["pool"]
    if "choose_random" in b.options:
        opts["choose_random"] = b.options["choose_random"]
    opts["sym_include_original"] = bool(
        b.options.get("include_original", True))
    return opts


def _fuse_rotsym(steps: List, verbose: bool, rng: bool = False) -> List:
    """Collapse adjacent eligible rotations → symmetry pairs into single
    RotationsSymmetries steps (fan-out fusion: the FusedChain stage model
    is 1→1, so the pair gets its own transform)."""
    from image_processor_pipeline_tpu_torch.pipeline import ProcessingStep
    from image_processor_pipeline_tpu_torch.transforms.rotsym import (
        RotationsSymmetries,
    )

    out: List = []
    i = 0
    while i < len(steps):
        a = steps[i]
        opts = (_rotsym_options(a, steps[i + 1], rng)
                if i + 1 < len(steps) else None)
        if opts is not None:
            b = steps[i + 1]
            elided = {_norm(p) for p in a.output_paths}
            touchers = [
                s for s in steps if s is not a and s is not b
                and (elided.intersection(_norm(p) for p in s.input_paths)
                     or elided.intersection(
                         _norm(p) for p in s.output_paths))
            ]
            if not touchers and _elided_dirs_clean([a]):
                fused = ProcessingStep(
                    name=f"{a.name}+{b.name}",
                    process_function=RotationsSymmetries(),
                    input_dirs=[str(p) for p in a.input_paths],
                    output_dirs=[str(p) for p in b.output_paths],
                    pairing_method="one_input",
                    workers=a.workers,
                    options=opts,
                    seed=a.seed,
                    overwrite=getattr(a, "overwrite", "allow"),
                    retries=getattr(a, "retries", 0),
                    mesh=getattr(a, "mesh", None),
                    device=a.device,
                )
                if verbose:
                    print(f"[auto_fuse] {a.name} -> {b.name} fused into "
                          f"one rotations+symmetries step (1 intermediate "
                          f"dir skipped)")
                out.append(fused)
                i += 2
                continue
        out.append(a)
        i += 1
    return out


#: PasteOverlayOntoBackground options the fused pair models
_OVL_KEYS = frozenset({"scale_min", "scale_max", "yolo_class_id"})
#: BorderCrop options the fused pair models
_BC_KEYS = frozenset({"crop_margins"})


def _fuse_ovlborder(steps: List, verbose: bool) -> List:
    """Collapse adjacent overlays → border-crop pairs into single
    ``OverlaysBorderCrop`` steps (transforms/ovlborder.py).  rng-TIER
    ONLY: the unfused pair's intermediate is a lossy ``.jpg`` (PIL q75,
    reference overlays.py:169), so the fused single-encode image cannot
    be byte-equal — it is the same composite WITHOUT that quantization
    generation (higher fidelity, same distribution; geometry and labels
    stay byte-identical because the paste draws ride the copied step
    seed over the unchanged pairing inventory)."""
    from image_processor_pipeline_tpu_torch.pipeline import ProcessingStep
    from image_processor_pipeline_tpu_torch.transforms.overlays import (
        PasteOverlayOntoBackground,
    )
    from image_processor_pipeline_tpu_torch.transforms.ovlborder import (
        OverlaysBorderCrop,
    )
    from image_processor_pipeline_tpu_torch.transforms.recadrages import BorderCrop

    def eligible(a, b) -> bool:
        if (type(a.process_function) is not PasteOverlayOntoBackground
                or type(b.process_function) is not BorderCrop):
            return False
        # a keeps its own 2-dir pairing verbatim (modulo/zip/...); both
        # must be plain-engine shapes the fused step can represent
        if not (_plain_engine_shape(a) and _plain_engine_shape(b)):
            return False
        if not (len(a.input_paths) == 2 and len(a.output_paths) == 2
                and len(b.input_paths) == 1 and len(b.output_paths) == 1
                and b.pairing_method == "one_input"
                and _norm(b.input_paths[0]) == _norm(a.output_paths[0])
                and _engine_compatible(a, b)):
            return False
        if not set(a.options) <= (_OVL_KEYS | _ENGINE_KEYS):
            return False
        if not set(b.options) <= (_BC_KEYS | _ENGINE_KEYS):
            return False
        # the elided composite-image dir must not double as a KEPT final
        # output — neither the crop's image dir nor the label dir (an
        # overlays step with output_dirs=[d, d] leaves composites next to
        # the labels in the unfused run; fusing would delete them)
        if _norm(a.output_paths[0]) in (_norm(b.output_paths[0]),
                                        _norm(a.output_paths[1])):
            return False
        return True

    out: List = []
    i = 0
    while i < len(steps):
        a = steps[i]
        if i + 1 < len(steps) and eligible(a, steps[i + 1]):
            b = steps[i + 1]
            elided = {_norm(a.output_paths[0])}
            touchers = [
                s for s in steps if s is not a and s is not b
                and (elided.intersection(_norm(p) for p in s.input_paths)
                     or elided.intersection(
                         _norm(p) for p in s.output_paths))
            ]
            # only output_paths[0] (the composite-image dir) is elided;
            # the label dir is a kept final output
            if not touchers and _dirs_clean([a.output_paths[0]]):
                opts = {k: a.options[k] for k in a.options}
                opts.update({k: b.options[k] for k in _BC_KEYS
                             if k in b.options})
                fused = ProcessingStep(
                    name=f"{a.name}+{b.name}",
                    process_function=OverlaysBorderCrop(),
                    input_dirs=[str(p) for p in a.input_paths],
                    output_dirs=[str(b.output_paths[0]),
                                 str(a.output_paths[1])],
                    pairing_method=a.pairing_method,
                    fixed_input=a.fixed_input,
                    workers=a.workers,
                    options=opts,
                    seed=a.seed,
                    overwrite=getattr(a, "overwrite", "allow"),
                    retries=getattr(a, "retries", 0),
                    mesh=getattr(a, "mesh", None),
                    device=a.device,
                )
                if verbose:
                    print(f"[auto_fuse] {a.name} -> {b.name} fused into "
                          f"one overlays+border-crop step (rng tier: "
                          f"final images skip the intermediate .jpg "
                          f"generation — labels byte-identical, pixels "
                          f"higher-fidelity)")
                out.append(fused)
                i += 2
                continue
        out.append(a)
        i += 1
    return out


def _writes_png_only(step) -> bool:
    """True when the step's transform PROVABLY writes only ``.png`` files
    — step metadata, no disk inspection (an intra-run producer's output
    dir doesn't exist at fuse time, so _png_only_dir can't see it)."""
    from image_processor_pipeline_tpu_torch.transforms.cleanup import (
        KeepLargestComponent,
    )
    from image_processor_pipeline_tpu_torch.transforms.filters import (
        ColorMaskTransparency,
    )
    from image_processor_pipeline_tpu_torch.transforms.fused import FusedChain
    from image_processor_pipeline_tpu_torch.transforms.rotations import (
        RandomRotations,
    )
    from image_processor_pipeline_tpu_torch.transforms.rotchain import (
        RotationsChain,
    )
    from image_processor_pipeline_tpu_torch.transforms.rotsym import (
        RotationsSymmetries,
    )

    t = step.process_function
    if isinstance(t, (ColorMaskTransparency, KeepLargestComponent)):
        return True  # mask always writes .png; cleanup is png-in/png-out
    # a fan-out/fused producer carrying output_bands=3 (rng-tier Enhance
    # tails) writes 3-channel pngs: qualifying it would recreate the RGB
    # band divergence _rgba_png declines for on-disk inputs (standalone
    # cleanup errors on no-alpha pngs; fit-crop uses the RGB bbox) —
    # this rule must prove the same RGBA invariant as the disk probe
    if step.options.get("output_bands") not in (None, 4):
        return False
    if isinstance(t, (RotationsSymmetries, RotationsChain)):
        return True  # the fused fan-outs always write RGBA .png
    if type(t) is RandomRotations:
        return str(step.options.get("output_format", "png")).lower() == "png"
    if isinstance(t, FusedChain):
        return str(step.options.get("output_suffix",
                                    ".png")).lower() == ".png"
    return False


def _png_input_ok(path, step, steps) -> bool:
    """A head input dir is provably-lossless when it already exists
    holding only ``.png`` files, OR when exactly ONE earlier step of this
    run list produces it, that producer provably writes only ``.png``,
    and the dir holds nothing yet (stale non-png files would have been
    inventoried — and per-item rejected — by the standalone head)."""
    if _png_only_dir(path):
        return True
    np_ = _norm(path)
    idx = next(i for i, s in enumerate(steps) if s is step)
    writers = [
        (j, s) for j, s in enumerate(steps)
        if s is not step and np_ in {_norm(q) for q in s.output_paths}
    ]
    if len(writers) != 1:
        return False
    j, producer = writers[0]
    if j >= idx or not _writes_png_only(producer):
        return False
    try:
        if any(f.is_file() for f in Path(path).iterdir()):
            return False  # pre-existing files of unknown provenance
    except (FileNotFoundError, NotADirectoryError):
        pass  # not there yet — the producer creates it
    except OSError:
        return False
    return True


def _head_eligible(step, steps) -> bool:
    from image_processor_pipeline_tpu_torch.transforms.filters import (
        ColorMaskTransparency,
    )

    if not (_step_plain(step) and len(step.output_paths) == 1
            and step.input_paths):
        return False
    if isinstance(step.process_function, ColorMaskTransparency):
        return True  # accepts any input, always writes lossless RGBA png
    return all(_png_input_ok(p, step, steps) for p in step.input_paths)


def _enhance_final(nxt, first, prev_out) -> Optional[object]:
    """``auto_fuse="rng"`` tier: an EnhanceImage step may TERMINATE a
    fused run.  Final-position-only: the standalone step re-decodes its
    input ``mode="RGB"`` and writes 3-CHANNEL files (reference
    tranfo.py:9-55), so a downstream RGBA-consuming step would see
    different bands if enhance sat mid-chain (cleanup would even raise).
    The fused chain replicates the banding by stripping alpha at encode
    (``output_bands=3``) — distribution-equal, never byte-equal: the
    fused per-(item, stage) factor draws differ from the standalone
    per-file tree, and 'sample' pairing flips blur/rgb flags for an exact
    30% of items where the fused stage draws independent Bernoulli(0.3).

    Returns the translated Enhance stage, or None when ineligible."""
    from image_processor_pipeline_tpu_torch.pairing import SAMPLE_RATE
    from image_processor_pipeline_tpu_torch.transforms.enhance import EnhanceImage
    from image_processor_pipeline_tpu_torch.transforms.fused import Enhance

    if type(nxt.process_function) is not EnhanceImage:
        return None
    if (nxt.fixed_input
            or len(nxt.input_paths) != 1 or len(nxt.output_paths) != 1
            or _norm(nxt.input_paths[0]) != _norm(prev_out)):
        return None
    # 'sample' pairing only adds per-item blur/rgb flags — the inventory
    # is the plain listing either way, so it chains like one_input
    if nxt.pairing_method not in ("one_input", "sample"):
        return None
    if not _plain_engine_shape(nxt):
        return None
    if not set(nxt.options) <= _ENGINE_KEYS:
        return None
    if not _engine_compatible(first, nxt):
        return None
    p = SAMPLE_RATE if nxt.pairing_method == "sample" else 0.0
    return Enhance(blur_prob=p, rgb_prob=p)


def _sym_fanout_spec(b, rng: bool = False) -> Optional[tuple]:
    """``(syms, sym_sample)`` for a fan-out composite when ``b`` is an
    eligible GenerateSymmetries step, else None (shared eligibility
    rule: _sym_step_pool).

    Byte tier (and whole-pool selections under rng): ``syms`` is the
    deterministic SET the standalone step would save (whole pool in
    order, 'o' appended when missing and ``include_original`` is set —
    reference symmetry.py:122-126) and ``sym_sample`` is None.  Sub-pool
    selections (reachable only under ``rng=True``): ``syms`` is the
    SUPERSET the draws can reach and ``sym_sample = (pool, k,
    include_original)`` feeds the composite's per-(item, slot) tree
    (transforms/rotsym.py select_syms)."""
    pool = _sym_step_pool(b, rng)
    if pool is None:
        return None
    inc = bool(b.options.get("include_original", True))
    cr = b.options.get("choose_random")
    syms = list(pool)
    if inc and "o" not in syms:
        syms.append("o")
    if cr is None or cr >= len(pool):
        return tuple(syms), None  # whole pool: deterministic either tier
    if cr < 0:
        # the standalone step raises PER ITEM at run time; declining
        # keeps that surface instead of failing at fuse time
        return None
    return tuple(syms), (tuple(pool), int(cr), inc)


def _sym_tail(steps: List, j: int, first, prev_out, rng: bool):
    """The GenerateSymmetries step at index ``j`` when it eligibly
    TERMINATES a fused chain run chaining from ``prev_out``, else None
    (the 1→S fan-out at the end of a deterministic chain —
    transforms/chainsym.py has the byte-safety argument; the selection
    rule is the shared _sym_step_pool)."""
    if j >= len(steps):
        return None
    nxt = steps[j]
    if _sym_step_pool(nxt, rng) is None:
        return None
    if _norm(nxt.input_paths[0]) != _norm(prev_out):
        return None
    if not _engine_compatible(first, nxt):
        return None
    return nxt


def _rotchain_head_ok(a) -> bool:
    """Eligible rotations head for the fan-out chain fusion (mirrors
    _rotsym_options' head conditions)."""
    from image_processor_pipeline_tpu_torch.transforms.rotations import (
        RandomRotations,
    )

    return (
        type(a.process_function) is RandomRotations
        and _step_plain(a)
        and len(a.input_paths) == 1 and len(a.output_paths) == 1
        and set(a.options) <= (_ROT_KEYS | _ENGINE_KEYS)
        and str(a.options.get("output_format", "png")).lower() == "png"
    )


def _fuse_rotsymchain(steps: List, verbose: bool,
                      rng: bool = False) -> List:
    """Collapse rotations → symmetries → {ColorMask, Cleanup, FitCrop}+
    runs into single (N+1)×S fan-out ``RotSymChain`` steps
    (transforms/rotsymchain.py has the composed byte-safety argument).
    Byte tier: the symmetry selection must be deterministic (whole
    pool); under the rng tier sub-pool sampling fuses too — the
    composite draws each slot's subset from the shared per-(item,
    rotation) tree (rotsym.select_syms), distribution-equal only.
    Runs BEFORE _fuse_rotsym so the 3+-step shape wins over the bare
    pair."""
    from image_processor_pipeline_tpu_torch.transforms.rotsymchain import (
        RotSymChain,
    )

    out: List = []
    i = 0
    while i < len(steps):
        a = steps[i]
        run: List = []
        stages: List = []
        spec = None
        if _rotchain_head_ok(a) and i + 1 < len(steps):
            b = steps[i + 1]
            if (_norm(b.input_paths[0]) == _norm(a.output_paths[0])
                    if b.input_paths else False):
                if _engine_compatible(a, b):
                    spec = _sym_fanout_spec(b, rng)
        if spec is not None:
            run, stages, _, _ = _walk_det_tail(
                steps, i + 2, a, b.output_paths[0])
        if run:  # >= 1 tail stage (the bare pair is _fuse_rotsym's job)
            involved = [a, b] + run
            # strict_distinct: the symmetry half ADDS files next to its
            # inputs, so aliased intermediate dirs change a downstream
            # step's INVENTORY (sym out==rot out: the standalone mask
            # processes the bare rotations too — _fuse_rotsym declines
            # that shape, and this pass must not steal it)
            if _fanout_guards_ok(steps, involved, a, strict_distinct=True):
                out.append(_build_fanout_step(
                    involved, RotSymChain(stages, *spec), {},
                    verbose, "rotations+symmetries+chain"))
                i += len(involved)
                continue
        out.append(a)
        i += 1
    return out


def _walk_det_tail(steps: List, j: int, anchor, prev_out):
    """Extend a fan-out fusion with consecutive deterministic
    translatable tail steps starting at index ``j``, chaining from
    ``prev_out``.  Returns (run, stages, prev_out, j) — the ONE tail
    rule shared by _fuse_rotchain and _fuse_rotsymchain."""
    run: List = []
    stages: List = []
    while j < len(steps):
        nxt = steps[j]
        if (nxt.fixed_input
                or not _step_plain(nxt)
                or len(nxt.input_paths) != 1
                or len(nxt.output_paths) != 1
                or _norm(nxt.input_paths[0]) != _norm(prev_out)
                or not _engine_compatible(anchor, nxt)):
            break
        tr = _translate(nxt)
        if tr is None:
            break
        run.append(nxt)
        stages.append(tr[0])
        prev_out = nxt.output_paths[0]
        j += 1
    return run, stages, prev_out, j


def _fanout_guards_ok(steps: List, involved: List, head,
                      strict_distinct: bool) -> bool:
    """The shared safety gate for fan-out fusions: the final dir must
    not be elided, no OTHER step may touch an elided dir, elided dirs
    must be empty (_dirs_clean), and — when the fan-out ADDS files next
    to its inputs (``strict_distinct``, the symmetry half) — every
    involved dir must be pairwise distinct, because aliased intermediate
    dirs change a downstream step's INVENTORY (sym out == rot out: the
    standalone tail processes the bare rotations too)."""
    elided_list = [_norm(p) for s in involved[:-1] for p in s.output_paths]
    elided = set(elided_list)
    final = _norm(involved[-1].output_paths[0])
    if final in elided:
        return False
    if strict_distinct and (
            len(elided_list) != len(elided)
            or _norm(head.input_paths[0]) in elided):
        return False
    touchers = [
        s for s in steps if s not in involved
        and (elided.intersection(_norm(p) for p in s.input_paths)
             or elided.intersection(_norm(p) for p in s.output_paths))
    ]
    return not touchers and _elided_dirs_clean(involved[:-1])


def _build_fanout_step(involved: List, transform, extra_opts: dict,
                       verbose: bool, what: str):
    """Construct the fused ProcessingStep for a fan-out rewrite: head
    engine knobs + rot options ride over; outputs land in the last
    step's dirs; intermediates are elided."""
    from image_processor_pipeline_tpu_torch.pipeline import ProcessingStep

    a = involved[0]
    opts = {k: a.options[k] for k in a.options
            if k in (_ROT_KEYS | _ENGINE_KEYS)}
    opts.pop("output_format", None)  # fused outputs: .png
    opts.update(extra_opts)
    fused = ProcessingStep(
        name="+".join(s.name for s in involved),
        process_function=transform,
        input_dirs=[str(p) for p in a.input_paths],
        output_dirs=[str(p) for p in involved[-1].output_paths],
        pairing_method="one_input",
        workers=a.workers,
        options=opts,
        seed=a.seed,
        overwrite=getattr(a, "overwrite", "allow"),
        retries=getattr(a, "retries", 0),
        mesh=getattr(a, "mesh", None),
        device=a.device,
    )
    if verbose:
        print(f"[auto_fuse] {' -> '.join(s.name for s in involved)} "
              f"fused into one {what} step "
              f"({len(involved) - 1} intermediate dir(s) skipped)")
    return fused


def _fuse_rotchain(steps: List, verbose: bool, rng: bool = False) -> List:
    """Collapse rotations → {ColorMask, Cleanup, FitCrop}+ runs into
    single fan-out RotationsChain steps (transforms/rotchain.py has the
    byte-safety argument: the rotations RNG tree rides the copied step
    seed over the unchanged inventory; the tail stages are deterministic
    and the elided intermediates lossless ``.png``).  Under the rng tier
    the tail may additionally END with an EnhanceImage step
    (distribution-equal — see _enhance_final)."""
    from image_processor_pipeline_tpu_torch.transforms.rotchain import (
        RotationsChain,
    )
    from image_processor_pipeline_tpu_torch.transforms.rotchainsym import (
        RotationsChainSymmetries,
    )

    out: List = []
    i = 0
    while i < len(steps):
        a = steps[i]
        run: List = []
        stages: List = []
        enh_final = False
        sym_step = None
        spec = None
        if _rotchain_head_ok(a):
            run, stages, prev_out, j = _walk_det_tail(
                steps, i + 1, a, a.output_paths[0])
            if rng and j < len(steps):
                st = _enhance_final(steps[j], a, prev_out)
                if st is not None:  # enhance must be last (3-channel out)
                    run.append(steps[j])
                    stages.append(st)
                    enh_final = True
                    prev_out = steps[j].output_paths[0]
                    j += 1
            # a trailing symmetries step joins the fan-out (flips of each
            # slot's tail result, transforms/rotchainsym.py; under the
            # rng tier sub-pool sampling rides the shared per-(item,
            # rotation) tree — distribution-equal only)
            if run and j < len(steps):
                nxt = steps[j]
                spec = _sym_fanout_spec(nxt, rng)
                if (spec is not None
                        and _norm(nxt.input_paths[0]) == _norm(prev_out)
                        and _engine_compatible(a, nxt)):
                    sym_step = nxt
        if run:
            extra = {"output_bands": 3} if enh_final else {}
            # prefer the sym-extended shape; fall back to the bare chain
            # when its guards fail (e.g. the sym output dir aliases an
            # elided intermediate)
            candidates = []
            if sym_step is not None:
                candidates.append((
                    [a] + run + [sym_step],
                    RotationsChainSymmetries(stages, *spec),
                    "rotations+chain+symmetries"))
            candidates.append(([a] + run, RotationsChain(stages),
                               "rotations+chain"))
            fused = False
            for involved, transform, what in candidates:
                if _fanout_guards_ok(steps, involved, a,
                                     strict_distinct=False):
                    out.append(_build_fanout_step(
                        involved, transform, extra, verbose, what))
                    i += len(involved)
                    fused = True
                    break
            if fused:
                continue
        out.append(a)
        i += 1
    return out


def _fuse_symchain(steps: List, verbose: bool, rng: bool = False) -> List:
    """Collapse symmetries → {ColorMask, Cleanup, FitCrop}+ runs into
    single fan-out ``SymmetriesChain`` steps (transforms/symchain.py has
    the byte-safety argument — entirely draw-free), and — when ANOTHER
    eligible symmetries step terminates the run — into
    ``SymmetriesChainSymmetries`` (the dihedral fan-out at BOTH ends,
    transforms/symchainsym.py).  Byte tier: both selections must be
    deterministic (whole pool); under the rng tier sub-pool sampling
    fuses at either end (distribution-equal only).  The head inputs
    must be lossless 8-bit RGBA ``.png`` (the standalone symmetry step
    writes intermediates with the INPUT's suffix, symmetry.py:133-134,
    so lossy or band-divergent inputs change the unfused tail's view).
    Runs AFTER the rotation passes so rot→sym→tail keeps its 3+-shape."""
    from image_processor_pipeline_tpu_torch.transforms.symchain import (
        SymmetriesChain,
    )
    from image_processor_pipeline_tpu_torch.transforms.symchainsym import (
        SymmetriesChainSymmetries,
    )

    out: List = []
    i = 0
    while i < len(steps):
        a = steps[i]
        run: List = []
        stages: List = []
        tail_sym = None
        tail_spec = None
        spec = _sym_fanout_spec(a, rng)
        if spec is not None and all(
                _png_input_ok(p, a, steps) for p in a.input_paths):
            run, stages, prev_out, j = _walk_det_tail(
                steps, i + 1, a, a.output_paths[0])
            # a second symmetries step may TERMINATE the run: flips of
            # each head slot's tail result (both-ends fan-out)
            if run and j < len(steps):
                nxt = steps[j]
                tail_spec = _sym_fanout_spec(nxt, rng)
                if (tail_spec is not None
                        and _norm(nxt.input_paths[0]) == _norm(prev_out)
                        and _engine_compatible(a, nxt)):
                    tail_sym = nxt
        if run:
            # prefer the both-ends shape; fall back to the head-only
            # fan-out when its guards fail (e.g. the trailing sym's
            # output dir aliases an elided intermediate).  strict: BOTH
            # symmetry halves add files next to their inputs, so aliased
            # dirs change a downstream inventory
            candidates = []
            if tail_sym is not None:
                candidates.append((
                    [a] + run + [tail_sym],
                    lambda: SymmetriesChainSymmetries(
                        stages, spec[0], tail_spec[0],
                        sym_sample=spec[1], tail_sample=tail_spec[1]),
                    "symmetries+chain+symmetries", True))
            candidates.append(([a] + run,
                               lambda: SymmetriesChain(stages, *spec),
                               "symmetries+chain", False))
            fused = False
            for involved, make, what, strict in candidates:
                if _fanout_guards_ok(steps, involved, a,
                                     strict_distinct=strict):
                    out.append(_build_fanout_step(
                        involved, make(), {}, verbose, what))
                    i += len(involved)
                    fused = True
                    break
            if fused:
                continue
        out.append(a)
        i += 1
    return out


def fuse_steps(steps: List, verbose: bool = True,
               tier: str = "byte") -> List:
    """Return a new step list with eligible consecutive runs collapsed
    into single FusedChain steps.  The input steps are not mutated.

    ``tier="byte"`` (default) fuses only byte-invisible shapes;
    ``tier="rng"`` additionally fuses RNG stages whose fused draws come
    from a different tree than the standalone per-file tree — final-stage
    EnhanceImage and sub-pool symmetry sampling — producing
    equally-DISTRIBUTED but not byte-equal outputs (documented opt-in)."""
    from image_processor_pipeline_tpu_torch.pipeline import ProcessingStep
    from image_processor_pipeline_tpu_torch.transforms.chainsym import (
        ChainSymmetries,
    )
    from image_processor_pipeline_tpu_torch.transforms.fused import FusedChain

    if tier not in ("byte", "rng"):
        raise ValueError(f"tier must be 'byte' or 'rng', got {tier!r}")
    rng = tier == "rng"
    steps = _fuse_rotsymchain(steps, verbose, rng)  # 3+-shape first
    steps = _fuse_rotsym(steps, verbose, rng)
    steps = _fuse_rotchain(steps, verbose, rng)
    steps = _fuse_symchain(steps, verbose, rng)  # after rot: they own sym
    if rng:
        # overlays -> border crop: the lossy .jpg intermediate makes the
        # byte tier impossible by construction (see _fuse_ovlborder)
        steps = _fuse_ovlborder(steps, verbose)
    out: List = []
    i = 0
    while i < len(steps):
        first = steps[i]
        tr0 = _translate(first) if _head_eligible(first, steps) else None
        run = [first]
        stages = [tr0[0]] if tr0 else []
        enh_final = False
        if tr0:
            j = i + 1
            while j < len(steps):
                nxt = steps[j]
                if rng:
                    st = _enhance_final(nxt, first,
                                        run[-1].output_paths[0])
                    if st is not None:
                        run.append(nxt)
                        stages.append(st)
                        enh_final = True
                        j += 1
                        break  # enhance must be last (3-channel output)
                if (nxt.fixed_input
                        or not _step_plain(nxt)
                        or len(nxt.input_paths) != 1
                        or len(nxt.output_paths) != 1
                        or _norm(nxt.input_paths[0])
                        != _norm(run[-1].output_paths[0])
                        or not _engine_compatible(first, nxt)):
                    break
                tr = _translate(nxt)
                if tr is None:
                    break
                run.append(nxt)
                stages.append(tr[0])
                j += 1
        sym_step = (_sym_tail(steps, j, first, run[-1].output_paths[0], rng)
                    if tr0 else None)
        if sym_step is None and len(run) < 2:
            out.append(first)
            i += 1
            continue

        def _guards_ok(involved, elided_steps):
            # no OTHER step may read OR write an elided intermediate
            # directory (a writer running before the fused position
            # would have added files the standalone downstream step
            # inventories), the final output dir must not double as an
            # elided intermediate (the unfused run leaves intermediate
            # files there too), and elided dirs must hold nothing stale
            elided = {_norm(p) for s in elided_steps for p in s.output_paths}
            if _norm(involved[-1].output_paths[0]) in elided:
                return False
            touchers = [
                s for s in steps if s not in involved
                and (elided.intersection(_norm(p) for p in s.input_paths)
                     or elided.intersection(
                         _norm(p) for p in s.output_paths))
            ]
            return not touchers and _elided_dirs_clean(elided_steps)

        # prefer the sym-extended shape; fall back to chain-only fusion
        # when its guards fail (e.g. the sym output dir aliases an
        # elided intermediate) and the bare chain is still fusable
        candidates = []
        if sym_step is not None:
            # the chain's FINAL output is elided too: the symmetry step
            # is the run's only materialization
            candidates.append((run + [sym_step], run))
        if len(run) >= 2:
            candidates.append((run, run[:-1]))
        fused = None
        for involved, elided_steps in candidates:
            if not _guards_ok(involved, elided_steps):
                continue
            with_sym = involved[-1] is sym_step
            fused_opts = {k: first.options[k] for k in _ENGINE_KEYS
                          if k in first.options}
            fused_opts["output_suffix"] = ".png"
            if enh_final:
                # EnhanceImage writes 3-channel files (tranfo.py:9-55)
                fused_opts["output_bands"] = 3
            if with_sym:
                for k in ("pool", "choose_random", "include_original"):
                    if k in sym_step.options:
                        fused_opts[k] = sym_step.options[k]
                transform = ChainSymmetries(stages)
            else:
                transform = FusedChain(stages)
            # input/output paths are ALREADY root-resolved on the source
            # steps — build the fused step rootless so they are not
            # resolved a second time (a relative root would nest:
            # root/root/d)
            fused = ProcessingStep(
                name="+".join(s.name for s in involved),
                process_function=transform,
                input_dirs=[str(p) for p in first.input_paths],
                output_dirs=[str(p) for p in involved[-1].output_paths],
                pairing_method="one_input",
                workers=first.workers,
                options=fused_opts,
                seed=first.seed,
                overwrite=getattr(first, "overwrite", "allow"),
                retries=getattr(first, "retries", 0),
                mesh=getattr(first, "mesh", None),
                device=first.device,
            )
            if verbose:
                what = (f"{len(stages)} stages + symmetry fan-out"
                        if with_sym else f"{len(stages)} stages")
                print(f"[auto_fuse] {' -> '.join(s.name for s in involved)} "
                      f"fused into one step ({what}, "
                      f"{len(involved) - 1} intermediate dir(s) skipped)")
            out.append(fused)
            i += len(involved)
            break
        if fused is None:
            out.append(first)
            i += 1
    return out

"""The plain reference against the port's CPU path on tiny cells, the
control (the reference in bfloat16 in the program's place), and a run
with the timed path broken underneath, which must come out not correct."""

import json

import numpy as np
import pytest
import torch

from port_bench import harness, run

CELLS = ["rotsym640.jpeg", "chain640.b16"]


def _readings(cell: harness.Cell, seed: int, seconds: float):
    drv = harness.driver(cell.config["driver"])
    st = drv.setup(seed, cell.config, cell.traffic, "cpu")
    try:
        drv.window(st, seconds, False)
        return ({c.name: c.value for c in drv.check(st)},
                {c.name: c.value for c in drv.check(st, torch.bfloat16)})
    finally:
        drv.close(st)


@pytest.mark.parametrize("name, options", [
    ("rotsym640.jpeg", {}),
    # the coefficient transports forced on, as "auto" runs them on a card
    ("rotsym640.jpeg", {"device_decode": True, "device_encode": True}),
    ("chain640.b16", {}),
])
def test_reference_equals_the_port_and_the_control_does_not(name, options):
    from conftest import tiny_cell

    program, control = _readings(tiny_cell(name, **options), 2147483659,
                                 0.5)
    assert all(v == 0 for v in program.values()), program
    failed = [k for k, v in control.items() if v > 0]
    assert failed, control


def _line(name, trace=False):
    line, _ = run.run(name, 2147483671, 0.3, trace, device="cpu")
    return json.loads(line)


def _altered(fn, centre=False):
    """``fn`` whose [B, H, W, C] output has one pixel of every image
    changed: the first, or the centre one."""
    def broken(*a, **k):
        out = fn(*a, **k).clone()
        y, x = (out.shape[1] // 2, out.shape[2] // 2) if centre else (0, 0)
        out[:, y, x] ^= 0x40
        return out
    return broken


@pytest.mark.parametrize("name, owner, attr, centre", [
    ("chain640.b16", "image_processor_pipeline_tpu_torch.models.chains",
     "augment_chain", False),
    ("rotsym640.jpeg", "image_processor_pipeline_tpu_torch.ops.geometry",
     "crop", False),
    ("rotsym640.jpeg", "image_processor_pipeline_tpu_torch.ops.rotate",
     "shear_rotate", True),
])
def test_an_answer_altered_where_it_is_made_is_not_correct(
        tiny, monkeypatch, name, owner, attr, centre):
    import importlib

    mod = importlib.import_module(owner)
    monkeypatch.setattr(mod, attr, _altered(getattr(mod, attr), centre))
    out = _line(name)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_a_symmetry_altered_where_it_is_made_is_not_correct(tiny,
                                                            monkeypatch):
    from image_processor_pipeline_tpu_torch.transforms import symmetry

    flips = dict(symmetry._FLIP_FNS)
    flips["h"] = _altered(flips["h"])
    monkeypatch.setattr(symmetry, "_FLIP_FNS", flips)
    assert _line("rotsym640.jpeg")["correct"] is False


def test_an_item_that_fails_is_not_correct(tiny, monkeypatch):
    from image_processor_pipeline_tpu_torch.transforms import rotations

    orig = rotations.RandomRotations.save_item
    calls = []

    def failing(self, *a, **k):
        calls.append(1)
        if len(calls) % 3 == 0:
            raise OSError("disk full")
        return orig(self, *a, **k)

    monkeypatch.setattr(rotations.RandomRotations, "save_item", failing)
    out = _line("rotsym640.jpeg")
    assert out["correct"] is False and out["failed"] >= 1


def test_the_reference_chain_draws_follow_the_seed():
    from port_bench.reference import chain

    boxes = np.tile(np.float32([0.5, 0.5, 0.2, 0.2]), (4, 1))
    a = chain.draws_for(np.arange(4) + 2**33, boxes, 640, 640, 512)
    b = chain.draws_for(np.arange(4) + 2**33, boxes, 640, 640, 512)
    c = chain.draws_for(np.arange(4) + 2**33 + 4, boxes, 640, 640, 512)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[2], c[2])

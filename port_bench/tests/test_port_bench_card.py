"""Every cell on the card, briefly: a run that is correct and reports each
metric the cell names.  Marked ``cuda``; skips without a card.

    python3 -m pytest port_bench/tests/test_port_bench_card.py -m cuda
"""

import json

import pytest

from conftest import all_cells
from port_bench import harness, run


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", all_cells())
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_correct_on_the_card(card, name, trace):
    line, _ = run.run(name, 2**31 + 101, 3.0, trace)
    out = json.loads(line)
    assert out["correct"] is True, out["checks"]
    cell = harness.load_cell(name)
    wanted = cell.per_layer if trace else cell.end_to_end
    assert set(out["metrics"]) == {m["name"] for m in wanted}
    assert out["device"]["platform"] == "gpu"


@pytest.mark.cuda
def test_the_fused_chroma_key_cell_reads_the_ccl_on_the_card(card,
                                                              monkeypatch):
    """``fusedchain640.clutter`` traced, briefly: correct, one fused step a
    pass (the driver ends the run otherwise), the three CCL metrics read,
    the roofline share in (0, 100]."""
    from conftest import _load_cell

    monkeypatch.setattr(harness, "load_cell", _load_cell)
    line, _ = run.run("fusedchain640.clutter", 2**31 + 103, 3.0, True)
    out = json.loads(line)
    assert out["correct"] is True, out["checks"]
    m = out["metrics"]
    assert {"ccl_ms_per_batch", "ccl_sweeps_per_batch",
            "ccl_roofline"} <= set(m)
    assert 0 < m["ccl_roofline"]["value"] <= 100

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

"""The readings that a cell's limits are set from, on the card.

    python3 port_bench/control.py --workload <cell> --seconds <s> --seeds 1 2 3 ...

For each seed, in one process: the cell's set-up, a window of --seconds,
then its compared numbers twice: for the program (the lower reading) and
for the control, the plain reference computed in bfloat16 put in the
program's place (the upper reading).  One JSON line a seed.  The
benchmark's own runs do not run this.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench import harness  # noqa: E402


def readings(workload: str, seed: int, seconds: float):
    """{"program": {check: value}, "control": {check: value}} of one
    seed, on the card."""
    import torch

    cell = harness.load_cell(workload)
    harness.require_cards(cell.chips)
    drv = harness.driver(cell.config["driver"])
    st = drv.setup(seed, cell.config, cell.traffic, "cuda")
    try:
        drv.window(st, seconds, False)
        return {"seed": seed,
                "program": {c.name: c.value for c in drv.check(st)},
                "control": {c.name: c.value
                            for c in drv.check(st, torch.bfloat16)}}
    finally:
        drv.close(st)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    a = ap.parse_args(argv)
    for seed in a.seeds:
        print(json.dumps(readings(a.workload, seed, a.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

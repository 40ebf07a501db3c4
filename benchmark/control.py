"""Readings behind the output check's limits, on the card, at a cell's
own size: for each seed, one run of the cell (a short window) whose
numbers are the program's, the control's (the reference computed with
TF32 products, the precision below the configuration's float32, in the
program's place) and, for a training cell, a step that leaves half of
each batch out.  A state left unchanged reads 1 on the change by
construction and needs no run.

    python benchmark/control.py --workload <cell> --seeds 1 2 3 \
        [--seconds 3] [--out readings.json]

Not run by the benchmark's runs.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    harness.configure_process()
    import torch
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    kind = harness.load_kind(cell)
    card = harness.card()
    rows = []
    for seed in args.seeds:
        run = kind.run(cell, seed, args.seconds, False,
                         torch.device("cuda", 0), card, with_controls=True)
        row = {"seed": seed, "program": run.readings,
               **run.counters["controls"], "faults": run.faults}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"workload": cell.name, "card": card, "rows": rows}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

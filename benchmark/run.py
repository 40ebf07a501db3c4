"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for.  The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number the output check compared
beside its limit, which also end standard error.  Without the cards, or
with the program absent, or with ``jax``, ``jaxlib``, ``flax`` or
``sm_hpss_mtl_tpu`` loaded once the window has closed, it prints no
result and exits with another code than 0.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import harness  # noqa: E402


def result(run: harness.Run, checks: list, trace: bool) -> dict:
    cell = run.cell
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = harness.load_reader(cell, m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            if m["name"] in run.e2e:
                metrics[m["name"]] = {"value": run.e2e[m["name"]],
                                      "unit": m["unit"]}
    device = {"platform": "gpu", "kind": run.card["name"],
              "count": cell.chips,
              "memory_peak_bytes": run.memory_peak_bytes,
              "power_limit_w": run.card["power_limit_w"]}
    line = {"correct": all(c["ok"] for c in checks) and not run.faults
            and run.failed == 0,
            "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics, "device": device}
    if trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        line["breakdown"] = {"device_ops": run.trace.device_ops,
                             "idle_gaps": run.trace.idle_gaps}
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                      for c in checks}
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    started = harness.process_start()
    harness.configure_process()
    import torch
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    kind = harness.load_kind(cell)
    run = kind.run(cell, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", 0), harness.card())
    run.e2e["setup_s"] = run.window_start - started
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    checks = harness.compare(run.readings, cell.limits)
    line = result(run, checks, bool(args.trace))
    print("setup: " + ", ".join(f"{k} {v:.2f} s" for k, v in
                                run.setup.seconds.items()), file=sys.stderr)
    for fault in run.faults:
        print(f"fault: {fault}", file=sys.stderr)
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} <= {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Record the CPU's bf16-against-float32 spread of one train step of each
model of ``chip_smoke.BF16_STEP_MODELS`` at full width: the readings that
``chip_smoke.py``'s bf16 bars are made of (``BF16_STEP_BARS``).

For each model: the first crop batch of the training corpus that
``chip_smoke.py`` makes, the CPU's features of it (the kernels' plain
versions), and from the same float32 weights, dropout off, a patch step on
those features in float32 and in bf16 on the CPU.  (The CPU's audio step
is the same computation: the plain version's features, then this step.)
Per model: the relative loss difference, the largest BatchNorm-statistic
difference, the BatchNorm-fed biases' largest update per lr per element,
and each other parameter's update difference relative to its norm (above
the rounding floor), as ``chip_smoke._spread`` measures them.

It runs on the CPU alone, but at full width: run it on the GPU machine,
from the repository's root, and commit what it writes:

    python3 tools/bf16_step_bars.py [--out tools/bf16_step_bars.json]
"""

import argparse
import json
import os
import platform
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

KEYS = ("loss_rel", "stats_err_max", "bn_fed_bias_update_max_per_lr",
        "update_rel")


def spreads(corpus: dict) -> dict:
    out = {}
    for model, (optimizer, _) in cs.BF16_STEP_MODELS.items():
        audio, labels, f32, b16 = cs.bf16_inputs(corpus, model)
        patches = cs._patches(audio, model, "cpu")
        before = {k: v.clone() for k, v in f32.state_dict().items()}
        noise = cs._bn_fed_biases(f32)
        steps = [cs._stepped(net, patches, labels, "cpu", False, model,
                             optimizer) for net in (b16, f32)]
        r, _ = cs._spread(before, *steps, noise)
        out[model] = {k: r[k] for k in KEYS}
        print(model, {k: r[k] for k in KEYS[:3]}, "largest update",
              r["update_rel_max_at"], r["update_rel_max"], flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, cs.BF16_STEP_BARS))
    args = ap.parse_args()
    t0 = time.perf_counter()
    try:
        card = cs.card_line()
    except (OSError, subprocess.SubprocessError):
        card = "not read"
    with tempfile.TemporaryDirectory() as tmp:
        models = spreads(cs.make_train_corpus(os.path.join(tmp, "tc")))
    record = {"recorded_by": "tools/bf16_step_bars.py",
              "machine": {"card": card, "cpu": platform.processor()
                          or platform.machine(),
                          "cpu_threads": torch.get_num_threads(),
                          "torch": torch.__version__},
              "seed": cs.SEED, "models": models}
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {args.out} in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()

"""bf16 train steps on the card, first thing in a fresh process.

An earlier bf16 probe failed once on an H100 (loss 0.372 relative and
BatchNorm statistics 1.25e4 card bf16 against CPU bf16; card bf16 against
card float32 loss 0.206, statistics 5.8) with a version of
``chip_smoke.bf16_step_checks`` that was never kept; later runs of the
check never failed.  This probe runs what that one ran first, right after
the kernels are built: ``chip_smoke.bf16_step_checks`` (every bar, every
repeat), ``ROUNDS`` times.  Then it measures one hypothesis for the
failure, a step held against a step on another batch: for each model, the
card's bf16 audio step on the next crop batch against the CPU's bf16 and
the card's float32 steps on the first.  If those read as the failure did,
a harness that fed the two sides different batches explains it.

On the GPU machine, from the repository's root:

    python3 tools/bf16_probe.py
"""

import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

ROUNDS = 2


def other_batch(corpus: dict) -> dict:
    out = {}
    for model, (optimizer, _) in cs.BF16_STEP_MODELS.items():
        crops = cs._crops(corpus, cs.SEED, model)
        (audio, labels), (audio2, labels2) = next(crops), next(crops)
        _, _, f32, b16 = cs.bf16_inputs(corpus, model)
        before = {k: v.clone() for k, v in f32.state_dict().items()}
        noise = cs._bn_fed_biases(f32)
        ref = {tag: cs._stepped(net, audio, labels, dev, True, model,
                                optimizer)
               for tag, net, dev in (("cpu_bf16", b16, "cpu"),
                                     ("card_f32", f32, "cuda"))}
        moved = cs._stepped(b16, audio2, labels2, "cuda", True, model,
                            optimizer)
        out[model] = {}
        for tag, step in ref.items():
            r, _ = cs._spread(before, moved, step, noise)
            out[model][f"card_bf16_next_batch_vs_{tag}"] = {
                k: r[k] for k in ("loss_rel", "stats_err_max",
                                  "update_rel_max", "update_rel_max_at")}
    return out


def main() -> None:
    t0 = time.perf_counter()
    print(cs.card_line(), flush=True)
    print("build", cs.build_all()[0], flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        corpus = cs.make_train_corpus(os.path.join(tmp, "tc"))
        for i in range(ROUNDS):
            try:
                r = cs.bf16_step_checks(corpus)["models"]
            except cs.PhaseError as e:
                print(f"round {i} failed: {e}", flush=True)
                continue
            print(f"round {i} passed:", json.dumps({
                m: {tag: [round(x["update_rel_max"], 4) for x in runs]
                    for tag, runs in v.items()
                    if tag.startswith(("patch_", "audio_"))}
                for m, v in r.items()}), flush=True)
        print("other batch:", json.dumps(other_batch(corpus)), flush=True)
    print(f"total {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()

"""A fold at the reference's scale, by the PyTorch port (counterpart of
``tools/scale_rehearsal.py``).

1. Synthesizes the JAX tool's MUSAN-shaped corpus under ``--root``
   (``make_toy_musan``: 300 music files of 30-90 s with seed 11, 300
   speech files of 60-180 s with seed 12, ~25 h with the SMR-cycled
   speech+music pairs of the folds), unless it is there already.
2. Builds the CV folds and derives the TR/V/TS steps from the corpus
   duration as the reference does (``with_steps_from_durations``).
3. Runs fold 0 of each requested run in its own child process through
   ``cli/experiment.py::run_experiment`` at the reference geometry: batch
   16 per class (48), W 68, 120 mel bands, a 50-epoch budget with the
   reference's early stopping; ``--bf16`` trains with
   ``compute_dtype='bfloat16'`` as ``cli.mtl --bf16`` does.
4. Writes the report to ``--out``: per run the JAX tool's keys, with the
   card's name and power limit (``nvidia-smi``), the compute dtype, K1's
   launches in the child, the warm step time and the ``stage_timer``
   records of corpus synthesis, folds, fit and test.  While a child runs,
   the report holds every epoch its fold log has flushed, so a run that
   is cut leaves its finished epochs (status 'running', or 'cut' where
   the tool was terminated).

    python3 tools/scale_rehearsal_torch.py --merge --out SCALE.json \\
        --pipelines device                      # on the GPU
    python3 tools/scale_rehearsal_torch.py --device cpu --n-music 3 \\
        --n-speech 3 --dur-scale 0.03 --epochs 1 --root /tmp/s --out s.json
"""

import argparse
import csv
import json
import os
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N_MUSIC = 300            # ~5 h  at 30-90 s a file
N_SPEECH = 300           # ~10 h at 60-180 s a file
# speech+music takes speech's duration in the folds' accounting -> ~25 h.
KEEP = ("music", "speech", "speech+music")
LEMAIRE = "Lemaire_et_al_MTL"


def ensure_corpus(root: str, n_music: int = N_MUSIC,
                  n_speech: int = N_SPEECH, dur_scale: float = 1.0) -> str:
    """The JAX tool's corpus: the same counts, durations and seeds.  A
    corpus already under ``root`` is kept if it was made with the same
    arguments; one made with others raises."""
    from sm_hpss_mtl_tpu_torch.data.audio import make_toy_musan
    made = {"n_music": n_music, "n_speech": n_speech,
            "dur_scale": dur_scale}
    stamp = os.path.join(root, "corpus.json")
    if os.path.exists(os.path.join(root, "music")):
        with open(stamp) as f:
            found = json.load(f)
        if found != made:
            raise ValueError(f"{root} holds a corpus made with {found}, "
                             f"not {made}: pass another --root")
        return root
    make_toy_musan(root, n_per_class=n_music,
                   duration_s=(30.0 * dur_scale, 90.0 * dur_scale),
                   seed=11, only=("music",))
    make_toy_musan(root, n_per_class=n_speech,
                   duration_s=(60.0 * dur_scale, 180.0 * dur_scale),
                   seed=12, only=("speech",))
    with open(stamp, "w") as f:
        json.dump(made, f)
    return root


def run_key(pipeline: str, model: str, bf16: bool) -> str:
    """A run's key in the report, and the tag of its directories."""
    key = pipeline if model == LEMAIRE else f"{pipeline}_{model}"
    return key + "_bf16" if bf16 else key


def experiment_config(root: str, pipeline: str, epochs: int, model: str,
                      bf16: bool):
    from sm_hpss_mtl_tpu_torch.train.config import ExperimentConfig
    tag = run_key(pipeline, model, bf16)
    return ExperimentConfig(
        model=model, data_root=root,
        feature_dir=os.path.join(root, "features_" + tag
                                 if pipeline == "device" else "features"),
        output_dir=os.path.join(root, "results_" + tag),
        epochs=epochs, batch_size=16, patch_size=68, patch_shift=68,
        pipeline=pipeline, seed=0,
        compute_dtype="bfloat16" if bf16 else "float32")


def fold_log_path(cfg) -> str:
    return os.path.join(cfg.output_dir, cfg.model, cfg.feat_name,
                        "fold0_log.csv")


def read_epochs(path: str) -> list[dict]:
    """The fold log's finished epochs, numbers as floats."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        rows = list(csv.DictReader(f))
    return [{k: float(v) for k, v in r.items()} for r in rows
            if None not in r.values() and "" not in r.values()]


def card() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi not available ({type(e).__name__})"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else "nvidia-smi not available"


def run_pipeline(root: str, pipeline: str, epochs: int, model: str = LEMAIRE,
                 bf16: bool = False, device: str = "cuda") -> dict:
    """Fold 0 of one run, in this process; prints its row as the last
    line."""
    import torch

    from sm_hpss_mtl_tpu_torch.cli.experiment import (load_or_create_folds,
                                                      run_experiment)
    from sm_hpss_mtl_tpu_torch.ops import frontend
    from sm_hpss_mtl_tpu_torch.utils import stage_timer
    from sm_hpss_mtl_tpu_torch.utils.profiling import counters

    cfg = experiment_config(root, pipeline, epochs, model, bf16)
    stages = {}
    with stage_timer("folds", stages):
        cv = load_or_create_folds(cfg)
    durations = {k: v for k, v in cv["total_duration"].items() if k in KEEP}
    cfg_steps = cfg.with_steps_from_durations(durations)

    # K1's launch shapes (n_fft, l_harm, l_perc, clips, frames), which
    # chip_smoke.py holds against the plain version.
    k1_shapes = set()
    launch = frontend.launch

    def recording(y, M, **kw):
        if M is not None:
            k1_shapes.add((kw["n_fft"], kw["l_harm"], kw["l_perc"],
                           y.numel() // y.shape[-1],
                           1 + (y.shape[-1] - kw["n_fft"])
                           // kw["hop_length"]))
        return launch(y, M, **kw)

    frontend.launch = recording
    k1_before = counters().get("stft_hpss_mel.launches", 0)
    t0 = time.time()
    try:
        out = run_experiment(cfg, folds=[0], verbose=True, resume=False,
                             device=device, timings=stages)[0]
    finally:
        frontend.launch = launch
    wall_total = time.time() - t0
    k1_launches = counters().get("stft_hpss_mel.launches", 0) - k1_before

    epochs_rows = read_epochs(fold_log_path(cfg))
    epoch_s = [r["epoch_train_s"] for r in epochs_rows]
    warm = sorted(epoch_s[1:] or epoch_s)
    warm_median = warm[len(warm) // 2]
    fit = out["fit"]
    row = {
        "pipeline": pipeline,
        "model": model,
        "tr_steps": cfg_steps.tr_steps, "v_steps": cfg_steps.v_steps,
        "ts_steps": cfg_steps.ts_steps,
        "corpus_hours": round(sum(durations.values()), 2),
        "epochs_run": len(epochs_rows),
        "stopped_early": bool(fit.stopped_early),
        "epoch_train_s": [round(t, 1) for t in epoch_s],
        "first_epoch_s": round(epoch_s[0], 1),
        "warm_epoch_s_median": round(warm_median, 1),
        "sustained_steps_per_s_warm": round(
            cfg_steps.tr_steps / warm_median, 1),
        "steps_per_s_overall": round(
            cfg_steps.tr_steps * len(epochs_rows) / sum(epoch_s), 1),
        "train_wall_s": round(fit.wall_time, 1),
        "train_process_s": round(fit.training_time, 1),
        "total_wall_s": round(wall_total, 1),
        "accuracy": out["row"]["accuracy"],
        "gen_accuracy": out["row"].get("gen_accuracy"),
        "val_loss": out["row"]["val_loss"],
        "cache_stats": out["cache_stats"],
        "device": card() if torch.device(device).type == "cuda" else "cpu",
        "compute_dtype": cfg.compute_dtype,
        "k1_launches": k1_launches,
        "k1_shapes": sorted(k1_shapes),
        # The loop runs at least one step an epoch (tiny corpora).
        "warm_step_ms": 1e3 * warm_median / max(cfg_steps.tr_steps, 1),
        "stages": stages,
        "epochs": epochs_rows,
        "status": "finished",
    }
    print(json.dumps(row))
    return row


class Report:
    """The report on disk, rewritten whole at every change."""

    def __init__(self, path: str, args, merge: bool):
        self.path = path
        self.data = {
            "tool": "tools/scale_rehearsal_torch.py",
            "geometry": "batch 16/class=48, W=68, n_mels=120; each row "
                        "names its model and compute dtype",
            "epoch_budget": args.epochs,
            "corpus": f"{args.n_music} music x {30 * args.dur_scale:g}-"
                      f"{90 * args.dur_scale:g} s (seed 11) + "
                      f"{args.n_speech} speech x {60 * args.dur_scale:g}-"
                      f"{180 * args.dur_scale:g} s (seed 12) + SMR-cycled "
                      "speech+music pairs",
            "methodology": (
                "fold 0 per run in its own process; steps derived from "
                "the corpus duration as the reference does; per-epoch "
                "wall clock from the fold log; sustained steps/s = "
                "tr_steps / median warm-epoch time; warm_step_ms = median "
                "warm-epoch time / tr_steps"),
            "pipelines": {}}
        if merge and os.path.exists(path):
            with open(path) as f:
                self.data["pipelines"] = json.load(f).get("pipelines", {})

    def put(self, key: str, row: dict) -> None:
        self.data["pipelines"][key] = row
        os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                    exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.data, f, indent=1)
        os.replace(tmp, self.path)


def run_child(args, pipeline: str, report: Report, corpus_stage: dict,
              poll_s: float = 10.0) -> dict:
    """One run in a child process; the report takes each epoch its fold
    log flushes, and the child's output is echoed as it comes."""
    key = run_key(pipeline, args.model, args.bf16)
    cfg = experiment_config(args.root, pipeline, args.epochs, args.model,
                            args.bf16)
    log = fold_log_path(cfg)
    if os.path.exists(log):
        os.unlink(log)
    out_path = os.path.join(args.root, f"child_{key}.out")
    cmd = [sys.executable, os.path.abspath(__file__), "--child", pipeline,
           "--root", args.root, "--epochs", str(args.epochs), "--model",
           args.model, "--device", args.device,
           *(["--bf16"] if args.bf16 else [])]
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    base = {"pipeline": pipeline, "model": args.model,
            "compute_dtype": "bfloat16" if args.bf16 else "float32",
            "stages": {"corpus": corpus_stage}}
    with open(out_path, "w") as out_f:
        proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=out_f,
                                stderr=subprocess.STDOUT, text=True)

    def cut(signum, frame):
        proc.kill()
        report.put(key, {**base, "status": "cut",
                         "epochs": read_epochs(log)})
        sys.exit(128 + signum)

    old = signal.signal(signal.SIGTERM, cut)
    seen = 0
    t0 = time.time()
    try:
        with open(out_path) as echo:
            while True:
                done = proc.poll() is not None
                sys.stdout.write(echo.read())
                sys.stdout.flush()
                epochs = read_epochs(log)
                if len(epochs) != seen:
                    seen = len(epochs)
                    report.put(key, {**base, "status": "running",
                                     "epochs": epochs})
                if done:
                    break
                if time.time() - t0 > 14000:
                    proc.kill()
                    proc.wait()
                    break
                time.sleep(poll_s)
    finally:
        signal.signal(signal.SIGTERM, old)
    with open(out_path) as f:
        lines = f.read().strip().splitlines()
    if proc.returncode != 0:
        report.put(key, {**base, "status": "failed",
                         "returncode": proc.returncode,
                         "epochs": read_epochs(log)})
        raise RuntimeError(f"child {key} failed ({proc.returncode}):\n"
                           + "\n".join(lines[-40:]))
    row = json.loads(lines[-1])
    row["stages"] = {"corpus": corpus_stage, **row["stages"]}
    report.put(key, row)
    return row


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=os.path.join(REPO, "build",
                                                 "scale_report.json"))
    p.add_argument("--root", default=os.path.join(REPO, "build",
                                                  "scale_corpus"))
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--pipelines", nargs="*", default=["host", "device"])
    p.add_argument("--model", default=LEMAIRE,
                   help="model family of this run (e.g. Doukhan_et_al_MTL)")
    p.add_argument("--merge", action="store_true",
                   help="merge rows into an existing --out report instead "
                        "of overwriting it")
    p.add_argument("--n-music", type=int, default=N_MUSIC)
    p.add_argument("--n-speech", type=int, default=N_SPEECH)
    p.add_argument("--dur-scale", type=float, default=1.0,
                   help="scale factor on per-file durations (smoke runs)")
    p.add_argument("--bf16", action="store_true",
                   help="train in bf16 (compute_dtype='bfloat16')")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--child", default=None, help="internal: one pipeline")
    p.add_argument("--poll-s", type=float, default=10.0,
                   help="seconds between reads of a child's fold log")
    args = p.parse_args(argv)

    if args.child:
        run_pipeline(args.root, args.child, args.epochs, args.model,
                     args.bf16, args.device)
        return

    from sm_hpss_mtl_tpu_torch.utils import stage_timer
    stages = {}
    with stage_timer("corpus", stages):
        ensure_corpus(args.root, args.n_music, args.n_speech,
                      args.dur_scale)
    report = Report(args.out, args, args.merge)
    for pipeline in args.pipelines:
        row = run_child(args, pipeline, report, stages["corpus"],
                        args.poll_s)
        print(pipeline, "->", {k: row[k] for k in
                               ("epochs_run", "first_epoch_s",
                                "warm_epoch_s_median", "warm_step_ms",
                                "accuracy")}, flush=True)
    print("->", args.out)


if __name__ == "__main__":
    main()

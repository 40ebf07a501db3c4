"""Hyperparameter tuning drivers (counterpart of
``sm_hpss_mtl_tpu/cli/tune.py``, the same modes and flags, plus
``--device``).

- ``--mode grid``: sweep ONE hyperparameter over the reference's ranges
  (``Hyperparameter_Selection.py:541-552``): n_mels 20..120, l_harm and
  l_perc 11..51 (kernels K1 to K4 are built for every pair of these grids,
  ``ops/hpss.py::KERNEL_MEDIANS``), W 25..100, the loss-weight presets;
  one short training per value on one fold.  With ``--vmap`` the
  loss-weight grid trains as one multi-trial program
  (``train/multitrial.py``).
- ``--mode search``: random or GP Bayesian search (``--algo``) over the
  TCN architecture space or the MTL head shapes (``--space
  arch|mtl-heads``; ``utils/bayesopt.py``).
- ``--mode seeds``: ``--trials`` seed replicates as one multi-trial
  program.

Results go to the tab-separated ``Performance_Tuning.csv`` in
``--output``; the best setting is printed.  Runs on CUDA unless
``--device cpu`` is given; without a GPU it raises.  ``--shard-trials``
(with ``--vmap`` or ``--mode seeds``) shards the trial axis over every
visible GPU (``parallel.make_mesh``), or over the one CPU with ``--device
cpu``; the trial count must divide evenly.

    python -m sm_hpss_mtl_tpu_torch.cli.tune --data corpus --mode grid \\
        --param l_harm [--device cpu]
    python -m sm_hpss_mtl_tpu_torch.cli.tune --data corpus --mode search \\
        --space arch --trials 20
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from ..data.batcher import BalancedBatcher, BatcherConfig
from ..data.featurize import Featurizer
from ..data.folds import get_train_test_files
from ..data.prefetch import DevicePrefetcher
from ..device import resolve_device
from ..train.config import ExperimentConfig
from ..parallel.mesh import make_mesh
from ..train.multitrial import fit_multi
from ..train.optimizers import for_model
from ..utils.bayesopt import ARCH_SPACE, MTL_HEADS_SPACE, BayesOptimizer
from ..utils.results import append_results
from .experiment import (_check_ported, _class_subset, _label_map,
                         class_names_for, load_or_create_folds, model_spec,
                         run_experiment, split_train_val)

GRID_RANGES = {
    "n_mels": [20, 40, 60, 80, 100, 120],
    "l_harm": [11, 21, 31, 41, 51],
    "l_perc": [11, 21, 31, 41, 51],
    "W": [25, 50, 75, 100],
    "loss_weights": [
        {"3C": 0.4, "R": 0.2, "M": 0.2, "S": 0.2},
        {"3C": 0.2, "R": 0.4, "M": 0.2, "S": 0.2},
        {"3C": 0.2, "R": 0.2, "M": 0.4, "S": 0.2},
        {"3C": 0.2, "R": 0.2, "M": 0.2, "S": 0.4},
    ],
}


def _apply_grid_value(cfg: ExperimentConfig, param: str, value):
    if param == "n_mels":
        return dataclasses.replace(cfg, n_mels_override=int(value))
    if param == "l_harm":
        return dataclasses.replace(cfg, l_harm=int(value))
    if param == "l_perc":
        return dataclasses.replace(cfg, l_perc=int(value))
    if param == "W":
        v = int(value)
        return dataclasses.replace(cfg, patch_size=v, patch_shift=v,
                                   test_patch_shift=v)
    if param == "loss_weights":
        return dataclasses.replace(cfg, loss_weights=value)
    raise ValueError(param)


def search_space(space: str) -> dict:
    if space == "arch":
        return ARCH_SPACE
    if space == "mtl-heads":
        return MTL_HEADS_SPACE
    raise ValueError(space)


def sample_arch(rng: np.random.Generator, space: str) -> dict:
    return {k: (v[rng.integers(len(v))])
            for k, v in search_space(space).items()}


def run_vmapped_trials(base: ExperimentConfig, trials: list[dict],
                       fold: int, verbose: bool = False, mesh=None,
                       device: str | torch.device = "cuda") -> list[dict]:
    """Train the shape-invariant ``trials`` (loss weights, lr scales,
    seeds) as one multi-trial program (``train/multitrial.py``) on one
    host batch stream of fold ``fold``: the host pipeline (``Featurizer``
    on ``device``, ``BalancedBatcher``).  ``mesh`` shards the trials over
    its 'data' devices (``train.multitrial.fit_multi``).  Returns one row
    per trial: its settings, best val loss and accuracy, and best
    epoch."""
    device = resolve_device(device)
    _check_ported(base)
    cv_file_list = load_or_create_folds(base)
    if not base.tr_steps:
        keep = set(class_names_for(base.n_classes))
        base = base.with_steps_from_durations(
            {k: v for k, v in cv_file_list["total_duration"].items()
             if k in keep})
    spec = model_spec(base)
    if spec.input_kind == "dual":
        raise ValueError("vmapped trials do not support dual-tower models")
    feat_cfg = base.feature_config()
    cache_dir = (os.path.join(base.feature_dir, base.model,
                              feat_cfg.feat_name)
                 if base.feature_dir else None)
    fz = Featurizer(feat_cfg, cache_dir=cache_dir, device=device)
    train_files, _ = get_train_test_files(
        cv_file_list, fold, class_names=class_names_for(base.n_classes))
    train_files = _class_subset(train_files, base.n_classes)
    tr_files, va_files = split_train_val(train_files, seed=base.seed)
    bcfg = BatcherConfig(
        batch_size=base.batch_size, patch_size=base.patch_size,
        patch_shift=base.patch_shift, feat_name=feat_cfg.feat_name,
        input_kind=base.input_kind, augment_noise=False, seed=base.seed)
    train_iter = DevicePrefetcher(
        BalancedBatcher(fz, base.data_root, tr_files, bcfg), device)
    val_iter = DevicePrefetcher(
        BalancedBatcher(fz, base.data_root, va_files,
                        dataclasses.replace(bcfg, seed=base.seed + 1)),
        device)
    tr_steps = max(base.lr_schedule_steps or base.tr_steps, 1)
    heads = sorted({h for t in trials for h in (t.get("loss_weights") or {})})
    try:
        result = fit_multi(
            spec.module, lambda ps: for_model(base.model, ps, tr_steps,
                                              trial_axis=True)[0],
            _label_map(train_iter, spec.mtl), _label_map(val_iter, spec.mtl),
            mtl=spec.mtl, trials=trials,
            heads=tuple(heads) if spec.mtl and heads else None,
            epochs=base.epochs, steps_per_epoch=base.tr_steps,
            val_steps=max(base.v_steps, 1), l2_reg=base.l2_reg,
            base_seed=base.seed, mesh=mesh, device=device, verbose=verbose)
    finally:
        train_iter.close()
        val_iter.close()
    rows = []
    for i, trial in enumerate(trials):
        rows.append({"trial": i, **{k: str(v) for k, v in trial.items()},
                     "val_loss": float(result.best_val_loss[i]),
                     "accuracy": float(result.best_accuracy[i]),
                     "best_epoch": int(result.best_epoch[i])})
    return rows


def _score(cfg: ExperimentConfig, fold: int, tag: str,
           device: str | torch.device = "cuda") -> dict:
    # Per-trial output dir: trials must not share (or resume from) each
    # other's checkpoints, since their architectures differ.
    cfg = dataclasses.replace(
        cfg, output_dir=os.path.join(cfg.output_dir, tag))
    out = run_experiment(cfg, folds=[fold], verbose=False, resume=False,
                         device=device)[0]
    return {"val_loss": out["row"]["val_loss"],
            "accuracy": out["row"]["accuracy"]}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", required=True)
    p.add_argument("--model", default="Lemaire_et_al_MTL")
    p.add_argument("--features", default="")
    p.add_argument("--output", default="./results/tuning")
    p.add_argument("--mode", choices=["grid", "search", "seeds"],
                   default="grid")
    p.add_argument("--vmap", action="store_true",
                   help="train shape-invariant trials as one multi-trial "
                        "program (grid --param loss_weights only)")
    p.add_argument("--shard-trials", action="store_true",
                   help="with --vmap/--mode seeds: shard the trial axis "
                        "over the visible GPUs (trials must divide evenly)")
    p.add_argument("--param", choices=list(GRID_RANGES), default="l_harm")
    p.add_argument("--space", choices=["arch", "mtl-heads"], default="arch")
    p.add_argument("--algo", choices=["random", "bayes"], default="random")
    p.add_argument("--trials", type=int, default=20)
    p.add_argument("--fold", type=int, default=0)
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--patch-size", type=int, default=68)
    p.add_argument("--tr-steps", type=int, default=0)
    p.add_argument("--v-steps", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    base = ExperimentConfig(
        model=args.model, data_root=args.data, feature_dir=args.features,
        output_dir=args.output, epochs=args.epochs,
        batch_size=args.batch_size, patch_size=args.patch_size,
        patch_shift=args.patch_size, tr_steps=args.tr_steps,
        v_steps=args.v_steps, seed=args.seed)

    rows = []
    if args.mode == "seeds" or (args.mode == "grid" and args.vmap):
        if args.mode == "seeds":
            trials = [{"seed": args.seed + t} for t in range(args.trials)]
        elif args.param == "loss_weights":
            trials = [{"loss_weights": w}
                      for w in GRID_RANGES["loss_weights"]]
        else:
            raise SystemExit("--vmap supports --param loss_weights only "
                             "(other grid params change tensor shapes)")
        mesh = None
        if args.shard_trials:
            mesh = make_mesh(devices=[device] if device.type == "cpu"
                             else None)
        rows = run_vmapped_trials(base, trials, args.fold, mesh=mesh,
                                  device=device)
        for row in rows:
            append_results(args.output, args.fold, row, suffix="Tuning")
            print(row, flush=True)
    elif args.mode == "grid":
        for value in GRID_RANGES[args.param]:
            cfg = _apply_grid_value(base, args.param, value)
            tag = value if not isinstance(value, dict) else max(
                value, key=value.get)
            score = _score(cfg, args.fold, f"{args.param}_{tag}", device)
            row = {args.param: str(value), **score}
            rows.append(row)
            append_results(args.output, args.fold, row, suffix="Tuning")
            print(row, flush=True)
    else:
        rng = np.random.default_rng(args.seed)
        opt = None
        if args.algo == "bayes":
            opt = BayesOptimizer(search_space(args.space), seed=args.seed,
                                 n_init=min(5, max(args.trials // 4, 2)))
        for t in range(args.trials):
            arch = opt.ask() if opt else sample_arch(rng, args.space)
            cfg = dataclasses.replace(base, arch_kwargs=arch)
            score = _score(cfg, args.fold, f"trial{t}", device)
            if opt:
                opt.tell(arch, score["val_loss"])
            row = {"trial": t, **arch, **score}
            rows.append(row)
            append_results(args.output, args.fold, row, suffix="Tuning")
            print(row, flush=True)
    best = min(rows, key=lambda r: r["val_loss"])
    print("best:", best)
    return rows, best


if __name__ == "__main__":
    main()

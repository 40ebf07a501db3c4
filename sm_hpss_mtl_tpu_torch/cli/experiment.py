"""Experiment runner (counterpart of ``sm_hpss_mtl_tpu/cli/experiment.py``):
per CV fold, the 70/30 train/val file split, class-balanced streams, the
model and optimizer, ``fit`` with early stopping and the best checkpoint,
the file-wise test (and optionally the SMR sweep), and the results CSVs.

Two input pipelines, as in the JAX package:

- **device**: the host streams raw-audio crops (``data.audiostream``), and
  each step featurizes them on the device (``train.endtoend``; on CUDA
  through kernel K1 for the Mel-HPSS families, K2 for the full-resolution
  ones);
- **host**: ``Featurizer`` computes whole-file features (on its device;
  K1 or K2 on CUDA) and ``BalancedBatcher`` streams patch batches.

Every model of ``models.zoo`` trains here: the MTL models on the S/M/R/3C
labels (the 5-class model also on N, on the ``cv_info_5_class`` folds)
with the heads' l2 penalty, the single-task ones on the one-hot classes
alone and without it, as the JAX runner does.  The intermediate-fusion
model takes each batch as its two towers' inputs.  With
``frame_level_scaling`` the fold's corpus statistics (``data.stats``, one
featurization of every training file) replace the row standardization in
both pipelines and the tester.

``pipeline='auto'`` is the device pipeline on CUDA and the host pipeline on
the CPU.  Everything runs on ``device``, CUDA unless the caller asks for
the CPU.  Under several processes (``parallel.initialize_from_env``:
torchrun's environment with ``SMHPSS_DISTRIBUTED=1``, or the JAX package's
coordinator variables) each process reads its own round-robin shard of the
fold's training and validation files and draws from its own seed, as the
JAX runner does; one process runs as before.
"""

from __future__ import annotations

import contextlib
import csv
import os
from dataclasses import replace

import numpy as np
import torch

from ..data.audiostream import AudioCache, AudioCropBatcher
from ..data.batcher import BalancedBatcher, BatcherConfig
from ..data.featurize import Featurizer
from ..data.folds import (create_cv_folds, get_train_test_files,
                          load_cv_folds, save_cv_folds)
from ..data.prefetch import DevicePrefetcher
from ..data.stats import load_or_compute_fold_stats
from ..device import resolve_device
from ..eval.metrics import accuracy
from ..eval.tester import FileWiseTester
from ..models.lemaire import init_weights
from ..models.zoo import INPUT_KIND, MTL, ModelSpec, get_spec
from ..parallel.distributed import (initialize_from_env, per_process_seed,
                                    process_file_shard)
from ..train.checkpoint import (checkpoint_exists, restore_checkpoint,
                                update_metadata)
from ..train.config import SERVED_KINDS, ExperimentConfig
from ..train.endtoend import make_audio_eval_step, make_audio_train_step
from ..train.loop import (EARLY_STOP_MIN_DELTA, EARLY_STOP_PATIENCE,
                          FitResult, evaluate_generator, fit)
from ..train.optimizers import for_model
from ..train.state import TrainState, make_predict
from ..utils.profiling import stage_timer
from ..utils.results import (append_results, dump_configuration,
                             dump_model_summary)


def split_train_val(train_files: dict, frac: float = 0.7, seed: int = 0):
    """The reference's per-class 70/30 shuffle split."""
    rng = np.random.default_rng(seed)
    tr, va = {}, {}
    for cls, files in train_files.items():
        files = list(files)
        rng.shuffle(files)
        n = int(len(files) * frac)
        tr[cls], va[cls] = files[:n], files[n:]
        # Tiny corpora: never leave a side empty.
        if files and not tr[cls]:
            tr[cls] = files[:1]
        if files and not va[cls]:
            va[cls] = files[-1:]
    return tr, va


def resolve_clip_patches(config: ExperimentConfig, tr_files: dict) -> int:
    """``config.clip_patches``, or for 0 (adaptive): 1 patch per sampled
    clip when the smallest training class has fewer than
    ``8 * batch_size`` clips (small corpora need clip diversity per step),
    else 4."""
    if config.clip_patches > 0:
        return config.clip_patches
    counts = [len(v) for v in tr_files.values() if len(v)]
    n_min = min(counts) if counts else 0
    return 1 if n_min < 8 * config.batch_size else 4


def _resume_status(meta: dict, csv_log: str, budget: int,
                   patience: int | None = None,
                   min_delta: float | None = None):
    """``(finished, completed_epochs)`` for an existing fold checkpoint.

    A fold is finished when its metadata has the ``completed`` stamp, its
    epoch log spans the budget, or replaying the early-stopping rule over
    the logged val losses stops (checkpoints without the stamp).  Anything
    else is an interrupted run that continues for the remaining budget."""
    patience = EARLY_STOP_PATIENCE if patience is None else patience
    min_delta = EARLY_STOP_MIN_DELTA if min_delta is None else min_delta
    try:
        with open(csv_log) as f:
            rows = [r for r in csv.DictReader(f) if r.get("val_loss")]
    except OSError:
        rows = []
    done = (int(meta["epochs_run"]) if "epochs_run" in meta
            else (int(rows[-1]["epoch"]) + 1 if rows
                  else int(meta.get("epoch", -1)) + 1))
    if meta.get("completed") or done >= budget:
        return True, done
    best, wait = float("inf"), 0
    for r in rows:
        v = float(r["val_loss"])
        if v < best - min_delta:
            best, wait = v, 0
        else:
            wait += 1
            if wait >= patience:
                return True, done  # early-stopped in a prior run
    return False, done


def class_names_for(n_classes: int) -> list[str]:
    names = ["music", "speech", "speech+music", "noise", "speech+noise"]
    if n_classes == 2:
        return names[:2]
    return names[:3] if n_classes == 3 else names[:5]


def _class_subset(files: dict, n_classes: int) -> dict:
    keep = set(class_names_for(n_classes))
    return {k: v for k, v in files.items() if k in keep}


#: ``ExperimentConfig.compute_dtype`` -> the model's compute dtype.
COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def _check_ported(config: ExperimentConfig) -> None:
    if config.model not in MTL:
        raise ValueError(f"unknown model {config.model!r}")
    if INPUT_KIND[config.model] in SERVED_KINDS:
        raise ValueError(
            f"{config.model} is served (cli.segment), not trained: a fold "
            "cuts 68-frame patches with one label each, and its 30-s "
            "contexts need a label per frame over each crop")
    if config.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"unknown compute_dtype {config.compute_dtype!r}")


def model_spec(config: ExperimentConfig) -> ModelSpec:
    """The fold's model with Keras's initialisation from ``config.seed``,
    built as the JAX runner builds it: a preset with ``n_mels = -1``
    (Jang's, Papakostas's) leaves the model its own mel geometry; the input
    rows are the features' and, with ``skewness_vector``, a patch is one
    skewness vector, ``(1, D)`` per row ('Row') or ``(W, 1)`` per column
    ('Col'), which only the time-major models take.  The intermediate-
    fusion model's towers take half the rows each.  ``compute_dtype``
    'bfloat16' builds the model with ``dtype=torch.bfloat16`` (float32
    parameters, bf16 compute, as the JAX runner's ``dtype=jnp.bfloat16``)."""
    feat_cfg = config.feature_config()
    mels_kw = {"n_mels": feat_cfg.n_mels} if feat_cfg.n_mels > 0 else {}
    in_dim, patch_size = feat_cfg.dim, config.patch_size
    if config.skewness_vector:
        if config.input_kind != "time_mel":
            raise ValueError("skewness vectors feed only the time-major "
                             f"Lemaire models, not {config.model!r}")
        if config.skewness_vector == "Row":
            patch_size = 1
        else:
            in_dim = 1
    spec = get_spec(config.model, n_classes=config.n_classes,
                    patch_size=patch_size, in_dim=in_dim,
                    dropout_rate=config.dropout_rate,
                    dtype=COMPUTE_DTYPES[config.compute_dtype], **mels_kw,
                    **(config.arch_kwargs or {}))
    init_weights(spec.module, torch.Generator().manual_seed(config.seed))
    return spec


def _label_map(batches, mtl: bool):
    """A single-task model takes only the one-hot class labels."""
    for x, labels in batches:
        yield (x, labels) if mtl else (x, labels["3C"])


def _device_pipeline(config, spec, feat_cfg, tr_files, va_files, data_seed,
                     optimizer, device, generator, fold_stats, l2_reg):
    """The device pipeline's raw-audio crop streams and audio steps."""
    k = resolve_clip_patches(config, tr_files)
    clips = max(1, -(-config.batch_size // k))
    cache_root = config.feature_dir or config.output_dir
    cache = AudioCache(
        cache_dir=os.path.join(cache_root, "audio_cache") if cache_root
        else None, Tw=config.Tw, Ts=config.Ts)

    def batcher(files, seed):
        return AudioCropBatcher(cache, config.data_root, files, feat_cfg,
                                clips_per_class=clips, n_patches_per_clip=k,
                                patch_size=config.patch_size,
                                patch_shift=config.patch_shift, seed=seed,
                                min_crop_s=config.min_crop_s)

    train_iter = DevicePrefetcher(batcher(tr_files, data_seed + 100), device)
    val_iter = DevicePrefetcher(batcher(va_files, data_seed + 1), device)
    if fold_stats is not None:
        fold_stats = tuple(torch.as_tensor(a, device=device)
                           for a in fold_stats)
    step_kw = dict(patch_size=config.patch_size,
                   patch_shift=config.patch_shift,
                   input_kind=spec.input_kind, mtl=spec.mtl,
                   skewness_vector=config.skewness_vector,
                   fold_stats=fold_stats, loss_weights=config.loss_weights,
                   n_patches_per_clip=k)
    train_step = make_audio_train_step(
        spec.module, optimizer, feat_cfg, generator=generator,
        l2_reg=l2_reg, augment_noise=config.augment_noise, **step_kw)
    eval_step = make_audio_eval_step(spec.module, feat_cfg, **step_kw)
    return train_iter, val_iter, train_step, eval_step


def run_fold(config: ExperimentConfig, cv_file_list: dict, fold: int,
             verbose: bool = True, resume: bool = True,
             device: str | torch.device = "cuda",
             timings: dict | None = None) -> dict:
    """Train and evaluate one fold of ``config.model``; returns the results
    row and what produced it.  ``resume=True``: a finished fold's
    checkpoint is restored instead of retrained, an interrupted one
    continues for the remaining epochs.  ``timings``, where given,
    receives the ``stage_timer`` records of the stages 'fit' and 'test'
    (the file-wise test and the generator evaluation)."""
    device = resolve_device(device)

    def stage(name):
        return (stage_timer(name, timings, verbose=verbose)
                if timings is not None else contextlib.nullcontext())
    _check_ported(config)
    feat_cfg = config.feature_config()
    spec = model_spec(config)
    model = spec.module.to(device)
    cache_dir = (os.path.join(config.feature_dir, config.model,
                              feat_cfg.feat_name)
                 if config.feature_dir else None)
    fz = Featurizer(feat_cfg, cache_dir=cache_dir, device=device)

    train_files, test_files = get_train_test_files(
        cv_file_list, fold, class_names=class_names_for(config.n_classes))
    train_files = _class_subset(train_files, config.n_classes)
    test_files = _class_subset(test_files, config.n_classes)
    tr_files, va_files = split_train_val(train_files, seed=config.seed)
    # Several processes: each reads a disjoint file shard and draws from a
    # decorrelated stream; the model's weights stay seeded by config.seed.
    tr_files = process_file_shard(tr_files)
    va_files = process_file_shard(va_files)
    data_seed = per_process_seed(config.seed)

    fold_stats = None
    if config.frame_level_scaling:
        stats_cache = os.path.join(
            config.feature_dir or config.output_dir,
            f"{config.model}_{feat_cfg.feat_name}_fold{fold}_stats.npz")
        fold_stats = load_or_compute_fold_stats(
            stats_cache, fz, config.data_root, train_files)

    optimizer, _ = for_model(config.model, model.parameters(),
                             tr_steps=max(config.lr_schedule_steps
                                          or config.tr_steps, 1))
    generator = torch.Generator(device=device).manual_seed(config.seed)
    l2_reg = config.l2_reg if spec.mtl else 0.0
    # The intermediate-fusion model ('dual'): the batchers and the tester
    # cut time-major patches and split them in two, the device pipeline
    # featurizes with input_kind='dual'.
    dual = spec.input_kind == "dual"
    bcfg = BatcherConfig(
        batch_size=config.batch_size, patch_size=config.patch_size,
        patch_shift=config.patch_shift, feat_name=feat_cfg.feat_name,
        input_kind=config.input_kind, dual_tower=dual,
        # Augmentation runs on the device inside the train step; the host
        # stream stays clean (and the val stream always is).
        augment_noise=False, frame_level_scaling=config.frame_level_scaling,
        skewness_vector=config.skewness_vector, seed=data_seed)

    pipeline = config.pipeline
    if pipeline == "auto":
        pipeline = "device" if device.type == "cuda" else "host"
    step_overrides = {}
    train_batchers = []
    if pipeline == "device":
        train_iter, val_iter, train_step, eval_step = _device_pipeline(
            config, spec, feat_cfg, tr_files, va_files, data_seed,
            optimizer, device, generator, fold_stats, l2_reg)
        step_overrides = {"train_step": train_step, "eval_step": eval_step}
    elif pipeline == "host":
        train_batchers = [
            BalancedBatcher(fz, config.data_root, tr_files,
                            replace(bcfg, seed=data_seed + 100 + w),
                            fold_stats=fold_stats)
            for w in range(max(config.prefetch_workers, 1))]
        train_iter = DevicePrefetcher(train_batchers, device)
        val_iter = DevicePrefetcher(
            BalancedBatcher(fz, config.data_root, va_files,
                            replace(bcfg, seed=data_seed + 1),
                            fold_stats=fold_stats), device)
    else:
        raise ValueError(f"unknown pipeline {config.pipeline!r}")

    op_dir = os.path.join(config.output_dir, config.model,
                          feat_cfg.feat_name)
    os.makedirs(op_dir, exist_ok=True)
    summary_path = os.path.join(op_dir, "model_summary.txt")
    if not os.path.exists(summary_path):
        try:
            dump_model_summary(summary_path, model)
        except OSError as e:  # the summary is best effort, never fatal
            print(f"model summary skipped: {type(e).__name__}: {e}")

    ckpt_dir = os.path.join(op_dir, f"fold{fold}_ckpt")
    csv_log = os.path.join(op_dir, f"fold{fold}_log.csv")

    def _run_fit(state=None, initial_epoch=0, initial_best=float("inf")):
        result = fit(model, optimizer, _label_map(train_iter, spec.mtl),
                     _label_map(val_iter, spec.mtl), mtl=spec.mtl,
                     l2_reg=l2_reg,
                     augment_noise=config.augment_noise,
                     epochs=config.epochs,
                     steps_per_epoch=max(config.tr_steps, 1),
                     val_steps=max(config.v_steps, 1),
                     loss_weights=config.loss_weights, generator=generator,
                     state=state, initial_epoch=initial_epoch,
                     initial_best=initial_best, checkpoint_dir=ckpt_dir,
                     csv_log=csv_log, verbose=verbose, **step_overrides)
        if checkpoint_exists(ckpt_dir):
            # Stamp the outcome, so that a later resume tells a finished
            # fold from one whose process died mid-budget.
            update_metadata(ckpt_dir, {
                "completed": True,
                "epochs_run": initial_epoch + len(result.history),
                "stopped_early": result.stopped_early,
                "training_time_s": round(result.training_time, 2),
                "wall_time_s": round(result.wall_time, 2)})
        return result

    with stage("fit"):
        try:
            if resume and checkpoint_exists(ckpt_dir):
                state, meta = restore_checkpoint(
                    ckpt_dir, TrainState(model, optimizer))
                finished, done_epochs = _resume_status(meta, csv_log,
                                                       config.epochs)
                if finished:
                    result = FitResult(
                        state=state,
                        best_val_loss=meta.get("val_loss", float("nan")),
                        best_epoch=meta.get("epoch", -1))
                    if verbose:
                        print(f"fold {fold}: restored finished checkpoint "
                              f"(best epoch {result.best_epoch})",
                              flush=True)
                else:
                    if verbose:
                        print(f"fold {fold}: checkpoint is mid-training "
                              f"({done_epochs}/{config.epochs} epochs), "
                              "resuming for the remaining budget",
                              flush=True)
                    result = _run_fit(
                        state=state, initial_epoch=done_epochs,
                        initial_best=meta.get("val_loss", float("inf")))
            else:
                result = _run_fit()
        finally:
            train_iter.close()
            val_iter.close()

    with stage("test"):
        predict = make_predict(model)
        tester = FileWiseTester(
            featurizer=fz, predict_fn=lambda x: predict(result.state, x),
            folder=config.data_root, feat_name=feat_cfg.feat_name,
            input_kind=config.input_kind, dual_tower=dual,
            patch_size=config.patch_size,
            test_patch_shift=config.test_patch_shift,
            frame_level_scaling=config.frame_level_scaling,
            fold_stats=fold_stats, skewness_vector=config.skewness_vector)
        test_res = tester.test_model(test_files, verbose=verbose)

        row = {"val_loss": round(result.best_val_loss, 4),
               "epochs_run": len(result.history),
               "train_time_s": round(result.training_time, 1),
               "wall_time_s": round(result.wall_time, 1)}
        if config.ts_steps:
            # The reference's evaluate-on-generator metrics (TS_STEPS
            # batches of the balanced test stream).
            eval_steps = max(config.ts_steps, 1)
            if (config.max_eval_steps
                    and eval_steps > config.max_eval_steps):
                print(f"fold {fold}: generator eval capped at "
                      f"{config.max_eval_steps} of {eval_steps} TS steps "
                      "(config.max_eval_steps; 0 = uncapped)", flush=True)
                eval_steps = config.max_eval_steps
            test_iter = DevicePrefetcher(
                BalancedBatcher(fz, config.data_root, test_files,
                                replace(bcfg, seed=config.seed + 2),
                                fold_stats=fold_stats), device)
            try:
                gen = evaluate_generator(model, result.state,
                                         _label_map(test_iter, spec.mtl),
                                         eval_steps, mtl=spec.mtl,
                                         loss_weights=config.loss_weights)
            finally:
                test_iter.close()
            row["gen_loss"] = round(gen["loss"], 4)
            row["gen_accuracy"] = round(gen["accuracy"], 4)
    row["accuracy"] = accuracy(test_res["ConfMat"])
    class_names = (["mu", "sp", "spmu", "no", "spno"])[:config.n_classes]
    for i, cls in enumerate(class_names):
        row[f"Prec_{cls}"] = test_res["precision"][i]
        row[f"Rec_{cls}"] = test_res["recall"][i]
        row[f"F1_{cls}"] = test_res["fscore"][i]
    append_results(op_dir, fold, row)
    # Cache behaviour: the featuregram cache's counters and, on the host
    # pipeline, the patch LRU's summed over the worker batchers.
    cache_stats = {"featurizer": dict(fz.stats)}
    if pipeline == "host":
        cache_stats["patch_lru"] = {
            k: sum(b.cache_stats[k] for b in train_batchers)
            for k in ("hits", "misses", "evictions")}
    return {"row": row, "test": test_res, "fit": result, "op_dir": op_dir,
            "tester": tester, "test_files": test_files,
            "cache_stats": cache_stats, "pipeline": pipeline}


def load_or_create_folds(config: ExperimentConfig) -> dict:
    """The reference's CV-fold bootstrap: load the corpus's
    ``cv_info[_5_class]/cv_file_list.pkl``, or create and save it."""
    with_noise = config.n_classes == 5
    cv_path = os.path.join(config.data_root,
                           "cv_info_5_class" if with_noise else "cv_info")
    if os.path.exists(os.path.join(cv_path, "cv_file_list.pkl")):
        return load_cv_folds(cv_path)
    cv_file_list = create_cv_folds(config.data_root, cv=config.cv_folds,
                                   with_noise=with_noise, seed=config.seed)
    save_cv_folds(cv_file_list, cv_path)
    return cv_file_list


def run_experiment(config: ExperimentConfig, folds=None, *,
                   smr_sweep: bool = False, verbose: bool = True,
                   resume: bool = True,
                   device: str | torch.device = "cuda",
                   timings: dict | None = None) -> list:
    """Run ``folds`` (default: all) of ``config`` on ``device``: CUDA unless
    the caller passes ``device="cpu"``; CUDA without a GPU raises.
    ``timings`` receives each fold's stage times (``run_fold``), the last
    fold's where there are several."""
    device = resolve_device(device)
    _check_ported(config)
    # Several processes where the environment asks for them; a no-op in one.
    initialize_from_env()
    cv_file_list = load_or_create_folds(config)

    if not config.tr_steps:
        keep = set(class_names_for(config.n_classes))
        config = config.with_steps_from_durations(
            {k: v for k, v in cv_file_list["total_duration"].items()
             if k in keep})

    op_dir = os.path.join(config.output_dir, config.model,
                          config.feat_name)
    dump_configuration(op_dir, config)

    folds = folds if folds is not None else range(config.cv_folds)
    results = []
    for fold in folds:
        out = run_fold(config, cv_file_list, fold, verbose=verbose,
                       resume=resume, device=device, timings=timings)
        if smr_sweep:
            sweep = out["tester"].smr_sweep(out["test_files"],
                                            config.test_smr_levels)
            out["smr_sweep"] = sweep
            for db, res in sweep.items():
                append_results(out["op_dir"], fold,
                               {"SMR": db, "acc": accuracy(res["ConfMat"])},
                               suffix="SMR")
        results.append(out)
    return results

"""The port's experiment runner, ``cli.mtl`` and ``cli.baseline`` against
the JAX package on a toy corpus (``make_toy_musan(n_per_class=9,
duration_s=2.0)``), on the CPU.

Whole runs are not compared value for value (the RNGs differ): a fold of
each pipeline must write the files and columns the JAX run writes
(``Performance.csv``, ``Configuration.csv``, ``fold0_log.csv``), a finite
val loss and a checkpoint.  The helpers (the resume rule, the train/val
split, the clip patches, the step counts) match the JAX functions exactly.
The model is a narrow Lemaire-MTL (8 filters, 1 stack, dilations (1, 2),
16 mel bands, 16-frame patches, 2 per class), or its single-task twin, or
an image-family model at 16-frame patches (Jang's with 24 mel bands).
"""

import csv
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from sm_hpss_mtl_tpu.cli import experiment as jexp
from sm_hpss_mtl_tpu.train import config as jconfig
from sm_hpss_mtl_tpu.models import get_model as jget_model
from sm_hpss_mtl_tpu_torch.cli import baseline as tbaseline
from sm_hpss_mtl_tpu_torch.cli import experiment as texp
from sm_hpss_mtl_tpu_torch.cli import mtl as tmtl
from sm_hpss_mtl_tpu_torch.data import audio as taudio
from sm_hpss_mtl_tpu_torch.train import config as tconfig

torch.set_num_threads(2)

TINY = dict(model="Lemaire_et_al_MTL", epochs=2, batch_size=2,
            patch_size=16, patch_shift=16, tr_steps=1, v_steps=1,
            augment_noise=False, n_mels_override=16, seed=0,
            arch_kwargs=dict(n_filters=8, nb_stacks=1, Nd=2))


@pytest.fixture(scope="module")
def toy_root(tmp_path_factory):
    return taudio.make_toy_musan(str(tmp_path_factory.mktemp("toy_e2e")),
                                 n_per_class=9, duration_s=2.0)


def _header(path, delimiter):
    with open(path) as f:
        return next(csv.reader(f, delimiter=delimiter))


def _config_keys(path):
    with open(path) as f:
        return [line.split("\t", 1)[0] for line in f]


@pytest.fixture(scope="module")
def jax_run(toy_root, tmp_path_factory):
    """One JAX fold (host pipeline, the JAX default off the TPU)."""
    out = str(tmp_path_factory.mktemp("jax_results"))
    cfg = jconfig.ExperimentConfig(data_root=toy_root, output_dir=out,
                                   pipeline="host", dft_precision="highest",
                                   **TINY)
    res = jexp.run_experiment(cfg, folds=[0], verbose=False)[0]
    return res["op_dir"]


@pytest.mark.parametrize("pipeline", ["host", "device"])
def test_run_experiment_writes_the_jax_columns(toy_root, tmp_path, jax_run,
                                               pipeline):
    cfg = tconfig.ExperimentConfig(data_root=toy_root,
                                   output_dir=str(tmp_path),
                                   pipeline=pipeline, **TINY)
    out = texp.run_experiment(cfg, folds=[0], verbose=False,
                              device="cpu")[0]
    assert out["pipeline"] == pipeline
    row = out["row"]
    assert np.isfinite(row["val_loss"]) and 0.0 <= row["accuracy"] <= 1.0
    assert len(out["fit"].history) == 2
    op_dir = out["op_dir"]
    assert op_dir == os.path.join(str(tmp_path), "Lemaire_et_al_MTL",
                                  "LogMelHarmPercSpec")
    assert (_header(os.path.join(op_dir, "Performance.csv"), "\t")
            == _header(os.path.join(jax_run, "Performance.csv"), "\t"))
    assert (_header(os.path.join(op_dir, "fold0_log.csv"), ",")
            == _header(os.path.join(jax_run, "fold0_log.csv"), ","))
    assert (_config_keys(os.path.join(op_dir, "Configuration.csv"))
            == _config_keys(os.path.join(jax_run, "Configuration.csv")))
    ckpt = os.path.join(op_dir, "fold0_ckpt")
    assert os.path.exists(os.path.join(ckpt, "state", "model.npz"))
    with open(os.path.join(ckpt, "metadata.json")) as f:
        meta = json.load(f)
    assert meta["completed"] and meta["epochs_run"] == 2
    assert os.path.exists(os.path.join(op_dir, "model_summary.txt"))
    stats = out["cache_stats"]
    assert stats["featurizer"]["computes"] > 0
    assert ("patch_lru" in stats) == (pipeline == "host")


def test_resume_completes_interrupted_fold(toy_root, tmp_path):
    """A fold whose process died mid-budget resumes for the remaining
    epochs; a finished one is restored and trains nothing (JAX's
    ``test_resume_completes_interrupted_fold``)."""
    cfg = tconfig.ExperimentConfig(data_root=toy_root,
                                   output_dir=str(tmp_path),
                                   pipeline="device", **TINY)
    out1 = texp.run_experiment(cfg, folds=[0], verbose=False,
                               device="cpu")[0]
    assert len(out1["fit"].history) == 2
    meta_path = os.path.join(out1["op_dir"], "fold0_ckpt", "metadata.json")
    with open(meta_path) as f:
        meta = json.load(f)
    assert meta["completed"] and meta["epochs_run"] == 2
    for k in ("completed", "epochs_run", "stopped_early"):
        meta.pop(k, None)
    with open(meta_path, "w") as f:
        json.dump(meta, f)

    cfg4 = dataclasses.replace(cfg, epochs=4)
    out2 = texp.run_experiment(cfg4, folds=[0], verbose=False,
                               device="cpu")[0]
    assert len(out2["fit"].history) == 2
    with open(os.path.join(out1["op_dir"], "fold0_log.csv")) as f:
        rows = list(csv.DictReader(f))
    assert [int(r["epoch"]) for r in rows] == [0, 1, 2, 3]
    with open(meta_path) as f:
        meta2 = json.load(f)
    assert meta2["completed"] and meta2["epochs_run"] == 4
    out3 = texp.run_experiment(cfg4, folds=[0], verbose=False,
                               device="cpu")[0]
    assert len(out3["fit"].history) == 0


def _write_log(path, losses):
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["epoch", "loss", "val_loss"])
        w.writeheader()
        for i, v in enumerate(losses):
            w.writerow({"epoch": i, "loss": v, "val_loss": v})


@pytest.mark.parametrize("meta,losses,budget", [
    ({"epoch": 1}, [1.0, 0.8], 10),                   # interrupted
    ({"epoch": 0}, [1.0] * 6, 10),                    # early-stopped
    ({"epoch": 1}, [1.0, 0.9], 2),                    # budget reached
    ({"completed": True, "epochs_run": 3}, [1.0, 0.9], 10),
    ({"epoch": 4}, None, 10),                         # no log
])
def test_resume_status_matches_jax(tmp_path, meta, losses, budget):
    log = str(tmp_path / "log.csv")
    if losses is not None:
        _write_log(log, losses)
    assert (texp._resume_status(meta, log, budget)
            == jexp._resume_status(meta, log, budget))


def test_split_clip_patches_and_steps_match_jax():
    for seed, sizes in ((0, (2, 1, 7)), (3, (30, 300, 50)), (5, (0, 4, 9))):
        files = {c: [f"{c}{i}" for i in range(n)] for c, n in
                 zip(("music", "speech", "speech+music"), sizes)}
        assert (texp.split_train_val(files, seed=seed)
                == jexp.split_train_val(files, seed=seed))
        for bs, cp in ((16, 0), (2, 0), (16, 3)):
            kw = dict(batch_size=bs, clip_patches=cp)
            assert (texp.resolve_clip_patches(
                tconfig.ExperimentConfig(**kw), files)
                == jexp.resolve_clip_patches(
                    jconfig.ExperimentConfig(**kw), files))
    hours = {"music": 1.7, "speech": 2.3, "speech+music": 2.3}
    for kw in ({}, dict(batch_size=4, patch_shift=34, cv_folds=5)):
        got = tconfig.ExperimentConfig(**kw).with_steps_from_durations(hours)
        want = jconfig.ExperimentConfig(**kw).with_steps_from_durations(hours)
        assert ((got.tr_steps, got.v_steps, got.ts_steps)
                == (want.tr_steps, want.v_steps, want.ts_steps))
        assert got.tr_steps > 0


def test_config_matches_jax_but_for_the_dft_precision():
    got = tconfig.ExperimentConfig(n_mels_override=40)
    want = jconfig.ExperimentConfig(n_mels_override=40)
    names = [f.name for f in dataclasses.fields(want)]
    assert [f.name for f in dataclasses.fields(got)] == names
    differ = [n for n in names if getattr(got, n) != getattr(want, n)]
    assert differ == ["dft_precision"] and got.dft_precision == "highest"
    assert got.input_kind == want.input_kind == "time_mel"
    assert tconfig.TIME_MAJOR_MODELS == jconfig.TIME_MAJOR_MODELS
    assert (dataclasses.asdict(got.feature_config())
            == dataclasses.asdict(dataclasses.replace(
                want, dft_precision="highest").feature_config()))


def test_cli_mtl_needs_device_cpu_without_a_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--data", str(tmp_path), "--output", str(tmp_path / "res")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmtl.main(argv)
    with pytest.raises(SystemExit):                 # argparse refuses it
        tmtl.main(argv + ["--device", "cpu", "--dft-precision", "bf16"])
    # The JAX CLI's default precision is taken; the fold then fails on the
    # empty corpus, as the --bf16 run below does.
    with pytest.raises(FileNotFoundError):
        tmtl.main(argv + ["--device", "cpu", "--dft-precision", "bf16x3"])
    # bf16 compute is ported: the runner takes --bf16, the fold then fails
    # on the empty corpus; a compute dtype JAX does not have is refused.
    with pytest.raises(FileNotFoundError):
        tmtl.main(argv + ["--device", "cpu", "--bf16"])
    with pytest.raises(ValueError, match="compute_dtype"):
        texp._check_ported(tconfig.ExperimentConfig(compute_dtype="float16"))
    # Lemaire's variants are ported (ROADMAP §1 item 7): the runner takes
    # them, the folds then fail on the empty corpus.
    for model in ("Lemaire_et_al_Cascaded_MTL", "Lemaire_et_al_MTL_5class",
                  "Lemaire_et_al_MTL_IF"):
        texp._check_ported(tconfig.ExperimentConfig(model=model))
        with pytest.raises(FileNotFoundError):
            tmtl.main(argv + ["--device", "cpu", "--model", model])
    with pytest.raises(ValueError, match="unknown model"):
        tmtl.main(argv + ["--device", "cpu", "--model", "Lemaire_MTL"])


@pytest.fixture(scope="module")
def jax_single_task_run(toy_root, tmp_path_factory):
    """One JAX fold of the single-task narrow Lemaire (host pipeline): the
    single-task runs' columns (``accuracy``, no head losses)."""
    out = str(tmp_path_factory.mktemp("jax_single"))
    cfg = jconfig.ExperimentConfig(data_root=toy_root, output_dir=out,
                                   pipeline="host", dft_precision="highest",
                                   **{**TINY, "model": "Lemaire_et_al"})
    return jexp.run_experiment(cfg, folds=[0], verbose=False)[0]["op_dir"]


def _same_columns(op_dir, jax_dir):
    assert (_header(os.path.join(op_dir, "Performance.csv"), "\t")
            == _header(os.path.join(jax_dir, "Performance.csv"), "\t"))
    assert (_header(os.path.join(op_dir, "fold0_log.csv"), ",")
            == _header(os.path.join(jax_dir, "fold0_log.csv"), ","))
    assert (_config_keys(os.path.join(op_dir, "Configuration.csv"))
            == _config_keys(os.path.join(jax_dir, "Configuration.csv")))


IMAGE = dict(epochs=2, batch_size=2, patch_size=16, patch_shift=16,
             tr_steps=1, v_steps=1, augment_noise=False, seed=0)


@pytest.mark.parametrize("model,pipeline", [
    ("Jang_et_al_MTL", "host"), ("Jang_et_al_MTL", "device"),
    ("Papakostas_et_al_MTL", "device")])
def test_image_mtl_fold_writes_the_jax_columns(toy_root, tmp_path, jax_run,
                                               model, pipeline):
    kw = {"n_mels_override": 24} if model.startswith("Jang") else {}
    cfg = tconfig.ExperimentConfig(model=model, data_root=toy_root,
                                   output_dir=str(tmp_path),
                                   pipeline=pipeline, **IMAGE, **kw)
    out = texp.run_experiment(cfg, folds=[0], verbose=False,
                              device="cpu")[0]
    assert out["pipeline"] == pipeline
    assert np.isfinite(out["row"]["val_loss"])
    assert out["test"]["ConfMat"].shape == (3, 3)
    assert out["op_dir"] == os.path.join(str(tmp_path), model,
                                         cfg.feat_name)
    _same_columns(out["op_dir"], jax_run)
    assert os.path.exists(os.path.join(out["op_dir"], "fold0_ckpt", "state",
                                       "model.npz"))


def test_model_spec_keeps_the_model_mel_geometry():
    """Presets with ``n_mels = -1`` (Jang's, Papakostas's) give the model
    no mel count, as the JAX runner does: Jang-MTL's mel-scale layers keep
    the JAX zoo's 120 bands (the runner passed -1 before), and each image
    model's first dense layer is sized for its features' rows."""
    cfg = tconfig.ExperimentConfig(model="Jang_et_al_MTL")
    assert cfg.feature_config().n_mels == -1
    spec = texp.model_spec(cfg)
    want = jget_model("Jang_et_al_MTL").module.n_mels     # JAX's default
    assert spec.module.melCl_H.kernel.shape[0] == want == 120
    assert (spec.input_kind, spec.mtl) == ("image", True)
    spec = texp.model_spec(tconfig.ExperimentConfig(
        model="Papakostas_et_al_MTL"))
    assert spec.module.fc1.dense.in_features == 13 * 2 * 512   # 402 rows
    spec = texp.model_spec(tconfig.ExperimentConfig(
        model="Doukhan_et_al_MTL", n_mels_override=20))
    assert spec.module.fc1.dense.in_features == 5 * 256        # 40 rows
    # A skewness vector feeds (1, D) or (W, 1) patches; only the time-major
    # models take it.
    tcn = texp.model_spec(tconfig.ExperimentConfig(
        n_mels_override=16, skewness_vector="Row",
        arch_kwargs=TINY["arch_kwargs"])).module
    assert (tcn.tcn.initial_conv.in_channels, tcn.heads.C_out.in_features
            ) == (32, 8)
    tcn = texp.model_spec(tconfig.ExperimentConfig(
        skewness_vector="Col", arch_kwargs=TINY["arch_kwargs"])).module
    assert (tcn.tcn.initial_conv.in_channels, tcn.heads.C_out.in_features
            ) == (1, 68 * 8)
    with pytest.raises(ValueError, match="time-major"):
        texp.model_spec(tconfig.ExperimentConfig(model="Jang_et_al_MTL",
                                                 skewness_vector="Row"))


@pytest.mark.parametrize("pipeline", ["host", "device"])
def test_single_task_fold_takes_the_3C_labels_and_no_l2(
        toy_root, tmp_path, jax_single_task_run, monkeypatch, pipeline):
    """``cli.baseline`` with Jang's single-task model: the train and val
    streams hand the model only the one-hot classes, the step applies no
    l2 (JAX applies it only to MTL models), and the fold writes the JAX
    single-task run's columns."""
    seen = {}
    fit, audio_step = texp.fit, texp.make_audio_train_step

    def spy_fit(model, optimizer, train_iter, val_iter, **kw):
        seen["fit"] = kw

        def labels_of(it, name):
            for x, y in it:
                seen.setdefault(name, type(y))
                yield x, y
        return fit(model, optimizer, labels_of(train_iter, "train"),
                   labels_of(val_iter, "val"), **kw)

    def spy_step(*args, **kw):
        seen["step"] = kw
        return audio_step(*args, **kw)

    monkeypatch.setattr(texp, "fit", spy_fit)
    monkeypatch.setattr(texp, "make_audio_train_step", spy_step)
    out = tbaseline.main(["--data", toy_root, "--output", str(tmp_path),
                          "--model", "Jang_et_al", "--device", "cpu",
                          "--pipeline", pipeline, "--epochs", "2",
                          "--batch-size", "2", "--patch-size", "16",
                          "--patch-shift", "16", "--tr-steps", "1",
                          "--v-steps", "1", "--no-augment", "--folds", "0"])[0]
    assert seen["train"] is seen["val"] is torch.Tensor
    assert seen["fit"]["mtl"] is False and seen["fit"]["l2_reg"] == 0.0
    if pipeline == "device":
        assert seen["step"]["mtl"] is False and seen["step"]["l2_reg"] == 0.0
    hist = out["fit"].history
    assert "accuracy" in hist[0] and "S_loss" not in hist[0]
    assert out["op_dir"] == os.path.join(str(tmp_path), "Jang_et_al",
                                         "LogSpec")
    _same_columns(out["op_dir"], jax_single_task_run)


@pytest.mark.parametrize("option,pipeline", [
    ("frame_level_scaling", "host"), ("frame_level_scaling", "device"),
    ("Row", "host"), ("Col", "device")])
def test_scaled_and_skewness_folds_write_the_jax_columns(
        toy_root, tmp_path, jax_run, option, pipeline):
    """``--frame-level-scaling`` (the fold's statistics cached under the
    JAX package's name) and ``--skewness-vector`` with Lemaire-MTL."""
    kw = ({"frame_level_scaling": True} if option == "frame_level_scaling"
          else {"skewness_vector": option})
    feat = str(tmp_path / "features")
    cfg = tconfig.ExperimentConfig(data_root=toy_root, feature_dir=feat,
                                   output_dir=str(tmp_path / "res"),
                                   pipeline=pipeline, **TINY, **kw)
    out = texp.run_experiment(cfg, folds=[0], verbose=False,
                              device="cpu")[0]
    assert np.isfinite(out["row"]["val_loss"])
    _same_columns(out["op_dir"], jax_run)
    stats = os.path.join(feat, "Lemaire_et_al_MTL_LogMelHarmPercSpec_"
                               "fold0_stats.npz")
    assert os.path.exists(stats) == (option == "frame_level_scaling")
    tester = out["tester"]
    assert tester.skewness_vector == kw.get("skewness_vector")
    if option == "frame_level_scaling":
        with np.load(stats) as z:
            np.testing.assert_array_equal(tester.fold_stats[0], z["mean"])
        assert tester.frame_level_scaling

"""The port's experiment runner and ``cli.mtl`` against the JAX package on a
toy corpus (``make_toy_musan(n_per_class=9, duration_s=2.0)``), on the CPU.

Whole runs are not compared value for value (the RNGs differ): a fold of
each pipeline must write the files and columns the JAX run writes
(``Performance.csv``, ``Configuration.csv``, ``fold0_log.csv``), a finite
val loss and a checkpoint.  The helpers (the resume rule, the train/val
split, the clip patches, the step counts) match the JAX functions exactly.
The model is a narrow Lemaire-MTL (8 filters, 1 stack, dilations (1, 2),
16 mel bands, 16-frame patches, 2 per class).
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
    with pytest.raises(NotImplementedError, match="item 2c"):
        tmtl.main(argv + ["--device", "cpu", "--bf16"])
    with pytest.raises(SystemExit):                 # argparse refuses it
        tmtl.main(argv + ["--device", "cpu", "--dft-precision", "bf16x3"])
    for extra, item in ((["--frame-level-scaling"], "2c"),
                        (["--skewness-vector", "Row"], "2c"),
                        (["--model", "Jang_et_al_MTL"], "2c"),
                        (["--model", "Doukhan_et_al_MTL"], "7")):
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            tmtl.main(argv + ["--device", "cpu"] + extra)

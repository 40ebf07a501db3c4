"""Intermediate and late fusion in the port against the JAX package: the
dual tester (the twin towers' inputs), ``LateFusionTester`` (the α-blend
of a harmonic-feature and a percussive-feature model), the
``cli.fuse_intermediate`` and ``cli.fuse_late`` drivers, and
``cli.segment`` on the fusion model, which neither package serves.

Testers on the same weights (narrow models: 8 filters, 1 stack; 16 mel
bands): labels and confusion matrices equal; the late-fusion blend within
1e-5 of JAX's; the fusion model's predictions within ``test_torch_eval``'s
tester bar of 1e-4, both testers on the same featuregrams.  At 16 bands
some rows of a toy item span under 2 dB at -60 dB, where one float32 ulp
of the row's value is 8e-6 after standardization: the two packages'
standardizations (summation order) leave the patches 2.5e-5 apart and the
predictions 1.1e-5 apart, and the featurizers' own float32 differences (up
to 1e-3 dB, held by ``test_torch_eval``) would move them by 2.4e-4.  A wrong
patch, split or head moves them by 1e-2 or more.
The drivers write the JAX drivers' files and columns; ``cli.fuse_late``,
whose models are built at full width by both drivers, writes JAX's row.
The toy corpus has a -40 dB noise floor (``test_torch_eval`` explains).
"""

import csv
import dataclasses
import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax
import jax.numpy as jnp

from sm_hpss_mtl_tpu.cli import fuse_intermediate as jfuse_if
from sm_hpss_mtl_tpu.cli import fuse_late as jfuse_late
from sm_hpss_mtl_tpu.cli import mtl as jmtl
from sm_hpss_mtl_tpu.cli import segment as jcli
from sm_hpss_mtl_tpu.data import featurize as jfeat
from sm_hpss_mtl_tpu.eval import fusion as jfusion
from sm_hpss_mtl_tpu.eval import segment as jseg
from sm_hpss_mtl_tpu.eval import tester as jtester
from sm_hpss_mtl_tpu.models import get_model as jget_model
from sm_hpss_mtl_tpu.ops import patches as jpatches
from sm_hpss_mtl_tpu_torch import weights
from sm_hpss_mtl_tpu_torch.cli import fuse_intermediate as tfuse_if
from sm_hpss_mtl_tpu_torch.cli import fuse_late as tfuse_late
from sm_hpss_mtl_tpu_torch.cli import mtl as tmtl
from sm_hpss_mtl_tpu_torch.cli import segment as tcli
from sm_hpss_mtl_tpu_torch.data import audio as taudio
from sm_hpss_mtl_tpu_torch.data import featurize as tfeat
from sm_hpss_mtl_tpu_torch.data import folds as tfolds
from sm_hpss_mtl_tpu_torch.eval import fusion as tfusion
from sm_hpss_mtl_tpu_torch.eval import tester as ttester
from sm_hpss_mtl_tpu_torch.models.zoo import get_model
from sm_hpss_mtl_tpu_torch.train import checkpoint as tckpt
from sm_hpss_mtl_tpu_torch.train import optimizers as toptim
from sm_hpss_mtl_tpu_torch.train.state import TrainState

torch.set_num_threads(2)

IF = "Lemaire_et_al_MTL_IF"
NARROW = dict(n_filters=8, nb_stacks=1)
N_MELS = 16
PRED_ATOL = 1e-5
DUAL_ATOL = 1e-4
LEVELS = (0, 10)


@pytest.fixture
def jax_constant_rows_fixed(monkeypatch):
    """The JAX tester's and segmenter's standardization with constant rows
    centred to 0 (``test_torch_segment`` explains the JAX helper's
    fault); patched here, not edited."""
    def fixed(FV):
        FV = np.asarray(FV)
        out = np.array(jpatches.standardize_rows(FV))
        out[FV.max(axis=-1) == FV.min(axis=-1)] = 0.0
        return out

    monkeypatch.setattr(jtester, "standardize_rows", fixed)
    monkeypatch.setattr(jseg, "standardize_rows", fixed)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Six music and six speech files of 1.5-2.5 s, one clip of 0.15 s per
    class (12 frames: the short-clip route) in fold 0, a noise floor."""
    root = str(tmp_path_factory.mktemp("toy_fusion"))
    taudio.make_toy_musan(root, n_per_class=6, duration_s=(1.5, 2.5),
                          seed=6)
    rng = np.random.default_rng(7)
    for cls, synth in (("music", taudio._synth_music),
                       ("speech", taudio._synth_speech)):
        name = f"{cls}-short-0000"
        taudio.write_wav(os.path.join(root, cls, name + ".wav"),
                         taudio.normalize_signal_np(synth(rng, 2400, 16000)))
        with open(os.path.join(root, "annotations", cls + ".csv"), "a",
                  newline="") as f:
            csv.writer(f).writerow([name, "short"])
    for cls in ("music", "speech"):
        for name in sorted(os.listdir(os.path.join(root, cls))):
            path = os.path.join(root, cls, name)
            x, _ = taudio.read_wav(path)
            taudio.write_wav(path, x + 1e-2 * rng.standard_normal(len(x)))
    cv = tfolds.create_cv_folds(root, seed=0)
    tfolds.save_cv_folds(cv, os.path.join(root, "cv_info"))
    _, test = tfolds.get_train_test_files(cv, 0)
    assert "music-short-0000.wav" in test["music"]
    return root, test


def _flax(name, seed, sample, **kw):
    module = jget_model(name, n_mels=N_MELS, **kw).module
    v = module.init({"params": jax.random.PRNGKey(seed),
                     "dropout": jax.random.PRNGKey(seed + 1)}, sample,
                    train=False)
    return module, jax.tree_util.tree_map(np.asarray, dict(v))


def _testers(root, module, v, net, feat_name, dual_tower=False):
    cfg = dict(feat_name=feat_name, n_mels=N_MELS)
    want = jtester.FileWiseTester(
        featurizer=jfeat.Featurizer(jfeat.FeatureConfig(**cfg), bucket=False,
                                    use_pallas=False),
        predict_fn=jax.jit(lambda x: module.apply(v, x, train=False)),
        folder=root, feat_name=feat_name, dual_tower=dual_tower)
    net.load_state_dict(weights.from_flax(v))
    got = ttester.FileWiseTester(
        featurizer=tfeat.Featurizer(tfeat.FeatureConfig(**cfg), bucket=False,
                                    device="cpu"),
        predict_fn=net.eval(), folder=root, feat_name=feat_name,
        dual_tower=dual_tower)
    return want, got


def _same_results(got, want, atol=None):
    if atol is not None:
        np.testing.assert_allclose(got["Predictions"], want["Predictions"],
                                   rtol=0, atol=atol)
    for k in ("PtdLabels", "GroundTruth", "ConfMat"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_dual_tester_and_sweep_match_jax(corpus, jax_constant_rows_fixed):
    """Both testers take the port's featuregrams (the featurizers are held
    to each other by ``test_torch_eval``), so this holds the patches, their
    standardization, the split into the twin inputs and the model, to
    ``DUAL_ATOL``."""
    root, test = corpus
    half = jnp.zeros((2, 68, N_MELS))
    module, v = _flax(IF, 0, {"harm_input": half, "perc_input": half},
                      **NARROW)
    net = get_model(IF, n_mels=N_MELS, **NARROW)
    want, got = _testers(root, module, v, net, "LogMelHarmPercSpec",
                         dual_tower=True)
    want.featurizer = got.featurizer
    res_got, res_want = got.test_model(test), want.test_model(test)
    assert set(res_got["GroundTruth"]) == {0, 1, 2}
    _same_results(res_got, res_want, DUAL_ATOL)
    sweep_got = got.smr_sweep(test, levels=LEVELS)
    sweep_want = want.smr_sweep(test, levels=LEVELS)
    for db in LEVELS:
        _same_results(sweep_got[db], sweep_want[db], DUAL_ATOL)


def test_late_fusion_tester_matches_jax(corpus, jax_constant_rows_fixed):
    root, test = corpus
    sides = {}
    for feat, seed in (("LogMelHarmSpec", 2), ("LogMelPercSpec", 4)):
        module, v = _flax("Lemaire_et_al_MTL", seed,
                          jnp.zeros((2, 68, N_MELS)), Nd=2, **NARROW)
        net = get_model("Lemaire_et_al_MTL", in_dim=N_MELS, Nd=2, **NARROW)
        sides[feat] = _testers(root, module, v, net, feat)
    (jh, th), (jp, tp) = sides["LogMelHarmSpec"], sides["LogMelPercSpec"]
    for alpha in (0.5, 0.3):
        got = tfusion.LateFusionTester(th, tp, alpha=alpha).test_model(test)
        want = jfusion.LateFusionTester(jh, jp, alpha=alpha).test_model(test)
        assert set(got) == set(want) | {"Predictions"}
        _same_results(got, want)
        for k in ("precision", "recall", "fscore"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # The blend over the shorter of the two predictions, at the annotated
    # SMR of a pair.
    pair = test["speech+music"][0]
    sp = os.path.join(root, "speech", pair["speech"])
    mu = os.path.join(root, "music", pair["music"])
    fused = tfusion.LateFusionTester(th, tp, alpha=0.3)
    np.testing.assert_allclose(
        fused._blend("speech_music", sp, mu, pair["SMR"]),
        jfusion.LateFusionTester(jh, jp, alpha=0.3)._blend(
            "speech_music", sp, mu, pair["SMR"]), rtol=0, atol=PRED_ATOL)
    # Remixed at one level, only the pairs are tested.
    res = fused.test_model(test, target_db=5)
    assert set(res["GroundTruth"]) == {2}


def _narrow(config_from_args):
    """A CLI's ``config_from_args`` at the narrow width (the CLIs have no
    flag for the architecture)."""
    return lambda args: dataclasses.replace(
        config_from_args(args), arch_kwargs=dict(NARROW),
        n_mels_override=N_MELS)


ARGS = ["--epochs", "1", "--batch-size", "2", "--patch-size", "16",
        "--patch-shift", "16", "--tr-steps", "2", "--v-steps", "1",
        "--folds", "0", "--no-augment"]


def _header(path, delimiter):
    with open(path) as f:
        return next(csv.reader(f, delimiter=delimiter))


def _config_keys(path):
    with open(path) as f:
        return [line.split("\t", 1)[0] for line in f]


@pytest.fixture(scope="module")
def jax_if_run(corpus, tmp_path_factory):
    """One JAX fold of ``cli.fuse_intermediate`` (host pipeline)."""
    out = str(tmp_path_factory.mktemp("jax_if"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfuse_if, "config_from_args",
                   _narrow(jmtl.config_from_args))
        res = jfuse_if.main(["--data", corpus[0], "--output", out,
                             "--dft-precision", "highest", *ARGS])
    return res[0]


@pytest.mark.parametrize("pipeline", ["host", "device"])
def test_cli_fuse_intermediate_writes_the_jax_columns(corpus, jax_if_run,
                                                      monkeypatch, tmp_path,
                                                      pipeline):
    monkeypatch.setattr(tfuse_if, "config_from_args",
                        _narrow(tmtl.config_from_args))
    out = tfuse_if.main(["--data", corpus[0], "--output", str(tmp_path),
                         "--device", "cpu", "--pipeline", pipeline,
                         *ARGS])[0]
    want = jax_if_run
    assert out["pipeline"] == pipeline
    assert out["test"]["ConfMat"].shape == (3, 3)
    assert set(out["row"]) == set(want["row"])
    assert np.isfinite(out["row"]["val_loss"])
    assert out["op_dir"] == os.path.join(str(tmp_path), IF,
                                         "LogMelHarmPercSpec")
    for name, delim in (("Performance.csv", "\t"), ("fold0_log.csv", ",")):
        assert (_header(os.path.join(out["op_dir"], name), delim)
                == _header(os.path.join(want["op_dir"], name), delim))
    assert (_config_keys(os.path.join(out["op_dir"], "Configuration.csv"))
            == _config_keys(os.path.join(want["op_dir"],
                                         "Configuration.csv")))
    assert out["tester"].dual_tower
    assert os.path.exists(os.path.join(out["op_dir"], "fold0_ckpt", "state",
                                       "model.npz"))


def _checkpoints(tmp_path, feat, seed):
    """A full-width Lemaire-MTL on ``feat`` (120 rows) saved as the JAX
    driver's orbax checkpoint and as the port's npz checkpoint of the same
    weights."""
    from sm_hpss_mtl_tpu.train import TrainState as JState, for_model
    from sm_hpss_mtl_tpu.train.checkpoint import save_checkpoint
    spec = jget_model("Lemaire_et_al_MTL", n_mels=120)
    jopt, _ = for_model("Lemaire_et_al_MTL", tr_steps=1)
    state = JState.create(spec.module, jopt, jnp.zeros((2, 16, 120)),
                          jax.random.PRNGKey(seed))
    jdir = str(tmp_path / f"j_{feat}")
    save_checkpoint(jdir, state)
    net = get_model("Lemaire_et_al_MTL", in_dim=120, patch_size=16)
    net.load_state_dict(weights.from_flax(jax.tree_util.tree_map(
        np.asarray, {"params": state.params,
                     "batch_stats": state.batch_stats})))
    opt, _ = toptim.for_model("Lemaire_et_al_MTL", net.parameters(),
                              tr_steps=1)
    tdir = str(tmp_path / f"t_{feat}")
    tckpt.save_checkpoint(tdir, TrainState(net, opt), {"epoch": 0})
    return jdir, tdir


def test_cli_fuse_late_writes_the_jax_row(corpus, tmp_path,
                                          jax_constant_rows_fixed):
    root, _ = corpus
    (jh, th), (jp, tp) = (_checkpoints(tmp_path, f, s) for f, s in
                          (("LogMelHarmSpec", 1), ("LogMelPercSpec", 2)))
    common = ["--data", root, "--patch-size", "16", "--alpha", "0.4"]
    want = jfuse_late.main(common + ["--ckpt-harm", jh, "--ckpt-perc", jp,
                                     "--output", str(tmp_path / "jres")])
    got = tfuse_late.main(common + ["--ckpt-harm", th, "--ckpt-perc", tp,
                                    "--output", str(tmp_path / "tres"),
                                    "--device", "cpu"])
    _same_results(got, want)
    rows = []
    for side in ("jres", "tres"):
        path = tmp_path / side / "Late_Fusion" / "Lemaire_et_al_MTL" \
            / "Performance.csv"
        with open(path) as f:
            rows.append(list(csv.reader(f, delimiter="\t")))
    assert rows[1][0] == rows[0][0]                 # the JAX row keys
    assert rows[1] == rows[0]                       # and values


def test_cli_segment_refuses_the_fusion_model_as_jax_fails(tmp_path):
    """Neither CLI serves the fusion model: the JAX CLI builds its template
    state from one array, which the model indexes by 'harm_input' (a
    TypeError); the port's refuses it by name (a ValueError)."""
    wav = str(tmp_path / "b.wav")
    x = np.random.default_rng(0).standard_normal(16000 * 14 // 10)
    wavfile.write(wav, 16000, (0.1 * x * 32767).astype(np.int16))
    with pytest.raises(TypeError, match="harm_input"):
        jcli.main([wav, "--model", IF, "--ckpt", str(tmp_path / "ckpt")])
    with pytest.raises(ValueError, match="harm_input"):
        tcli.main([wav, "--model", IF, "--weights", str(tmp_path / "w.npz"),
                   "--device", "cpu"])


def test_classifier_refuses_the_fusion_model(tmp_path):
    from sm_hpss_mtl_tpu_torch import infer as tinfer
    with pytest.raises(ValueError, match="two inputs"):
        tinfer.Classifier.from_weights(str(tmp_path / "w.npz"), model=IF,
                                       device="cpu")

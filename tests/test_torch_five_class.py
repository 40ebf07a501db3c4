"""The 5-class path of the port against the JAX package: the folds with the
noise class (``cli.make_folds --with-noise``), the file-wise tester with
the noise singles and the speech+noise pairs (label 4), the
``cli.five_class`` driver, and ``cli.segment`` serving the 5-class model
through its S and M heads.

Tester predictions within 1e-4 of JAX's, ``test_torch_eval``'s bar (the
features differ by float32 summation order, up to 1e-3 dB, which moves a
narrow model's probabilities by ~1e-5; a wrong patch, standardization or
head moves them by 1e-2 or more), labels and the (5, 5) confusion matrix
equal.  The narrow model: 8 filters, 1 stack, dilations (1, 2), 16 mel
bands.  Runs write the JAX run's files and
columns (the RNGs differ, so values are not compared).  The toy corpus
has a -40 dB noise floor (``test_torch_eval`` explains).
"""

import csv
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sm_hpss_mtl_tpu.cli import five_class as jfive
from sm_hpss_mtl_tpu.cli import make_folds as jmake_folds
from sm_hpss_mtl_tpu.cli import mtl as jmtl
from sm_hpss_mtl_tpu.data import featurize as jfeat
from sm_hpss_mtl_tpu.data import folds as jfolds
from sm_hpss_mtl_tpu.eval import segment as jseg
from sm_hpss_mtl_tpu.eval import tester as jtester
from sm_hpss_mtl_tpu.models import get_model as jget_model
from sm_hpss_mtl_tpu.ops import patches as jpatches
from sm_hpss_mtl_tpu_torch import weights
from sm_hpss_mtl_tpu_torch.cli import five_class as tfive
from sm_hpss_mtl_tpu_torch.cli import make_folds as tmake_folds
from sm_hpss_mtl_tpu_torch.cli import mtl as tmtl
from sm_hpss_mtl_tpu_torch.data import audio as taudio
from sm_hpss_mtl_tpu_torch.data import featurize as tfeat
from sm_hpss_mtl_tpu_torch.data import folds as tfolds
from sm_hpss_mtl_tpu_torch.eval import tester as ttester
from sm_hpss_mtl_tpu_torch.models.zoo import get_model

torch.set_num_threads(2)

FIVE = "Lemaire_et_al_MTL_5class"
NARROW = dict(n_filters=8, nb_stacks=1, Nd=2)
N_MELS = 16
PRED_ATOL = 1e-4
CLASSES = ["music", "speech", "speech+music", "noise", "speech+noise"]


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
    """Nine files of 2 s per class, noise included, with a noise floor."""
    root = str(tmp_path_factory.mktemp("toy_5c"))
    taudio.make_toy_musan(root, n_per_class=9, duration_s=2.0,
                          with_noise=True, seed=4)
    rng = np.random.default_rng(5)
    for cls in ("music", "speech", "noise"):
        for name in sorted(os.listdir(os.path.join(root, cls))):
            path = os.path.join(root, cls, name)
            x, _ = taudio.read_wav(path)
            taudio.write_wav(path, x + 1e-2 * rng.standard_normal(len(x)))
    return root


def test_make_folds_with_noise_writes_the_jax_folds(corpus, tmp_path):
    out_j, out_t = str(tmp_path / "j"), str(tmp_path / "t")
    jmake_folds.main(["--data", corpus, "--with-noise", "--output", out_j])
    tmake_folds.main(["--data", corpus, "--with-noise", "--output", out_t])
    assert sorted(os.listdir(out_t)) == sorted(os.listdir(out_j))
    got, want = tfolds.load_cv_folds(out_t), jfolds.load_cv_folds(out_j)
    assert set(got) == set(want)
    for k in ("music", "speech", "noise", "speech+music", "speech+noise"):
        assert got[k] == want[k], k
    for k, v in want["total_duration"].items():
        assert got["total_duration"][k] == pytest.approx(v, rel=1e-9)
    # The default output is <data>/cv_info, as in JAX.
    tmake_folds.main(["--data", corpus, "--cv", "3"])
    assert os.path.exists(os.path.join(corpus, "cv_info",
                                       "cv_file_list.pkl"))


def test_five_class_tester_matches_jax(corpus, jax_constant_rows_fixed):
    """The noise singles (label 3) and the speech+noise pairs (label 4) of
    fold 0, through a narrow 5-class model on both sides."""
    cv = tfolds.create_cv_folds(corpus, with_noise=True, seed=0)
    _, test = tfolds.get_train_test_files(cv, 0, class_names=CLASSES)
    assert test["noise"] and test["speech+noise"]
    module = jget_model(FIVE, n_mels=N_MELS, **NARROW).module
    v = module.init({"params": jax.random.PRNGKey(3),
                     "dropout": jax.random.PRNGKey(4)},
                    jnp.zeros((2, 68, 2 * N_MELS)), train=False)
    v = jax.tree_util.tree_map(np.asarray, dict(v))
    net = get_model(FIVE, n_mels=N_MELS, **NARROW)
    net.load_state_dict(weights.from_flax(v))
    cfg = dict(n_mels=N_MELS)
    want = jtester.FileWiseTester(
        featurizer=jfeat.Featurizer(jfeat.FeatureConfig(**cfg), bucket=False,
                                    use_pallas=False),
        predict_fn=jax.jit(lambda x: module.apply(v, x, train=False)),
        folder=corpus, feat_name="LogMelHarmPercSpec")
    got = ttester.FileWiseTester(
        featurizer=tfeat.Featurizer(tfeat.FeatureConfig(**cfg), bucket=False,
                                    device="cpu"),
        predict_fn=net.eval(), folder=corpus, feat_name="LogMelHarmPercSpec")
    res_got, res_want = got.test_model(test), want.test_model(test)
    assert res_got["ConfMat"].shape == (5, 5)
    assert set(res_got["GroundTruth"]) == {0, 1, 2, 3, 4}
    np.testing.assert_allclose(res_got["Predictions"],
                               res_want["Predictions"], rtol=0,
                               atol=PRED_ATOL)
    for k in ("PtdLabels", "GroundTruth", "ConfMat"):
        np.testing.assert_array_equal(res_got[k], res_want[k], err_msg=k)
    _, heads = got.predict_file("noise", "", os.path.join(
        corpus, "noise", test["noise"][0]))
    assert set(heads) == {"S", "M", "N", "R", "3C"}
    assert heads["R"].shape[1] == 3 and heads["3C"].shape[1] == 5


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
def jax_five_class_run(corpus, tmp_path_factory):
    """One JAX fold of ``cli.five_class`` (host pipeline)."""
    out = str(tmp_path_factory.mktemp("jax_5c"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfive, "config_from_args",
                   _narrow(jmtl.config_from_args))
        res = jfive.main(["--data", corpus, "--output", out,
                          "--dft-precision", "highest", *ARGS])
    return res[0]


@pytest.mark.parametrize("pipeline", ["host", "device"])
def test_cli_five_class_writes_the_jax_columns(corpus, jax_five_class_run,
                                               monkeypatch, tmp_path,
                                               pipeline):
    monkeypatch.setattr(tfive, "config_from_args",
                        _narrow(tmtl.config_from_args))
    out = tfive.main(["--data", corpus, "--output", str(tmp_path),
                      "--device", "cpu", "--pipeline", pipeline, *ARGS])[0]
    want = jax_five_class_run
    assert out["pipeline"] == pipeline
    assert out["test"]["ConfMat"].shape == want["test"]["ConfMat"].shape \
        == (5, 5)
    assert set(out["row"]) == set(want["row"])
    assert "F1_spno" in out["row"] and np.isfinite(out["row"]["val_loss"])
    assert os.path.basename(os.path.dirname(out["op_dir"])) == FIVE
    for name, delim in (("Performance.csv", "\t"), ("fold0_log.csv", ",")):
        assert (_header(os.path.join(out["op_dir"], name), delim)
                == _header(os.path.join(want["op_dir"], name), delim))
    assert (_config_keys(os.path.join(out["op_dir"], "Configuration.csv"))
            == _config_keys(os.path.join(want["op_dir"],
                                         "Configuration.csv")))
    assert "N_loss" in out["fit"].history[0]
    assert os.path.exists(os.path.join(corpus, "cv_info_5_class",
                                       "cv_file_list.pkl"))


def test_cli_segment_five_class_matches_jax_cli(tmp_path,
                                                jax_constant_rows_fixed):
    # The 5-class model served through its S and M heads at full width
    # (LogMelHarmPercSpec, 240 rows); 1.4 s: 138 frames.
    from test_torch_lemaire_variants import serve_both
    (jprob, jlab, j), (tprob, tlab, t) = serve_both(tmp_path, FIVE, 240, 8,
                                                    "M")
    assert tprob.shape == jprob.shape == (138 - 67,)
    np.testing.assert_allclose(tprob, jprob, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tlab, jlab)
    assert set(t) == set(j)
    assert t["track_R"].shape[1] == 3 and t["track_3C"].shape[1] == 5
    for k in ("track_S", "track_M", "track_N", "track_R", "track_3C"):
        assert t[k].shape == j[k].shape
        np.testing.assert_allclose(t[k], j[k], rtol=0, atol=1e-4)


def test_classifier_serves_the_five_class_model(corpus, tmp_path):
    """``Classifier.from_weights`` at full width: five class
    probabilities and the N head."""
    from sm_hpss_mtl_tpu_torch import infer as tinfer
    from sm_hpss_mtl_tpu_torch.models.lemaire import init_weights
    net = init_weights(get_model(FIVE), torch.Generator().manual_seed(0))
    npz = str(tmp_path / "w.npz")
    weights.save_npz(npz, weights.to_flax(net.state_dict()))
    clf = tinfer.Classifier.from_weights(npz, model=FIVE, device="cpu")
    wav = os.path.join(corpus, "noise", sorted(os.listdir(
        os.path.join(corpus, "noise")))[0])
    out = clf.classify_file(wav)
    assert out["probabilities"].shape == (5,)
    assert abs(out["probabilities"].sum() - 1) < 1e-5
    assert out["class_name"] == tinfer.CLASS_NAMES[out["label"]]
    assert out["heads"]["N"].shape == (1,) and out["heads"]["R"].shape == (3,)


def test_audio_cache_temporary_files_are_per_thread(corpus, tmp_path,
                                                    monkeypatch):
    """The train and val streams' prefetch threads may cache one item at
    once (a tiny 5-class split puts a class's one training file on both
    sides): each writes its own temporary file before the atomic rename."""
    import threading

    from sm_hpss_mtl_tpu_torch.data import audiostream as tstream
    names, save = [], np.save
    barrier = threading.Barrier(2)

    def recording_save(path, arr):
        names.append(path)
        barrier.wait(timeout=10)        # both threads write at once
        save(path, arr)

    monkeypatch.setattr(tstream.np, "save", recording_save)
    cache = tstream.AudioCache(cache_dir=str(tmp_path))
    wav = os.path.join(corpus, "noise", sorted(os.listdir(
        os.path.join(corpus, "noise")))[0])
    errors = []

    def get():
        try:
            cache.get("noise", mu_path=wav)
        except Exception as e:            # raised in the thread
            errors.append(e)

    threads = [threading.Thread(target=get) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(set(names)) == 2

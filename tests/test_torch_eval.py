"""File-wise evaluation in the port against the JAX package: the loader
chain (RMS energy, silence removal, tiling), the folds, the patches, the
featurizer and its cache, the file-wise tester with its SMR sweep, and the
``Classifier`` entry point.

Features are compared at ``test_torch_dsp``'s 1e-3 dB (float32 summation
order in the DFT and mel products); tester predictions within 1e-4 (the
same features through a narrow model; a wrong patch, standardization or
head moves them by 1e-2 or more), with labels and confusion matrices
equal.  Models are narrow (few filters, few bands) and carry the flax
weights across with ``weights.from_flax``.
"""

import csv
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sm_hpss_mtl_tpu import native
from sm_hpss_mtl_tpu.data import audio as jaudio
from sm_hpss_mtl_tpu.data import batcher as jbatcher
from sm_hpss_mtl_tpu.data import featurize as jfeat
from sm_hpss_mtl_tpu.data import folds as jfolds
from sm_hpss_mtl_tpu.eval import segment as jseg
from sm_hpss_mtl_tpu.eval import tester as jtester
from sm_hpss_mtl_tpu import infer as jinfer
from sm_hpss_mtl_tpu.ops import patches as jpatches
from sm_hpss_mtl_tpu.ops import reference as jref
from sm_hpss_mtl_tpu.ops import silence as jsilence
from sm_hpss_mtl_tpu_torch import infer as tinfer
from sm_hpss_mtl_tpu_torch import weights
from sm_hpss_mtl_tpu_torch.data import audio as taudio
from sm_hpss_mtl_tpu_torch.data import batcher as tbatcher
from sm_hpss_mtl_tpu_torch.data import featurize as tfeat
from sm_hpss_mtl_tpu_torch.data import folds as tfolds
from sm_hpss_mtl_tpu_torch.eval import tester as ttester
from sm_hpss_mtl_tpu_torch.ops import patches as tpatches
from sm_hpss_mtl_tpu_torch.ops import reference as tref
from sm_hpss_mtl_tpu_torch.ops import silence as tsilence

torch.set_num_threads(2)

DB_ATOL = 1e-3
PRED_ATOL = 1e-4
LEVELS = (0, 10)


@pytest.fixture
def jax_constant_rows_fixed(monkeypatch):
    """The JAX tester's and segmenter's standardization with constant rows
    centred to 0, as sklearn and the port do (``test_torch_segment``
    explains the JAX helper's fault); patched here, not edited."""
    def fixed(FV):
        FV = np.asarray(FV)
        out = np.array(jpatches.standardize_rows(FV))
        out[FV.max(axis=-1) == FV.min(axis=-1)] = 0.0
        return out

    monkeypatch.setattr(jtester, "standardize_rows", fixed)
    monkeypatch.setattr(jseg, "standardize_rows", fixed)


def _add_short_clip(root, cls, name, seconds, seed):
    """A clip of ``seconds`` beside a toy corpus, with its annotation row
    (stratum 'short', so the first one lands in fold 0)."""
    rng = np.random.default_rng(seed)
    synth = taudio._synth_speech if cls == "speech" else taudio._synth_music
    n = int(seconds * 16000)
    x = taudio.normalize_signal_np(synth(rng, n, 16000))
    path = os.path.join(root, cls, name + ".wav")
    taudio.write_wav(path, x)
    with open(os.path.join(root, "annotations", cls + ".csv"), "a",
              newline="") as f:
        csv.writer(f).writerow([name, "short"])
    return path


def _add_noise_floor(root, seed, level=1e-2):
    """White noise at ``level`` (-40 dB of the unit peak) added to every
    wav.  The toy synthesizers' sines leave bins 100 dB below the peak,
    where float32 round-off in the DFT decides the dB values (the two
    packages differ by up to 0.02 dB there); recordings have a floor."""
    rng = np.random.default_rng(seed)
    for cls in ("music", "speech"):
        for name in sorted(os.listdir(os.path.join(root, cls))):
            path = os.path.join(root, cls, name)
            x, _ = taudio.read_wav(path)
            taudio.write_wav(path, x + level * rng.standard_normal(len(x)))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Two music and two speech files of 1-2.5 s, and one short clip of
    each class (10 and 13 frames at n_fft 400) in fold 0."""
    root = str(tmp_path_factory.mktemp("toy"))
    taudio.make_toy_musan(root, n_per_class=2, duration_s=(1.0, 2.5),
                          seed=3)
    _add_short_clip(root, "music", "music-short-0000", 0.12, 1)
    _add_short_clip(root, "speech", "speech-short-0000", 0.15, 2)
    _add_noise_floor(root, 4)
    cv = tfolds.create_cv_folds(root, seed=0)
    _, test = tfolds.get_train_test_files(cv, 0)
    assert "music-short-0000.wav" in test["music"]
    assert "speech-short-0000.wav" in test["speech"]
    return root, test


# --- host-side DSP and data helpers ----------------------------------------

@pytest.mark.parametrize("n", [400, 1601, 3001])
def test_rms_energy_and_frame_match_jax(n):
    """The loader's numpy RMS (the silence gate) and its framing."""
    y = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    got = tref.rms_energy(y, 400, 160)
    assert got.shape == (1 + n // 160,)
    np.testing.assert_array_equal(got, jref.rms_energy(y, 400, 160))
    np.testing.assert_array_equal(tref.frame_signal(y, 400, 160),
                                  jref.frame_signal(y, 400, 160))


def _gapped(seed, gaps=3):
    """1.2 s of tone bursts with ``gaps`` near-silent gaps of 150 ms."""
    rng = np.random.default_rng(seed)
    t = np.arange(19200) / 16000
    x = 0.5 * np.sin(2 * np.pi * 300 * t)
    for g in range(gaps):
        s = 3000 + g * 5000
        x[s:s + 2400] = 1e-4 * rng.standard_normal(2400)
    return (x + 1e-3 * rng.standard_normal(len(x))).astype(np.float32)


@pytest.mark.parametrize("gaps", [0, 1, 3])
def test_remove_silence_matches_both_jax_versions(gaps):
    x = _gapped(gaps, gaps)
    energy = tref.rms_energy(x, 400, 160)
    got = tsilence.remove_silence(x, energy, 16000)
    assert native.available()
    for rm in (jsilence.remove_silence, native.remove_silence):
        want = rm(x, energy, 16000)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
        assert got[3] == pytest.approx(want[3], abs=1e-12)
    assert (len(got[0]) < len(x)) == (gaps > 1)   # a lone gap is kept


def test_load_and_preprocess_signal_matches_jax(tmp_path):
    clips = {"gapped": _gapped(5), "tiled": _gapped(6, 0)[:800],
             "plain": _gapped(7, 0)}
    for name, x in clips.items():
        path = str(tmp_path / f"{name}.wav")
        taudio.write_wav(path, x)
        got, sr = taudio.load_and_preprocess_signal(path)
        want, jsr = jaudio.load_and_preprocess_signal(path)
        assert sr == jsr == 16000
        np.testing.assert_array_equal(got, want)
        assert taudio.duration_seconds(path) == jaudio.duration_seconds(path)
    assert len(got) == len(clips["plain"])
    tiled, _ = taudio.load_and_preprocess_signal(str(tmp_path / "tiled.wav"))
    assert len(tiled) == 1600                      # 50 ms doubled to 100 ms
    with pytest.raises(NotImplementedError, match="mp3"):
        taudio.duration_seconds(str(tmp_path / "a.mp3"))


def test_toy_corpus_and_folds_match_jax(tmp_path):
    kw = dict(n_per_class=5, duration_s=(0.3, 0.6), seed=1, with_noise=True)
    taudio.make_toy_musan(str(tmp_path / "t"), **kw)
    jaudio.make_toy_musan(str(tmp_path / "j"), **kw)
    for cls in ("music", "speech", "noise"):
        names = sorted(os.listdir(tmp_path / "j" / cls))
        assert sorted(os.listdir(tmp_path / "t" / cls)) == names
        for n in names:
            assert ((tmp_path / "t" / cls / n).read_bytes()
                    == (tmp_path / "j" / cls / n).read_bytes())
    root = str(tmp_path / "j")
    got = tfolds.create_cv_folds(root, with_noise=True, seed=4)
    want = jfolds.create_cv_folds(root, with_noise=True, seed=4)
    assert got == want
    names = ["music", "speech", "speech+music", "speech+noise"]
    assert (tfolds.get_train_test_files(got, 1, names)
            == jfolds.get_train_test_files(want, 1, names))
    tfolds.save_cv_folds(got, str(tmp_path / "ft"))
    jfolds.save_cv_folds(want, str(tmp_path / "fj"))
    for f in sorted(os.listdir(tmp_path / "fj")):
        assert ((tmp_path / "ft" / f).read_bytes()
                == (tmp_path / "fj" / f).read_bytes()), f
    assert tfolds.load_cv_folds(str(tmp_path / "ft")) == want
    assert (tfolds.read_annotations(os.path.join(root, "annotations"),
                                    "music")
            == jfolds.read_annotations(os.path.join(root, "annotations"),
                                       "music"))


@pytest.mark.parametrize("T,size,shift", [
    (5, 68, 68),      # tiled until longer than one window
    (68, 68, 68),     # exactly one window: tiled too
    (69, 68, 68),
    (301, 68, 68),
    (150, 16, 4),
])
def test_extract_patches_np_matches_jax(T, size, shift):
    rng = np.random.default_rng(T)
    FV = rng.standard_normal((6, T)).astype(np.float32)
    got = tpatches.extract_patches_np(FV, size, shift)
    np.testing.assert_array_equal(got, jpatches.extract_patches_np(
        FV, size, shift))
    assert tpatches.tiled_length(T, size) == jpatches.tiled_length(T, size)
    assert (tpatches.num_patches(T, size, shift)
            == jpatches.num_patches(T, size, shift) == got.shape[0])
    np.testing.assert_array_equal(tpatches._start_indices(T, size, shift),
                                  jpatches._start_indices(T, size, shift))


def test_scale_frames_matches_jax():
    rng = np.random.default_rng(9)
    fv = rng.standard_normal((5, 30)).astype(np.float32)
    mean, std = fv.mean(axis=1), fv.std(axis=1)
    std[2] = 0.0
    np.testing.assert_array_equal(tbatcher.scale_frames(fv, mean, std),
                                  jbatcher.scale_frames(fv, mean, std))


# --- featurizer -------------------------------------------------------------

def _items(root):
    sp = os.path.join(root, "speech", "speech-toy-0000.wav")
    mu = os.path.join(root, "music", "music-toy-0001.wav")
    short = os.path.join(root, "speech", "speech-short-0000.wav")
    return [("speech", sp, "", None), ("music", "", mu, None),
            ("speech_music", sp, mu, 5), ("speech_music", short, mu, -5),
            ("speech", short, "", None), ("muspeak", sp, "", None)]


@pytest.mark.parametrize("bucket", [False, True])
def test_featurizer_matches_jax(corpus, bucket):
    root, _ = corpus
    got_f = tfeat.Featurizer(tfeat.FeatureConfig(n_mels=40), bucket=bucket,
                             device="cpu")
    want_f = jfeat.Featurizer(jfeat.FeatureConfig(n_mels=40), bucket=bucket,
                              use_pallas=False)
    for item in _items(root):
        got = got_f.featuregram(*item, save_feat=False)
        want = want_f.featuregram(*item, save_feat=False)
        assert got.dtype == np.float32 and got.shape == want.shape, item
        np.testing.assert_allclose(got, want, rtol=0, atol=DB_ATOL,
                                   err_msg=str(item))
    assert got_f.stats == {"mem_hits": 0, "disk_hits": 0, "computes": 6}
    assert tfeat.FeatureConfig().dim == jfeat.FeatureConfig().dim == 240
    with pytest.raises(NotImplementedError, match="bf16x3"):
        tfeat.Featurizer(tfeat.FeatureConfig(dft_precision="bf16x3"),
                         device="cpu").featuregram(*_items(root)[0])


def test_featurizer_cache_names_and_round_trip(corpus, tmp_path):
    root, _ = corpus
    for sp, mu, db in (("a/s.wav", "b/m.wav", -5), ("a/s.wav", "", None),
                       ("", "b/m.x.wav", None), ("s", "m", 12)):
        assert (tfeat.mixture_cache_name(sp, mu, db)
                == jfeat.mixture_cache_name(sp, mu, db))
    cache = str(tmp_path / "cache")
    item = _items(root)[2]
    first = tfeat.Featurizer(tfeat.FeatureConfig(n_mels=40), cache_dir=cache,
                             device="cpu")
    fv = first.featuregram(*item)
    assert os.path.exists(os.path.join(
        cache, "speech_music", "speech-toy-0000_music-toy-0001_5dB.npy"))
    assert first.featuregram(*item) is fv
    assert first.stats == {"mem_hits": 1, "disk_hits": 0, "computes": 1}
    second = tfeat.Featurizer(tfeat.FeatureConfig(n_mels=40),
                              cache_dir=cache, device="cpu")
    np.testing.assert_array_equal(second.featuregram(*item), fv)
    assert second.stats["disk_hits"] == 1
    # The JAX featurizer reads the port's cache file as its own.
    jax_f = jfeat.Featurizer(jfeat.FeatureConfig(n_mels=40), cache_dir=cache,
                             use_pallas=False)
    np.testing.assert_array_equal(jax_f.featuregram(*item), fv)
    assert jax_f.stats["disk_hits"] == 1
    # The memory LRU holds at most mem_cache_mb.
    tiny = tfeat.Featurizer(tfeat.FeatureConfig(n_mels=40), device="cpu",
                            mem_cache_mb=0)
    tiny.featuregram(*item)
    tiny.featuregram(*item)
    assert tiny.stats == {"mem_hits": 0, "disk_hits": 0, "computes": 2}


def test_precompute_equals_featuregram(corpus, tmp_path):
    root, _ = corpus
    items = _items(root)
    cfg = tfeat.FeatureConfig(n_mels=40)
    pre = tfeat.Featurizer(cfg, cache_dir=str(tmp_path), device="cpu")
    assert pre.precompute(items, batch_size=2) == len(items)
    assert pre.precompute(items) == 0             # all on disk now
    single = tfeat.Featurizer(cfg, device="cpu")
    for item in items:
        got = pre.featuregram(*item)
        np.testing.assert_allclose(got, single.featuregram(*item), rtol=0,
                                   atol=DB_ATOL, err_msg=str(item))
    assert pre.stats["mem_hits"] == len(items)


# --- file-wise tester -------------------------------------------------------

def _lemaire(n_mels):
    from sm_hpss_mtl_tpu.models.lemaire import LemaireMTL as JLemaire
    from sm_hpss_mtl_tpu_torch.models.lemaire import LemaireMTL
    narrow = dict(n_filters=8, nb_stacks=1, Nd=3)
    module = JLemaire(**narrow)
    v = module.init({"params": jax.random.PRNGKey(0),
                     "dropout": jax.random.PRNGKey(1)},
                    jnp.zeros((2, 68, 2 * n_mels)), train=False)
    v = jax.tree_util.tree_map(np.asarray, dict(v))
    net = LemaireMTL(2 * n_mels, **narrow)
    return module, v, net


def _jang(n_mels):
    from sm_hpss_mtl_tpu.models import get_model as jget_model
    from sm_hpss_mtl_tpu_torch.models.zoo import get_model
    module = jget_model("Jang_et_al_MTL", n_mels=n_mels).module
    v = module.init({"params": jax.random.PRNGKey(2),
                     "dropout": jax.random.PRNGKey(3)},
                    jnp.zeros((1, 514, 68, 1)), train=False)
    v = jax.tree_util.tree_map(np.asarray, dict(v))
    return module, v, get_model("Jang_et_al_MTL", n_mels=n_mels)


def _testers(root, model, jcfg, tcfg, input_kind):
    module, v, net = model
    net.load_state_dict(weights.from_flax(v))
    net.eval()
    apply = jax.jit(lambda x: module.apply(v, x, train=False))
    want = jtester.FileWiseTester(
        featurizer=jfeat.Featurizer(jcfg, bucket=False, use_pallas=False),
        predict_fn=apply, folder=root, feat_name=jcfg.feat_name,
        input_kind=input_kind)
    got = ttester.FileWiseTester(
        featurizer=tfeat.Featurizer(tcfg, bucket=False, device="cpu"),
        predict_fn=net, folder=root, feat_name=tcfg.feat_name,
        input_kind=input_kind)
    return want, got


def _same_results(got, want):
    np.testing.assert_allclose(got["Predictions"], want["Predictions"],
                               rtol=0, atol=PRED_ATOL)
    np.testing.assert_array_equal(got["PtdLabels"], want["PtdLabels"])
    np.testing.assert_array_equal(got["GroundTruth"], want["GroundTruth"])
    np.testing.assert_array_equal(got["ConfMat"], want["ConfMat"])


@pytest.mark.parametrize("name", ["lemaire", "jang"])
def test_tester_and_sweep_match_jax(corpus, jax_constant_rows_fixed,
                                    monkeypatch, name):
    root, test = corpus
    if name == "lemaire":
        cfg = dict(n_mels=40)
        model, kind = _lemaire(40), "time_mel"
    else:
        cfg = dict(feat_name="LogHarmPercSpec", n_fft=512, n_mels=-1)
        model, kind = _jang(24), "image"
        # Model calls of two patches, so that files span several.
        monkeypatch.setattr(ttester, "IMAGE_BATCH_WINDOWS", 2)
    want, got = _testers(root, model, jfeat.FeatureConfig(**cfg),
                         tfeat.FeatureConfig(**cfg), kind)
    res_got, res_want = got.test_model(test), want.test_model(test)
    n_items = len(test["music"]) + len(test["speech"]) + len(
        test["speech+music"])
    assert got.featurizer.stats["computes"] == n_items
    assert res_got["Predictions"].shape[1] == 3
    assert set(res_got["GroundTruth"]) == {0, 1, 2}
    _same_results(res_got, res_want)
    sweep_got = got.smr_sweep(test, levels=LEVELS)
    sweep_want = want.smr_sweep(test, levels=LEVELS)
    for db in LEVELS:
        _same_results(sweep_got[db], sweep_want[db])
    for k in ("ConfMat", "precision", "recall", "fscore"):
        np.testing.assert_array_equal(sweep_got["All"][k],
                                      sweep_want["All"][k])


def test_tester_frame_level_scaling_matches_jax(corpus):
    root, _ = corpus
    cfg = dict(n_mels=40)
    want, got = _testers(root, _lemaire(40), jfeat.FeatureConfig(**cfg),
                         tfeat.FeatureConfig(**cfg), "time_mel")
    rng = np.random.default_rng(5)
    stats = (rng.standard_normal(80).astype(np.float32) - 40,
             rng.uniform(5, 10, 80).astype(np.float32))
    for t in (want, got):
        t.frame_level_scaling, t.fold_stats = True, stats
    sp = os.path.join(root, "speech", "speech-toy-0001.wav")
    g = got.file_patches("speech", sp)
    w = want.file_patches("speech", sp)
    assert g.shape == w.shape and g.shape[1:] == (68, 80)
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)


def test_unpadded_patch_batches_give_the_padded_outputs():
    # The JAX tester pads each file's patches to a power of two for XLA's
    # compile cache; in eval mode each patch's output is its own, so the
    # port calls the model on the patches as they are.
    _, v, net = _lemaire(40)
    net.load_state_dict(weights.from_flax(v))
    net.eval()
    x = np.random.default_rng(6).standard_normal((5, 68, 80)).astype(
        np.float32)
    padded, n = jtester._pad_pow2(x)
    assert (padded.shape[0], n) == (8, 5)
    with torch.inference_mode():
        got = net(torch.from_numpy(x))
        want = net(torch.from_numpy(padded))
    for k in got:
        torch.testing.assert_close(got[k], want[k][:n], rtol=0, atol=1e-6)


def test_tester_refuses_what_is_not_ported():
    f = tfeat.Featurizer(tfeat.FeatureConfig(), device="cpu")
    kw = dict(featurizer=f, predict_fn=None, folder="",
              feat_name="LogMelHarmPercSpec")
    # Intermediate fusion is ported: the twin inputs are the patches'
    # two halves (held to JAX by test_torch_fusion).
    assert ttester.FileWiseTester(dual_tower=True, **kw).dual_tower
    with pytest.raises(ValueError, match="input_kind"):
        ttester.FileWiseTester(input_kind="dual", **kw)
    # Skewness vectors are ported (ops/stats.py).
    assert ttester.FileWiseTester(skewness_vector="Row", **kw
                                  ).skewness_vector == "Row"


@pytest.mark.parametrize("skew", ["Row", "Col"])
def test_tester_skewness_patches_match_jax(corpus, skew):
    """Each 68-frame test patch as its skewness vector, per row (a
    ``(1, D)`` time-major patch) or per column (``(68, 1)``)."""
    root, _ = corpus
    cfg = dict(n_mels=40)
    want, got = _testers(root, _lemaire(40), jfeat.FeatureConfig(**cfg),
                         tfeat.FeatureConfig(**cfg), "time_mel")
    for t in (want, got):
        t.skewness_vector = skew
    sp = os.path.join(root, "speech", "speech-toy-0001.wav")
    g = got.file_patches("speech", sp)
    w = want.file_patches("speech", sp)
    assert g.shape == w.shape
    assert g.shape[1:] == ((1, 80) if skew == "Row" else (68, 1))
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)


# --- Classifier -------------------------------------------------------------

def test_classifier_matches_jax(corpus, tmp_path, jax_constant_rows_fixed):
    from sm_hpss_mtl_tpu.models import get_model as jget_model
    root, _ = corpus
    module = jget_model("Lemaire_et_al_MTL", n_mels=120).module
    v = module.init({"params": jax.random.PRNGKey(7),
                     "dropout": jax.random.PRNGKey(8)},
                    jnp.zeros((2, 68, 240)), train=False)
    v = jax.tree_util.tree_map(np.asarray, dict(v))
    npz = str(tmp_path / "w.npz")
    weights.save_npz(npz, v)
    got = tinfer.Classifier.from_weights(npz, device="cpu")
    assert got.tester.input_kind == "time_mel"
    assert got.tester.featurizer.bucket
    cfg = jfeat.FeatureConfig(feat_name="LogMelHarmPercSpec", n_fft=400,
                              n_mels=120)
    want = jinfer.Classifier(tester=jtester.FileWiseTester(
        featurizer=jfeat.Featurizer(cfg, use_pallas=False),
        predict_fn=jax.jit(lambda x: module.apply(v, x, train=False)),
        folder="", feat_name=cfg.feat_name, input_kind="time_mel"))
    sp = os.path.join(root, "speech", "speech-toy-0001.wav")
    mu = os.path.join(root, "music", "music-short-0000.wav")
    for call in (lambda c: c.classify_file(sp),
                 lambda c: c.classify_pair(sp, mu, 5.0)):
        g, w = call(got), call(want)
        assert g["label"] == w["label"]
        assert g["class_name"] == w["class_name"] == tinfer.CLASS_NAMES[
            g["label"]]
        np.testing.assert_allclose(g["probabilities"], w["probabilities"],
                                   rtol=0, atol=PRED_ATOL)
        np.testing.assert_array_equal(g["patch_labels"], w["patch_labels"])
        assert set(g["heads"]) == set(w["heads"]) == {"S", "M", "R", "3C"}
        for k in g["heads"]:
            np.testing.assert_allclose(g["heads"][k], w["heads"][k],
                                       rtol=0, atol=PRED_ATOL)
    assert tinfer.CLASS_NAMES == jinfer.CLASS_NAMES

"""Frame-level scaling statistics and per-patch moments in the port against
the JAX package: ``data.stats.get_data_stats`` and
``load_or_compute_fold_stats`` over a toy corpus (rtol 1e-5 of each
vector's largest value: the features of the two packages differ by float32
summation order, ~1e-4 dB, the long-double sums average it over every
frame, and a mean near 0 keeps it absolute), and
``ops.stats.patch_statistics`` for each statistic on both axes (atol 1e-5,
float32 reductions in another order), with constant slices."""

import os

import numpy as np
import pytest
import torch

from sm_hpss_mtl_tpu.data import featurize as jfeat
from sm_hpss_mtl_tpu.data import folds as jfolds
from sm_hpss_mtl_tpu.data import stats as jstats
from sm_hpss_mtl_tpu.ops import stats as jopstats
from sm_hpss_mtl_tpu_torch.data import audio as taudio
from sm_hpss_mtl_tpu_torch.data import featurize as tfeat
from sm_hpss_mtl_tpu_torch.data import stats as tstats
from sm_hpss_mtl_tpu_torch.ops import stats as topstats

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """``make_toy_musan`` with white noise at -40 dB of the unit peak on
    every wav (the toy synthesizers leave bins where two float32 DFTs
    differ by 0.02 dB; ``test_torch_eval`` explains)."""
    root = str(tmp_path_factory.mktemp("toy_stats"))
    taudio.make_toy_musan(root, n_per_class=4, duration_s=1.5, seed=4)
    rng = np.random.default_rng(5)
    for cls in ("music", "speech"):
        d = os.path.join(root, cls)
        for name in sorted(os.listdir(d)):
            x, _ = taudio.read_wav(os.path.join(d, name))
            taudio.write_wav(os.path.join(d, name),
                             x + 1e-2 * rng.standard_normal(len(x)))
    files, _ = jfolds.get_train_test_files(
        jfolds.create_cv_folds(root, seed=0), 0)
    return root, files


FEATURES = [dict(feat_name="LogMelHarmPercSpec", n_fft=400, n_mels=16),
            dict(feat_name="LogHarmPercSpec", n_fft=512, n_mels=-1)]


@pytest.mark.parametrize("feat", FEATURES, ids=lambda f: f["feat_name"])
def test_get_data_stats_matches_jax(corpus, feat):
    root, files = corpus
    assert len(files["speech+music"]) > 0
    got = tstats.get_data_stats(
        tfeat.Featurizer(tfeat.FeatureConfig(**feat), device="cpu"), root,
        files)
    want = jstats.get_data_stats(
        jfeat.Featurizer(jfeat.FeatureConfig(dft_precision="highest",
                                             **feat), use_pallas=False),
        root, files)
    rows = tfeat.FeatureConfig(**feat).dim
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32 and g.shape == (rows,)
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())
    assert (got[1] > 0).all()


def test_load_or_compute_fold_stats_caches_as_jax(corpus, tmp_path):
    root, files = corpus
    fz = tfeat.Featurizer(tfeat.FeatureConfig(**FEATURES[0]), device="cpu")
    path = str(tmp_path / "c" / "Lemaire_et_al_MTL_LogMelHarmPercSpec_"
                               "fold0_stats.npz")
    got = tstats.load_or_compute_fold_stats(path, fz, root, files)
    assert os.path.exists(path)
    computes = fz.stats["computes"]
    again = tstats.load_or_compute_fold_stats(path, fz, root, files)
    assert fz.stats["computes"] == computes          # read, not recomputed
    # The JAX package reads the port's cache, and the port reads JAX's.
    jgot = jstats.load_or_compute_fold_stats(path, None, root, files)
    jpath = str(tmp_path / "j.npz")
    want = jstats.load_or_compute_fold_stats(
        jpath, jfeat.Featurizer(jfeat.FeatureConfig(
            dft_precision="highest", **FEATURES[0]), use_pallas=False),
        root, files)
    back = tstats.load_or_compute_fold_stats(jpath, None, root, files)
    for g, a, j, w, b in zip(got, again, jgot, want, back):
        np.testing.assert_array_equal(a, g)
        np.testing.assert_array_equal(j, g)
        np.testing.assert_array_equal(b, w)
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())


def _patches(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((5, 12, 16)) ** 3).astype(np.float32)
    x[1, 3, :] = 2.5                   # a constant row
    x[2, :, 7] = -1.0                  # a constant column
    x[3] = 0.0                         # a constant patch
    x[4, 5, :] = 1e3 + 1e-4 * rng.standard_normal(16).astype(np.float32)
    return x


@pytest.mark.parametrize("stat_type", ["mean", "variance", "skew",
                                       "kurtosis"])
@pytest.mark.parametrize("axis", [0, 1])
def test_patch_statistics_match_jax(stat_type, axis):
    x = _patches(axis)
    got = topstats.patch_statistics(torch.from_numpy(x), stat_type=stat_type,
                                    axis=axis).numpy()
    want = np.asarray(jopstats.patch_statistics(x, stat_type=stat_type,
                                                axis=axis))
    assert got.shape == want.shape == ((5, 16) if axis == 0 else (5, 12))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if stat_type in ("skew", "kurtosis"):
        # Zero-variance slices give 0, not NaN.
        assert got[3].tolist() == [0.0] * got.shape[1]
        assert (got[1, 3] if axis == 1 else got[2, 7]) == 0.0
    with pytest.raises(ValueError, match="axis"):
        topstats.patch_statistics(torch.from_numpy(x), axis=2)


def test_skewness_vectors_are_the_row_and_column_skewness():
    x = torch.from_numpy(_patches(3))
    row = topstats.skewness_vectors(x, "Row")
    col = topstats.skewness_vectors(x, "Col")
    assert row.shape == (5, 12, 1) and col.shape == (5, 1, 16)
    torch.testing.assert_close(row[..., 0], topstats.patch_statistics(
        x, stat_type="skew", axis=1), rtol=0, atol=0)
    torch.testing.assert_close(col[:, 0], topstats.patch_statistics(
        x, stat_type="skew", axis=0), rtol=0, atol=0)
    with pytest.raises(ValueError, match="Row' or 'Col"):
        topstats.skewness_vectors(x, "row")

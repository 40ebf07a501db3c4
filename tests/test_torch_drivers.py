"""The last drivers of the port against the JAX package: ``balance_data``,
``transfer_learn``, ``cli.featurize`` (its feature cache) and ``cli.tsne``
(``collect_class_patches``, the KMeans compression, the grid search and
the CLI), all with ``--device cpu`` / ``device="cpu"``.

Features at ``test_torch_eval``'s 1e-3 dB (float32 summation order in the
DFT and mel products), and at 5e-3 dB more than 60 dB below the item's
peak (``DEEP_DB``), on a toy corpus with a -40 dB noise floor (the toy
synthesizers leave bins where two float32 DFTs differ by 0.02 dB); the
skewness vectors of ``collect_class_patches`` within 2e-3 (skewness of
rows standardized over a 16-frame patch, whose cubes carry the features'
1e-3 dB three times); balanced data bit for bit.  The JAX t-SNE
standardization is patched to centre constant rows, as the port and
sklearn do (ROADMAP §3).
"""

import functools
import os

import numpy as np
import pytest
import torch

from sm_hpss_mtl_tpu.cli import featurize as jfeaturize
from sm_hpss_mtl_tpu.cli import tsne as jtsne
from sm_hpss_mtl_tpu.data import balance as jbalance
from sm_hpss_mtl_tpu.data import featurize as jfeat
from sm_hpss_mtl_tpu.data import folds as jfolds
from sm_hpss_mtl_tpu.ops import patches as jpatches
from sm_hpss_mtl_tpu_torch.cli import featurize, tsne
from sm_hpss_mtl_tpu_torch.data import audio as taudio
from sm_hpss_mtl_tpu_torch.data import featurize as tfeat
from sm_hpss_mtl_tpu_torch.data.balance import balance_data
from sm_hpss_mtl_tpu_torch.models.zoo import get_model
from sm_hpss_mtl_tpu_torch.train import optimizers as toptim
from sm_hpss_mtl_tpu_torch.train.state import TrainState
from sm_hpss_mtl_tpu_torch.train.transfer import transfer_learn

torch.set_num_threads(2)

DB_ATOL = 1e-3
SKEW_ATOL = 2e-3
#: Feature bins more than DEEP_DB below their item's peak (down to the
#: 80 dB floor: a tonal file's percussive part, whose masks are ~1e-4)
#: hold DEEP_DB_ATOL: float32 DFT rounding, ~1e-7 of the peak amplitude,
#: is 3e-4 of a bin 70 dB down, and the squared masks triple it.
DEEP_DB, DEEP_DB_ATOL = 60.0, 5e-3


def _noise_floor(root, seed, level=1e-2):
    rng = np.random.default_rng(seed)
    for cls in sorted(os.listdir(root)):
        d = os.path.join(root, cls)
        if cls == "annotations" or not os.path.isdir(d):
            continue
        for name in sorted(os.listdir(d)):
            x, _ = taudio.read_wav(os.path.join(d, name))
            taudio.write_wav(os.path.join(d, name),
                             x + level * rng.standard_normal(len(x)))


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("drivers") / "corpus")
    taudio.make_toy_musan(root, n_per_class=3, duration_s=(1.0, 2.0),
                          seed=1)
    _noise_floor(root, 2)
    return root


@pytest.fixture
def jax_constant_rows_fixed(monkeypatch):
    def fixed(FV):
        FV = np.asarray(FV)
        out = np.array(jpatches.standardize_rows(FV))
        out[FV.max(axis=-1) == FV.min(axis=-1)] = 0.0
        return out

    monkeypatch.setattr(jtsne, "standardize_rows", fixed)


@pytest.mark.parametrize("seed", [0, 3])
def test_balance_data_matches_jax(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((30, 4))
    y = np.array([0] * 17 + [1] * 9 + [2] * 4)
    got, want = balance_data(x, y, seed=seed), jbalance.balance_data(
        x, y, seed=seed)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (np.unique(got[1], return_counts=True)[1] == 17).all()


def test_balance_data_fallback(rng):
    # The JAX package's test of the same name (tests/test_data.py).
    x = rng.standard_normal((30, 4))
    y = np.array([0] * 20 + [1] * 10)
    xb, yb = balance_data(x, y, seed=0)
    _, c = np.unique(yb, return_counts=True)
    assert c[0] == c[1] == 20
    assert xb.shape[0] == 40


def test_transfer_learn_continues():
    # The JAX package's test of the same name: the remaining budget of
    # epochs from a restored state; none left is a no-op.
    net = get_model("Lemaire_et_al_MTL", n_mels=6, patch_size=16,
                    dropout_rate=0.0, n_filters=8, nb_stacks=1, Nd=2)
    x = torch.randn(6, 16, 12, generator=torch.Generator().manual_seed(0))
    cls = np.repeat([0, 1, 2], 2)
    labels = {"S": torch.tensor(cls == 1, dtype=torch.float32),
              "M": torch.tensor(cls == 0, dtype=torch.float32),
              "R": torch.full((6, 2), 0.5), "3C": torch.eye(3)[cls]}

    def stream():
        while True:
            yield x, labels

    opt, _ = toptim.for_model("Lemaire_et_al_MTL", net.parameters(),
                              tr_steps=10)
    state = TrainState(net, opt)
    res = transfer_learn(net, opt, state, stream(), stream(), mtl=True,
                         epochs=3, steps_per_epoch=2, val_steps=1,
                         initial_epoch=1, verbose=False,
                         generator=torch.Generator().manual_seed(0))
    assert 1 <= len(res.history) <= 2
    assert res.state.step >= 2
    res0 = transfer_learn(net, opt, state, stream(), stream(), mtl=True,
                          epochs=2, steps_per_epoch=2, val_steps=1,
                          initial_epoch=2)
    assert res0.history == [] and res0.state is state


def test_featurize_cache_matches_jax(toy, tmp_path, monkeypatch):
    # The same items cached under the same names, each featuregram within
    # 1e-3 dB of the JAX CLI's, that at the DFT precision the port serves
    # ('highest'; the JAX config's default is 'bf16x3').
    monkeypatch.setattr(jfeaturize, "ExperimentConfig", functools.partial(
        jfeaturize.ExperimentConfig, dft_precision="highest"))
    kw = ["--data", toy, "--model", "Lemaire_et_al_MTL", "--batch-size", "4"]
    done = featurize.main([*kw, "--features", str(tmp_path / "t"),
                           "--device", "cpu"])
    jfeaturize.main([*kw, "--features", str(tmp_path / "j")])
    sub = os.path.join("Lemaire_et_al_MTL", "LogMelHarmPercSpec")
    got = {os.path.relpath(os.path.join(d, f), tmp_path / "t" / sub)
           for d, _, fs in os.walk(tmp_path / "t" / sub) for f in fs}
    want = {os.path.relpath(os.path.join(d, f), tmp_path / "j" / sub)
            for d, _, fs in os.walk(tmp_path / "j" / sub) for f in fs}
    assert got == want and len(got) == done == 9
    for name in sorted(got):
        g = np.load(tmp_path / "t" / sub / name)
        w = np.load(tmp_path / "j" / sub / name)
        assert g.shape == w.shape == (240, g.shape[1])
        deep = w < w.max() - DEEP_DB
        np.testing.assert_allclose(g[~deep], w[~deep], rtol=0, atol=DB_ATOL,
                                   err_msg=name)
        np.testing.assert_allclose(g[deep], w[deep], rtol=0,
                                   atol=DEEP_DB_ATOL, err_msg=name)
    # A second run finds every item cached.
    assert featurize.main([*kw, "--features", str(tmp_path / "t"),
                           "--device", "cpu"]) == 0


@pytest.mark.parametrize("stat", [None, "Row", "Col"])
def test_collect_class_patches_matches_jax(toy, jax_constant_rows_fixed,
                                           stat):
    cv = jfolds.create_cv_folds(toy, seed=0)
    files = {"music": cv["music"]["fold0"], "speech": cv["speech"]["fold0"],
             "speech_music": cv["speech+music"]["fold0"]}
    kw = dict(patch_size=16, patch_shift=16, feat_name="LogMelHarmPercSpec",
              stat=stat, max_patches_per_class=40, seed=3)
    gx, gy = tsne.collect_class_patches(
        tfeat.Featurizer(tfeat.FeatureConfig(n_mels=16), device="cpu"), toy,
        files, **kw)
    wx, wy = jtsne.collect_class_patches(
        jfeat.Featurizer(jfeat.FeatureConfig(n_mels=16)), toy, files, **kw)
    np.testing.assert_array_equal(gy, wy)
    assert gx.shape == wx.shape
    tol = DB_ATOL if stat is None else SKEW_ATOL
    # Without a statistic the patches are standardized rows: 1e-3 dB over
    # a row's std (at least 1 dB here).
    np.testing.assert_allclose(gx, wx, rtol=0, atol=tol)


def test_kmeans_compress_and_grid_search(tmp_path):
    # The JAX package's t-SNE helpers, ported unchanged (sklearn on the
    # host): the compression against the JAX function, its cache, and the
    # grid search's scores (tests/test_segment_tune_tsne.py).
    rng = np.random.default_rng(0)
    X = np.concatenate([rng.normal(0, 1, (30, 5)),
                        rng.normal(6, 1, (30, 5))])
    y = np.repeat([0, 1], 30)
    cache = str(tmp_path / "c.npz")
    got = tsne.kmeans_compress(X, y, clusters=4, seed=0, cache=cache)
    want = jtsne.kmeans_compress(X, y, clusters=4, seed=0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-12)
    assert os.path.exists(cache)
    rows, best = tsne.grid_search_tsne(X, perplexities=[5, 10],
                                       exaggerations=[4],
                                       learning_rates=[100], seed=0)
    assert len(rows) == 2
    assert all(np.isfinite(r["kl"]) for r in rows)
    assert best["kl"] == min(r["kl"] for r in rows)
    assert best["embedding"].shape == (60, 2)


def test_tsne_cli(toy, tmp_path):
    # The JAX package's test of the same name, with --device cpu.
    out = str(tmp_path / "tsne.npz")
    emb, y = tsne.main([
        "--data", toy, "--out", out, "--feat-name", "LogMelSpec",
        "--n-mels", "16", "--stat", "Row", "--patch-size", "16",
        "--clusters", "5", "--max-patches", "50", "--device", "cpu"])
    assert emb.shape[1] == 2
    assert len(np.unique(y)) == 3
    assert os.path.exists(out)
    z = np.load(out)
    np.testing.assert_array_equal(z["labels"], y)


@pytest.mark.parametrize("cli", ["featurize", "tsne"])
def test_drivers_without_device_cpu_raise_when_no_gpu(monkeypatch, tmp_path,
                                                      cli):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--data", str(tmp_path)] + (
        ["--features", str(tmp_path / "f")] if cli == "featurize" else [])
    mod = featurize if cli == "featurize" else tsne
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(argv)

"""The port's native host kernels (``sm_hpss_mtl_tpu_torch/native``) against
their numpy twins in the port and against the JAX package's native kernels,
at ``tests/test_native.py``'s tolerances; the copy of ``kernels.cpp``
pinned to its source; where the library is built; a failed build raises;
and the port's host batcher with noise on equals the JAX package's."""

from pathlib import Path

import numpy as np
import pytest
import scipy.stats
import torch

from sm_hpss_mtl_tpu import native as jnative
from sm_hpss_mtl_tpu.data import batcher as jbatcher
from sm_hpss_mtl_tpu.data import folds as jfolds
from sm_hpss_mtl_tpu.ops import reference as ref
from sm_hpss_mtl_tpu_torch import native
from sm_hpss_mtl_tpu_torch.data import audio as taudio
from sm_hpss_mtl_tpu_torch.data import batcher as tbatcher
from sm_hpss_mtl_tpu_torch.data import featurize as tfeat
from sm_hpss_mtl_tpu_torch.ops import patches as tpatches
from sm_hpss_mtl_tpu_torch.ops import silence as tsilence
from sm_hpss_mtl_tpu_torch.ops import stats as tstats

REPO = Path(__file__).resolve().parents[1]
W = 16
N_MELS = 16
BS = 4


@pytest.fixture(scope="module", autouse=True)
def built():
    assert jnative.available(), jnative.build_error()
    assert native.available(), native.build_error()


def _below_header(path: Path) -> str:
    """The source after its leading comment block."""
    lines = path.read_text().splitlines(keepends=True)
    i = 0
    while lines[i].startswith("//") or not lines[i].strip():
        i += 1
    return "".join(lines[i:])


def test_kernels_cpp_copy_is_pinned_to_the_jax_source():
    got = _below_header(REPO / "sm_hpss_mtl_tpu_torch" / "native"
                        / "kernels.cpp")
    want = _below_header(REPO / "sm_hpss_mtl_tpu" / "native" / "kernels.cpp")
    assert got == want
    assert "add_gaussian_noise_f32" in got


def test_library_is_built_under_build_not_in_the_package():
    lib = native.LIB_PATH
    assert lib.parent == REPO / "build" / "torch_native"
    assert lib.exists()
    assert lib.stat().st_mtime >= native.SOURCE.stat().st_mtime
    pkg = REPO / "sm_hpss_mtl_tpu_torch"
    assert not [p for p in pkg.rglob("*.so")]


def test_a_failed_build_raises_with_the_compilers_message(monkeypatch,
                                                         tmp_path):
    broken = tmp_path / "kernels.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "LIB_PATH", tmp_path / "build" / "lib.so")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    with pytest.raises(RuntimeError, match="did not build") as err:
        native.extract_patches(np.zeros((2, 20), np.float32), 8, 8)
    assert "error" in str(err.value)
    assert not native.available()
    assert "kernels.cpp" in native.build_error()
    x = np.zeros(8, np.float32)
    with pytest.raises(RuntimeError, match="did not build"):
        native.add_gaussian_noise(x, 1.0, seed=1)
    assert not x.any()                   # nothing drew from another sampler


@pytest.mark.parametrize("T,W_,shift", [(500, 68, 68), (40, 68, 68),
                                        (300, 249, 24)])
def test_extract_patches(rng, T, W_, shift):
    fv = rng.standard_normal((12, T)).astype(np.float32)
    got = native.extract_patches(fv, W_, shift)
    np.testing.assert_array_equal(got, tpatches.extract_patches_np(
        fv, W_, shift).astype(np.float32))
    np.testing.assert_array_equal(got, jnative.extract_patches(fv, W_, shift))


def test_standardize_rows(rng):
    fv = rng.standard_normal((8, 123)).astype(np.float32)
    fv[3] = 2.5
    fv[5] = -80.0                          # a row pinned at the dB floor
    got = native.standardize_rows(fv)
    want = tpatches.standardize_rows(torch.from_numpy(
        fv.astype(np.float64))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert not got[3].any() and not got[5].any()
    np.testing.assert_array_equal(got, jnative.standardize_rows(fv))


def test_scale_frames(rng):
    fv = rng.standard_normal((6, 50)).astype(np.float32)
    mean = rng.standard_normal(6).astype(np.float32)
    stdev = np.abs(rng.standard_normal(6)).astype(np.float32)
    got = native.scale_frames(fv, mean, stdev)
    np.testing.assert_allclose(got, tbatcher.scale_frames(fv, mean, stdev),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got, jnative.scale_frames(fv, mean, stdev))
    # Shapes are checked before the pointers reach the kernel.
    with pytest.raises(ValueError, match=r"\(D,\) statistics"):
        native.scale_frames(fv, mean[:3], stdev)
    with pytest.raises(ValueError, match="axis"):
        native.patch_statistics(fv[None].astype(np.float64), "skew", 2)
    with pytest.raises(ValueError, match="takes \\(D, T\\)"):
        native.standardize_rows(fv[0])


def test_remove_silence(rng):
    fs = 16000
    x = 0.5 * rng.standard_normal(3 * fs).astype(np.float32)
    x[fs // 2:fs] = 1e-5
    x[2 * fs:2 * fs + fs // 2] = 1e-5
    e = ref.rms_energy(x, 400, 160)
    got = native.remove_silence(x, e, fs)
    for want in (tsilence.remove_silence(x, e, fs),
                 jnative.remove_silence(x, e, fs)):
        for i in range(3):
            np.testing.assert_array_equal(got[i], want[i])
        assert abs(got[3] - want[3]) < 1e-9
    assert len(got[0]) < len(x)              # the two gaps went


@pytest.mark.parametrize("stat,axis", [("mean", 0), ("variance", 1),
                                       ("skew", 0), ("kurtosis", 1)])
def test_patch_statistics(rng, stat, axis):
    fv = rng.standard_normal((4, 10, 20))
    got = native.patch_statistics(fv, stat, axis)
    fns = {"mean": np.mean, "variance": np.var,
           "skew": scipy.stats.skew, "kurtosis": scipy.stats.kurtosis}
    want = np.stack([fns[stat](fv[i], axis=axis) for i in range(4)])
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)
    np.testing.assert_array_equal(got, jnative.patch_statistics(fv, stat,
                                                                axis))
    # The port's twin computes in float32.
    twin = tstats.patch_statistics(torch.from_numpy(fv), stat_type=stat,
                                   axis=axis).numpy()
    np.testing.assert_allclose(got, twin, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape,seed", [((10000,), 7), ((48, 68, 240), 42),
                                        ((3, 5, 7), 2 ** 63 - 2)])
def test_add_gaussian_noise_is_the_jax_field(shape, seed):
    base = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    got, want = base.copy(), base.copy()
    native.add_gaussian_noise(got, 5e-3, seed)
    jnative.add_gaussian_noise(want, 5e-3, seed)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, base)


def test_add_gaussian_noise_moments_and_determinism():
    x = np.zeros((48, 68, 240), np.float32)
    native.add_gaussian_noise(x, 1.0, seed=42)
    assert abs(float(x.mean())) < 5e-3
    assert abs(float(x.var()) - 1.0) < 5e-3
    z = (x - x.mean()) / x.std()
    assert abs(float((z ** 3).mean())) < 2e-2
    assert abs(float((z ** 4).mean()) - 3.0) < 5e-2
    assert abs(float((np.abs(x) > 3).mean()) - 0.0027) < 5e-4
    a, b, c = (np.zeros(10000, np.float32) for _ in range(3))
    native.add_gaussian_noise(a, 5e-3, seed=7)
    native.add_gaussian_noise(b, 5e-3, seed=7)
    native.add_gaussian_noise(c, 5e-3, seed=8)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    with pytest.raises(ValueError, match="float32"):
        native.add_gaussian_noise(np.zeros(4), 1.0, seed=1)


def test_audio_loader_removes_silence_as_jax(tmp_path):
    from sm_hpss_mtl_tpu.data import audio as jaudio
    fs = 16000
    rng = np.random.default_rng(3)
    x = 0.3 * rng.standard_normal(2 * fs)
    x[fs // 4:fs // 2] = 0.0
    x[fs:fs + fs // 3] = 0.0
    path = str(tmp_path / "gaps.wav")
    taudio.write_wav(path, x, fs)
    got, _ = taudio.load_and_preprocess_signal(path)
    want, _ = jaudio.load_and_preprocess_signal(path)
    assert len(got) < len(x)
    np.testing.assert_array_equal(got, want)


class _SharedFeatures:
    """One featurizer's featuregrams, memoized, so that two batchers read
    the same arrays."""

    def __init__(self, fz):
        self.fz = fz
        self.memo = {}

    def featuregram(self, *args, **kw):
        key = (args, tuple(sorted(kw.items())))
        if key not in self.memo:
            self.memo[key] = np.asarray(self.fz.featuregram(*args, **kw),
                                        np.float32)
        return self.memo[key]


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("toy"))
    taudio.make_toy_musan(root, n_per_class=6, duration_s=1.5, seed=4)
    return root, jfolds.create_cv_folds(root, seed=0)


def test_balanced_batcher_with_noise_matches_jax(toy):
    """Given the same featuregrams, the port's batches are the JAX
    package's bit for bit, noise included.  (With each package's own
    featurizer they differ by the features' difference, which
    ``test_torch_train`` holds with noise off.)"""
    root, cv = toy
    files, _ = jfolds.get_train_test_files(cv, 1)
    kw = dict(batch_size=BS, patch_size=W, patch_shift=W,
              augment_noise=True, seed=7)
    fz = _SharedFeatures(tfeat.Featurizer(tfeat.FeatureConfig(n_mels=N_MELS),
                                          device="cpu"))
    got = tbatcher.BalancedBatcher(fz, root, files,
                                   tbatcher.BatcherConfig(**kw))
    want = jbatcher.BalancedBatcher(fz, root, files,
                                    jbatcher.BatcherConfig(**kw))
    clean = tbatcher.BalancedBatcher(
        fz, root, files, tbatcher.BatcherConfig(**{**kw,
                                                   "augment_noise": False}))
    for i in range(4):
        (gx, gl), (wx, wl) = next(got), next(want)
        assert gx.shape == wx.shape == (3 * BS, W, 2 * N_MELS)
        np.testing.assert_array_equal(gx, wx)
        if i == 0:
            # The first batch's files come before any noise draw.
            cx, _ = next(clean)
            assert 0 < np.abs(gx - cx).max() < 0.05
        for k in wl:
            np.testing.assert_array_equal(gl[k], wl[k])
    assert got.cache_stats == want.cache_stats

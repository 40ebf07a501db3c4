"""DSP and data helpers of the port against the JAX package.

Feature tolerance is atol 1e-3 dB: the two packages sum the DFT and mel
products in different orders in float32 (relative differences ~1e-6),
and the dB map turns a relative error e into 4.3*e dB; 1e-3 dB leaves two
orders of magnitude of headroom while still catching any wrong frame,
edge rule or clamp (those move features by whole dB).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sm_hpss_mtl_tpu.data import audio as jaudio
from sm_hpss_mtl_tpu.data import featurize as jfeat
from sm_hpss_mtl_tpu.ops import featuregram as jfg
from sm_hpss_mtl_tpu.ops import mel as jmel
from sm_hpss_mtl_tpu.ops import patches as jpatches
from sm_hpss_mtl_tpu.ops import reference as jref
from sm_hpss_mtl_tpu_torch.data import audio as taudio
from sm_hpss_mtl_tpu_torch.data import featurize as tfeat
from sm_hpss_mtl_tpu_torch.ops import featuregram as tfg
from sm_hpss_mtl_tpu_torch.ops import mel as tmel
from sm_hpss_mtl_tpu_torch.ops import patches as tpatches
from sm_hpss_mtl_tpu_torch.ops import reference as tref
from sm_hpss_mtl_tpu_torch.ops import stft as tstft

torch.set_num_threads(1)

DB_ATOL = 1e-3


def _audio(seconds, seed):
    rng = np.random.default_rng(seed)
    n = int(16000 * seconds)
    t = np.arange(n) / 16000
    x = (0.4 * np.sin(2 * np.pi * 330 * t) + 0.2 * np.sin(2 * np.pi * 1750 * t)
         + 0.05 * rng.standard_normal(n))
    for k in range(0, n - 40, 2400):
        x[k:k + 40] += np.hanning(40)
    return x.astype(np.float32)


@pytest.mark.parametrize("sr,n_fft,n_mels", [(22050, 400, 120),
                                             (16000, 400, 120),
                                             (22050, 512, 24)])
def test_mel_filterbank_exact(sr, n_fft, n_mels):
    want = np.asarray(jmel.mel_filterbank(sr, n_fft, n_mels))
    got = tmel.mel_filterbank(sr, n_fft, n_mels).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tref.mel_filterbank(sr, n_fft, n_mels),
                                  jref.mel_filterbank(sr, n_fft, n_mels))


def test_reference_copies_exact():
    f = np.linspace(0, 11025, 97)
    np.testing.assert_array_equal(tref.hz_to_mel(f), jref.hz_to_mel(f))
    np.testing.assert_array_equal(tref.hz_to_mel(f, htk=True),
                                  jref.hz_to_mel(f, htk=True))
    m = np.linspace(0, 40, 51)
    np.testing.assert_array_equal(tref.mel_to_hz(m), jref.mel_to_hz(m))
    np.testing.assert_array_equal(tref.mel_frequencies(10, 0, 8000),
                                  jref.mel_frequencies(10, 0, 8000))
    np.testing.assert_array_equal(tref.pad_center(tref.hann_window(400), 512),
                                  jref.pad_center(jref.hann_window(400), 512))
    np.testing.assert_array_equal(
        tstft.hann_window(400, 512).numpy(),
        jref.pad_center(jref.hann_window(400), 512).astype(np.float32))


def test_stft_mag_matches_numpy_golden():
    x = _audio(0.5, 1)
    got = tstft.stft_mag(torch.from_numpy(x), n_fft=400, win_length=400,
                         hop_length=160).numpy()
    want = jref.stft_mag(x, 400, 400, 160)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("valid", [None, 37, "batched"])
def test_power_to_db_valid_len(valid):
    rng = np.random.default_rng(3)
    S = (rng.random((2, 6, 50)) ** 6).astype(np.float32)
    S[:, :, 40:] = 50.0       # padded frames louder than any real one
    if valid == "batched":
        v_np = np.array([30, 45]).reshape(2, 1, 1)
        jv, tv = jnp.asarray(v_np), torch.from_numpy(v_np)
    else:
        jv = tv = valid
    want = np.asarray(jmel.power_to_db(jnp.asarray(S), valid_len=jv))
    got = tmel.power_to_db(torch.from_numpy(S), valid_len=tv).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


def test_standardize_rows_with_constant_row():
    rng = np.random.default_rng(4)
    FV = rng.standard_normal((5, 40)).astype(np.float32) * 3 + 1
    FV[2] = 7.0
    want = np.asarray(jpatches.standardize_rows(FV))
    got = tpatches.standardize_rows(torch.from_numpy(FV)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.all(got[2] == 0.0)


def test_standardize_rows_constant_row_at_db_floor():
    # A row pinned at the dB floor, as the empty low mel filters of the
    # sr=22050 bank always are.  In float32 its rounded mean differs from
    # the value, so the JAX helper's std == 0 test misses it and the row
    # standardizes to +-1 noise; the port centres it to 0 as sklearn does.
    FV = np.full((2, 99), -80.70137, np.float32)
    FV[1] = np.linspace(-3, 3, 99)
    jax_row = np.asarray(jpatches.standardize_rows(FV))[0]
    assert np.abs(jax_row).max() > 0.5
    got = tpatches.standardize_rows(torch.from_numpy(FV)).numpy()
    assert np.all(got[0] == 0.0)
    np.testing.assert_allclose(got[1], np.asarray(
        jpatches.standardize_rows(FV))[1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("feat_name", ["LogMelHarmPercSpec", "LogMelSpec",
                                       "LogMelPercSpec"])
def test_featuregram_bucketed_matches_jax(feat_name):
    x = _audio(1.3, 2)
    true_t = tstft.n_frames(len(x), 400, 160)
    xb = tfeat._reflect_pad_to(x, tfeat.bucket_length(len(x)))
    np.testing.assert_array_equal(
        xb, jfeat._reflect_pad_to(x, jfeat.bucket_length(len(x))))
    kw = dict(feat_name=feat_name, n_mels=40)
    want = np.asarray(jfg.featuregram(jnp.asarray(xb), use_pallas=False,
                                      valid_frames=jnp.asarray(true_t),
                                      **kw))
    got = tfg.featuregram(torch.from_numpy(xb), valid_frames=true_t,
                          **kw).numpy()
    assert got.shape == want.shape == (tfg.feature_dim(feat_name, n_mels=40),
                                       tstft.n_frames(len(xb), 400, 160))
    np.testing.assert_allclose(got, want, rtol=0, atol=DB_ATOL)


def test_featuregram_slabbed_matches_jax():
    x = _audio(3.0, 6)       # 298 frames: 5 slabs of 64 with a ragged tail
    kw = dict(feat_name="LogMelHarmPercSpec", n_mels=40, slab_frames=64)
    want = np.asarray(jfg.featuregram_slabbed(x, **kw))
    got = tfg.featuregram_slabbed(torch.from_numpy(x), **kw).numpy()
    assert got.shape == want.shape == (80, 298)
    np.testing.assert_allclose(got, want, rtol=0, atol=DB_ATOL)
    whole = tfg.featuregram(torch.from_numpy(x), feat_name=kw["feat_name"],
                            n_mels=40).numpy()
    np.testing.assert_allclose(got, whole, rtol=0, atol=DB_ATOL)


def test_featuregram_k2_families_raise_on_cuda_only():
    x = torch.from_numpy(_audio(0.2, 7))
    assert tfg.featuregram(x, feat_name="HarmSpec").shape == (201, 18)
    with pytest.raises(ValueError, match="unknown featName"):
        tfg._parse("LogMelFoo")


@pytest.mark.parametrize("n", [100, 16000, 16001, 123457])
def test_bucket_length_matches_jax(n):
    assert tfeat.bucket_length(n) == jfeat.bucket_length(n)


def test_read_wav_resamples_stereo_like_jax(tmp_path):
    from scipy.io import wavfile
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((2205, 2)) * 8000).astype(np.int16)
    path = str(tmp_path / "s.wav")
    wavfile.write(path, 22050, x)
    got, sr = taudio.read_wav(path)
    want, jsr = jaudio.read_wav(path)
    assert sr == jsr == 16000
    np.testing.assert_array_equal(got, want)

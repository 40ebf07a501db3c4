"""HPSS resynthesis in the port against the JAX package: the complex STFT
and its inverse, the mixing helpers, wav I/O, ``resynthesize`` and the
``cli.hpss_resynth`` entry point, all on the CPU.

Tolerances: the STFT and the masks agree to float32 rounding (~1e-5 on
spectra of order 10).  The inverse divides by the overlap-added squared
window ``wsum``, which is ~1e-9 at the first and last samples, so there
it amplifies rounding without bound.  Signals are therefore compared
times ``wsum`` (the raw overlap-add, before the division) at every
sample.
"""

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax.numpy as jnp

from sm_hpss_mtl_tpu.cli import hpss_resynth as jcli
from sm_hpss_mtl_tpu.data import audio as jaudio
from sm_hpss_mtl_tpu.ops import mixing as jmix
from sm_hpss_mtl_tpu.ops import stft as jstft
from sm_hpss_mtl_tpu_torch.cli import hpss_resynth as tcli
from sm_hpss_mtl_tpu_torch.data import audio as taudio
from sm_hpss_mtl_tpu_torch.ops import mixing as tmix
from sm_hpss_mtl_tpu_torch.ops import stft as tstft

torch.set_num_threads(1)

KW = dict(n_fft=400, win_length=400, hop_length=160)


def _signal(seconds, seed):
    """A tone with clicks and a little noise, 16 kHz float32."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000
    x = 0.4 * np.sin(2 * np.pi * 330 * t) + 0.01 * rng.standard_normal(t.size)
    for k in range(500, t.size - 40, 2400):
        x[k:k + 40] += 0.8 * np.hanning(40)
    return x.astype(np.float32)


def _wsum(n_samples, length=None, n_fft=400, win_length=400, hop=160):
    """The overlap-added squared window of the iSTFT of an
    ``n_samples`` signal's STFT, trimmed or zero-padded to ``length``."""
    w = tstft.hann_window(win_length, n_fft).numpy() ** 2
    T = 1 + (n_samples - n_fft) // hop
    wsum = np.zeros(n_fft + hop * (T - 1))
    for t in range(T):
        wsum[t * hop:t * hop + n_fft] += w
    length = wsum.size if length is None else length
    return np.pad(wsum, (0, max(0, length - wsum.size)))[:length]


@pytest.mark.parametrize("n_fft,win_length", [(400, 400), (512, 400)])
def test_stft_matches_jax(n_fft, win_length):
    y = np.random.default_rng(n_fft).standard_normal((2, 5_000))
    y = y.astype(np.float32)
    kw = dict(n_fft=n_fft, win_length=win_length, hop_length=160)
    want = np.asarray(jstft.stft(jnp.asarray(y), **kw))
    got = tstft.stft(torch.from_numpy(y), **kw)
    assert got.dtype == torch.complex64
    assert got.shape == want.shape == (2, 1 + n_fft // 2, 29)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(
        tstft.stft_mag(torch.from_numpy(y), **kw).numpy(), np.abs(want),
        rtol=0, atol=1e-4)


@pytest.mark.parametrize("length", [None, 4_000, 4_880, 5_100])
def test_istft_matches_jax(length):
    # Trim (4000), exact (4880 = 400 + 160*28), zero pad (5100).
    y = np.random.default_rng(1).standard_normal((2, 5_000))
    S = np.asarray(jstft.stft(jnp.asarray(y.astype(np.float32)), **KW))
    want = np.asarray(jstft.istft(jnp.asarray(S), length=length, **KW))
    got = tstft.istft(torch.from_numpy(S.copy()), length=length, **KW).numpy()
    assert got.shape == want.shape
    wsum = _wsum(5_000, length)
    np.testing.assert_allclose(got * wsum, want * wsum, rtol=0, atol=2e-5)
    if length == 5_100:
        assert np.all(got[:, 4_880:] == 0)
    # The round trip gives the signal back, up to the same weighting.
    n = min(got.shape[-1], 4_880)
    np.testing.assert_allclose(got[:, :n] * wsum[:n], y[:, :n] * wsum[:n],
                               rtol=0, atol=1e-4)


def test_mixing_matches_jax():
    rng = np.random.default_rng(2)
    sp = rng.standard_normal(3_000).astype(np.float32)
    mu = rng.standard_normal(1_100).astype(np.float32) * 3 + 0.5
    np.testing.assert_array_equal(tmix.normalize_signal_np(mu),
                                  jmix.normalize_signal_np(mu))
    for smr in (-5.0, 0.0, 12.5):
        np.testing.assert_array_equal(tmix.mix_signals_np(sp, mu, smr),
                                      jmix.mix_signals_np(sp, mu, smr))


def test_wav_io_matches_jax(tmp_path):
    x = _signal(0.1, 3) * 1.5             # some samples clip
    taudio.write_wav(str(tmp_path / "t.wav"), x)
    jaudio.write_wav(str(tmp_path / "j.wav"), x)
    assert ((tmp_path / "t.wav").read_bytes()
            == (tmp_path / "j.wav").read_bytes())
    got, sr = taudio.read_audio(str(tmp_path / "t.wav"))
    want, jsr = jaudio.read_audio(str(tmp_path / "t.wav"))
    assert sr == jsr == 16000
    np.testing.assert_array_equal(got, want)
    # mp3 goes to libmpg123 in both packages (test_torch_codecs); a
    # missing file fails there alike.
    for package in (taudio, jaudio):
        with pytest.raises(RuntimeError, match="mpg123"):
            package.read_audio(str(tmp_path / "clip.mp3"))


def test_resynthesize_matches_jax():
    x = _signal(1.0, 4)
    jh, jp = jcli.resynthesize(x)
    th, tp = tcli.resynthesize(x, device="cpu")
    assert th.shape == tp.shape == x.shape
    wsum = _wsum(len(x), len(x))
    for got, want in ((th, jh), (tp, jp)):
        np.testing.assert_allclose(got * wsum, np.asarray(want) * wsum,
                                   rtol=0, atol=1e-5)
    # The tone lands in the harmonic part, the clicks in the percussive.
    spec = np.abs(np.fft.rfft(th[1000:-1000]))
    assert abs(np.argmax(spec) * 16000 / (len(x) - 2000) - 330) < 5
    assert np.abs(tp[495:545]).max() > 5 * np.abs(tp[1500:2000]).max()


@pytest.mark.parametrize("mix", [False, True])
def test_main_writes_three_wavs_like_jax(tmp_path, mix):
    wav = str(tmp_path / "sp.wav")
    wavfile.write(wav, 16000, (_signal(0.6, 5) * 32767).astype(np.int16))
    args = [wav]
    if mix:
        mu = str(tmp_path / "mu.wav")
        rng = np.random.default_rng(6)
        wavfile.write(mu, 16000, (rng.uniform(-0.5, 0.5, 4_000) * 32767
                                  ).astype(np.int16))
        args += ["--mix", mu, "--smr", "5"]
    jcli.main(args + ["--out-dir", str(tmp_path / "j")])
    paths = tcli.main(args + ["--out-dir", str(tmp_path / "t"),
                              "--device", "cpu"])
    stem = "sp+mu_5dB" if mix else "sp"
    assert [p.rsplit("/", 1)[1] for p in paths] == [
        f"{stem}.wav", f"{stem}_Harmonic.wav", f"{stem}_Percussive.wav"]
    for path in paths:
        name = path.rsplit("/", 1)[1]
        _, got = wavfile.read(path)
        _, want = wavfile.read(str(tmp_path / "j" / name))
        assert got.dtype == np.int16 and got.shape == want.shape
        # Peak-normalised int16: one step of rounding may differ.  The
        # peak itself may sit at an ill-conditioned edge sample, so the
        # comparison is weighted as above and allows a 1e-3 scale change.
        wsum = np.minimum(_wsum(len(got), len(got)), 1.0)
        diff = np.abs(got.astype(float) - want) * wsum
        assert diff.max() <= 1 + 1e-3 * np.abs(want).max(), name

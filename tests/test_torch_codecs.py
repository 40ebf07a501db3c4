"""mp3 input in the port (``data/codecs.py`` and the ``read_audio`` /
``duration_seconds`` dispatch) against the JAX package's.

A mirror of ``tests/test_codecs.py``: a fixture encodes a known tone with
the system libmp3lame (a ctypes binding of the test's own), the codec
under test decodes it back, and the tolerances are the JAX tests'
(mp3 is lossy: correlation, not bit equality).  Both packages bind the
same libmpg123, so on the same file their samples and durations are
equal.  The port's module is a copy of the JAX one, pinned by its code.
"""

import ast
import ctypes
import ctypes.util
from pathlib import Path

import numpy as np
import pytest

from sm_hpss_mtl_tpu.data import audio as jaudio
from sm_hpss_mtl_tpu.data import codecs as jcodecs
from sm_hpss_mtl_tpu_torch.data import audio as taudio
from sm_hpss_mtl_tpu_torch.data import codecs

REPO = Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.skipif(not codecs.available(),
                                reason="libmpg123 not present")


def _encode_mp3(path, x, sr, channels=1):
    """Minimal libmp3lame encode of float32 audio, mono or the same signal
    on both channels (test helper only)."""
    lib = ctypes.CDLL(ctypes.util.find_library("mp3lame") or
                      "libmp3lame.so.0")
    lib.lame_init.restype = ctypes.c_void_p
    gf = ctypes.c_void_p(lib.lame_init())
    lib.lame_set_in_samplerate(gf, sr)
    lib.lame_set_num_channels(gf, channels)
    if channels == 1:
        lib.lame_set_mode(gf, 3)  # MONO
        lib.lame_set_brate(gf, 128)
    assert lib.lame_init_params(gf) >= 0
    pcm = (np.clip(x, -1, 1) * 32767).astype(np.int16)
    ptr = pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_short))
    out = ctypes.create_string_buffer(len(pcm) * 2 * channels + 7200)
    n = lib.lame_encode_buffer(gf, ptr, ptr if channels == 2 else None,
                               len(pcm), out, len(out))
    assert n >= 0
    data = out.raw[:n]
    n = lib.lame_encode_flush(gf, out, len(out))
    data += out.raw[:n]
    lib.lame_close(gf)
    Path(path).write_bytes(data)


@pytest.fixture(scope="module")
def tone_mp3(tmp_path_factory):
    sr = 16000
    t = np.arange(sr * 2) / sr
    x = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    path = tmp_path_factory.mktemp("mp3") / "tone.mp3"
    _encode_mp3(str(path), x, sr)
    return str(path), x, sr


def _aligned_corr(y, x, sr):
    """Correlation of ``y`` with ``x`` after the codec's delay, found by
    cross-correlation."""
    c = np.correlate(y[: sr // 2], x[: sr // 4], mode="valid")
    lag = int(np.argmax(c))
    a, b = y[lag:lag + sr], x[:sr]
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_codecs_copy_is_pinned_to_the_jax_module():
    """The code below the docstring is the JAX module's."""
    def body(path):
        tree = ast.parse(path.read_text())
        return [ast.dump(node) for node in tree.body[1:]]
    got = body(REPO / "sm_hpss_mtl_tpu_torch" / "data" / "codecs.py")
    want = body(REPO / "sm_hpss_mtl_tpu" / "data" / "codecs.py")
    assert got == want


def test_read_mp3_roundtrip(tone_mp3):
    path, x, sr = tone_mp3
    y, got_sr = codecs.read_mp3(path)
    assert got_sr == sr
    assert abs(len(y) - len(x)) < sr // 4      # encoder and decoder delay
    assert _aligned_corr(y, x, sr) > 0.99
    spec = np.abs(np.fft.rfft(y))
    assert abs(np.argmax(spec) * sr / len(y) - 440.0) < 2.0
    want, want_sr = jcodecs.read_mp3(path)
    assert want_sr == got_sr
    np.testing.assert_array_equal(y, want)


def test_read_audio_dispatch_matches_jax(tone_mp3, tmp_path):
    path, x, sr = tone_mp3
    y_mp3, sr1 = taudio.read_audio(path)
    assert sr1 == 16000 and y_mp3.ndim == 1
    want, jsr = jaudio.read_audio(path)
    assert jsr == sr1
    np.testing.assert_array_equal(y_mp3, want)
    wav = str(tmp_path / "tone.wav")
    taudio.write_wav(wav, x, sr)
    y_wav, sr2 = taudio.read_audio(wav)
    assert sr2 == 16000
    assert _aligned_corr(y_mp3, y_wav, sr) > 0.99
    # The reference's load chain takes the mp3 too.
    got, _ = taudio.load_and_preprocess_signal(path)
    np.testing.assert_array_equal(
        got, jaudio.load_and_preprocess_signal(path)[0])


def test_mp3_duration_matches_jax(tone_mp3):
    path, x, sr = tone_mp3
    dur = taudio.duration_seconds(path)
    assert dur == pytest.approx(len(x) / sr, abs=0.2)
    assert dur == jaudio.duration_seconds(path)


def test_stereo_resample_mp3_matches_jax(tmp_path):
    """A 44.1 kHz stereo mp3 comes out mono 16 kHz through read_audio."""
    sr = 44100
    t = np.arange(sr) / sr
    x = (0.4 * np.sin(2 * np.pi * 523.25 * t)).astype(np.float32)
    path = str(tmp_path / "stereo.mp3")
    _encode_mp3(path, x, sr, channels=2)
    y, got_sr = taudio.read_audio(path)
    assert got_sr == 16000 and y.ndim == 1
    spec = np.abs(np.fft.rfft(y))
    assert abs(np.argmax(spec) * 16000 / len(y) - 523.25) < 3.0
    np.testing.assert_array_equal(y, jaudio.read_audio(path)[0])
    assert taudio.duration_seconds(path) == jaudio.duration_seconds(path)

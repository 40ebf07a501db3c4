"""K1 and K2 ports: the plain versions of ``stft_hpss_mel`` and
``stft_hpss`` against the JAX kernels.

The JAX side is the Pallas kernel in interpret mode at
``dft_precision='highest'`` (the port's kernels are full float32) and the
jnp oracle chain for clips too short for the kernel's edge mirror.  The
CUDA kernels themselves are held to these plain versions on the card by
``chip_smoke.py``.  Tolerance rtol 2e-4, atol 2e-5, as
``tests/test_frontend_pallas.py`` holds the Pallas kernel to its oracle.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sm_hpss_mtl_tpu.ops import frontend_pallas as fp
from sm_hpss_mtl_tpu.ops import hpss_pallas
from sm_hpss_mtl_tpu.ops import mel as jmel
from sm_hpss_mtl_tpu_torch.ops import frontend as tfe

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-5)


def _mel(n_mels, n_fft):
    return np.array(jmel.mel_filterbank(22050, n_fft, n_mels))


@pytest.mark.parametrize("n_fft,n_samples,tile_t,l_harm,l_perc,n_mels,B", [
    (400, 16_000, 48, 21, 11, 32, 2),   # T=98: thin last tile
    (400, 8_000, 364, 21, 11, 32, 2),   # T=48: single tile wider than T
    (400, 7_920, 24, 21, 11, 32, 2),    # T=48: exact tile multiple
    (400, 9_520, 48, 21, 11, 32, 2),    # T=58: last tile exactly ht frames
    (512, 12_000, 32, 11, 5, 24, 1),    # Jang geometry, J=4
])
def test_plain_matches_pallas_interpret(n_fft, n_samples, tile_t, l_harm,
                                        l_perc, n_mels, B):
    rng = np.random.default_rng(n_samples + n_fft)
    y = rng.standard_normal((B, n_samples)).astype(np.float32)
    M = _mel(n_mels, n_fft)
    kw = dict(n_fft=n_fft, win_length=400, hop_length=160, l_harm=l_harm,
              l_perc=l_perc, power=2.0)
    jh, jp = fp._frontend_pallas(jnp.asarray(y), jnp.asarray(M).T,
                                 tile_t=tile_t, dft_precision="highest",
                                 interpret=True, **kw)
    th, tp = tfe.stft_hpss_mel_plain(torch.from_numpy(y),
                                     torch.from_numpy(M), **kw)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)


@pytest.mark.parametrize("T", [1, 5, 19])
def test_plain_matches_oracle_short_clips(T):
    # Clips shorter than 2*(l_harm//2) frames: the symmetric time padding
    # repeats (period 2T), which the JAX kernel leaves to its oracle.
    rng = np.random.default_rng(T)
    y = rng.standard_normal((2, 400 + (T - 1) * 160)).astype(np.float32)
    M = _mel(40, 400)
    kw = dict(n_fft=400, win_length=400, hop_length=160, l_harm=21,
              l_perc=11, power=2.0)
    jh, jp = fp._oracle(jnp.asarray(y), jnp.asarray(M), **kw)
    th, tp = tfe.stft_hpss_mel_plain(torch.from_numpy(y),
                                     torch.from_numpy(M), **kw)
    assert th.shape == (2, 40, T)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)


def test_wrapper_sends_cpu_tensors_to_plain_version():
    rng = np.random.default_rng(5)
    y = torch.from_numpy(rng.standard_normal((3, 1, 4_000)).astype(np.float32))
    M = torch.from_numpy(_mel(16, 400))
    before = tfe.stft_hpss_mel.launches
    h, p = tfe.stft_hpss_mel(y, M)
    assert tfe.stft_hpss_mel.launches == before
    assert h.shape == p.shape == (3, 1, 16, 23)
    h0, p0 = tfe.stft_hpss_mel_plain(y, M)
    torch.testing.assert_close(h, h0, rtol=0, atol=0)
    torch.testing.assert_close(p, p0, rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="bf16x3"):
        tfe.stft_hpss_mel(y, M, dft_precision="bf16x3")
    with pytest.raises(NotImplementedError, match="power"):
        tfe.stft_hpss_mel(y, M, power=1.0)


def test_kernel_median_networks_match_jax():
    # csrc/median.cuh, which frontend.cu includes, writes out the pruned
    # Batcher networks of ops/hpss_pallas.py::median_network; each must be
    # the same list.
    src = (tfe._nvcc.CSRC / "median.cuh").read_text()
    assert '#include "median.cuh"' in (tfe._nvcc.CSRC
                                       / "frontend.cu").read_text()
    for n in (5, 11, 21):
        body = src.split(f"struct Median<{n}>")[1].split("return")[0]
        pairs = tuple((int(i), int(j))
                      for i, j in re.findall(r"CS\((\d+),(\d+)\)", body))
        assert pairs == hpss_pallas.median_network(n), n
    assert set(tfe.KERNEL_MEDIANS) == {(21, 11), (11, 5)}


def test_import_needs_no_nvcc(tmp_path):
    # The CPU test machines have no nvcc: importing the kernel module must
    # not build or look for it.
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path))
    code = ("import sm_hpss_mtl_tpu_torch.ops.frontend as f, "
            "sm_hpss_mtl_tpu_torch.ops.featuregram; "
            "assert f._library.cache_info().currsize == 0")
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=os.path.dirname(os.path.dirname(__file__)))


@pytest.mark.parametrize("n_fft,n_samples,tile_t,l_harm,l_perc,B", [
    (400, 16_000, 48, 21, 11, 2),   # thin last tile
    (512, 12_000, 32, 21, 11, 2),   # Jang geometry, J=4
    (512, 12_000, 32, 11, 5, 1),    # the kernel's narrow median pair
])
def test_fullres_plain_matches_pallas_interpret(n_fft, n_samples, tile_t,
                                                l_harm, l_perc, B):
    # K2: full-resolution masked magnitudes, the HarmSpec/PercSpec family,
    # at the geometries of test_frontend_pallas.py::
    # test_frontend_fullres_parity.
    rng = np.random.default_rng(n_samples + n_fft + l_harm)
    y = rng.standard_normal((B, n_samples)).astype(np.float32)
    kw = dict(n_fft=n_fft, win_length=400, hop_length=160, l_harm=l_harm,
              l_perc=l_perc, power=2.0)
    jh, jp = fp.stft_hpss(jnp.asarray(y), tile_t=tile_t,
                          dft_precision="highest", interpret=True, **kw)
    th, tp = tfe.stft_hpss_plain(torch.from_numpy(y), **kw)
    assert th.shape == (B, 1 + n_fft // 2, 1 + (n_samples - n_fft) // 160)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)


def test_fullres_wrapper_sends_cpu_tensors_to_plain_version():
    rng = np.random.default_rng(6)
    y = torch.from_numpy(rng.standard_normal((3, 1, 4_000)).astype(np.float32))
    before = (tfe.stft_hpss.launches, tfe.stft_hpss_mel.launches)
    h, p = tfe.stft_hpss(y, n_fft=512)
    assert (tfe.stft_hpss.launches, tfe.stft_hpss_mel.launches) == before
    assert h.shape == p.shape == (3, 1, 257, 22)
    h0, p0 = tfe.stft_hpss_plain(y, n_fft=512)
    torch.testing.assert_close(h, h0, rtol=0, atol=0)
    torch.testing.assert_close(p, p0, rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="bf16x3"):
        tfe.stft_hpss(y, dft_precision="bf16x3")
    with pytest.raises(NotImplementedError, match="power"):
        tfe.stft_hpss(y, power=1.0)
    with pytest.raises(ValueError, match="unsupported device"):
        tfe.stft_hpss(y.to("meta"))


def test_plain_versions_never_route_into_k3(monkeypatch):
    # chip_smoke.py holds K1 and K2 to these plain versions on the card: if
    # they called the dispatching ops.hpss.hpss, a CUDA tensor would take
    # K3 and the kernels would be compared with another kernel.
    from sm_hpss_mtl_tpu_torch.ops import featuregram as tfg
    from sm_hpss_mtl_tpu_torch.ops import hpss as thpss

    def refuse(*args, **kwargs):
        raise AssertionError("plain version reached the K3 dispatcher")

    monkeypatch.setattr(thpss, "_dispatch", refuse)
    rng = np.random.default_rng(7)
    y = torch.from_numpy(rng.standard_normal((1, 4_000)).astype(np.float32))
    M = torch.from_numpy(_mel(16, 400))
    tfe.stft_hpss_plain(y)
    tfe.stft_hpss_mel_plain(y, M)
    tfg.featuregram(y, feat_name="LogHarmPercSpec", n_fft=512)
    tfg.featuregram(y, feat_name="LogMelHarmPercSpec", n_mels=16)


@pytest.mark.parametrize("T", [1, 8, 19])
def test_short_clips_match_jax_short_clip_kernels(T):
    # Clips under 2*(l_harm//2) = 20 frames: the JAX front end sends them
    # to stft_mag and the spectral Pallas kernels (K4 for mel features, K3
    # at full resolution), here in interpret mode.  The port's dispatchers
    # take the plain chain on the CPU.
    rng = np.random.default_rng(100 + T)
    y = rng.standard_normal((2, 400 + (T - 1) * 160)).astype(np.float32)
    M = _mel(120, 400)
    kw = dict(n_fft=400, win_length=400, hop_length=160, l_harm=21,
              l_perc=11)
    jh, jp = fp.stft_hpss_mel(jnp.asarray(y), M, dft_precision="highest",
                              interpret=True, **kw)
    th, tp = tfe.stft_hpss_mel(torch.from_numpy(y), torch.from_numpy(M),
                               **kw)
    assert th.shape == (2, 120, T)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)
    jh, jp = fp.stft_hpss(jnp.asarray(y), dft_precision="highest",
                          interpret=True, **kw)
    th, tp = tfe.stft_hpss(torch.from_numpy(y), **kw)
    assert th.shape == (2, 201, T)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)


@pytest.mark.parametrize("l_harm,l_perc,T,want", [
    (21, 11, 1, "spectral"), (21, 11, 19, "spectral"),
    (21, 11, 20, "fused"), (21, 11, 98, "fused"),
    (11, 5, 9, "spectral"), (11, 5, 10, "fused"),
])
@pytest.mark.parametrize("mel", [True, False])
def test_cuda_route_sends_short_clips_to_k4_and_k3(monkeypatch, l_harm,
                                                   l_perc, T, want, mel):
    # The CUDA route (frontend._dispatch) with its launchers replaced by
    # spies: clips under 2*(l_harm//2) frames go to stft_mag and then K4
    # (mel) or K3 (full resolution), the rest to K1 or K2.
    from sm_hpss_mtl_tpu_torch.ops import hpss as thpss
    seen = []

    def spectral(name):
        def run(S, *a, **kw):
            seen.append((name, tuple(S.shape)))
            return S, S
        return run

    monkeypatch.setattr(thpss, "hpss_mel", spectral("K4"))
    monkeypatch.setattr(thpss, "hpss", spectral("K3"))
    monkeypatch.setattr(tfe, "launch", lambda y, M, **kw: seen.append(
        ("K1" if M is not None else "K2", tuple(y.shape))))
    y = torch.zeros((2, 400 + (T - 1) * 160))
    M = torch.from_numpy(_mel(16, 400)) if mel else None
    tfe._dispatch(y, M, n_fft=400, win_length=400, hop_length=160,
                  l_harm=l_harm, l_perc=l_perc)
    if want == "spectral":
        assert seen == [("K4" if mel else "K3", (2, 201, T))]
    else:
        assert seen == [("K1" if mel else "K2", tuple(y.shape))]

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
from sm_hpss_mtl_tpu_torch.ops import mel as tmel
from sm_hpss_mtl_tpu_torch.utils.profiling import counters

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-5)


def _launches(*kernels):
    """The launch counters of ``kernels`` (``utils.profiling.counters()``)."""
    counts = counters()
    return tuple(counts.get(f"{k}.launches", 0) for k in kernels)


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
    before = _launches("stft_hpss_mel")
    h, p = tfe.stft_hpss_mel(y, M)
    assert _launches("stft_hpss_mel") == before
    assert h.shape == p.shape == (3, 1, 16, 23)
    h0, p0 = tfe.stft_hpss_mel_plain(y, M)
    torch.testing.assert_close(h, h0, rtol=0, atol=0)
    torch.testing.assert_close(p, p0, rtol=0, atol=0)
    # The JAX kernels' other modes take the same route: the plain version
    # of that mode (tests/test_torch_modes.py holds it to JAX).
    for kw in (dict(dft_precision="bf16x3"), dict(power=1.0),
               dict(dft_precision="bf16x3", power=1.5)):
        got = tfe.stft_hpss_mel(y, M, **kw)
        assert _launches("stft_hpss_mel") == before
        for g, w, w0 in zip(got, tfe.stft_hpss_mel_plain(y, M, **kw),
                            (h0, p0)):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
            assert not torch.equal(g, w0), kw
    with pytest.raises(ValueError, match="dft_precision"):
        tfe.stft_hpss_mel(y, M, dft_precision="high")


def test_kernel_median_networks_match_jax():
    # csrc/median.cuh, which frontend.cu includes, writes out the pruned
    # Batcher networks of ops/hpss_pallas.py::median_network; each must be
    # the same list.
    src = (tfe._nvcc.CSRC / "median.cuh").read_text()
    assert '#include "median.cuh"' in (tfe._nvcc.CSRC
                                       / "frontend.cu").read_text()
    for n in (5, 11, 21, 31, 41, 51):
        body = src.split(f"struct Median<{n}>")[1].split("return")[0]
        pairs = tuple((int(i), int(j))
                      for i, j in re.findall(r"CS\((\d+),(\d+)\)", body))
        assert pairs == hpss_pallas.median_network(n), n
    # KERNEL_MEDIANS: the pairs whose networks the header holds (and that
    # chip_smoke.py times per pair); any other pair's are generated.
    assert set(tfe.KERNEL_MEDIANS) == {
        (21, 11), (11, 5), (11, 11), (31, 11), (41, 11), (51, 11), (21, 21),
        (21, 31), (21, 41), (21, 51)}
    for pair in tfe.KERNEL_MEDIANS:
        assert tfe._nvcc.pair_networks(pair) == "", pair
    assert "struct Median<3>" in tfe._nvcc.pair_networks((3, 3))


def test_import_needs_no_nvcc(tmp_path):
    # The CPU test machines have no nvcc: importing the kernel module must
    # not build or look for it.
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path))
    code = ("import sm_hpss_mtl_tpu_torch.ops.frontend as f, "
            "sm_hpss_mtl_tpu_torch.ops.featuregram; "
            "assert f._nvcc.load.cache_info().currsize == 0")
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
    before = _launches("stft_hpss", "stft_hpss_mel")
    h, p = tfe.stft_hpss(y, n_fft=512)
    assert _launches("stft_hpss", "stft_hpss_mel") == before
    assert h.shape == p.shape == (3, 1, 257, 22)
    h0, p0 = tfe.stft_hpss_plain(y, n_fft=512)
    torch.testing.assert_close(h, h0, rtol=0, atol=0)
    torch.testing.assert_close(p, p0, rtol=0, atol=0)
    for kw in (dict(dft_precision="bf16x3"), dict(power=1.0)):
        got = tfe.stft_hpss(y, n_fft=512, **kw)
        assert _launches("stft_hpss", "stft_hpss_mel") == before
        for g, w, w0 in zip(got, tfe.stft_hpss_plain(y, n_fft=512, **kw),
                            (h0, p0)):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
            assert not torch.equal(g, w0), kw
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

    for name in ("hpss", "hpss_masks", "_launch", "_launch_masks"):
        monkeypatch.setattr(thpss, name, refuse)
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


def _fragment_matrices(n_fft, win_length=400):
    # Undo the layout of ops/frontend.py::dft_fragments by the PTX B
    # fragment of mma.m16n8k8 (.tf32): lane l holds b0 = B[k = l % 4,
    # n = l // 4] and b1 = B[k = l % 4 + 4, n = l // 4] of its 8 x 8 tile;
    # tile 2q is group q of the cos matrix, 2q + 1 of the sin matrix.
    # Returns {(part, half): (8*s_hi, 8*n_groups) float32}.
    frag = tfe.dft_fragments(n_fft, win_length)
    s_lo, s_hi = tfe.dft_steps(n_fft, win_length)
    n_groups = -(-(1 + n_fft // 2) // 8)
    assert frag.shape == (s_hi - s_lo, 2 * n_groups, 32, 4)
    lane = np.arange(32)
    k = 8 * np.arange(s_lo, s_hi)[:, None, None] + lane % 4
    n = 8 * np.arange(n_groups)[None, :, None] + lane // 4
    out = {}
    for part in (0, 1):
        f = frag[:, part::2]
        for half in (0, 1):
            m = np.zeros((8 * s_hi, 8 * n_groups), np.float32)
            m[k, n], m[k + 4, n] = f[..., 2 * half], f[..., 2 * half + 1]
            out[part, half] = m
    return out


def _folded_basis64(n_fft, width, win_length=400):
    # Rows n in [0, n_fft/2]: cos part c_n w_n cos(2 pi n k / N) with
    # c_{N/2} = 1/2, sin part -w_n sin(2 pi n k / N) for 0 < n < N/2; zero
    # past bin F - 1.  The angle is reduced exactly (n k mod n_fft).
    from sm_hpss_mtl_tpu.ops import reference as jref
    F, half = 1 + n_fft // 2, n_fft // 2
    w = jref.pad_center(jref.hann_window(win_length), n_fft)[:half + 1]
    ang = 2 * np.pi * (np.outer(np.arange(half + 1), np.arange(F))
                       % n_fft) / n_fft
    C, S = np.zeros((half + 1, width)), np.zeros((half + 1, width))
    C[:, :F] = np.cos(ang) * w[:, None]
    C[half] *= 0.5
    S[1:half, :F] = -np.sin(ang[1:half]) * w[1:half, None]
    return C, S


def _fold(frames, n_fft):
    # e_n = x_n + x_{N-n}, o_n = x_n - x_{N-n} for n in [0, N/2] (x_N, which
    # meets only zero basis rows, taken as 0), in the frames' dtype.
    half = n_fft // 2
    x = frames[..., :half + 1]
    z = np.concatenate([np.zeros_like(frames[..., :1]),
                        frames[..., :half - 1:-1]], axis=-1)
    return x + z, x - z


@pytest.mark.parametrize("n_fft", [400, 512])
def test_basis_halves_are_tf32_and_sum_to_the_f64_basis(n_fft):
    # The kernels' folded split-TF32 basis: both halves carry no mantissa
    # bits below TF32's 10, hi + lo is the float64 basis within 2^-21 of
    # each entry, the k-steps the kernels skip hold only exact zeros, and
    # the folded sums are the DFT.
    m = _fragment_matrices(n_fft)
    for half in m.values():
        assert not (half.view(np.uint32) & 0x1FFF).any()
    width = m[0, 0].shape[1]
    C, S = _folded_basis64(n_fft, width)
    s_lo, s_hi = tfe.dft_steps(n_fft, 400)
    assert 8 * s_hi > n_fft // 2 >= 8 * (s_hi - 1)
    for part, B in ((0, C), (1, S)):
        B = np.concatenate([B, np.zeros((8 * s_hi - len(B), width))])
        assert not B[:8 * s_lo].any()
        err = np.abs(m[part, 0].astype(np.float64) + m[part, 1] - B)
        assert (err <= 2.0 ** -21 * np.abs(B)).all(), (part, err.max())
        assert np.abs(m[part, 0] - B).max() > 1e-5   # lo carries real bits
    x = np.random.default_rng(10).standard_normal((3, n_fft))
    e, o = _fold(x, n_fft)
    F = 1 + n_fft // 2
    want = np.fft.rfft(x * tfe.ref.pad_center(tfe.ref.hann_window(400),
                                              n_fft))
    np.testing.assert_allclose(e @ C[:, :F], want.real, atol=1e-11)
    np.testing.assert_allclose(o @ S[:, :F], want.imag, atol=1e-11)


def _rna_tf32(x):
    # cvt.rna.tf32.f32: round float32 to 10 stored mantissa bits, ties away
    # from zero.
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split_tf32_mag(y, n_fft):
    # The kernels' DFT emulated on the CPU: frames folded in float32 and
    # split into TF32 halves as the kernel splits its A fragments, the
    # wrapper's basis halves, and lo*hi + hi*lo + hi*hi in float32 (lo*lo
    # dropped).
    m = _fragment_matrices(n_fft)
    T = 1 + (y.shape[-1] - n_fft) // 160
    idx = 160 * np.arange(T)[:, None] + np.arange(n_fft)
    e, o = _fold(y[..., idx].astype(np.float32), n_fft)
    F = 1 + n_fft // 2
    reim = []
    for part, a in ((0, e), (1, o)):
        a = np.concatenate([a, np.zeros(a.shape[:-1] + (
            len(m[part, 0]) - a.shape[-1],), np.float32)], axis=-1)
        a_hi = _rna_tf32(a)
        a_lo = _rna_tf32(a - a_hi)
        hi, lo = m[part, 0], m[part, 1]
        reim.append((a_lo @ hi + a_hi @ lo + a_hi @ hi)[..., :F])
    re, im = reim
    return np.swapaxes(np.sqrt(re * re + im * im), -1, -2)


def _toy_sine(n, seed):
    # A chord of pure sines with the -40 dB white-noise floor of the
    # evaluation tests (tests/test_torch_eval.py::_add_noise_floor).
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    x = sum(a * np.sin(2 * np.pi * f * t)
            for f, a in ((220.0, 0.5), (330.0, 0.3), (440.0, 0.2)))
    return (x + 1e-2 * rng.standard_normal(n)).astype(np.float32)[None]


@pytest.mark.parametrize("signal,n_fft,mel", [
    ("random", 400, True), ("sine", 400, True), ("random", 512, False),
    ("sine", 512, False)])
def test_split_tf32_dft_meets_the_kernel_bar(signal, n_fft, mel):
    # The split product alone, through the plain HPSS and the mel bank,
    # meets K1's (K2's) bar against the JAX oracle chain at
    # dft_precision='highest' semantics.
    n = n_fft + 97 * 160
    y = (np.random.default_rng(11).standard_normal((2, n)).astype(np.float32)
         if signal == "random" else _toy_sine(n, 12))
    kw = dict(n_fft=n_fft, win_length=400, hop_length=160, l_harm=21,
              l_perc=11, power=2.0)
    M = _mel(120, n_fft) if mel else None
    S = torch.from_numpy(_split_tf32_mag(y, n_fft))
    th, tp = tfe.hpss_plain(S, l_harm=21, l_perc=11)
    if mel:
        Mt = torch.from_numpy(M)
        th, tp = Mt @ th, Mt @ tp
    jh, jp = fp._oracle(jnp.asarray(y), None if M is None else jnp.asarray(M),
                        **kw)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)


def _sparse_basis():
    rng = np.random.default_rng(13)
    M = rng.random((20, 37)).astype(np.float32)
    M[rng.random(M.shape) < 0.8] = 0
    M[[0, 5, 19]] = 0                                    # empty rows
    M[7, [0, 36]] = 1.0                                  # both edges
    return M


@pytest.mark.parametrize("bank", [(22050, 400, 120), (22050, 512, 120),
                                  (16000, 400, 64), "sparse"])
def test_mel_band_ranges_cover_every_nonzero(bank):
    # K1 and K4 sum each band over [lo, hi) only: every nonzero lies inside,
    # an empty row gets [0, 0), and an in-order float32 sum over the range
    # equals the dense in-order sum bit for bit.
    M = _sparse_basis() if bank == "sparse" else _mel(bank[2], bank[1])
    if bank != "sparse":
        M = np.array(jmel.mel_filterbank(*bank), np.float32)
    r = tmel.mel_band_ranges(torch.from_numpy(M))
    assert r.dtype == torch.int32 and r.shape == (M.shape[0], 2)
    lo, hi = r[:, 0].numpy(), r[:, 1].numpy()
    k = np.arange(M.shape[1])
    inside = (k >= lo[:, None]) & (k < hi[:, None])
    assert not (M != 0)[~inside].any()
    empty = ~(M != 0).any(axis=1)
    assert (lo[empty] == 0).all() and (hi[empty] == 0).all()
    assert (M[~empty, lo[~empty]] != 0).all()
    assert (M[~empty, hi[~empty] - 1] != 0).all()
    h = np.random.default_rng(14).random(M.shape[1]).astype(np.float32)
    for m in range(M.shape[0]):
        dense = ranged = np.float32(0)
        for j in range(M.shape[1]):
            dense = np.float32(dense + M[m, j] * h[j])
        for j in range(lo[m], hi[m]):
            ranged = np.float32(ranged + M[m, j] * h[j])
        assert dense.tobytes() == ranged.tobytes(), m


def test_launch_refuses_geometry_the_kernel_does_not_tile():
    # A k-step of 8 samples must not cross a row of hop samples: n_fft and
    # hop must be multiples of 8, checked before anything is built.
    y = torch.zeros((1, 4000))
    kw = dict(win_length=400, l_harm=21, l_perc=11)
    with pytest.raises(ValueError, match="multiples of 8"):
        tfe.launch(y, None, n_fft=400, hop_length=100, **kw)
    with pytest.raises(ValueError, match="multiples of 8"):
        tfe.launch(y, None, n_fft=404, hop_length=160, **kw)
    # The fold about n_fft/2 needs a window centred symmetrically.
    with pytest.raises(ValueError, match="symmetric"):
        tfe.launch(y, None, n_fft=400, hop_length=160, win_length=399,
                   l_harm=21, l_perc=11)
    with pytest.raises(ValueError, match="symmetric"):
        tfe.dft_fragments(512, 399)
    assert tfe._nvcc.load.cache_info().currsize == 0


def test_plain_versions_run_in_float64_for_float64_audio():
    # chip_smoke.py measures the kernels against a float64 run of the plain
    # versions; float32 audio keeps the float32 chain.
    y = np.random.default_rng(15).standard_normal((1, 8000))
    M = torch.from_numpy(_mel(40, 400))
    h64, p64 = tfe.stft_hpss_mel_plain(torch.from_numpy(y), M)
    h32, p32 = tfe.stft_hpss_mel_plain(torch.from_numpy(y.astype(np.float32)),
                                       M)
    assert h64.dtype == p64.dtype == torch.float64
    assert h32.dtype == p32.dtype == torch.float32
    np.testing.assert_allclose(h32.numpy(), h64.numpy(), **TOL)
    np.testing.assert_allclose(p32.numpy(), p64.numpy(), **TOL)
    H, P = tfe.stft_hpss_plain(torch.from_numpy(y), n_fft=512)
    assert H.dtype == P.dtype == torch.float64


def test_band_ranges_are_kept_per_basis_tensor():
    # The wrappers of K1 and K4 scan a basis once while the tensor lives
    # unchanged; an in-place change or another tensor is scanned again.
    M = torch.from_numpy(_sparse_basis())
    r = tmel._band_ranges_of(M)
    assert tmel._band_ranges_of(M) is r
    assert tfe._band_ranges_of is tmel._band_ranges_of
    M[0, 3] = 1.0
    r2 = tmel._band_ranges_of(M)
    assert r2 is not r and r2[0].tolist() == [3, 4]
    assert torch.equal(r2, tmel.mel_band_ranges(M))
    key = id(M)
    del M
    assert key not in tmel._BANDS


@pytest.mark.parametrize("l_harm,l_perc,n_samples,mel", [
    (51, 11, 16_000, True),    # T=98: K1 at the widest harmonic median
    (21, 51, 16_000, True),    # the widest percussive median
    (51, 11, 11_120, False),   # K2, the training crop's 68 frames
    (21, 51, 11_120, False),
])
def test_plain_matches_pallas_interpret_at_the_tuners_widths(
        l_harm, l_perc, n_samples, mel):
    # The tuner's widest median pairs (cli/tune.py::GRID_RANGES), which
    # K1 and K2 are built for: the plain versions against the Pallas
    # kernel in interpret mode.
    rng = np.random.default_rng(n_samples + l_harm + l_perc)
    y = rng.standard_normal((1, n_samples)).astype(np.float32)
    kw = dict(n_fft=400, win_length=400, hop_length=160, l_harm=l_harm,
              l_perc=l_perc, power=2.0)
    if mel:
        M = _mel(32, 400)
        jh, jp = fp._frontend_pallas(jnp.asarray(y), jnp.asarray(M).T,
                                     tile_t=64, dft_precision="highest",
                                     interpret=True, **kw)
        th, tp = tfe.stft_hpss_mel_plain(torch.from_numpy(y),
                                         torch.from_numpy(M), **kw)
    else:
        jh, jp = fp.stft_hpss(jnp.asarray(y), tile_t=64,
                              dft_precision="highest", interpret=True, **kw)
        th, tp = tfe.stft_hpss_plain(torch.from_numpy(y), **kw)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)


@pytest.mark.parametrize("l_harm,l_perc,T", [(51, 11, 1), (51, 11, 30),
                                             (51, 11, 49), (21, 51, 7)])
def test_plain_matches_oracle_short_clips_at_the_tuners_widths(l_harm,
                                                               l_perc, T):
    # Clips under 2*(l_harm//2) frames at the wide pairs: under 50 frames
    # at l_harm 51, where the front end takes the short-clip route (K4).
    rng = np.random.default_rng(T + l_harm)
    y = rng.standard_normal((2, 400 + (T - 1) * 160)).astype(np.float32)
    M = _mel(40, 400)
    kw = dict(n_fft=400, win_length=400, hop_length=160, l_harm=l_harm,
              l_perc=l_perc, power=2.0)
    jh, jp = fp._oracle(jnp.asarray(y), jnp.asarray(M), **kw)
    th, tp = tfe.stft_hpss_mel_plain(torch.from_numpy(y),
                                     torch.from_numpy(M), **kw)
    assert th.shape == (2, 40, T)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)

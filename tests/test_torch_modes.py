"""The front end's modes beyond the port's defaults: the bf16x3 DFT (the JAX
package's default ``dft_precision``), any mask ``power``, any odd median
pair of widths 3 to 61.

The plain versions of K1-K4 are held to the JAX Pallas kernels in interpret
mode, at the JAX tests' tolerances where the two compute the same thing:
rtol 2e-4, atol 2e-5 for K1/K2 (``tests/test_frontend_pallas.py``) and 1e-5,
1e-6 for K3/K4 (``tests/test_hpss_pallas.py``).  The CUDA kernels are held
to these plain versions on the card by ``chip_smoke.py`` (``phase_modes``).

bf16x3 is not the same computation on both sides: the JAX kernel rounds
the raw samples to bf16 halves, the port (``csrc/frontend.cu``) rounds the
frame folded about ``n_fft/2`` (``e_n = x_n + x_{N-n}``), so the two carry
independent rounding errors of the same size.  So the port's bf16x3 is held
to be of JAX's accuracy class: its RMS error against JAX's ``'highest'``
is within 0.5-1.25 of JAX's own bf16x3 error (it reads 0.95-1.01; below
0.5 it would not be bf16x3 at all), its largest difference from JAX's
bf16x3 within twice JAX's own largest bf16x3 error (each lies within one
bf16x3 error of the exact DFT; it reads up to 1.6 of it).  In features
(``power_to_db`` at 80 dB): the mean |dB| difference from JAX's bf16x3
within twice JAX's own bf16x3-vs-'highest' mean (it reads 1.16-1.31), and
K1's mel features within 0.02 dB of JAX's at every bin, the DFT precision
policy's bar (``BASELINE.md``; they read under 5e-4 dB).  K2's
full-resolution maxima sit at the quietest bins, where the dB error of an
absolute error of the same size is largest: JAX's own bf16x3 reads up to
0.084 dB there against its 'highest', so no 0.02 dB bar holds for either
side, and K2 is held on the mean.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sm_hpss_mtl_tpu.ops import frontend_pallas as fp
from sm_hpss_mtl_tpu.ops import hpss_pallas
from sm_hpss_mtl_tpu.ops import mel as jmel
from sm_hpss_mtl_tpu_torch.ops import _nvcc
from sm_hpss_mtl_tpu_torch.ops import featuregram as tfg
from sm_hpss_mtl_tpu_torch.ops import frontend as tfe
from sm_hpss_mtl_tpu_torch.ops import hpss as thpss
from sm_hpss_mtl_tpu_torch.ops import median_networks as mnet
from sm_hpss_mtl_tpu_torch.ops import mel as tmel

torch.set_num_threads(2)

K12_TOL = dict(rtol=2e-4, atol=2e-5)
K34_TOL = dict(rtol=1e-5, atol=1e-6)
FEATURE_DB = 0.02


def _mel(n_mels, n_fft=400):
    return np.array(jmel.mel_filterbank(22050, n_fft, n_mels), np.float32)


def _shard_audio(y, j, n, T_local, ht, hop=160, n_fft=400):
    """Shard ``j`` of ``n`` with its halos, as the sharded front end hands
    it to the kernel (zeros past either end)."""
    a = (j * T_local - ht) * hop
    b = ((j + 1) * T_local + ht - 1) * hop + n_fft
    seg = np.zeros((y.shape[0], b - a), np.float32)
    lo, hi = max(a, 0), min(b, y.shape[1])
    seg[:, lo - a:hi - a] = y[:, lo:hi]
    return seg


def _db(x):
    return tmel.power_to_db(torch.from_numpy(np.array(x)) ** 2,
                            top_db=80.0).numpy()


def _rms(a, b):
    return float(np.sqrt(np.mean((np.asarray(a, np.float64)
                                  - np.asarray(b, np.float64)) ** 2)))


# --- bf16x3 -----------------------------------------------------------------

@pytest.mark.parametrize("n_fft", [400, 512])
@pytest.mark.parametrize("mel", [True, False], ids=["K1", "K2"])
@pytest.mark.parametrize("flags", [None, (1, 0), (0, 0), (0, 1)],
                         ids=["whole", "halo10", "halo00", "halo01"])
def test_bf16x3_plain_is_of_jax_bf16x3_accuracy(n_fft, mel, flags):
    rng = np.random.default_rng(n_fft + 3 * mel + (flags or (2, 2))[0])
    kw = dict(n_fft=n_fft, win_length=400, hop_length=160, l_harm=21,
              l_perc=11, power=2.0)
    if flags is None:
        y = rng.standard_normal((2, n_fft + 97 * 160)).astype(np.float32)
        halo = {}
        jhalo = {}
    else:
        n, T_local = 4, 24
        j = {(1, 0): 0, (0, 0): 1, (0, 1): 3}[flags]
        whole = rng.standard_normal((2, n_fft + (n * T_local - 1) * 160))
        y = _shard_audio(whole.astype(np.float32), j, n, T_local, 10,
                         n_fft=n_fft)
        halo = dict(halo_in_audio=True, edge_flags=flags)
        jhalo = dict(halo_in_audio=True,
                     edge_flags=jnp.asarray([flags], jnp.int32))
    M = _mel(32, n_fft) if mel else None
    jax_out = {
        prec: fp._frontend_pallas(
            jnp.asarray(y), None if M is None else jnp.asarray(M).T,
            tile_t=24 if flags else 64, dft_precision=prec, interpret=True,
            **jhalo, **kw)
        for prec in ("bf16x3", "highest")}
    # JAX's CPU runtime finishes before torch computes: no thread pools of
    # the two libraries run side by side in this process.
    jax.block_until_ready(jax_out)
    yt = torch.from_numpy(y)
    port = (tfe.stft_hpss_mel_plain(yt, torch.from_numpy(M),
                                    dft_precision="bf16x3", **halo, **kw)
            if mel else tfe.stft_hpss_plain(yt, dft_precision="bf16x3",
                                            **halo, **kw))
    for c in range(2):
        p = port[c].numpy()
        jb = np.asarray(jax_out["bf16x3"][c])
        jh = np.asarray(jax_out["highest"][c])
        assert p.shape == jb.shape
        own = _rms(jb, jh)
        assert 0.5 * own <= _rms(p, jh) <= 1.25 * own, (_rms(p, jh), own)
        assert np.abs(p - jb).max() <= 2 * np.abs(jb - jh).max()
        d_db = np.abs(_db(p) - _db(jb))
        own_db = np.abs(_db(jb) - _db(jh))
        assert d_db.mean() <= 2 * own_db.mean(), (d_db.mean(), own_db.mean())
        if mel:
            assert d_db.max() <= FEATURE_DB, d_db.max()


def _bf16(x):
    """float32 -> bfloat16 -> float32, round to nearest even, in numpy."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    b = (b + np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return b.view(np.float32)


def _bf16_fragment_matrices(n_fft, win_length=400):
    # Undo ops/frontend.py::dft_fragments(..., 'bf16x3') by the PTX B
    # fragment of mma.m16n8k16 (.bf16): lane l holds b0 = B[k = 2(l % 4),
    # 2(l % 4) + 1; n = l // 4] and b1 = the same rows + 8 of its 16 x 8
    # tile, element k in the low half; tile 2q is group q of the cos
    # matrix, 2q + 1 of the sin matrix.  Returns {(part, half): float32}.
    frag = tfe.dft_fragments(n_fft, win_length, "bf16x3").view(np.uint32)
    s_lo, s_hi = tfe.dft_steps(n_fft, win_length, "bf16x3")
    n_groups = -(-(1 + n_fft // 2) // 8)
    assert frag.shape == (s_hi - s_lo, 2 * n_groups, 32, 4)
    lane = np.arange(32)
    k = 16 * np.arange(s_lo, s_hi)[:, None, None] + 2 * (lane % 4)
    n = 8 * np.arange(n_groups)[None, :, None] + lane // 4
    out = {}
    for part in (0, 1):
        f = frag[:, part::2]
        for half in (0, 1):
            m = np.zeros((16 * s_hi, 8 * n_groups), np.uint32)
            for w, rows in ((0, k), (1, k + 8)):
                word = f[..., 2 * half + w]
                m[rows, n] = word << np.uint32(16)
                m[rows + 1, n] = word & np.uint32(0xFFFF0000)
            out[part, half] = m.view(np.float32)
    return out


@pytest.mark.parametrize("n_fft,win_length", [(400, 400), (512, 400),
                                              (512, 512)])
def test_bf16_fragments_rebuild_the_f64_basis(n_fft, win_length):
    # hi and lo are bf16 values whose sum is the float64 folded basis to
    # bf16x2 accuracy (2^-16 of each entry, the residual of two roundings
    # to 8 significant bits), the k-steps skipped before the window and
    # every row past n_fft/2 hold exact zeros, and the halves are those
    # the plain version multiplies by.
    m = _bf16_fragment_matrices(n_fft, win_length)
    s_lo, s_hi = tfe.dft_steps(n_fft, win_length, "bf16x3")
    assert 16 * s_hi > n_fft // 2 >= 16 * (s_hi - 1)
    half = n_fft // 2
    width = m[0, 0].shape[1]
    C, S = tfe._folded_basis(n_fft, win_length, 16 * s_hi)
    plain = tfe._bf16_halves(n_fft, win_length)
    F = 1 + half
    for part, B in ((0, C), (1, S)):
        hi, lo = m[part, 0], m[part, 1]
        for h in (hi, lo):
            assert not (h.view(np.uint32) & 0xFFFF).any()
        assert not B[:16 * s_lo].any() and not B[half + 1:].any()
        assert not hi[half + 1:].any() and not lo[half + 1:].any()
        err = np.abs(hi.astype(np.float64) + lo - B[:, :width])
        assert (err <= 2.0 ** -16 * np.abs(B)).all(), err.max()
        assert np.abs(lo).max() > 0
        np.testing.assert_array_equal(hi[16 * s_lo:half + 1, :F],
                                      plain[2 * part][16 * s_lo:])
        np.testing.assert_array_equal(lo[16 * s_lo:half + 1, :F],
                                      plain[2 * part + 1][16 * s_lo:])


@pytest.mark.parametrize("n_fft", [400, 512])
def test_bf16x3_plain_magnitude_is_the_fragment_product(n_fft):
    # The kernel's arithmetic emulated in numpy from the fragments it reads:
    # frames folded in float32, split into bf16 halves (round to nearest
    # even, as cvt.rn.bf16x2.f32), lo*hi + hi*lo + hi*hi in float32.
    # stft_mag_bf16x3 computes the same products; only the order of the
    # float32 sums differs.
    y = np.random.default_rng(20).standard_normal((2, n_fft + 40 * 160))
    y = y.astype(np.float32)
    m = _bf16_fragment_matrices(n_fft)
    T = 1 + (y.shape[-1] - n_fft) // 160
    frames = y[..., 160 * np.arange(T)[:, None] + np.arange(n_fft)]
    half = n_fft // 2
    z = np.concatenate([np.zeros_like(frames[..., :1]),
                        frames[..., :half - 1:-1]], axis=-1)
    x = frames[..., :half + 1]
    reim = []
    for part, a in ((0, x + z), (1, x - z)):
        a_hi = _bf16(a)
        a_lo = _bf16(a - a_hi)
        hi, lo = m[part, 0][:half + 1], m[part, 1][:half + 1]
        reim.append((a_lo @ hi + a_hi @ lo + a_hi @ hi)[..., :half + 1])
    want = np.swapaxes(np.sqrt(reim[0] ** 2 + reim[1] ** 2), -1, -2)
    got = tfe.stft_mag_bf16x3(torch.from_numpy(y), n_fft=n_fft,
                              win_length=400, hop_length=160)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_cpu_route_takes_the_cuda_routes_precision():
    # The CUDA route sends clips under 2*(l_harm//2) frames to the float32
    # stft_mag and K4/K3 whatever the precision (frontend_pallas._dispatch);
    # the CPU route takes the same precision per length, so bf16x3 reaches
    # long clips only.
    M = torch.from_numpy(_mel(24))
    rng = np.random.default_rng(21)
    for T, want in ((19, "highest"), (20, "bf16x3"), (60, "bf16x3")):
        y = torch.from_numpy(rng.standard_normal(
            (1, 400 + (T - 1) * 160)).astype(np.float32))
        for fn, plain, args in (
                (tfe.stft_hpss_mel, tfe.stft_hpss_mel_plain, (M,)),
                (tfe.stft_hpss, tfe.stft_hpss_plain, ())):
            got = fn(y, *args, dft_precision="bf16x3")
            exp = plain(y, *args, dft_precision=want)
            for g, w in zip(got, exp):
                torch.testing.assert_close(g, w, rtol=0, atol=0)
    # Halo mode is never a short clip.
    y = torch.from_numpy(rng.standard_normal((1, 400 + 29 * 160)).astype(
        np.float32))
    for g, w in zip(tfe.stft_hpss_mel(y, M, dft_precision="bf16x3",
                                      halo_in_audio=True, edge_flags=(0, 0)),
                    tfe.stft_hpss_mel_plain(y, M, dft_precision="bf16x3",
                                            halo_in_audio=True,
                                            edge_flags=(0, 0))):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("T,route", [(13, "short"), (40, "fused")])
@pytest.mark.parametrize("mel", [True, False])
def test_cuda_route_passes_the_modes(monkeypatch, T, route, mel):
    # With the launchers replaced by spies: K1/K2 get the precision and the
    # power; K4/K3 (short clips) get the power.
    seen = []
    monkeypatch.setattr(thpss, "hpss_mel", lambda S, M, **kw: seen.append(
        ("K4", kw)) or (S, S))
    monkeypatch.setattr(thpss, "hpss", lambda S, **kw: seen.append(
        ("K3", kw)) or (S, S))
    monkeypatch.setattr(tfe, "launch", lambda y, M, **kw: seen.append(
        ("K1" if M is not None else "K2", kw)))
    y = torch.zeros((1, 400 + (T - 1) * 160))
    M = torch.from_numpy(_mel(16)) if mel else None
    tfe._dispatch(y, M, n_fft=400, win_length=400, hop_length=160,
                  l_harm=15, l_perc=7, power=1.5, dft_precision="bf16x3")
    (name, kw), = seen
    if route == "short":
        assert name == ("K4" if mel else "K3")
        assert kw == dict(l_harm=15, l_perc=7, power=1.5)
    else:
        assert name == ("K1" if mel else "K2")
        assert kw["power"] == 1.5 and kw["dft_precision"] == "bf16x3"


def test_frontend_time_sharded_at_bf16x3_matches_unsharded():
    # Halo mode at bf16x3 through the sharded front end on a mesh of the
    # CPU: every frame's DFT is the same product, so the shards equal the
    # whole signal's plain bf16x3 run.
    from sm_hpss_mtl_tpu_torch import parallel as tpar
    y = np.random.default_rng(22).standard_normal((2, 400 + 95 * 160))
    y = torch.from_numpy(y.astype(np.float32))
    mesh = tpar.make_mesh(n_data=1, n_time=4,
                          devices=[torch.device("cpu")] * 4)
    M = torch.from_numpy(_mel(24))
    got = tpar.stft_hpss_mel_time_sharded(y, M, mesh, dft_precision="bf16x3")
    want = tfe.stft_hpss_mel_plain(y, M, dft_precision="bf16x3")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-6)


def test_featuregram_slabbed_takes_the_precision():
    y = torch.from_numpy(np.random.default_rng(23).standard_normal(
        400 + 299 * 160).astype(np.float32))
    kw = dict(feat_name="LogMelHarmPercSpec", n_mels=24,
              dft_precision="bf16x3")
    whole = tfg.featuregram(y, **kw)
    slabbed = tfg.featuregram_slabbed(y, slab_frames=100, **kw)
    np.testing.assert_allclose(slabbed.numpy(), whole.numpy(), atol=1e-4)
    highest = tfg.featuregram_slabbed(y, slab_frames=100,
                                      feat_name="LogMelHarmPercSpec",
                                      n_mels=24)
    assert np.abs(slabbed.numpy() - highest.numpy()).max() > 0


def test_precision_names_its_library_and_power_is_an_argument():
    # One library per pair and precision; the mask power is a kernel
    # argument (a float before the stream in every entry point), so it
    # names no library and takes no define.
    paths = {prec: _nvcc.library_path("frontend.cu", (21, 11), prec)
             for prec in ("highest", "bf16x3")}
    assert len(set(paths.values())) == 2
    assert "_bf16x3_" in paths["bf16x3"].name
    assert _nvcc.precision_defines("frontend.cu") == []
    assert _nvcc.precision_defines("frontend.cu", "bf16x3") == [
        "-DHPSS_BF16X3=1"]
    with pytest.raises(ValueError, match="no DFT"):
        _nvcc.library_path("hpss.cu", (21, 11), "bf16x3")
    with pytest.raises(ValueError, match="dft_precision"):
        _nvcc.precision_defines("frontend.cu", "bf16")
    for source, fn in (("frontend.cu", "k1_stft_hpss_mel"),
                       ("frontend.cu", "k2_stft_hpss"),
                       ("hpss.cu", "k3_hpss"), ("hpss.cu", "k4_hpss_mel")):
        sig = re.search(rf"\bint {fn}\((.*?)\)\s*\{{",
                        (_nvcc.CSRC / source).read_text(), re.S).group(1)
        assert [a.split()[-1] for a in sig.split(",")][-2:] == [
            "power", "stream"], fn
    assert "HPSS_POWER" not in "".join(
        (_nvcc.CSRC / f).read_text() for f in ("frontend.cu", "hpss.cu",
                                               "median.cuh"))


# --- any power ----------------------------------------------------------------

@pytest.mark.parametrize("power", [1.0, 1.5, 3.0])
@pytest.mark.parametrize("mel", [True, False], ids=["K1", "K2"])
def test_power_k1_k2_plain_match_pallas_interpret(power, mel):
    rng = np.random.default_rng(int(10 * power) + mel)
    y = rng.standard_normal((2, 16_000)).astype(np.float32)
    kw = dict(n_fft=400, win_length=400, hop_length=160, l_harm=21,
              l_perc=11, power=power)
    M = _mel(32) if mel else None
    jh, jp = fp._frontend_pallas(jnp.asarray(y),
                                 None if M is None else jnp.asarray(M).T,
                                 tile_t=48, dft_precision="highest",
                                 interpret=True, **kw)
    yt = torch.from_numpy(y)
    th, tp = (tfe.stft_hpss_mel_plain(yt, torch.from_numpy(M), **kw) if mel
              else tfe.stft_hpss_plain(yt, **kw))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **K12_TOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **K12_TOL)
    square = (tfe.stft_hpss_plain(yt, **dict(kw, power=2.0)) if not mel
              else tfe.stft_hpss_mel_plain(yt, torch.from_numpy(M),
                                           **dict(kw, power=2.0)))
    assert not torch.equal(th, square[0])


@pytest.mark.parametrize("power", [1.0, 1.5, 3.0])
@pytest.mark.parametrize("mask_only", [False, True])
def test_power_k3_plain_matches_pallas_interpret(power, mask_only):
    S = np.abs(np.random.default_rng(int(power * 4)).standard_normal(
        (2, 33, 70))).astype(np.float32)
    jfn = hpss_pallas.hpss_masks if mask_only else hpss_pallas.hpss
    tfn = thpss.hpss_masks_plain if mask_only else thpss.hpss_plain
    jh, jp = jfn(jnp.asarray(S), l_harm=21, l_perc=11, power=power,
                 tile_t=32, interpret=True)
    th, tp = tfn(torch.from_numpy(S), l_harm=21, l_perc=11, power=power)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **K34_TOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **K34_TOL)


@pytest.mark.parametrize("power", [1.0, 1.5, 3.0])
def test_power_k4_plain_matches_pallas_interpret(power):
    S = np.abs(np.random.default_rng(int(power * 5)).standard_normal(
        (2, 201, 13))).astype(np.float32)
    M = _mel(40)
    jh, jp = hpss_pallas.hpss_mel(jnp.asarray(S), M, l_harm=21, l_perc=11,
                                  power=power, interpret=True)
    th, tp = thpss.hpss_mel_plain(torch.from_numpy(S), torch.from_numpy(M),
                                  l_harm=21, l_perc=11, power=power)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **K34_TOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **K34_TOL)


# --- any odd median pair --------------------------------------------------------

def _header():
    return (_nvcc.CSRC / "median.cuh").read_text()


def _struct(text, head):
    """The text of ``template <>\\nstruct <head> {...};`` in ``text``."""
    start = text.index(f"template <>\nstruct {head} {{")
    return text[start:text.index("\n};\n", start) + 4]


@pytest.mark.parametrize("pair", thpss.KERNEL_MEDIANS)
def test_generator_writes_the_header_networks(pair):
    # The package's generator, run for the ten pairs, writes the very
    # structs median.cuh holds, so the header has nothing left to add.
    lh, lp = pair
    text = _header()
    singles, cores, merges = mnet.pair_needs(lh, lp)
    for n in singles:
        assert _struct(text, f"Median<{n}>") == mnet.median_struct(n)
    for w, k in cores:
        assert (_struct(text, f"MedianCore<{w}, {k}>")
                == mnet.core_struct(w, k))
    for k in merges:
        assert _struct(text, f"MedianMerge<{k}>") == mnet.merge_struct(k)
    assert mnet.pair_networks(lh, lp, text) == ""
    assert mnet.median_network(lh) == hpss_pallas.median_network(lh)


def _apply(pairs, wires):
    v = list(wires)
    for i, j in pairs:
        v[i], v[j] = np.minimum(v[i], v[j]), np.maximum(v[i], v[j])
    return v


def _running(w, k, x):
    """``hpss_median::running_medians<w, k>`` from the generated networks:
    out[j] = median of x[j .. j+w-1] for j < k."""
    if not mnet.shares_core(w, k):
        return [_apply(mnet.median_network(w), x[j:j + w])[w // 2]
                for j in range(k)]
    first = (w - 1) // 2 - k + 1
    core = _apply(mnet.core_network(w, k), x[k - 1:w])
    return [_apply(mnet.merge_network(k), core[first:first + k] + x[j:k - 1]
                   + x[w:w + j])[k - 1] for j in range(k)]


@pytest.mark.parametrize("w", range(mnet.MIN_WIDTH, mnet.MAX_WIDTH + 1, 2))
def test_networks_select_the_median_at_every_width(w):
    # Median<w> and the shared-core networks at K = 4 (frames) and 2 (bins),
    # over random columns and columns of few distinct values (ties).
    rng = np.random.default_rng(w)
    for x in (rng.standard_normal((w + 3, 3000)),
              rng.integers(0, 3, (w + 3, 3000)).astype(np.float64)):
        wires = [x[i] for i in range(w + 3)]
        np.testing.assert_array_equal(
            _apply(mnet.median_network(w), wires[:w])[w // 2],
            np.median(x[:w], axis=0))
        for k in (mnet.QT, mnet.QF):
            for j, got in enumerate(_running(w, k, wires[:w + k - 1])):
                np.testing.assert_array_equal(
                    got, np.median(x[j:j + w], axis=0), err_msg=f"{w},{k}")


def test_unit_widths_match_hpss_cu():
    # The generator's K per width is hpss.cu's unit: QT frames, QF bins.
    import re
    src = (_nvcc.CSRC / "hpss.cu").read_text()
    assert (mnet.QT, mnet.QF) == tuple(
        int(re.search(rf"constexpr int {q} = (\d+);", src).group(1))
        for q in ("QT", "QF"))


@pytest.mark.parametrize("pair", [(3, 3), (15, 7), (61, 61), (5, 61)])
def test_pairs_outside_the_header_get_generated_networks(pair):
    text = mnet.pair_networks(*pair, _header())
    singles, cores, merges = mnet.pair_needs(*pair)
    have = mnet.header_specialisations(_header())
    assert set(mnet.header_specialisations(text)[0]) == singles - have[0]
    assert set(mnet.header_specialisations(text)[1]) == cores - have[1]
    assert text.count("struct ") == len(singles - have[0]) + len(
        cores - have[1]) + len(merges - have[2])
    # Narrow harmonic windows have no shared core of QT frames.
    assert mnet.shares_core(pair[0], mnet.QT) == (pair[0] >= 7)


@pytest.mark.parametrize("l_harm,l_perc,match", [
    (63, 11, "3 to 61"), (21, 1, "3 to 61"), (20, 11, "odd"),
    (21, 10, "odd")])
def test_pairs_outside_the_range_are_refused_before_a_build(l_harm, l_perc,
                                                           match):
    y = torch.zeros((1, 400 + 99 * 160))
    S = torch.zeros((1, 201, 30))
    with pytest.raises(ValueError, match=match):
        tfe.launch(y, None, n_fft=400, win_length=400, hop_length=160,
                   l_harm=l_harm, l_perc=l_perc)
    with pytest.raises(ValueError, match=match):
        thpss._launch(S, l_harm=l_harm, l_perc=l_perc, mask_only=True)
    with pytest.raises(ValueError, match=match):
        _nvcc.build("hpss.cu", (l_harm, l_perc))
    assert _nvcc.load.cache_info().currsize == 0


@pytest.mark.parametrize("l_harm,l_perc", [(3, 3), (15, 7), (61, 61)])
def test_plain_versions_match_pallas_at_pairs_outside_the_header(l_harm,
                                                                  l_perc):
    # K1 (mel) and K3 at pairs the header does not hold: the plain versions
    # against the Pallas kernels in interpret mode (any pair's networks are
    # traced there).  l_harm 61 at 2*30 + 10 frames.
    T = 2 * (l_harm // 2) + 10
    rng = np.random.default_rng(l_harm * 100 + l_perc)
    y = rng.standard_normal((1, 400 + (T - 1) * 160)).astype(np.float32)
    kw = dict(n_fft=400, win_length=400, hop_length=160, l_harm=l_harm,
              l_perc=l_perc, power=2.0)
    M = _mel(24)
    jh, jp = fp._frontend_pallas(jnp.asarray(y), jnp.asarray(M).T,
                                 tile_t=32, dft_precision="highest",
                                 interpret=True, **kw)
    th, tp = tfe.stft_hpss_mel_plain(torch.from_numpy(y),
                                     torch.from_numpy(M), **kw)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **K12_TOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **K12_TOL)
    S = np.abs(rng.standard_normal((1, 40, T))).astype(np.float32)
    jh, jp = hpss_pallas.hpss(jnp.asarray(S), l_harm=l_harm, l_perc=l_perc,
                              tile_t=32, interpret=True)
    th, tp = thpss.hpss_plain(torch.from_numpy(S), l_harm=l_harm,
                              l_perc=l_perc)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **K34_TOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **K34_TOL)

"""K3 port: the plain ``hpss`` and ``hpss_masks`` against the JAX kernel.

The JAX side is ``ops/hpss_pallas.py``'s Pallas kernel in interpret mode,
at the geometries of ``tests/test_hpss_pallas.py``; tolerance rtol 1e-5,
atol 1e-6, as that file holds the kernel to the numpy golden.  The CUDA
kernel itself is held to the plain versions on the card by
``chip_smoke.py``.
"""

import importlib.util
import re
from collections import Counter

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sm_hpss_mtl_tpu.ops import hpss_pallas
from sm_hpss_mtl_tpu_torch.ops import _nvcc
from sm_hpss_mtl_tpu_torch.ops import hpss as thpss
from sm_hpss_mtl_tpu_torch.utils.profiling import counters

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)


def _launches(*kernels):
    """The launch counters of ``kernels`` (``utils.profiling.counters()``)."""
    counts = counters()
    return tuple(counts.get(f"{k}.launches", 0) for k in kernels)


def _mags(shape, seed):
    rng = np.random.default_rng(seed)
    return np.abs(rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("shape,l_harm,l_perc,tile_t,mask_only", [
    ((2, 31, 70), 7, 5, 32, False),      # interpret parity, small
    ((1, 17, 150), 21, 11, 48, True),    # several tiles, ragged last tile
    ((1, 17, 150), 21, 11, 48, False),
    ((2, 201, 19), 21, 11, 364, True),   # T < l_harm: time pad repeats
    ((2, 9, 40), 5, 3, 32, False),       # dispatch-shape geometry
])
def test_plain_matches_pallas_interpret(shape, l_harm, l_perc, tile_t,
                                        mask_only):
    S = _mags(shape, sum(shape) + l_harm)
    jfn = hpss_pallas.hpss_masks if mask_only else hpss_pallas.hpss
    tfn = thpss.hpss_masks_plain if mask_only else thpss.hpss_plain
    jh, jp = jfn(jnp.asarray(S), l_harm=l_harm, l_perc=l_perc,
                 tile_t=tile_t, interpret=True)
    th, tp = tfn(torch.from_numpy(S), l_harm=l_harm, l_perc=l_perc)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)


def test_plain_keeps_leading_axes():
    S = _mags((2, 3, 9, 40), 4)
    H4, P4 = thpss.hpss_plain(torch.from_numpy(S), l_harm=5, l_perc=3)
    assert H4.shape == P4.shape == S.shape
    H0, _ = thpss.hpss_plain(torch.from_numpy(S[1, 2]), l_harm=5, l_perc=3)
    torch.testing.assert_close(H4[1, 2], H0, rtol=0, atol=1e-6)
    jh, _ = hpss_pallas.hpss(jnp.asarray(S), l_harm=5, l_perc=3,
                             interpret=True, tile_t=32)
    np.testing.assert_allclose(H4.numpy(), np.asarray(jh), **TOL)


@pytest.mark.parametrize("mask_only", [False, True])
def test_wrappers_send_cpu_tensors_to_plain_versions(mask_only):
    S = torch.from_numpy(_mags((2, 21, 33), 9))
    fn = thpss.hpss_masks if mask_only else thpss.hpss
    plain = thpss.hpss_masks_plain if mask_only else thpss.hpss_plain
    before = _launches("hpss", "hpss_masks")
    got = fn(S)
    assert _launches("hpss", "hpss_masks") == before
    for g, w in zip(got, plain(S)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    with pytest.raises(ValueError, match="unsupported device"):
        fn(S.to("meta"))


def test_masks_sum_to_one_and_zero_where_silent():
    S = _mags((1, 30, 50), 11)
    S[0, 5:20] = 0.0        # silent band: both medians 0 in rows 10..14
    mh, mp = thpss.hpss_masks_plain(torch.from_numpy(S))
    silent = (mh == 0) & (mp == 0)
    assert silent[0, 10:15].all()
    total = (mh + mp)[~silent]
    torch.testing.assert_close(total, torch.ones_like(total), rtol=0,
                               atol=1e-6)


def _header_networks(src):
    nets = {}
    for n, body in re.findall(r"struct Median<(\d+)>\s*\{(.*?)return",
                              src, re.S):
        nets[int(n)] = tuple((int(i), int(j)) for i, j in
                             re.findall(r"CS\((\d+),(\d+)\)", body))
    return nets


def test_median_header_networks_select_the_median():
    # Each network of csrc/median.cuh, run on random columns, gives
    # np.median, and is hpss_pallas.median_network's list.
    nets = _header_networks((_nvcc.CSRC / "median.cuh").read_text())
    assert set(nets) == {5, 11, 21, 31, 41, 51}
    rng = np.random.default_rng(21)
    for n, pairs in nets.items():
        assert pairs == hpss_pallas.median_network(n), n
        x = rng.standard_normal((2000, n))
        v = [x[:, i].copy() for i in range(n)]
        for i, j in pairs:
            v[i], v[j] = np.minimum(v[i], v[j]), np.maximum(v[i], v[j])
        np.testing.assert_array_equal(v[n // 2], np.median(x, axis=1))


def test_kernels_share_the_median_header():
    # K1/K2 and K3 take their networks from the one header; neither
    # source writes a network of its own.
    for source in ("frontend.cu", "hpss.cu"):
        src = (_nvcc.CSRC / source).read_text()
        assert '#include "median.cuh"' in src, source
        assert "struct Median<" not in src, source
        assert _nvcc.CSRC / "median.cuh" in _nvcc._sources(source)
    # The pairs the header holds; every other pair's networks come from
    # ops/median_networks.py at its build, into a header of its own.
    assert set(thpss.KERNEL_MEDIANS) == {
        (21, 11), (11, 5), (11, 11), (31, 11), (41, 11), (51, 11), (21, 21),
        (21, 31), (21, 41), (21, 51)}
    assert all(_nvcc.pair_networks(p) == "" for p in thpss.KERNEL_MEDIANS)
    src = (_nvcc.CSRC / "median.cuh").read_text()
    assert "#include HPSS_PAIR_NETWORKS" in src


def test_library_path_follows_the_header(tmp_path, monkeypatch):
    # An edited header must rename the library, or a stale build loads.
    for name in ("hpss.cu", "median.cuh"):
        (tmp_path / name).write_bytes((_nvcc.CSRC / name).read_bytes())
    monkeypatch.setattr(_nvcc, "CSRC", tmp_path)
    before = _nvcc.library_path("hpss.cu", (21, 11))
    assert before.name.startswith("libhpss_")
    with open(tmp_path / "median.cuh", "a") as f:
        f.write("// edited\n")
    after = _nvcc.library_path("hpss.cu", (21, 11))
    assert after != before
    (tmp_path / "hpss.cu").write_bytes(b"// no includes\n")
    assert _nvcc._sources("hpss.cu") == [tmp_path / "hpss.cu"]


# --- K4: hpss_mel (HPSS medians and masks, then the mel projection) -------

def _bank(n_mels=120, n_fft=400):
    from sm_hpss_mtl_tpu.ops import mel as jmel
    return np.array(jmel.mel_filterbank(22050, n_fft, n_mels),
                    dtype=np.float32)


@pytest.mark.parametrize("T,l_harm,l_perc", [
    (1, 21, 11), (7, 21, 11), (15, 21, 11), (19, 21, 11),  # the path's T
    (400, 21, 11),                       # above the 364-frame Pallas tile
    (13, 11, 5), (40, 11, 5),            # the kernel's narrow median pair
])
def test_hpss_mel_plain_matches_pallas_interpret_and_fallback(T, l_harm,
                                                              l_perc):
    S = _mags((2, 201, T), 3 * T + l_harm)
    M = _bank()
    th, tp = thpss.hpss_mel_plain(torch.from_numpy(S), torch.from_numpy(M),
                                  l_harm=l_harm, l_perc=l_perc)
    assert th.shape == tp.shape == (2, 120, T)
    for interpret in (True, False):      # the Pallas kernel; its jnp fallback
        jh, jp = hpss_pallas.hpss_mel(jnp.asarray(S), M, l_harm=l_harm,
                                      l_perc=l_perc, interpret=interpret)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)


def test_hpss_mel_empty_bands_are_exact_zeros():
    # Row 0 of the sr=22050 bank at n_fft 400 is empty (row 2 holds one
    # weight of 1.7e-4); its output feeds the dB floor and must be exactly
    # 0.
    M = _bank()
    empty = np.flatnonzero(~M.any(axis=1))
    assert 0 in empty
    th, tp = thpss.hpss_mel_plain(torch.from_numpy(_mags((1, 201, 9), 5)),
                                  torch.from_numpy(M))
    assert torch.all(th[:, empty] == 0) and torch.all(tp[:, empty] == 0)


def test_hpss_mel_wrapper_sends_cpu_tensors_to_plain_version():
    S = torch.from_numpy(_mags((3, 1, 201, 12), 6))
    M = torch.from_numpy(_bank(24))
    before = _launches("hpss_mel")
    h, p = thpss.hpss_mel(S, M)
    assert _launches("hpss_mel") == before
    assert h.shape == p.shape == (3, 1, 24, 12)
    for g, w in zip((h, p), thpss.hpss_mel_plain(S, M)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    with pytest.raises(ValueError, match="unsupported device"):
        thpss.hpss_mel(S.to("meta"), M.to("meta"))


def test_hpss_mel_plain_never_reaches_a_kernel(monkeypatch):
    # chip_smoke.py holds K4 to hpss_mel_plain on the card: the plain
    # version must not route into K3's or K4's launchers.
    def refuse(*args, **kwargs):
        raise AssertionError("plain version reached a kernel launcher")

    for name in ("_launch", "_launch_masks", "_launch_mel"):
        monkeypatch.setattr(thpss, name, refuse)
    S = torch.from_numpy(_mags((1, 201, 5), 7))
    thpss.hpss_mel_plain(S, torch.from_numpy(_bank(16)))


def test_launch_stream_getter_fails_loudly_when_missing(monkeypatch):
    # Every kernel's launch (ops/_nvcc.py::launch) reads the current stream
    # through torch's private raw getter: a torch without it must fail at
    # the launch with a message that names it.
    dev = torch.device("cuda", 0)
    monkeypatch.setattr(_nvcc, "_RAW_STREAM", None)
    with pytest.raises(RuntimeError, match="_cuda_getCurrentRawStream"):
        _nvcc._stream(dev)
    monkeypatch.setattr(_nvcc, "_RAW_STREAM", lambda index: 1000 + index)
    assert _nvcc._stream(dev) == 1000
    if torch.version.cuda is not None:   # a torch built for CUDA has it
        assert hasattr(torch._C, "_cuda_getCurrentRawStream")


# --- Shared-core selection networks of median.cuh (K3 and K4) -------------

def _shared_core_networks(src):
    """The MedianCore<W, K> and MedianMerge<K> comparator lists of the
    header."""
    def pairs(body):
        return tuple((int(i), int(j))
                     for i, j in re.findall(r"CS\((\d+),(\d+)\)", body))
    cores = {(int(w), int(k)): pairs(body) for w, k, body in re.findall(
        r"struct MedianCore<(\d+), (\d+)>\s*\{(.*?)\n\};", src, re.S)}
    merges = {int(k): pairs(body) for k, body in re.findall(
        r"struct MedianMerge<(\d+)>\s*\{(.*?)return", src, re.S)}
    return cores, merges


def _run(pairs, wires):
    """A comparator list over a list of arrays (min to the first wire, max
    to the second); bitwise and/or for packed 0/1 columns."""
    v = list(wires)
    lo, hi = ((np.bitwise_and, np.bitwise_or) if v[0].dtype == np.uint64
              else (np.minimum, np.maximum))
    for i, j in pairs:
        v[i], v[j] = lo(v[i], v[j]), hi(v[i], v[j])
    return v


def _running_medians(cores, merges, w, k, x):
    """hpss_median::running_medians: x holds w + k - 1 wires; out[j] is the
    median of x[j .. j+w-1]."""
    first = (w - 1) // 2 - k + 1
    core = _run(cores[(w, k)], x[k - 1:w])
    out = []
    for j in range(k):
        u = core[first:first + k] + x[j:k - 1] + x[w:w + j]
        out.append(_run(merges[k], u)[k - 1])
    return out


def _packed_columns(n_wires, chunk_bits=20):
    """Every 0/1 input of ``n_wires`` wires, bit-parallel: chunks of
    2**chunk_bits columns, wire i of column c being bit i of c, each wire a
    uint64 array (64 columns a word); yields (first column, wires)."""
    low = min(n_wires, chunk_bits)
    words = max(1, (1 << low) // 64)
    lane = np.arange(64, dtype=np.uint64)
    word = np.arange(words, dtype=np.uint64)
    base = []
    for i in range(low):
        if i < 6:
            pat = np.bitwise_or.reduce(
                ((lane >> np.uint64(i)) & np.uint64(1)) << lane)
            base.append(np.full(words, pat, dtype=np.uint64))
        else:
            bit = (word >> np.uint64(i - 6)) & np.uint64(1)
            base.append(np.where(bit == 1, ~np.uint64(0), np.uint64(0)))
    for hi in range(1 << (n_wires - low)):
        high = [np.full(words, ~np.uint64(0) if (hi >> (i - low)) & 1
                        else np.uint64(0), dtype=np.uint64)
                for i in range(low, n_wires)]
        yield hi << low, base + high


def _unpack(bits, n):
    return np.unpackbits(bits.view(np.uint8), bitorder="little")[:n]


def _columns(first, n):
    return np.arange(first, first + n, dtype=np.uint64)


def test_shared_core_header_matches_generator():
    # tools/median_networks.py writes the lists; the header holds them.
    spec = importlib.util.spec_from_file_location(
        "median_networks", _nvcc.CSRC.parents[1] / "tools" /
        "median_networks.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    cores, merges = _shared_core_networks(
        (_nvcc.CSRC / "median.cuh").read_text())
    assert set(cores) == set(gen.INSTANCES)
    assert set(merges) == {k for _, k in gen.INSTANCES}
    for (w, k), pairs in cores.items():
        assert pairs == gen.core_network(w, k), (w, k)
    for k, pairs in merges.items():
        assert pairs == gen.merge_network(k), k
    # Comparators per output: well under half of Median<21> + Median<11>.
    per = {wk: gen.per_output(*wk)[0] for wk in gen.INSTANCES}
    assert per[(21, 4)] + per[(11, 2)] == 44.75
    assert per[(21, 4)] + per[(11, 2)] < 0.5 * (91 + 32)
    # chip_smoke.py counts them in the header it builds (and prices every
    # bound with them): the same counts, and Median<L>'s for K1 and K2.
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", _nvcc.CSRC.parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    single, shared = smoke.median_comparators()
    assert single == {21: 91, 11: 32, 5: 8, 31: 152, 41: 257, 51: 335}
    assert shared == {(lh, lp): per[(lh, 4)] + per[(lp, 2)]
                      for lh, lp in thpss.KERNEL_MEDIANS}
    assert shared[(21, 11)] == 44.75 and shared[(11, 5)] == 18.25


#: Shared-core networks small enough to check over every 0/1 input in a
#: few seconds; the wider ones (W >= 31) are checked as the backward pruning
#: of Batcher's network and on random inputs with ties.
EXHAUSTIVE = [(21, 4), (11, 4), (11, 2), (5, 2), (21, 2)]
WIDE = [(31, 4), (41, 4), (51, 4), (31, 2), (41, 2), (51, 2)]


@pytest.mark.parametrize("w,k", EXHAUSTIVE)
def test_median_core_sorts_the_middle_ranks_for_every_01_input(w, k):
    # 0-1 principle: a comparator network that puts ranks M-K+1 .. M of the
    # core onto those wires for every 0/1 input does so for every input.
    cores, _ = _shared_core_networks((_nvcc.CSRC / "median.cuh").read_text())
    c = w - k + 1
    m = (w - 1) // 2
    for first, wires in _packed_columns(c):
        out = _run(cores[(w, k)], wires)
        n = 64 * len(wires[0])
        zeros = c - np.bitwise_count(_columns(first, n)
                                     & np.uint64((1 << c) - 1))
        for r in range(m - k + 1, m + 1):
            got = _unpack(out[r], n)
            np.testing.assert_array_equal(got, (r >= zeros).astype(np.uint8))


@pytest.mark.parametrize("k", [2, 4])
def test_median_merge_selects_the_median_for_every_01_input(k):
    # K sorted core values (0s then 1s) and K - 1 free extras: the median
    # of the 2K - 1 values is 1 iff K or more of them are 1.
    _, merges = _shared_core_networks((_nvcc.CSRC / "median.cuh").read_text())
    for ones in range(k + 1):
        for extras in range(1 << (k - 1)):
            u = [np.array([1.0 if i >= k - ones else 0.0]) for i in range(k)]
            u += [np.array([float((extras >> i) & 1)]) for i in range(k - 1)]
            want = float(ones + bin(extras).count("1") >= k)
            assert _run(merges[k], u)[k - 1][0] == want, (k, ones, extras)


@pytest.mark.parametrize("w,k", EXHAUSTIVE)
def test_running_medians_are_exact_for_every_01_input(w, k):
    # The whole shared-core reconstruction (core network, then one merge per
    # output) over all 2**(w+k-1) 0/1 columns, 64 a word: output j is 1 iff
    # window j holds more than M ones.
    cores, merges = _shared_core_networks(
        (_nvcc.CSRC / "median.cuh").read_text())
    n_wires = w + k - 1
    m = (w - 1) // 2
    for first, wires in _packed_columns(n_wires):
        out = _running_medians(cores, merges, w, k, wires)
        n = 64 * len(wires[0])
        cols = _columns(first, n)
        for j in range(k):
            ones = np.bitwise_count((cols >> np.uint64(j))
                                    & np.uint64((1 << w) - 1))
            np.testing.assert_array_equal(_unpack(out[j], n),
                                          (ones > m).astype(np.uint8))


@pytest.mark.parametrize("w,k", EXHAUSTIVE + WIDE)
@pytest.mark.parametrize("kind", ["random", "ties"])
def test_shared_core_networks_match_np_median(w, k, kind):
    # Floats: the core's middle wires are np.sort's ranks, each merge gives
    # np.median of its 2K - 1 values, and the K outputs are np.median of the
    # K windows; "ties" draws from four values.
    cores, merges = _shared_core_networks(
        (_nvcc.CSRC / "median.cuh").read_text())
    rng = np.random.default_rng(w * 10 + k)
    x = (rng.standard_normal((4000, w + k - 1)) if kind == "random"
         else rng.integers(0, 4, (4000, w + k - 1)).astype(np.float64))
    wires = [x[:, i].copy() for i in range(w + k - 1)]
    m = (w - 1) // 2
    core = _run(cores[(w, k)], wires[k - 1:w])
    want = np.sort(x[:, k - 1:w], axis=1)
    for r in range(m - k + 1, m + 1):
        np.testing.assert_array_equal(core[r], want[:, r])
    u = np.concatenate([np.sort(x[:, :k], axis=1), x[:, k:2 * k - 1]], 1)
    got = _run(merges[k], [u[:, i].copy() for i in range(2 * k - 1)])[k - 1]
    np.testing.assert_array_equal(got, np.median(u, axis=1))
    out = _running_medians(cores, merges, w, k, wires)
    for j in range(k):
        np.testing.assert_array_equal(out[j], np.median(x[:, j:j + w], 1))


@pytest.mark.parametrize("w,k", WIDE)
def test_wide_shared_core_networks_are_the_pruned_batcher_network(w, k):
    # Over every 0/1 input is out of reach at W >= 31 (2**(W+K-1) columns):
    # each core network is exactly the JAX package's Batcher network on
    # W - K + 1 wires pruned backward from the K middle-rank wires (pruned
    # here independently of the generator), which sorts every input, so
    # those wires hold their ranks; and 1e5 seeded columns with ties give
    # np.median through the whole reconstruction.
    cores, merges = _shared_core_networks(
        (_nvcc.CSRC / "median.cuh").read_text())
    m = (w - 1) // 2
    needed, kept = set(range(m - k + 1, m + 1)), []
    for i, j in reversed(hpss_pallas.batcher_pairs(w - k + 1)):
        if i in needed or j in needed:
            kept.append((i, j))
            needed |= {i, j}
    assert cores[(w, k)] == tuple(reversed(kept))
    rng = np.random.default_rng(1000 * w + k)
    x = rng.integers(0, 6, (100_000, w + k - 1)).astype(np.float32)
    out = _running_medians(cores, merges, w, k,
                           [x[:, i].copy() for i in range(w + k - 1)])
    for j in range(k):
        np.testing.assert_array_equal(out[j], np.median(x[:, j:j + w], 1))


def test_soft_masks_rcp_stays_within_the_bar():
    # csrc/median.cuh::soft_masks_rcp emulated in float32 (correctly
    # rounded reciprocals, then products) against the plain softmask, over
    # random medians, exact ties, zeros, subnormal-scale and large values.
    rng = np.random.default_rng(3)
    h = np.abs(rng.standard_normal(200000)).astype(np.float32)
    p = np.abs(rng.standard_normal(200000)).astype(np.float32)
    scale = np.float32(10.0) ** rng.integers(-30, 30, h.shape)
    h, p = h * scale.astype(np.float32), p * scale.astype(np.float32)
    h[:100], p[:100] = 0, 0
    h[100:200] = p[100:200]
    p[200:300] = 0
    h[300:400] = np.float32(1e-39)
    one = np.float32(1)
    z = np.maximum(h, p)
    bad = z < np.finfo(np.float32).tiny
    r = one / np.where(bad, one, z)
    hn, pn = (h * r) ** 2, (p * r) ** 2
    rd = one / np.where(bad, one, hn + pn)
    mh = np.where(bad, 0, hn * rd).astype(np.float32)
    mp = np.where(bad, 0, pn * rd).astype(np.float32)
    wh = thpss.softmask(torch.from_numpy(h), torch.from_numpy(p)).numpy()
    wp = thpss.softmask(torch.from_numpy(p), torch.from_numpy(h)).numpy()
    np.testing.assert_allclose(mh, wh, **TOL)
    np.testing.assert_allclose(mp, wp, **TOL)
    assert (mh[:100] == 0).all() and (mp[:100] == 0).all()


# --- K4's block plan, emulated on the host ---------------------------------

def _hpss_cu_constants():
    src = (_nvcc.CSRC / "hpss.cu").read_text()
    return {name: int(v) for name, v in re.findall(
        r"constexpr int (\w+) = (\d+);", src)}


def _k4_plan(bands, F, T, l_harm, l_perc):
    """hpss_mel_kernel's decomposition: per block (group, time tile), the
    bins each pass computes, the tile rows and columns it reads, the
    (bin, frame) cells its units write, and the (band, frame) outputs it
    stores."""
    c = _hpss_cu_constants()
    G, TT, CH, QF, QT = (c["K4_BANDS"], c["K4_TT"], c["K4_CHUNK"], c["QF"],
                         c["QT"])
    hp, ht = l_perc // 2, l_harm // 2
    n_mels = len(bands)
    blocks = []
    for m0 in range(0, n_mels, G):
        live = [(lo, hi) for lo, hi in bands[m0:m0 + G] if hi > lo]
        glo = min((lo for lo, _ in live), default=F)
        ghi = max((hi for _, hi in live), default=0)
        for t0 in range(0, T, TT):
            ng = -(-min(TT, T - t0) // QT)
            passes = []
            for c0 in range(glo, ghi, CH):
                nb = min(CH, ghi - c0)
                np_ = -(-nb // QF)
                cells = {(c0 + QF * (u // ng) + q, t0 + QT * (u % ng) + j)
                         for u in range(np_ * ng)
                         for q in range(QF) for j in range(QT)}
                passes.append({"bins": range(c0, c0 + nb),
                               "rows": range(c0 - hp, c0 + QF * np_ + hp),
                               "cols": range(t0 - ht, t0 + QT * ng + ht),
                               "cells": cells})
            outs = [(m0 + w, t0 + l) for w in range(G) for l in range(TT)
                    if m0 + w < n_mels and t0 + l < T]
            blocks.append({"m0": m0, "t0": t0, "passes": passes,
                           "outputs": outs,
                           "threads_for_units": max(
                               [len(p["cells"]) // (QF * QT)
                                for p in passes], default=0)})
    return blocks, c


@pytest.mark.parametrize("n_fft", [400, 512])
@pytest.mark.parametrize("T", [1, 13, 19, 33])
def test_k4_block_plan_covers_each_band_once(n_fft, T):
    # With the real sr=22050 bank: each band's nonzero bins lie in its
    # group's passes, each bin in exactly one pass, with its percussive
    # halo inside that pass's tile rows and every real frame's harmonic
    # halo inside its columns; the units write every (bin, real frame)
    # cell a band reads; every output (band, frame) is stored exactly once.
    M = _bank(120, n_fft)
    F = M.shape[1]
    bands = [tuple(r) for r in
             thpss._band_ranges_of(torch.from_numpy(M)).tolist()]
    blocks, c = _k4_plan(bands, F, T, 21, 11)
    written = Counter()
    for blk in blocks:
        written.update(blk["outputs"])
        assert blk["threads_for_units"] <= c["THREADS"]
        for m in range(blk["m0"], min(blk["m0"] + c["K4_BANDS"], 120)):
            lo, hi = bands[m]
            for k in range(lo, hi):
                owners = [p for p in blk["passes"] if k in p["bins"]]
                assert len(owners) == 1, (m, k)
                p = owners[0]
                assert k - 5 in p["rows"] and k + 5 in p["rows"]
                assert len(p["rows"]) <= c["K4_CHUNK"] + 10
                for t in range(blk["t0"], min(T, blk["t0"] + c["K4_TT"])):
                    assert (k, t) in p["cells"]
                    assert t - 10 in p["cols"] and t + 10 in p["cols"]
    assert written == Counter((m, t) for m in range(120) for t in range(T))
    # Spans at T = 13: 15 blocks; bins computed twice, as the header says.
    if T == 13:
        assert len(blocks) == 15
        spans = [p["bins"] for b in blocks for p in b["passes"]]
        rows, union = sum(map(len, spans)), set().union(*spans)
        assert (rows, len(union)) == ((223, 199) if n_fft == 400
                                      else (282, 255))


@pytest.mark.parametrize("shape,l_harm,l_perc,mask_only", [
    ((1, 61, 120), 51, 11, False),   # two time tiles at the widest l_harm
    ((1, 61, 30), 51, 11, True),     # T < l_harm: the time pad repeats
    ((1, 61, 70), 21, 51, False),    # the widest l_perc
])
def test_plain_matches_pallas_interpret_at_the_tuners_widths(
        shape, l_harm, l_perc, mask_only):
    # K3 at the tuner's widest median pairs (cli/tune.py::GRID_RANGES).
    S = _mags(shape, sum(shape) + l_harm + l_perc)
    jfn = hpss_pallas.hpss_masks if mask_only else hpss_pallas.hpss
    tfn = thpss.hpss_masks_plain if mask_only else thpss.hpss_plain
    jh, jp = jfn(jnp.asarray(S), l_harm=l_harm, l_perc=l_perc, tile_t=64,
                 interpret=True)
    th, tp = tfn(torch.from_numpy(S), l_harm=l_harm, l_perc=l_perc)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)


@pytest.mark.parametrize("T,l_harm,l_perc", [
    (1, 51, 11), (30, 51, 11), (49, 51, 11),   # K4's clips at l_harm 51
    (13, 21, 51), (70, 51, 11)])
def test_hpss_mel_plain_matches_pallas_interpret_at_the_tuners_widths(
        T, l_harm, l_perc):
    S = _mags((1, 201, T), 5 * T + l_harm)
    M = _bank()
    th, tp = thpss.hpss_mel_plain(torch.from_numpy(S), torch.from_numpy(M),
                                  l_harm=l_harm, l_perc=l_perc)
    jh, jp = hpss_pallas.hpss_mel(jnp.asarray(S), M, l_harm=l_harm,
                                  l_perc=l_perc, interpret=True)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)

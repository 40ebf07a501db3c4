"""K3 port: the plain ``hpss`` and ``hpss_masks`` against the JAX kernel.

The JAX side is ``ops/hpss_pallas.py``'s Pallas kernel in interpret mode,
at the geometries of ``tests/test_hpss_pallas.py``; tolerance rtol 1e-5,
atol 1e-6, as that file holds the kernel to the numpy golden.  The CUDA
kernel itself is held to the plain versions on the card by
``chip_smoke.py``.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sm_hpss_mtl_tpu.ops import hpss_pallas
from sm_hpss_mtl_tpu_torch.ops import _nvcc
from sm_hpss_mtl_tpu_torch.ops import hpss as thpss

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)


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
    before = (thpss.hpss.launches, thpss.hpss_masks.launches)
    got = fn(S)
    assert (thpss.hpss.launches, thpss.hpss_masks.launches) == before
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
    assert set(nets) == {5, 11, 21}
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
    assert set(thpss.KERNEL_MEDIANS) == {(21, 11), (11, 5)}


def test_library_path_follows_the_header(tmp_path, monkeypatch):
    # An edited header must rename the library, or a stale build loads.
    for name in ("hpss.cu", "median.cuh"):
        (tmp_path / name).write_bytes((_nvcc.CSRC / name).read_bytes())
    monkeypatch.setattr(_nvcc, "CSRC", tmp_path)
    before = _nvcc.library_path("hpss.cu")
    assert before.name.startswith("libhpss_")
    with open(tmp_path / "median.cuh", "a") as f:
        f.write("// edited\n")
    after = _nvcc.library_path("hpss.cu")
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
    before = thpss.hpss_mel.launches
    h, p = thpss.hpss_mel(S, M)
    assert thpss.hpss_mel.launches == before
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

    for name in ("_dispatch", "_launch", "_launch_mel"):
        monkeypatch.setattr(thpss, name, refuse)
    S = torch.from_numpy(_mags((1, 201, 5), 7))
    thpss.hpss_mel_plain(S, torch.from_numpy(_bank(16)))


def _c_params(src, fn):
    """Kinds of the parameters of C function ``fn`` in ``src``: 'p' for a
    pointer, 'i' for an int."""
    sig = re.search(rf"\bint {fn}\((.*?)\)\s*\{{", src, re.S).group(1)
    return ["p" if "*" in a else "i" for a in sig.split(",")]


@pytest.mark.parametrize("module,source,functions", [
    ("hpss", "hpss.cu", ("k3_hpss", "k4_hpss_mel")),
    ("frontend", "frontend.cu", ("k1_stft_hpss_mel", "k2_stft_hpss",
                                 "k1_blocks_per_sm")),
])
def test_ctypes_bindings_match_c_signatures(monkeypatch, module, source,
                                            functions):
    # A binding with a wrong argument count or kind passes pointers as
    # 32-bit ints or shifts every argument; only the card would show it.
    import ctypes
    import importlib
    import types
    mod = importlib.import_module(f"sm_hpss_mtl_tpu_torch.ops.{module}")
    libs = []

    def fake_cdll(path):
        lib = types.SimpleNamespace(**{
            n: types.SimpleNamespace() for n in functions + (
                "k1_error_string", "k3_error_string")})
        libs.append(lib)
        return lib

    monkeypatch.setattr(_nvcc, "build", lambda source: "unbuilt.so")
    monkeypatch.setattr(ctypes, "CDLL", fake_cdll)
    mod._library.cache_clear()
    try:
        mod._library()
    finally:
        mod._library.cache_clear()
    src = (_nvcc.CSRC / source).read_text()
    kinds = {ctypes.c_void_p: "p", ctypes.c_int: "i"}
    for fn in functions:
        bound = getattr(libs[0], fn)
        assert [kinds[a] for a in bound.argtypes] == _c_params(src, fn), fn
        assert bound.restype is ctypes.c_int

"""The kernels' one seam to PyTorch (``ops/_nvcc.py``) on the CPU.

Every exported C function of ``csrc/`` is bound as its source declares it,
and every kernel's launcher reaches the card through ``_nvcc.launch``:
the current raw stream last, a failed launch raised with the kernel's name
and the library's error string.  No library is built: a stand-in for
``ctypes.CDLL`` or for the loaded library takes the calls.
"""

import contextlib
import ctypes
import importlib.util
import re
import types
from pathlib import Path

import pytest
import torch

from sm_hpss_mtl_tpu_torch.ops import _nvcc
from sm_hpss_mtl_tpu_torch.ops import frontend as tfe
from sm_hpss_mtl_tpu_torch.ops import hpss as thpss
from sm_hpss_mtl_tpu_torch.ops import tcn_block as tb
from sm_hpss_mtl_tpu_torch.ops.mel import mel_filterbank
from sm_hpss_mtl_tpu_torch.utils.profiling import counters

REPO = Path(__file__).resolve().parents[1]

#: Every function the three sources export, (source, name).
EXPORTS = [
    ("frontend.cu", "k1_stft_hpss_mel"), ("frontend.cu", "k2_stft_hpss"),
    ("frontend.cu", "k1_blocks_per_sm"), ("frontend.cu", "k1_error_string"),
    ("hpss.cu", "k3_hpss"), ("hpss.cu", "k4_hpss_mel"),
    ("hpss.cu", "k3_blocks_per_sm"), ("hpss.cu", "k4_blocks_per_sm"),
    ("hpss.cu", "k3_error_string"),
    ("tcn_block.cu", "tcn_forward_a"), ("tcn_block.cu", "tcn_forward_b"),
    ("tcn_block.cu", "tcn_backward_a"), ("tcn_block.cu", "tcn_error_string"),
]


def _c_params(src, fn):
    """Kinds of the parameters of C function ``fn`` in ``src``: 'p' for a
    pointer, 'f' for a float, 'i' for an int."""
    sig = re.search(rf"\b{fn}\((.*?)\)\s*\{{", src, re.S).group(1)
    return ["p" if "*" in a else "f" if a.split()[0] == "float" else "i"
            for a in sig.split(",")]


class _FakeCDLL:
    """A loaded library's stand-in: an attribute per function, each a
    namespace the binding fills in."""

    def __init__(self, path):
        self.path = path

    def __getattr__(self, name):
        fn = types.SimpleNamespace()
        setattr(self, name, fn)
        return fn


@pytest.mark.parametrize("source,fn", EXPORTS)
def test_ctypes_bindings_match_c_signatures(monkeypatch, source, fn):
    # A binding with a wrong argument count or kind passes pointers as
    # 32-bit ints or shifts every argument; only the card would show it.
    monkeypatch.setattr(_nvcc, "build", lambda *a: "unbuilt.so")
    monkeypatch.setattr(ctypes, "CDLL", _FakeCDLL)
    pair = None if source == "tcn_block.cu" else (21, 11)
    _nvcc.load.cache_clear()
    try:
        lib = _nvcc.load(source, pair)
    finally:
        _nvcc.load.cache_clear()
    assert set(_nvcc.signatures(_nvcc.CSRC / source)) == {
        f for s, f in EXPORTS if s == source}
    src = (_nvcc.CSRC / source).read_text()
    kinds = {ctypes.c_void_p: "p", ctypes.c_int: "i", ctypes.c_float: "f"}
    bound = getattr(lib, fn)
    assert [kinds[a] for a in bound.argtypes] == _c_params(src, fn)
    assert bound.restype is (ctypes.c_char_p if fn.endswith("_error_string")
                             else ctypes.c_int)


def _tcn_operands():
    g = torch.Generator().manual_seed(0)
    conv, x, grad = (torch.randn(2, 8, 5, generator=g) for _ in range(3))
    mask = torch.ones(2, 8, 1)
    return conv, torch.zeros(8), mask, x, grad


#: Each kernel's launcher on CPU tensors: (source, C function, the message
#: its failed launch starts with, the call).
LAUNCHES = {
    "K1": ("frontend.cu", "k1_stft_hpss_mel", "stft_hpss_mel kernel launch "
           "failed", lambda: tfe.launch(
               torch.zeros(2, 400 + 29 * 160),
               mel_filterbank(22050, 400, 120), n_fft=400, win_length=400,
               hop_length=160, l_harm=21, l_perc=11)),
    "K2": ("frontend.cu", "k2_stft_hpss", "stft_hpss kernel launch failed",
           lambda: tfe.launch(torch.zeros(2, 512 + 29 * 160), None,
                              n_fft=512, win_length=400, hop_length=160,
                              l_harm=21, l_perc=11, halo_in_audio=True,
                              edge_flags=(0, 1))),
    "K3": ("hpss.cu", "k3_hpss", "hpss kernel launch failed",
           lambda: thpss._launch(torch.zeros(2, 201, 13), l_harm=21,
                                 l_perc=11)),
    "K3 masks": ("hpss.cu", "k3_hpss", "hpss kernel launch failed",
                 lambda: thpss._launch(torch.zeros(201, 13), l_harm=11,
                                       l_perc=5, mask_only=True)),
    "K4": ("hpss.cu", "k4_hpss_mel", "hpss_mel kernel launch failed (F=201, "
           "l_harm=21, l_perc=11)", lambda: thpss._launch_mel(
               torch.zeros(1, 201, 13), mel_filterbank(22050, 400, 120),
               l_harm=21, l_perc=11)),
    "forward_a": ("tcn_block.cu", "tcn_forward_a", "tcn_block forward_a "
                  "kernel launch failed at (2, 8, 5)", lambda: tb._launch_a(
                      *_tcn_operands()[:3], 0.725)),
    "forward_b": ("tcn_block.cu", "tcn_forward_b", "tcn_block forward_b "
                  "kernel launch failed at (2, 8, 5)", lambda: tb._launch_b(
                      _tcn_operands()[3], *_tcn_operands()[:2], True)),
    "backward_a": ("tcn_block.cu", "tcn_backward_a", "tcn_block backward_a "
                   "kernel launch failed at (2, 8, 5)",
                   lambda: tb._launch_backward_a(
                       _tcn_operands()[4], *_tcn_operands()[:3], 0.725,
                       None)),
}


def _stand_in(monkeypatch, returns: int = 0) -> list:
    """Every library replaced by one whose kernels return ``returns``, the
    device context by a no-op and the stream getter by a constant; returns
    the list of the kernels' calls."""
    calls = []

    def kernel_fn(*args):
        calls.append(args)
        return returns

    libs = {source: types.SimpleNamespace(**{
        name: (lambda code: f"fake error {code}".encode())
        if name.endswith("_error_string") else kernel_fn
        for name in _nvcc.signatures(_nvcc.CSRC / source)})
        for source in ("frontend.cu", "hpss.cu", "tcn_block.cu")}
    monkeypatch.setattr(_nvcc, "load", lambda source, *a, **kw: libs[source])
    monkeypatch.setattr(_nvcc, "_made_current",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(_nvcc, "_RAW_STREAM", lambda index: 1234)
    return calls


@pytest.mark.parametrize("kernel", list(LAUNCHES))
def test_failed_launch_names_its_kernel_and_error(monkeypatch, kernel):
    """A non-zero return raises with the kernel's name (and shape detail)
    and the library's error string, counts no launch, and passes one
    argument per C parameter, the current raw stream last; a torch
    without the raw getter fails naming it."""
    source, fn, message, call = LAUNCHES[kernel]
    calls = _stand_in(monkeypatch, returns=700)
    before = counters()
    with pytest.raises(RuntimeError) as err:
        call()
    assert str(err.value) == f"{message}: fake error 700"
    assert counters() == before
    params = _nvcc.signatures(_nvcc.CSRC / source)[fn][1]
    assert len(calls) == 1 and len(calls[0]) == len(params)
    assert calls[0][-1] == 1234
    monkeypatch.setattr(_nvcc, "_RAW_STREAM", None)
    with pytest.raises(RuntimeError, match="_cuda_getCurrentRawStream"):
        call()
    assert len(calls) == 1


def test_chip_smoke_tally_reads_every_launch_at_the_seam(monkeypatch):
    """``chip_smoke.py::recorded`` counts each kernel's launches and keys
    its shapes from ``_nvcc.launch`` alone: K1/K2 by geometry, halo flags,
    DFT precision and power; K3 by mode; the TCN kernels by dtype, shape,
    bias rows and mask."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    _stand_in(monkeypatch)
    with cs.recorded() as rec:
        for _, _, _, call in LAUNCHES.values():
            call()
        tfe.launch(torch.zeros(1, 400 + 29 * 160),
                   mel_filterbank(22050, 400, 120), n_fft=400,
                   win_length=400, hop_length=160, l_harm=21, l_perc=11,
                   power=1.5, dft_precision="bf16x3")
    assert rec["launches"] == {"K1": 2, "K2": 1, "K3": 2, "K4": 1}
    assert rec["tcn"] == {"forward_a": 1, "forward_b": 1, "backward_a": 1}
    assert rec["halo"] == {"K1": 0, "K2": 1}
    assert rec["launches_by_precision"]["K1"] == {"highest": 1, "bf16x3": 1}
    assert rec["shapes"] == {
        "K1": {(400, 21, 11, 2, 30),
               (400, 21, 11, 1, 30, "bf16x3", "power1.5")},
        "K2": {(512, 21, 11, 2, 10, "halo", 0, 1)},
        "K3": {(False, 21, 11, 2, 201, 13), (True, 11, 5, 1, 201, 13)},
        "K4": {(21, 11, 1, 201, 13)},
        "tcn": {("forward_a", "float32", 2, 8, 5, 1, True),
                ("forward_b", "float32", 2, 8, 5, 1, None),
                ("backward_a", "float32", 2, 8, 5, 1, True)}}

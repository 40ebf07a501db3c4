"""The yardstick's arithmetic: published H100 peaks, the least time of the
front end's function (K1's and K2's) and of K3's and K4's, and the
operations they need.  Copied from ``chip_smoke.py`` (``HBM_BYTES_PER_S``,
``F32_FLOPS``, ``frontend_bound_ms``, ``k3_bound_ms``, ``k4_bound_ms``) so
that a change to the program cannot move the denominators.

Bounds price the function, not an implementation: an FFT of ``2.5 n
log2 n`` operations, both medians at the comparators per output of the
shared-core networks (each configuration's ``median_comparators``, for its
median pair), the soft masks, and the mel
projection over the basis's nonzero entries; bytes are each input read
once and each output written once.
"""

from __future__ import annotations

import math

#: NVIDIA H100 data sheet: HBM bytes/s; float32 FLOP/s outside the tensor
#: cores (SXM part, and the PCIe part).  The port computes in float32 with
#: TF32 off, so its model FLOPs are held to the float32 peak.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = {"PCIe": 51e12, "default": 67e12}
#: Operations per bin of the two soft masks and their products.
MASK_OPS = 10


def f32_peak(card: str) -> float:
    return F32_FLOPS["PCIe" if "PCIe" in card else "default"]


def bound_s(nbytes: float, flops: float, card: str) -> float:
    """The larger of bytes over HBM and operations over the f32 peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / f32_peak(card))


def frontend_flops(T: int, n_fft: int, comparators: float,
                   mel_nnz: int = 0, B: int = 1) -> float:
    """Operations of the front end's function over ``B`` items of ``T``
    frames: window, real FFT, magnitude, both medians, the masks and (K1)
    the mel projection of both components over the basis's nonzeros."""
    F = 1 + n_fft // 2
    per_frame = (n_fft + 2.5 * n_fft * math.log2(n_fft) + 3 * F
                 + comparators * 2 * F + MASK_OPS * F + 2 * 2 * mel_nnz)
    return B * T * per_frame


def frontend_bytes(T: int, N: int, n_fft: int, n_mels: int = 0,
                   B: int = 1) -> float:
    """Audio in; two (n_mels, T) maps and the basis (K1) or two (F, T)
    maps (K2) out."""
    F = 1 + n_fft // 2
    rows = n_mels if n_mels else F
    return 4 * (B * N + n_mels * F + 2 * B * rows * T)


def frontend_bound_s(T: int, N: int, n_fft: int, comparators: float,
                     card: str, n_mels: int = 0, mel_nnz: int = 0,
                     B: int = 1) -> float:
    """Least time of K1's function (``n_mels`` > 0) or K2's."""
    return bound_s(frontend_bytes(T, N, n_fft, n_mels, B),
                   frontend_flops(T, n_fft, comparators, mel_nnz, B), card)


def k3_bound_s(B: int, F: int, T: int, comparators: float,
               card: str) -> float:
    """Least time of K3's function: one (B, F, T) read and two written."""
    ops = comparators * 2 + MASK_OPS
    return bound_s(4 * 3 * B * F * T, ops * B * F * T, card)


def k4_bound_s(B: int, F: int, T: int, n_mels: int, mel_nnz: int,
               comparators: float, card: str) -> float:
    """Least time of K4's function: magnitudes and basis in, two (B,
    n_mels, T) maps out."""
    ops = ((comparators * 2 + MASK_OPS) * B * F * T
           + 2 * 2 * mel_nnz * B * T)
    return bound_s(4 * (B * F * T + n_mels * F + 2 * B * n_mels * T), ops,
                   card)

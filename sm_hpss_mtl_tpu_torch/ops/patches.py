"""Feature-matrix helpers (counterpart of ``sm_hpss_mtl_tpu/ops/patches.py``):
per-row standardization, and the reference's sliding-window patches on
the host (numpy) and on the device (torch).

Patch semantics are the reference's (``extract_patches`` plus the
short-clip rule of ``get_feature_patches``): a clip shorter than one window
is tiled (whole copies of the original) until strictly longer than
``patch_size``; windows are then centred at ``range(half, T - half,
shift)`` with ``half = patch_size // 2``.
"""

from __future__ import annotations

import numpy as np
import torch


def tiled_length(T: int, patch_size: int) -> int:
    """Length after the short-clip tiling rule: repeat the original until
    strictly longer than ``patch_size``."""
    out = T
    while out <= patch_size:
        out += T
    return out


def num_patches(T: int, patch_size: int, patch_shift: int) -> int:
    """Patch count for a (possibly tiled) time axis of ``T`` frames."""
    T = tiled_length(T, patch_size)
    half = patch_size // 2
    return len(range(half, T - half, patch_shift))


def _start_indices(T: int, patch_size: int, patch_shift: int) -> np.ndarray:
    half = patch_size // 2
    return np.arange(half, T - half, patch_shift) - half


def extract_patches_np(FV: np.ndarray, patch_size: int, patch_shift: int
                       ) -> np.ndarray:
    """``(D, T)`` -> ``(N, D, patch_size)`` windows, on the host."""
    D, T = FV.shape
    full_T = tiled_length(T, patch_size)
    if full_T != T:
        reps = -(-full_T // T)
        FV = np.tile(FV, (1, reps))[:, :full_T]
    starts = _start_indices(full_T, patch_size, patch_shift)
    idx = starts[:, None] + np.arange(patch_size)[None, :]
    return np.ascontiguousarray(np.moveaxis(FV[:, idx], 1, 0))


def extract_patches(FV: torch.Tensor, *, patch_size: int,
                    patch_shift: int) -> torch.Tensor:
    """``(..., D, T)`` -> ``(N, ..., D, patch_size)`` windows on ``FV``'s
    device, the patch axis leading (the device training pipeline's
    layout)."""
    T = FV.shape[-1]
    full_T = tiled_length(T, patch_size)
    if full_T != T:
        reps = -(-full_T // T)
        FV = FV.repeat((1,) * (FV.ndim - 1) + (reps,))[..., :full_T]
    n = len(_start_indices(full_T, patch_size, patch_shift))
    windows = FV.unfold(-1, patch_size, patch_shift)[..., :n, :]
    return windows.movedim(-2, 0)


def standardize_rows(FV: torch.Tensor) -> torch.Tensor:
    """Per-row standardization over the time axis, matching
    ``StandardScaler().fit_transform(FV.T).T``: ddof=0 std, and a constant
    row keeps scale 1 and is only centred, to exactly 0.

    A row is constant when its max equals its min.  Testing the float32
    std against 0 instead misses such rows: the rounded mean differs from
    the value, the std comes out ~1e-5 and the row standardizes to +-1
    noise.  The serving features always have such rows (the empty low
    filters of the sr=22050 mel bank sit at the dB floor).
    """
    mean = FV.mean(dim=-1, keepdim=True)
    scale = FV.var(dim=-1, unbiased=False, keepdim=True).sqrt()
    constant = FV.amax(dim=-1, keepdim=True) == FV.amin(dim=-1, keepdim=True)
    scale = torch.where(constant | (scale == 0.0), torch.ones_like(scale),
                        scale)
    centred = torch.where(constant, torch.zeros_like(FV), FV - mean)
    return centred / scale

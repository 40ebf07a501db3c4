"""Feature-matrix helpers (counterpart of ``sm_hpss_mtl_tpu/ops/patches.py``)."""

from __future__ import annotations

import torch


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

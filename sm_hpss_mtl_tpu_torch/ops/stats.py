"""Per-patch moment statistics: mean, variance, skewness, kurtosis
(counterpart of ``sm_hpss_mtl_tpu/ops/stats.py``).

The reference loops over patches calling scipy's ``skew`` and
``kurtosis`` (biased estimators, Fisher kurtosis); here the whole batch
``(N, F, T)`` is one reduction on the tensor's device, to ``(N, F)``
(axis 1, per row, "harmonic") or ``(N, T)`` (axis 0, per column,
"percussive").  A slice whose second moment is at most 1e-12 gives 0
for skewness and kurtosis.  :func:`skewness_vectors` makes the patches of
the experiment option ``skewness_vector``.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def patch_statistics(FV: torch.Tensor, *, stat_type: str = "skew",
                     axis: int = 0) -> torch.Tensor:
    """Statistics over one axis of each ``(F, T)`` patch of ``(N, F, T)``:
    ``axis`` 0 along columns (output ``(N, T)``), 1 along rows (output
    ``(N, F)``)."""
    if axis not in (0, 1):
        raise ValueError("axis must be 0 (columns) or 1 (rows)")
    dim = 1 if axis == 0 else 2
    x = FV.to(torch.float32)
    if stat_type == "mean":
        return x.mean(dim=dim)
    if stat_type == "variance":
        return x.var(dim=dim, correction=0)
    if stat_type not in ("skew", "kurtosis"):
        raise ValueError(f"unknown stat_type {stat_type!r}")
    d = x - x.mean(dim=dim, keepdim=True)
    m2 = (d * d).mean(dim=dim)
    safe = m2.clamp_min(_EPS)
    if stat_type == "skew":
        out = (d * d * d).mean(dim=dim) / safe ** 1.5
    else:
        out = (d * d * d * d).mean(dim=dim) / safe ** 2 - 3.0
    return torch.where(m2 > _EPS, out, torch.zeros_like(out))


def skewness_vectors(patches: torch.Tensor, kind: str) -> torch.Tensor:
    """Each ``(F, T)`` patch of ``(N, F, T)`` replaced by its skewness per
    row (``kind='Row'``: ``(N, F, 1)``) or per column (``'Col'``:
    ``(N, 1, T)``), as the reference's ``skewness_vector`` option does."""
    if kind == "Row":
        return patch_statistics(patches, stat_type="skew", axis=1)[:, :, None]
    if kind == "Col":
        return patch_statistics(patches, stat_type="skew", axis=0)[:, None, :]
    raise ValueError(f"skewness_vector must be 'Row' or 'Col', got {kind!r}")

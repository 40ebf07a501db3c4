"""Frame-level corpus scaling (counterpart of
``sm_hpss_mtl_tpu/data/batcher.py::scale_frames``; the batcher itself
belongs to the training slice)."""

from __future__ import annotations

import numpy as np


def scale_frames(fv: np.ndarray, mean: np.ndarray, stdev: np.ndarray
                 ) -> np.ndarray:
    """``(FV - mean) / (stdev + 1e-10)`` with per-row statistics."""
    return (fv - mean[:, None]) / (stdev[:, None] + 1e-10)

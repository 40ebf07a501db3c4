"""Audio length bucketing (counterpart of the helpers of
``sm_hpss_mtl_tpu/data/featurize.py``).

The serving path pads a whole-signal input to a geometric length bucket,
as the JAX package does to bound its compiled shapes; the port keeps the
rule so that both packages featurize the same padded signal.
"""

from __future__ import annotations

import numpy as np


def bucket_length(n: int, min_n: int = 16000, ratio: float = 1.1) -> int:
    """Geometric length buckets: the smallest grid point >= n."""
    m = min_n
    while m < n:
        m = int(m * ratio) + 1
    return m


def _reflect_pad_to(x: np.ndarray, target: int) -> np.ndarray:
    """Pad 1-D ``x`` to ``target`` samples by repeated symmetric
    reflection (handles pads longer than the signal)."""
    out = x
    flip = True
    while len(out) < target:
        out = np.concatenate([out, x[::-1] if flip else x])
        flip = not flip
    return out[:target]

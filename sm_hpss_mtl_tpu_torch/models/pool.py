"""Max pooling with TF/XLA padding semantics.

Counterpart of ``sm_hpss_mtl_tpu/models/pool.py::max_pool`` (which matches
``flax.linen.max_pool``).  ``'VALID'`` keeps only whole windows.
``'SAME'`` gives ``ceil(size / stride)`` outputs per axis and pads with
``-inf``, ``total // 2`` on the low side and the rest on the high side,
where ``total = (out - 1) * stride + window - size``: Jang's (2, 2)/2
pooling turns 17 time steps into 9 with one ``-inf`` column on the right.
Windows may overlap (Papakostas' (3, 3)/2).

Layout: the port's image models run NCHW, so this pools the last two axes
of ``(B, C, H, W)``; the JAX function takes NHWC.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _pad_amount(size: int, window: int, stride: int,
                padding: str) -> tuple[int, int]:
    if padding == "VALID":
        return 0, 0
    if padding != "SAME":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    out = -(-size // stride)
    total = max(0, (out - 1) * stride + window - size)
    return total // 2, total - total // 2


def max_pool(x: torch.Tensor, window: tuple[int, int],
             strides: tuple[int, int], padding: str = "VALID") -> torch.Tensor:
    """Max pool over the H, W axes of an NCHW tensor."""
    (wh, ww), (sh, sw) = window, strides
    ph = _pad_amount(x.shape[-2], wh, sh, padding)
    pw = _pad_amount(x.shape[-1], ww, sw, padding)
    if any(ph + pw):
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, (wh, ww), (sh, sw))

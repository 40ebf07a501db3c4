"""Time-sharded HPSS with halo exchange (counterpart of
the JAX package's ``parallel/halo.py``).

The harmonic median needs ``l_harm//2`` frames of context on each side, so
a spectrogram sharded along time hands each shard its ring neighbours'
edge frames (a copy to the shard's device; none between repeated
devices) and each shard computes its frames locally; the global edges use
the symmetric mirror of the unsharded op.  The medians are plain PyTorch
(``ops.hpss.hpss_from_extended``), as the JAX function computes them in
plain ``jnp`` rather than in a kernel.  Equal to ``ops.hpss.hpss_plain`` on
the whole array.
"""

from __future__ import annotations

import torch

from ..ops.hpss import hpss_from_extended
from .mesh import Mesh


def hpss_time_sharded(S: torch.Tensor, mesh: Mesh, *, l_harm: int = 21,
                      l_perc: int = 11, power: float = 2.0,
                      axis: str = "time") -> tuple[torch.Tensor, torch.Tensor]:
    """HPSS over ``(B, F, T)`` with T sharded on ``mesh`` axis ``axis``;
    ``(H, P)`` gathered on ``S``'s device.

    T must divide evenly by the axis size and each local block must hold
    at least ``l_harm//2`` frames."""
    ht = l_harm // 2
    n = mesh.shape[axis]
    if S.shape[-1] % n:
        raise ValueError(f"T={S.shape[-1]} not divisible by {axis}={n}")
    if S.shape[-1] // n < ht:
        raise ValueError("local time block smaller than the halo")
    mesh.check(S)
    T_local = S.shape[-1] // n
    local = [S[..., i * T_local:(i + 1) * T_local].to(dev, non_blocking=True)
             for i, dev in enumerate(mesh.along(axis))]
    outs_h, outs_p = [], []
    for i, x in enumerate(local):
        dev = x.device
        left = (x[..., :ht].flip(-1) if i == 0
                else local[i - 1][..., -ht:].to(dev, non_blocking=True))
        right = (x[..., -ht:].flip(-1) if i == n - 1
                 else local[i + 1][..., :ht].to(dev, non_blocking=True))
        H, P = hpss_from_extended(torch.cat([left, x, right], dim=-1),
                                  l_harm=l_harm, l_perc=l_perc, power=power)
        outs_h.append(H.to(S.device))
        outs_p.append(P.to(S.device))
    return torch.cat(outs_h, dim=-1), torch.cat(outs_p, dim=-1)

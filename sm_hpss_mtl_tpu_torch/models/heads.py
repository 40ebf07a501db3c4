"""Multi-task heads S (speech), M (music), N (noise, the 5-class model), R
(SMR regression) and 3C, the cascaded wiring, and the Keras dense layers
the models build from.

Counterpart of ``sm_hpss_mtl_tpu/models/heads.py`` (``MTLHeads`` with one
Dense-16 block per head by default, the reference's effective wiring;
``CascadedMTLHeads``; ``KDense``).
Keras BatchNorm has eps 1e-3 and momentum 0.99, which torch writes as
0.01; its running variance takes the biased batch variance
(``layers.BatchNorm1d``).  Keras's glorot-uniform initialisation is
``lemaire.init_weights``.

``dtype`` (flax's, ``layers``): each block's dense layer computes in it and
its BatchNorm returns float32; the output layers (``S_out`` ... ``C_out``)
have none, so they compute in float32 (``C_out`` on the trunk's vector,
promoted).  The cascaded heads take no dtype, as in JAX: their blocks
compute in float32 on whatever the trunk gives them.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import BatchNorm1d, Dropout, Linear

BN_KW = dict(eps=1e-3, momentum=0.01)


def dense_with_bn(in_features: int, width: int,
                  dtype: torch.dtype | None = None
                  ) -> tuple[Linear, BatchNorm1d]:
    """A Keras Dense layer computing in ``dtype`` and a Keras BatchNorm over
    its ``width`` outputs, as two modules, so that each keeps its own flax
    name (Jang's ``fc1`` and ``fc1_bn``)."""
    return (Linear(in_features, width, compute_dtype=dtype),
            BatchNorm1d(width, **BN_KW))


class HeadBlock(nn.Module):
    """Dense(width) -> BatchNorm -> ReLU -> Dropout(0.4)."""

    def __init__(self, in_features: int, width: int = 16,
                 dropout: float = 0.4, dtype: torch.dtype | None = None):
        super().__init__()
        self.dense = Linear(in_features, width, compute_dtype=dtype)
        self.bn = BatchNorm1d(width, **BN_KW)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dropout(torch.relu(self.bn(self.dense(x))))


class MTLHeads(nn.Module):
    """Parallel S / M [/ N] / R heads and the class softmax over a trunk
    vector.  ``with_noise`` (the 5-class model) adds the N head and widens
    R to 3 units [music, speech, noise]; each head stacks ``head_layers``
    blocks, named ``S_block``, ``S_block_l1``, ...  Outputs in the JAX
    order S, M, [N,] R, 3C (``3C`` also for 5 classes)."""

    def __init__(self, in_features: int, n_classes: int = 3,
                 head_width: int = 16, with_noise: bool = False,
                 head_layers: int = 1, dtype: torch.dtype | None = None):
        super().__init__()
        self.heads = ("S", "M", "N", "R") if with_noise else ("S", "M", "R")
        self.head_layers = head_layers
        for name in self.heads:
            for i in range(head_layers):
                self.add_module(_block_name(name, i), HeadBlock(
                    head_width if i else in_features, head_width,
                    dtype=dtype))
        self.S_out = Linear(head_width, 1)
        self.M_out = Linear(head_width, 1)
        if with_noise:
            self.N_out = Linear(head_width, 1)
        self.R_out = Linear(head_width, 3 if with_noise else 2)
        self.C_out = Linear(in_features, n_classes)

    def _stack(self, x: torch.Tensor, name: str) -> torch.Tensor:
        for i in range(self.head_layers):
            x = getattr(self, _block_name(name, i))(x)
        return x

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        out = {}
        for name in self.heads:
            y = getattr(self, f"{name}_out")(self._stack(x, name))
            out[name] = y if name == "R" else torch.sigmoid(y)
        out["3C"] = torch.softmax(self.C_out(x), dim=-1)
        return out


def _block_name(head: str, i: int) -> str:
    """Block ``i`` of a head's stack: ``S_block``, ``S_block_l1``, ..."""
    return f"{head}_block" + (f"_l{i}" if i else "")


class CascadedMTLHeads(nn.Module):
    """The cascaded heads, one Dense-16 block each: R's two units feed S
    and M, each of which concatenates its block's output with them and
    normalises the 18 values (``S_cat_bn``, ``M_cat_bn``) before its
    sigmoid.  Outputs in the JAX order R, S, M, 3C."""

    def __init__(self, in_features: int, n_classes: int = 3):
        super().__init__()
        for name in ("R", "S", "M"):
            self.add_module(f"{name}_block", HeadBlock(in_features))
        self.R_out = Linear(16, 2)
        self.S_cat_bn = BatchNorm1d(18, **BN_KW)
        self.S_out = Linear(18, 1)
        self.M_cat_bn = BatchNorm1d(18, **BN_KW)
        self.M_out = Linear(18, 1)
        self.C_out = Linear(in_features, n_classes)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        smr = self.R_out(self.R_block(x))
        out = {"R": smr}
        for name in ("S", "M"):
            y = torch.cat([getattr(self, f"{name}_block")(x), smr], dim=-1)
            y = getattr(self, f"{name}_cat_bn")(y)
            out[name] = torch.sigmoid(getattr(self, f"{name}_out")(y))
        out["3C"] = torch.softmax(self.C_out(x), dim=-1)
        return out

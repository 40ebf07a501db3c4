"""Multi-task heads S (speech), M (music), R (SMR regression) and 3C, and
the Keras dense layers the models build from.

Counterpart of ``sm_hpss_mtl_tpu/models/heads.py`` (``MTLHeads`` with one
Dense-16 block per head, the reference's effective wiring; ``KDense``).
Keras BatchNorm has eps 1e-3 and momentum 0.99, which torch writes as
0.01; its running variance takes the biased batch variance
(``layers.BatchNorm1d``).  Keras's glorot-uniform initialisation is
``lemaire.init_weights``.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import BatchNorm1d, Dropout

BN_KW = dict(eps=1e-3, momentum=0.01)


def dense_with_bn(in_features: int, width: int
                  ) -> tuple[nn.Linear, BatchNorm1d]:
    """A Keras Dense layer and a Keras BatchNorm over its ``width``
    outputs, as two modules, so that each keeps its own flax name (Jang's
    ``fc1`` and ``fc1_bn``)."""
    return nn.Linear(in_features, width), BatchNorm1d(width, **BN_KW)


class HeadBlock(nn.Module):
    """Dense(width) -> BatchNorm -> ReLU -> Dropout(0.4)."""

    def __init__(self, in_features: int, width: int = 16,
                 dropout: float = 0.4):
        super().__init__()
        self.dense = nn.Linear(in_features, width)
        self.bn = BatchNorm1d(width, **BN_KW)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dropout(torch.relu(self.bn(self.dense(x))))


class MTLHeads(nn.Module):
    """Parallel S / M / R heads and the 3C softmax over a trunk vector."""

    def __init__(self, in_features: int, n_classes: int = 3,
                 head_width: int = 16):
        super().__init__()
        for name in ("S", "M", "R"):
            self.add_module(f"{name}_block", HeadBlock(in_features, head_width))
        self.S_out = nn.Linear(head_width, 1)
        self.M_out = nn.Linear(head_width, 1)
        self.R_out = nn.Linear(head_width, 2)
        self.C_out = nn.Linear(in_features, n_classes)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        return {
            "S": torch.sigmoid(self.S_out(self.S_block(x))),
            "M": torch.sigmoid(self.M_out(self.M_block(x))),
            "R": self.R_out(self.R_block(x)),
            "3C": torch.softmax(self.C_out(x), dim=-1),
        }

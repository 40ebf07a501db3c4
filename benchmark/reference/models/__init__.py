"""The reference's model families, one module per family
(``models/<family>.py``), found by the configuration's ``family``.  Each
gives:

- ``forward(x, W, cfg, draws, train)``: the model's heads over a batch of
  inputs, from the weight dict ``W``;
- ``layout(patches)``: standardized ``(N, D, patch)`` windows as the model
  takes them;
- ``l2_names(W)``: the kernels the l2 penalty takes;
- optionally ``init_leaf(name, u, cfg)``: a seeded weight of the leaf
  ``name`` from uniform draws ``u`` of its shape, where the default rule of
  the benchmark's weights does not fit (None leaves it to that rule).

A configuration of a new family adds its module, and edits none.
"""

from __future__ import annotations

import importlib
import re

_NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]{0,63}$")


def family(cfg: dict):
    name = cfg["family"]
    if not _NAME.match(name):
        raise ValueError(f"not a model family: {name!r}")
    return importlib.import_module(f"{__name__}.{name}")


def forward(x, W: dict, cfg: dict, draws, train: bool) -> dict:
    return family(cfg).forward(x, W, cfg, draws, train)

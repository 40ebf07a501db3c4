"""The reference's optimizers, one module per kind
(``optimizers/<kind>.py``), found by the configuration's
``optimizer.kind``.  Each gives ``Optimizer(opt, params, start=None)``
with ``update(params, grads)`` and ``seen(g)`` (the gradient as the
update takes it), and ``gradient(opt, m0, m1, t)``: the gradient update
``t`` took, from its first moment before and after.  ``start`` is an
optimizer's state to go on from: ``{"t": updates taken, "m": {name:
first moment}, "v": {name: second moment or None}}``."""

from __future__ import annotations

import importlib
import re

_NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]{0,63}$")


def moment(start: dict | None, which: str, name: str, p):
    """The moment ``which`` ('m' or 'v') of ``name`` in ``start``, like
    ``p``; zero where ``start`` holds none."""
    m = start[which].get(name) if start else None
    return p.new_zeros(p.shape) if m is None else m.to(p).clone()


def kind(opt: dict):
    name = opt["kind"]
    if not _NAME.match(name):
        raise ValueError(f"not an optimizer kind: {name!r}")
    return importlib.import_module(f"{__name__}.{name}")


def optimizer(opt: dict, params: dict, start: dict | None = None):
    return kind(opt).Optimizer(opt, params, start)

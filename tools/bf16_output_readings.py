#!/usr/bin/env python3
"""The readings behind the output bars of ``tests/test_torch_bf16.py``.

    JAX_PLATFORMS=cpu python3 tools/bf16_output_readings.py

For each model family, at the test's narrow sizes and from its perturbed
flax variables and seeded input (eval mode), per head, in units of
``d_ref`` (the JAX bf16 model's max |delta| from the JAX float32 model):
the port's bf16 output against JAX's eager bf16 output (``port``), the
port's bf16 against its float32 output (``port_vs_f32``), and JAX's jitted
bf16 program against its eager one (``jax_jit``).  The test holds ``port``
to 1 (Doukhan-MTL: 2) and ``port_vs_f32`` to 2.  Prints one JSON line.

CPU only; imports both packages and the test module's helpers.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

import jax
import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _test_module():
    spec = importlib.util.spec_from_file_location(
        "test_torch_bf16", ROOT / "tests" / "test_torch_bf16.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def readings(t, name: str) -> dict:
    x, v, j32, j16, nets = t._models(name)
    with jax.disable_jit():
        want = t._heads(j16.apply(v, t._jnp(x), train=False))
        want32 = t._heads(j32.apply(v, t._jnp(x), train=False))
    jit16 = t._heads(jax.jit(lambda v, x: j16.apply(v, x, train=False))(
        v, t._jnp(x)))
    with torch.no_grad():
        got = t._heads(nets[t.BF16](t._t(x)))
        got32 = t._heads(nets[None](t._t(x)))
    out = {}
    for k in want:
        w16 = np.asarray(want[k])
        d_ref = float(np.abs(w16 - np.asarray(want32[k])).max())

        def dist(a, b=w16):
            return float(np.abs(np.asarray(a) - b).max()) / d_ref

        out[k] = {"d_ref": d_ref, "port": dist(got[k].numpy()),
                  "port_vs_f32": dist(got[k].numpy(), got32[k].numpy()),
                  "jax_jit": dist(jit16[k])}
    return out


def main() -> None:
    t = _test_module()
    print(json.dumps({name: readings(t, name) for name in t.FAMILIES}))


if __name__ == "__main__":
    main()

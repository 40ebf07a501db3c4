#!/usr/bin/env python3
"""Why the port's CPU tests hold the image CNNs' train steps in float64 and
against the JAX step run eagerly (``tests/test_torch_train.py``).

    JAX_PLATFORMS=cpu python3 tools/cnn_step_precision.py

Prints one JSON line with, for Papakostas-MTL (48 x 48 inputs), Doukhan-MTL
(40 x 68) and Jang-MTL (514 x 16, 24 mel bands) at batch 6 in train mode,
from one seeded flax init carried into the port:

- ``f32_vs_f64``: the largest difference of each head's output between the
  port's float32 and float64 forward passes (the rounding that the chain
  of train-mode BatchNorms amplifies);
- ``bias_grad``: the gradient of the loss (the 3C cross-entropy) with
  respect to the last conv bias before a train-mode BatchNorm (Doukhan's
  c4, Jang's b3), which is 0 in exact arithmetic: the port's, JAX's run
  eagerly, JAX's under ``jax.jit`` (XLA:CPU), each as the largest
  magnitude over the bias, and the loss's change under a finite
  difference of 1e-3 in every element of it (jitted).

CPU only; imports both packages.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402


class _NoDropout(fnn.Module):
    rate: float = 0.0
    deterministic: bool | None = None

    @fnn.compact
    def __call__(self, x, deterministic=None, rng=None):
        return x


CASES = {"Papakostas_et_al_MTL": ((6, 48, 48, 1), {}, None),
         "Doukhan_et_al_MTL": ((6, 40, 68, 1), {}, ("c4", "conv")),
         "Jang_et_al_MTL": ((6, 514, 16, 1), {"n_mels": 24},
                            ("b3", "conv"))}


def main() -> dict:
    fnn.Dropout = _NoDropout          # both sides deterministic
    from sm_hpss_mtl_tpu.models import get_model as jget_model
    from sm_hpss_mtl_tpu.train.losses import categorical_crossentropy
    from sm_hpss_mtl_tpu_torch import weights
    from sm_hpss_mtl_tpu_torch.models import layers
    from sm_hpss_mtl_tpu_torch.models.zoo import get_model
    out = {}
    for name, (shape, kw, bias_at) in CASES.items():
        module = jget_model(name, **kw).module
        v = jax.jit(lambda k: module.init(
            {"params": k, "dropout": k + 1}, jnp.zeros((1,) + shape[1:]),
            train=False))(jax.random.PRNGKey(4))
        v = jax.tree_util.tree_map(np.asarray, dict(v))
        rng = np.random.default_rng(12)
        x = rng.standard_normal(shape).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[np.repeat(np.arange(3), 2)]
        heads = {}
        for dtype in (torch.float32, torch.float64):
            net = get_model(name, in_dim=shape[1], patch_size=shape[2], **kw)
            net.load_state_dict(weights.from_flax(v))
            for m in net.modules():
                if isinstance(m, layers.Dropout):
                    m.rate = 0.0
            net = net.to(dtype).train()
            o = net(torch.from_numpy(x).to(dtype))
            heads[dtype] = {k: t.detach().double().numpy()
                            for k, t in o.items()}
            if dtype == torch.float32 and bias_at:
                loss = -(torch.from_numpy(y) * o["3C"].clamp(1e-7, 1).log()
                         ).sum(-1).mean()
                loss.backward()
                port_grad = float(net.get_submodule(
                    ".".join(bias_at)).bias.grad.abs().max())
        res = {"f32_vs_f64": {k: float(np.abs(heads[torch.float32][k]
                                              - heads[torch.float64][k]).max())
                              for k in heads[torch.float64]}}
        if bias_at:
            def loss(p):
                o, _ = module.apply(
                    {"params": p, "batch_stats": v["batch_stats"]},
                    jnp.asarray(x), train=True, mutable=["batch_stats"])
                return categorical_crossentropy(o["3C"], jnp.asarray(y))

            def grad_of(g):
                for key in bias_at:
                    g = g[key]
                return float(np.abs(np.asarray(g["bias"])).max())

            def shifted(p, d):
                p = jax.tree_util.tree_map(lambda a: a, p)
                node = p
                for key in bias_at:
                    node[key] = dict(node[key])
                    node = node[key]
                node["bias"] = node["bias"] + d
                return loss(p)

            params = jax.tree_util.tree_map(jnp.asarray, v["params"])
            f = jax.jit(shifted)
            res["bias_grad"] = {
                "bias": "/".join(bias_at),
                "port": port_grad,
                "jax_eager": grad_of(jax.grad(loss)(params)),
                "jax_jit": grad_of(jax.jit(jax.grad(loss))(params)),
                "loss_change_under_1e-3": abs(float(f(params, 1e-3))
                                              - float(f(params, 0.0)))}
        out[name] = res
    return out


if __name__ == "__main__":
    print(json.dumps(main()))

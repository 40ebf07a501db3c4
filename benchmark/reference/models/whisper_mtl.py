"""Whisper-MTL: Whisper large-v3's audio encoder (arXiv:2212.04356) over
standardized ``[H; P]`` contexts ``(N, D, L)``, with the S/M/R/3C heads at
every position.  Written out from the published equations: a GELU'd
stride-1 then stride-2 convolution, Whisper's sinusoid table, pre-
LayerNorm blocks of bidirectional attention (``softmax(q kᵀ / sqrt(64))
v`` as explicit products, no bias on k) and an erf-GELU MLP, a final
LayerNorm, then the heads.  Attention runs ``BLOCK`` contexts at a time,
so that the score matrices fit.  Weights are keyed as the program's
``state_dict`` names them."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import layers

#: Contexts whose attention scores are formed at once (20 heads x 1500^2
#: floats, 180 MB a context at large-v3's size).
BLOCK = 2


def layout(contexts: torch.Tensor) -> torch.Tensor:
    """Standardized ``(N, D, L)`` contexts are the model's input as they
    are."""
    return contexts


def l2_names(W: dict) -> list:
    """No kernel takes an l2 penalty: the model is not trained here."""
    return []


def sinusoids(length: int, channels: int, device) -> torch.Tensor:
    """Whisper's table, in float32 on the host as Whisper computes it."""
    inc = math.log(10000.0) / (channels // 2 - 1)
    inv = torch.exp(-inc * torch.arange(channels // 2, dtype=torch.float32,
                                        device="cpu"))
    t = torch.arange(length, dtype=torch.float32, device="cpu")[:, None] \
        * inv[None, :]
    return torch.cat([torch.sin(t), torch.cos(t)], 1).to(device)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def layer_norm(x: torch.Tensor, W: dict, name: str, eps: float
               ) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * W[name + ".weight"] \
        + W[name + ".bias"]


def linear(x: torch.Tensor, W: dict, name: str) -> torch.Tensor:
    y = x @ W[name + ".weight"].t()
    b = W.get(name + ".bias")
    return y if b is None else y + b


def attention(h: torch.Tensor, W: dict, name: str, n_heads: int
              ) -> torch.Tensor:
    N, P, C = h.shape
    d = C // n_heads

    def split(t):
        return t.view(N, P, n_heads, d).transpose(1, 2)   # (N, H, P, d)
    q, k, v = (split(linear(h, W, f"{name}.{p}_proj")) for p in "qkv")
    out = []
    for b in range(0, N, BLOCK):
        s = q[b:b + BLOCK] @ k[b:b + BLOCK].transpose(-1, -2) / math.sqrt(d)
        out.append(torch.softmax(s, dim=-1) @ v[b:b + BLOCK])
    a = torch.cat(out).transpose(1, 2).reshape(N, P, C)
    return linear(a, W, f"{name}.out_proj")


def forward(x: torch.Tensor, W: dict, cfg: dict, draws, train: bool
            ) -> dict:
    """The heads ``(N, L / 2, units)`` over ``(N, D, L)`` contexts."""
    a = cfg["arch"]
    eps = a["layer_norm_eps"]
    x = gelu(F.conv1d(x, W["conv1.weight"], W["conv1.bias"], padding=1))
    x = gelu(F.conv1d(x, W["conv2.weight"], W["conv2.bias"], stride=2,
                      padding=1))
    x = x.transpose(1, 2)
    N, P, C = x.shape
    x = x + sinusoids(P, C, x.device)
    for i in range(a["encoder_layers"]):
        p = f"layers.{i}"
        x = x + attention(layer_norm(x, W, f"{p}.self_attn_layer_norm", eps),
                          W, f"{p}.self_attn", a["encoder_attention_heads"])
        h = layer_norm(x, W, f"{p}.final_layer_norm", eps)
        x = x + linear(gelu(linear(h, W, f"{p}.fc1")), W, f"{p}.fc2")
    x = layer_norm(x, W, "layer_norm", eps)
    heads = layers.mtl_heads(x.reshape(N * P, C), W, draws, train)
    return {k: v.reshape(N, P, -1) for k, v in heads.items()}

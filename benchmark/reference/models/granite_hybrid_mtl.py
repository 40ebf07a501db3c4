"""Granite-Hybrid-MTL: granite-4.0-h-micro's hybrid trunk
(``ibm-granite/granite-4.0-h-micro`` ``config.json``; Mamba-2: Dao and Gu,
arXiv:2405.21060) over standardized ``[H; P]`` frames ``(N, D, F)``, with
the S/M/R/3C heads at every position.  One causal pass over whole
sequences, written out from the published equations, with no state, cache
or slots:

- a stem of two convolutions, k 3, the first over the input left-padded by
  2 frames, the second at stride 2 over the first's GELU left-padded by 1
  (position p sees frames up to 2p + 1), its GELU times
  ``embedding_multiplier``;
- per layer ``h += r * mixer(RMSNorm(h))``, ``h += r * W_out(silu(g) u)``,
  ``[g, u] = W_in(RMSNorm(h))``, ``r`` the ``residual_multiplier``;
- Mamba-2: ``[z | xBC | dt] = in_proj(h)``, ``xBC = silu(conv1d(xBC))``
  (depthwise, k 4, causal), split into x, B, C; ``dt = softplus(dt +
  dt_bias)``, ``A = -exp(A_log)``; the SSD in the minimal chunked form of
  the Mamba-2 paper (``ssd_minimal_discrete``: plain einsums over chunks of
  ``mamba_chunk_size`` positions from the sequence's first, the
  chunk-to-chunk recurrence of their states) plus ``D x``; then
  ``out_proj(RMSNorm(y * silu(z)))``;
- attention: 32 query heads over 8 key and value heads (each serving 4),
  no bias, no positions, ``softmax(q kᵀ * attention_multiplier)`` with a
  causal mask, as explicit products over ``QUERY_BLOCK`` queries at a time;
- a final RMSNorm, then the heads.

Weights are keyed as the program's ``state_dict`` names them.
:func:`init_leaf` gives the scan's parameters Mamba-2's published
initialisation, so that some heads remember over hundreds of positions.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import layers

#: Queries whose attention scores are formed at once (32 heads x 256 x
#: 60 000 keys, 2 GB at a 20-minute broadcast).
QUERY_BLOCK = 256
#: Chunks of the SSD whose intra-chunk terms are formed at once (64 heads
#: x 16 x 256 x 256 floats, 268 MB).
CHUNK_BLOCK = 16
#: Mamba-2's initialisation: A uniform in [1, 16], dt log-uniform in
#: [1e-3, 0.1] (inverted through the softplus into dt_bias), D = 1.
A_RANGE = (1.0, 16.0)
DT_RANGE = (1e-3, 0.1)


def layout(x: torch.Tensor) -> torch.Tensor:
    """Standardized ``(N, D, F)`` frames are the model's input as they
    are."""
    return x


def l2_names(W: dict) -> list:
    """No kernel takes an l2 penalty: the model is not trained here."""
    return []


def init_leaf(name: str, u: torch.Tensor, cfg: dict):
    """``A_log``, ``dt_bias`` and ``D`` of every mixer from uniform draws
    ``u``; None for every other leaf (the benchmark's default rule)."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "A_log":
        return torch.log(A_RANGE[0] + (A_RANGE[1] - A_RANGE[0]) * u)
    if leaf == "dt_bias":
        lo, hi = (math.log(v) for v in DT_RANGE)
        dt = torch.exp(lo + (hi - lo) * u)
        return dt + torch.log(-torch.expm1(-dt))        # softplus⁻¹(dt)
    if leaf == "D":
        return torch.ones_like(u)
    return None


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def linear(x: torch.Tensor, W: dict, name: str) -> torch.Tensor:
    return x @ W[name + ".weight"].t()


def segsum(a: torch.Tensor) -> torch.Tensor:
    """``out[..., t, s] = sum(a[..., s + 1 : t + 1])`` for s <= t, -inf
    above the diagonal (the paper's ``segsum``)."""
    T = a.shape[-1]
    ones = torch.ones(T, T, dtype=torch.bool, device=a.device)
    x = a[..., None].expand(*a.shape, T)
    x = x.masked_fill(~torch.tril(ones, -1), 0).cumsum(-2)
    return x.masked_fill(~torch.tril(ones), -torch.inf)


def ssd(x: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, chunk: int, state: torch.Tensor | None = None):
    """The minimal chunked SSD: ``x`` ``(b, T, h, p)`` (already times dt),
    ``a`` ``(b, T, h)`` (dt times A), ``B``, ``C`` ``(b, T, n)``.  Returns
    ``y`` ``(b, T, h, p)`` (without ``D x``) and the final state ``(b, h,
    p, n)``; ``T`` is padded to whole chunks with zeros, which add
    nothing."""
    b, T, h, p = x.shape
    pad = -T % chunk
    if pad:
        x, B, C = (F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
                   for t in (x, B, C))
        a = F.pad(a, (0, 0, 0, pad))
    c = x.shape[1] // chunk
    x = x.view(b, c, chunk, h, p)
    B = B.view(b, c, chunk, -1)
    C = C.view(b, c, chunk, -1)
    a = a.view(b, c, chunk, h).permute(0, 3, 1, 2)          # (b, h, c, l)
    a_cum = a.cumsum(-1)
    # 1. Inside each chunk (the diagonal blocks), CHUNK_BLOCK chunks at once.
    y = torch.empty_like(x)
    for k in range(0, c, CHUNK_BLOCK):
        s = slice(k, k + CHUNK_BLOCK)
        Lm = torch.exp(segsum(a[:, :, s]))                  # (b, h, c, l, l)
        y[:, s] = torch.einsum("bcln,bcsn,bhcls,bcshp->bclhp",
                               C[:, s], B[:, s], Lm, x[:, s])
    # 2. Each chunk's state from its own inputs.
    decay = torch.exp(a_cum[..., -1:] - a_cum)               # (b, h, c, l)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", B, decay, x)
    # 3. The states carried from chunk to chunk.
    if state is None:
        state = torch.zeros_like(states[:, :1])
    else:
        state = state[:, None]
    states = torch.cat([state, states], dim=1)
    chunk_decay = torch.exp(segsum(F.pad(a_cum[..., -1], (1, 0))))
    states = torch.einsum("bhzc,bchpn->bzhpn", chunk_decay, states)
    states, final = states[:, :-1], states[:, -1]
    # 4. Each chunk's carried state to its outputs.
    y = y + torch.einsum("bcln,bchpn,bhcl->bclhp", C, states,
                         torch.exp(a_cum))
    return y.reshape(b, c * chunk, h, p)[:, :T], final


def mamba(h: torch.Tensor, W: dict, name: str, cfg: dict) -> torch.Tensor:
    n, T, _ = h.shape
    H, P = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    N, inner = cfg["mamba_d_state"], cfg["mamba_n_heads"] * \
        cfg["mamba_d_head"]
    z, xbc, dt = linear(h, W, f"{name}.in_proj").split(
        [inner, inner + 2 * N, H], dim=-1)
    k = W[f"{name}.conv1d.weight"].shape[-1]
    xbc = F.conv1d(xbc.transpose(1, 2), W[f"{name}.conv1d.weight"],
                   W[f"{name}.conv1d.bias"], padding=k - 1,
                   groups=xbc.shape[-1])[..., :T].transpose(1, 2)
    x, B, C = F.silu(xbc).split([inner, N, N], dim=-1)
    dt = F.softplus(dt + W[f"{name}.dt_bias"])
    A = -torch.exp(W[f"{name}.A_log"])
    x = x.reshape(n, T, H, P)
    y, _ = ssd(x * dt[..., None], dt * A, B, C, cfg["mamba_chunk_size"])
    y = y + W[f"{name}.D"][:, None] * x
    y = y.reshape(n, T, inner) * F.silu(z)
    y = rms_norm(y, W[f"{name}.norm.weight"], cfg["rms_norm_eps"])
    return linear(y, W, f"{name}.out_proj")


def attention(h: torch.Tensor, W: dict, name: str, cfg: dict
              ) -> torch.Tensor:
    n, T, C = h.shape
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    d = C // H
    q = linear(h, W, f"{name}.q_proj").view(n, T, KV, H // KV, d) \
        .permute(0, 2, 3, 1, 4)                       # (n, KV, rep, T, d)
    k = linear(h, W, f"{name}.k_proj").view(n, T, KV, d).transpose(1, 2)
    v = linear(h, W, f"{name}.v_proj").view(n, T, KV, d).transpose(1, 2)
    out = torch.empty_like(q)
    keys = torch.arange(T, device=h.device)
    for s in range(0, T, QUERY_BLOCK):
        e = min(T, s + QUERY_BLOCK)
        scores = q[..., s:e, :] @ k[:, :, None, :e].transpose(-1, -2) \
            * cfg["attention_multiplier"]             # (n, KV, rep, q, e)
        later = keys[None, :e] > torch.arange(s, e, device=h.device)[:, None]
        scores = scores.masked_fill(later, -torch.inf)
        out[..., s:e, :] = torch.softmax(scores, dim=-1) @ v[:, :, None, :e]
    out = out.permute(0, 3, 1, 2, 4).reshape(n, T, C)
    return linear(out, W, f"{name}.o_proj")


def forward(x: torch.Tensor, W: dict, cfg: dict, draws, train: bool
            ) -> dict:
    """The heads ``(N, F / 2, units)`` over ``(N, D, F)`` frames, one
    causal pass."""
    eps, r = cfg["rms_norm_eps"], cfg["residual_multiplier"]
    h = F.gelu(F.conv1d(F.pad(x, (2, 0)), W["conv1.weight"],
                        W["conv1.bias"]))
    h = F.gelu(F.conv1d(F.pad(h, (1, 0)), W["conv2.weight"],
                        W["conv2.bias"], stride=2))
    h = h.transpose(1, 2) * cfg["embedding_multiplier"]
    for i, kind in enumerate(cfg["layer_types"]):
        p = f"layers.{i}"
        u = rms_norm(h, W[f"{p}.input_layernorm.weight"], eps)
        u = (mamba(u, W, f"{p}.mamba", cfg) if kind == "mamba"
             else attention(u, W, f"{p}.self_attn", cfg))
        h = h + u * r
        u = rms_norm(h, W[f"{p}.post_attention_layernorm.weight"], eps)
        g, u = linear(u, W, f"{p}.shared_mlp.input_linear").chunk(2, dim=-1)
        h = h + linear(F.silu(g) * u, W, f"{p}.shared_mlp.output_linear") * r
    h = rms_norm(h, W["norm.weight"], eps)
    N, P, C = h.shape
    heads = layers.mtl_heads(h.reshape(N * P, C), W, draws, train)
    return {k: v.reshape(N, P, -1) for k, v in heads.items()}

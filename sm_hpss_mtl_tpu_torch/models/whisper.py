"""Whisper's audio encoder as a trunk of the zoo: ``Whisper_MTL``.

The encoder of Whisper large-v3 (Radford et al., arXiv:2212.04356;
``openai/whisper-large-v3`` ``config.json``) over the system's HPSS
log-mels, with the MTL heads (S, M, R, 3C) applied at every position in
place of Whisper's decoder.  One input is a 30-s context: ``(B, D, L)``
standardized ``[H; P]`` rows, time last, ``L = 2 * max_source_positions``
frames at a 10 ms hop; the stride-2 stem leaves ``L / 2`` positions::

    x = gelu(conv1(x))                      # k 3, stride 1, pad 1: D -> C
    x = gelu(conv2(x))                      # k 3, stride 2, pad 1: C -> C
    x = x.transpose(1, 2) + sinusoids(L / 2, C)
    for each layer:                         # pre-LayerNorm, eps 1e-5
        x = x + attention(LN1(x))           # bidirectional, no mask
        x = x + fc2(gelu(fc1(LN2(x))))      # C -> 4C -> C
    x = LN_post(x)
    heads = MTLHeads(C)(x) per position     # each (B, L / 2, units)

Module names follow the published encoder's (``conv1``, ``layers.<i>.
self_attn.q_proj``, ``self_attn_layer_norm``, ``fc1``, ``final_layer_norm``,
``layer_norm``); the key projection has no bias, as published.  GELU is the
exact (erf) one.  The sinusoid table is Whisper's and no parameter: a
buffer left out of ``state_dict``.  Attention is
``F.scaled_dot_product_attention``; everything computes in float32 (a
lower precision is refused where the zoo builds the model).

The departures from the published model: the first convolution takes the
harmonic and percussive halves stacked (``2 * n_mels`` rows, 256 at 128
bands), the features are the system's (its mel bank, dB with an 80 dB
floor, per-row standardization), and the heads replace the decoder.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .heads import MTLHeads

LAYER_NORM_EPS = 1e-5


def sinusoids(length: int, channels: int, max_timescale: float = 10000.0
              ) -> torch.Tensor:
    """Whisper's position table ``(length, channels)``: sines then cosines
    of ``t * exp(-inc * i)``, ``inc = log(max_timescale) / (C/2 - 1)``, in
    float32 as Whisper computes it, on the host (a device's ``exp`` may
    differ in the last bit, which ``t`` up to 1500 turns into 1e-4)."""
    if channels % 2:
        raise ValueError(f"channels must be even, got {channels}")
    inc = math.log(max_timescale) / (channels // 2 - 1)
    inv = torch.exp(-inc * torch.arange(channels // 2, dtype=torch.float32,
                                        device="cpu"))
    t = torch.arange(length, dtype=torch.float32, device="cpu")[:, None] \
        * inv[None, :]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1)


class SelfAttention(nn.Module):
    """Bidirectional multi-head self-attention, softmax(q kᵀ / √d) v."""

    def __init__(self, d_model: int, n_heads: int):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"{n_heads} heads do not divide {d_model}")
        self.n_heads = n_heads
        self.q_proj = nn.Linear(d_model, d_model)
        self.k_proj = nn.Linear(d_model, d_model, bias=False)
        self.v_proj = nn.Linear(d_model, d_model)
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, L, C = x.shape

        def heads(t):
            return t.view(B, L, self.n_heads, C // self.n_heads) \
                .transpose(1, 2)
        a = F.scaled_dot_product_attention(heads(self.q_proj(x)),
                                           heads(self.k_proj(x)),
                                           heads(self.v_proj(x)))
        return self.out_proj(a.transpose(1, 2).reshape(B, L, C))


class EncoderLayer(nn.Module):
    """Pre-LayerNorm attention and MLP blocks, each added to the stream."""

    def __init__(self, d_model: int, n_heads: int, ffn_dim: int):
        super().__init__()
        self.self_attn_layer_norm = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)
        self.self_attn = SelfAttention(d_model, n_heads)
        self.final_layer_norm = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)
        self.fc1 = nn.Linear(d_model, ffn_dim)
        self.fc2 = nn.Linear(ffn_dim, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.self_attn_layer_norm(x))
        return x + self.fc2(F.gelu(self.fc1(self.final_layer_norm(x))))


class WhisperMTL(nn.Module):
    """The encoder over ``(B, in_dim, 2 * max_source_positions)`` contexts,
    with per-position MTL heads: a dict of ``(B, max_source_positions,
    units)`` tensors in the order S, M, R, 3C.  The widths default to
    large-v3's; ``context_frames`` is the input length it takes."""

    def __init__(self, in_dim: int, *, n_classes: int = 3,
                 head_width: int = 16, d_model: int = 1280,
                 encoder_layers: int = 32, encoder_attention_heads: int = 20,
                 encoder_ffn_dim: int = 5120,
                 max_source_positions: int = 1500):
        super().__init__()
        self.context_frames = 2 * max_source_positions
        self.conv1 = nn.Conv1d(in_dim, d_model, 3, padding=1)
        self.conv2 = nn.Conv1d(d_model, d_model, 3, stride=2, padding=1)
        self.register_buffer(
            "positions", sinusoids(max_source_positions, d_model),
            persistent=False)
        self.layers = nn.ModuleList(
            EncoderLayer(d_model, encoder_attention_heads, encoder_ffn_dim)
            for _ in range(encoder_layers))
        self.layer_norm = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)
        self.heads = MTLHeads(d_model, n_classes, head_width)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        if x.shape[-1] != self.context_frames:
            raise ValueError(f"a context is {self.context_frames} frames, "
                             f"got {x.shape[-1]}")
        x = F.gelu(self.conv1(x))
        x = F.gelu(self.conv2(x))
        x = x.transpose(1, 2) + self.positions
        for layer in self.layers:
            x = layer(x)
        x = self.layer_norm(x)
        B, P, C = x.shape
        return {k: v.reshape(B, P, -1)
                for k, v in self.heads(x.reshape(B * P, C)).items()}

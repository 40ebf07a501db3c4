"""Granite-4.0-H-Micro's hybrid trunk as a causal stream model of the zoo:
``Granite_Hybrid_MTL``.

The decoder of IBM's ``granite-4.0-h-micro`` (``config.json``,
``model_type`` ``granitemoehybrid``): 40 layers, 36 Mamba-2 mixers and 4
grouped-query attention layers (``layer_types``), each followed by a SwiGLU
MLP, over the system's HPSS log-mels, with the MTL heads (S, M, R, 3C) at
every position in place of the language-model head.  The trunk is causal,
so a broadcast is read once, chunk by chunk, each chunk's model call
carrying every layer's memory to the next (:class:`StreamState`)::

    x = gelu(conv1(pad_left(x, 2)))           # k 3: D -> C, frame f sees f-2..f
    x = gelu(conv2(pad_left(x, 1)))           # k 3, stride 2: position p
    h = 12 * x                                # sees frames up to 2p + 1
    for each layer:                           # RMSNorm eps 1e-5
        h = h + 0.22 * mixer(RMSNorm(h))      # Mamba-2 or attention
        h = h + 0.22 * W_out(silu(g) * u),  [g, u] = W_in(RMSNorm(h))
    heads = MTLHeads(C)(RMSNorm(h)) per position

Mamba-2 mixer: ``[z | xBC | dt] = in_proj(h)`` (4096, 4352, 64 wide),
``xBC = silu(causal depthwise conv4(xBC) + b)`` split into x (64 heads of
64), B and C (128 each, one group), ``dt = softplus(dt + dt_bias)``,
``A = -exp(A_log)``, the scan ``S_t = exp(dt_t A) S_{t-1} + dt_t x_t
B_tᵀ``, ``y_t = S_t C_t + D x_t`` (``ops/ssd_scan.py``: the kernel
``csrc/ssd_scan.cu`` on the card), then ``out_proj(RMSNorm(y * silu(z)))``
over all 4096 (``n_groups`` 1).  Attention: 32 query heads and 8 key and
value heads of 64, no bias, no position embedding, softmax scale
``attention_multiplier`` (1/64), causal over the slot's carried keys and
values and then the chunk's (``F.scaled_dot_product_attention`` with a
lower-right causal bias).  Module names follow the published checkpoint's
(``layers.<i>.mamba.in_proj``, ``.conv1d``, ``.A_log``, ``.D``,
``.dt_bias``, ``.norm``, ``.out_proj``; ``layers.<i>.self_attn.q_proj``
...; ``shared_mlp.input_linear`` / ``output_linear``; ``input_layernorm``,
``post_attention_layernorm``; ``norm``).  Everything computes in float32
(a lower precision is refused where the zoo builds the model).

The departures from the published model: a causal stride-2 stem over the
stacked harmonic and percussive log-mels (Whisper-MTL's shape, made causal)
in place of the token embedding, still multiplied by
``embedding_multiplier``; the heads in place of the tied language-model
head, so ``logits_scaling`` goes unused.

``forward(x, state)`` takes a batch of chunks ``(slots, D, F)`` (``F``
even; the segmenter's is :attr:`~GraniteHybridMTL.context_frames`) and a
:class:`StreamState` of as many slots, returns each head per position
``(slots, F / 2, units)`` and advances the state.  Slots may have carried
different numbers of positions; the projections, MLPs and the scan run
batched over the slots, attention per slot over its own keys.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention.bias import causal_lower_right

from ..ops.ssd_scan import ssd_scan
from ..utils.profiling import span
from .heads import MTLHeads

#: Granite-4.0-H-Micro's ``layer_types``: attention at 5, 15, 25 and 35.
LAYER_TYPES = tuple("attention" if i % 10 == 5 else "mamba"
                    for i in range(40))


class RMSNorm(nn.Module):
    """``weight * x / sqrt(mean(x²) + eps)`` over the last axis."""

    def __init__(self, width: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.weight * (x * torch.rsqrt(
            x.pow(2).mean(-1, keepdim=True) + self.eps))


class GatedRMSNorm(RMSNorm):
    """:class:`RMSNorm` of ``x * silu(gate)`` (Mamba-2's, one group)."""

    def forward(self, x: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
        return super().forward(x * F.silu(gate))


class Mamba2Mixer(nn.Module):
    """Mamba-2's mixer over a chunk, from and into the slots' carried conv
    tails ``(slots, d_conv - 1, conv_dim)`` and scan states ``(slots, H,
    P, N)``."""

    def __init__(self, width: int, n_heads: int, head_dim: int,
                 d_state: int, d_conv: int, eps: float):
        super().__init__()
        self.n_heads, self.head_dim, self.d_state = n_heads, head_dim, \
            d_state
        self.d_inner = n_heads * head_dim
        self.conv_dim = self.d_inner + 2 * d_state
        self.in_proj = nn.Linear(width, self.d_inner + self.conv_dim
                                 + n_heads, bias=False)
        self.conv1d = nn.Conv1d(self.conv_dim, self.conv_dim, d_conv,
                                groups=self.conv_dim)
        self.A_log = nn.Parameter(torch.zeros(n_heads))
        self.D = nn.Parameter(torch.ones(n_heads))
        self.dt_bias = nn.Parameter(torch.ones(n_heads))
        self.norm = GatedRMSNorm(self.d_inner, eps)
        self.out_proj = nn.Linear(self.d_inner, width, bias=False)

    def forward(self, h: torch.Tensor, conv_tail: torch.Tensor,
                ssm: torch.Tensor) -> torch.Tensor:
        slots, L, _ = h.shape
        z, xbc, dt = self.in_proj(h).split(
            [self.d_inner, self.conv_dim, self.n_heads], dim=-1)
        full = torch.cat([conv_tail, xbc], dim=1)     # (slots, k - 1 + L, .)
        conv_tail.copy_(full[:, L:])
        w = self.conv1d.weight[:, 0]                  # (conv_dim, k)
        acc = self.conv1d.bias + full[:, :L] * w[:, 0]
        for k in range(1, w.shape[1]):
            acc.addcmul_(full[:, k:k + L], w[:, k])
        x, B, C = F.silu(acc).split(
            [self.d_inner, self.d_state, self.d_state], dim=-1)
        dt = F.softplus(dt + self.dt_bias)
        y, state = ssd_scan(x.view(slots, L, self.n_heads, self.head_dim),
                            dt, -torch.exp(self.A_log), B, C, self.D, ssm)
        ssm.copy_(state)
        return self.out_proj(self.norm(y.view(slots, L, self.d_inner), z))


class GQAttention(nn.Module):
    """Causal grouped-query attention with no bias and no positions, over a
    slot's carried keys and values, then the chunk's."""

    def __init__(self, width: int, n_heads: int, n_kv_heads: int,
                 scale: float):
        super().__init__()
        if width % n_heads or n_heads % n_kv_heads:
            raise ValueError(f"{n_heads} heads, {n_kv_heads} key heads and "
                             f"width {width} do not divide")
        self.n_heads, self.n_kv_heads = n_heads, n_kv_heads
        self.head_dim = width // n_heads
        self.scale = scale
        kv = n_kv_heads * self.head_dim
        self.q_proj = nn.Linear(width, width, bias=False)
        self.k_proj = nn.Linear(width, kv, bias=False)
        self.v_proj = nn.Linear(width, kv, bias=False)
        self.o_proj = nn.Linear(width, width, bias=False)

    def forward(self, h: torch.Tensor, state: "StreamState",
                index: int) -> torch.Tensor:
        slots, L, width = h.shape
        d, rep = self.head_dim, self.n_heads // self.n_kv_heads
        q = self.q_proj(h).view(slots, L, self.n_heads, d).transpose(1, 2)
        k = self.k_proj(h).view(slots, L, self.n_kv_heads, d).transpose(1, 2)
        v = self.v_proj(h).view(slots, L, self.n_kv_heads, d).transpose(1, 2)
        out = torch.empty_like(q)
        for s in range(slots):
            keys, values = state.append_kv(index, s, k[s], v[s])
            S = keys.shape[1]
            out[s] = F.scaled_dot_product_attention(
                q[s:s + 1], keys.repeat_interleave(rep, 0)[None],
                values.repeat_interleave(rep, 0)[None],
                attn_mask=causal_lower_right(L, S), scale=self.scale)[0]
        return self.o_proj(out.transpose(1, 2).reshape(slots, L, width))


class SharedMLP(nn.Module):
    """SwiGLU: ``output_linear(silu(g) * u)``, ``[g, u] = input_linear(h)``."""

    def __init__(self, width: int, hidden: int):
        super().__init__()
        self.input_linear = nn.Linear(width, 2 * hidden, bias=False)
        self.output_linear = nn.Linear(hidden, width, bias=False)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        g, u = self.input_linear(h).chunk(2, dim=-1)
        return self.output_linear(F.silu(g) * u)


class HybridLayer(nn.Module):
    """A pre-norm mixer (Mamba-2 or attention) and a pre-norm MLP, each
    added to the stream times ``residual_multiplier``."""

    def __init__(self, kind: str, width: int, mlp: int, eps: float,
                 residual: float, mamba: dict, attention: dict):
        super().__init__()
        self.kind, self.residual = kind, residual
        self.input_layernorm = RMSNorm(width, eps)
        if kind == "mamba":
            self.mamba = Mamba2Mixer(width, eps=eps, **mamba)
        elif kind == "attention":
            self.self_attn = GQAttention(width, **attention)
        else:
            raise ValueError(f"unknown layer type {kind!r}")
        self.post_attention_layernorm = RMSNorm(width, eps)
        self.shared_mlp = SharedMLP(width, mlp)

    def forward(self, h: torch.Tensor, state: "StreamState",
                index: int) -> torch.Tensor:
        x = self.input_layernorm(h)
        if self.kind == "mamba":
            x = self.mamba(x, state.conv[index], state.ssm[index])
        else:
            x = self.self_attn(x, state, index)
        h = h + x * self.residual
        return h + self.shared_mlp(self.post_attention_layernorm(h)) \
            * self.residual


class StreamState:
    """What the trunk carries from one chunk of a slot's stream to the next,
    for ``slots`` streams side by side:

    - ``stem_in`` ``(slots, D, 2)``, ``stem_mid`` ``(slots, C, 1)``: the
      last two input frames and the last first-convolution frame;
    - ``conv`` ``(mamba layers, slots, d_conv - 1, conv_dim)`` and ``ssm``
      ``(mamba layers, slots, H, P, N)``: each Mamba-2 mixer's conv tail and
      scan state;
    - per slot and attention layer a key and a value buffer ``(KV heads,
      capacity, head_dim)``, made at the slot's first append and at least
      doubled whenever a chunk outruns it (kept across resets), and per
      slot :attr:`lengths`, the positions it has carried (its buffers'
      filled length).

    :meth:`reset` starts a slot's stream anew; the model's call appends its
    keys and values (:meth:`append_kv`) and then :meth:`advance` s every
    slot.  The bookkeeping (resets, appends) is the span
    ``segment.carry``."""

    def __init__(self, model: "GraniteHybridMTL", slots: int,
                 device=None):
        with torch.inference_mode(False):
            zeros = lambda *shape: torch.zeros(  # noqa: E731
                shape, dtype=torch.float32, device=device)
            m = model.mamba_shape
            self.stem_in = zeros(slots, model.conv1.in_channels, 2)
            self.stem_mid = zeros(slots, model.conv2.in_channels, 1)
            self.conv = zeros(model.n_mamba, slots, m["d_conv"] - 1,
                              m["conv_dim"])
            self.ssm = zeros(model.n_mamba, slots, m["n_heads"],
                             m["head_dim"], m["d_state"])
        self.device = self.ssm.device
        self.kv_shape = model.kv_shape
        self.n_attention = model.n_attention
        self.kv: list[list] = [[None] * model.n_attention
                               for _ in range(slots)]
        self.lengths = [0] * slots

    @property
    def slots(self) -> int:
        return len(self.lengths)

    def reset(self, slot: int) -> None:
        """Start ``slot``'s stream anew: zero its carried state and empty its
        keys and values (their buffers are kept for the slot's next
        stream)."""
        with span("segment.carry"), torch.inference_mode(False):
            for t in (self.stem_in, self.stem_mid):
                t[slot].zero_()
            self.conv[:, slot].zero_()
            self.ssm[:, slot].zero_()
            self.lengths[slot] = 0

    def _buffers(self, capacity: int) -> tuple:
        heads, d = self.kv_shape
        with torch.inference_mode(False):
            return tuple(torch.empty((heads, capacity, d),
                                     dtype=torch.float32, device=self.device)
                         for _ in range(2))

    def append_kv(self, index: int, slot: int, k: torch.Tensor,
                  v: torch.Tensor) -> tuple:
        """Write a chunk's keys and values ``(KV heads, L, head_dim)`` after
        the slot's carried ones in attention layer ``index``'s buffers;
        return the buffers' filled ``(KV heads, carried + L, head_dim)``
        views.  Buffers too short for them are replaced by ones of
        ``max(carried + L, 2 carried)`` positions, the carried copied over."""
        with span("segment.carry"):
            past, L = self.lengths[slot], k.shape[1]
            bufs = self.kv[slot][index]
            if bufs is None or bufs[0].shape[1] < past + L:
                grown = self._buffers(max(past + L, 2 * past))
                if bufs is not None:
                    for g, b in zip(grown, bufs):
                        g[:, :past] = b[:, :past]
                self.kv[slot][index] = bufs = grown
            bufs[0][:, past:past + L] = k
            bufs[1][:, past:past + L] = v
            return bufs[0][:, :past + L], bufs[1][:, :past + L]

    def advance(self, positions: int) -> None:
        """Every slot has carried ``positions`` more."""
        self.lengths = [n + positions for n in self.lengths]


class GraniteHybridMTL(nn.Module):
    """The causal hybrid trunk over ``(slots, in_dim, F)`` chunks with the
    MTL heads at every position: a dict of ``(slots, F / 2, units)``
    tensors in the order S, M, R, 3C.  The widths default to
    granite-4.0-h-micro's; :attr:`context_frames` is the chunk the
    segmenter feeds (3000 frames, 30 s)."""

    def __init__(self, in_dim: int, *, n_classes: int = 3,
                 head_width: int = 16, hidden_size: int = 2048,
                 layer_types=LAYER_TYPES, num_attention_heads: int = 32,
                 num_key_value_heads: int = 8,
                 attention_multiplier: float = 0.015625,
                 mamba_n_heads: int = 64, mamba_d_head: int = 64,
                 mamba_d_state: int = 128, mamba_d_conv: int = 4,
                 shared_intermediate_size: int = 8192,
                 residual_multiplier: float = 0.22,
                 embedding_multiplier: float = 12.0,
                 rms_norm_eps: float = 1e-5, context_frames: int = 3000):
        super().__init__()
        if context_frames % 2:
            raise ValueError(f"context_frames must be even, got "
                             f"{context_frames}")
        self.context_frames = context_frames
        self.embedding_multiplier = embedding_multiplier
        mamba = dict(n_heads=mamba_n_heads, head_dim=mamba_d_head,
                     d_state=mamba_d_state, d_conv=mamba_d_conv)
        attention = dict(n_heads=num_attention_heads,
                         n_kv_heads=num_key_value_heads,
                         scale=attention_multiplier)
        self.conv1 = nn.Conv1d(in_dim, hidden_size, 3)
        self.conv2 = nn.Conv1d(hidden_size, hidden_size, 3, stride=2)
        self.layers = nn.ModuleList(
            HybridLayer(kind, hidden_size, shared_intermediate_size,
                        rms_norm_eps, residual_multiplier, mamba, attention)
            for kind in layer_types)
        self.norm = RMSNorm(hidden_size, rms_norm_eps)
        self.heads = MTLHeads(hidden_size, n_classes, head_width)
        # Each layer's index among the layers of its kind, into the state.
        kinds = [layer.kind for layer in self.layers]
        self._index = [kinds[:i].count(k) for i, k in enumerate(kinds)]
        self.n_mamba = kinds.count("mamba")
        self.n_attention = kinds.count("attention")
        self.mamba_shape = dict(
            mamba, conv_dim=mamba_n_heads * mamba_d_head + 2 * mamba_d_state)
        self.kv_shape = (num_key_value_heads,
                         hidden_size // num_attention_heads)

    def new_state(self, slots: int, device=None) -> StreamState:
        """A fresh :class:`StreamState` of ``slots`` streams on ``device``
        (default: the model's)."""
        if device is None:
            device = self.conv1.weight.device
        return StreamState(self, slots, device)

    def forward(self, x: torch.Tensor, state: StreamState
                ) -> dict[str, torch.Tensor]:
        slots, D, frames = x.shape
        if frames % 2 or slots != state.slots:
            raise ValueError(f"chunks of an even number of frames for "
                             f"{state.slots} slots, got {tuple(x.shape)}")
        xin = torch.cat([state.stem_in, x], dim=-1)
        state.stem_in.copy_(xin[..., frames:])
        mid = F.gelu(self.conv1(xin))
        mid = torch.cat([state.stem_mid, mid], dim=-1)
        state.stem_mid.copy_(mid[..., frames:])
        h = F.gelu(self.conv2(mid)).transpose(1, 2).contiguous() \
            * self.embedding_multiplier
        for layer, index in zip(self.layers, self._index):
            h = layer(h, state, index)
        state.advance(h.shape[1])
        h = self.norm(h)
        B, P, C = h.shape
        return {k: v.reshape(B, P, -1)
                for k, v in self.heads(h.reshape(B * P, C)).items()}

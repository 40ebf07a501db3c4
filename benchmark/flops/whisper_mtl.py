"""Whisper-MTL: the encoder's stem, its layers' projections, MLPs and
attention products, and the heads at every position, per context of
``2 * max_source_positions`` frames."""


def attention_flops(cfg: dict) -> int:
    """The attention products of one context, q kᵀ and the weights times
    v, over every layer."""
    a = cfg["arch"]
    P, C = a["max_source_positions"], a["d_model"]
    return a["encoder_layers"] * 2 * 2 * P * P * C


def forward_flops(cfg: dict) -> int:
    a = cfg["arch"]
    P, C, D = a["max_source_positions"], a["d_model"], a["in_dim"]
    F, hw = a["encoder_ffn_dim"], a["head_width"]
    stem = 2 * (2 * P) * C * D * 3 + 2 * P * C * C * 3
    layer = 2 * P * C * C * 4 + 2 * P * C * F * 2
    heads = P * (2 * C * hw * 3 + 2 * hw * (1 + 1 + 2) + 2 * C * 3)
    return stem + a["encoder_layers"] * layer + attention_flops(cfg) + heads

"""Granite-Hybrid-MTL: per position, the causal stem, every layer's
projections, conv and MLP, and the heads; per chunk of positions a slot
feeds one model call, the scan's operations and bytes (chunked as the
published ``mamba_chunk_size``); attention's products and bytes from the
key positions the chunks' queries attend (the program's counter
``segment.kv_positions``, or per slot's chunk its carried and real
positions)."""

from __future__ import annotations


def _dims(cfg: dict) -> dict:
    C, H, P = cfg["hidden_size"], cfg["mamba_n_heads"], cfg["mamba_d_head"]
    N = cfg["mamba_d_state"]
    kinds = cfg["layer_types"]
    return dict(C=C, D=cfg["in_dim"], H=H, P=P, N=N, inner=H * P,
                conv=H * P + 2 * N, k=cfg["mamba_d_conv"],
                I=cfg["shared_intermediate_size"],
                heads=cfg["num_attention_heads"],
                kv=cfg["num_key_value_heads"] * C // cfg["num_attention_heads"],
                d=C // cfg["num_attention_heads"],
                mamba=kinds.count("mamba"), attention=kinds.count("attention"))


def forward_flops(cfg: dict) -> int:
    """Per position: the stem (two frames of the first convolution), every
    layer's products (no attention scores, no scan) and the heads."""
    m = _dims(cfg)
    C, I = m["C"], m["I"]
    stem = 2 * 2 * m["D"] * C * 3 + 2 * C * C * 3
    mlp = 2 * C * 2 * I + 2 * I * C
    mamba = (2 * C * (m["inner"] + m["conv"] + m["H"]) + 2 * m["conv"] * m["k"]
             + 2 * m["inner"] * C)
    attention = 2 * C * C * 2 + 2 * C * m["kv"] * 2
    hw = cfg["head_width"]
    heads = 2 * C * hw * 3 + 2 * hw * (1 + 1 + 2) + 2 * C * 3
    return (stem + m["mamba"] * (mamba + mlp)
            + m["attention"] * (attention + mlp) + heads)


def _chunks(cfg: dict, positions: int) -> list[int]:
    Q = cfg["mamba_chunk_size"]
    return [min(Q, positions - s) for s in range(0, positions, Q)]


def scan_flops(cfg: dict, positions: int) -> int:
    """The chunked scan of one slot's ``positions`` in one Mamba-2 layer:
    per chunk of ``l``, C·B over its lower triangle (shared by the heads),
    and per head the masked inner product, the state's read and the
    state's update."""
    m = _dims(cfg)
    out = 0
    for n in _chunks(cfg, positions):
        tri = n * (n + 1) // 2
        out += 2 * tri * m["N"] + m["H"] * (2 * tri * m["P"]
                                            + 2 * 2 * n * m["P"] * m["N"])
    return out


def scan_bytes(cfg: dict, positions: int) -> int:
    """The scan's least bytes for one slot's ``positions`` in one layer: x,
    B, C and dt read and y written once, the state read and written."""
    m = _dims(cfg)
    return 4 * (positions * (2 * m["inner"] + 2 * m["N"] + m["H"])
                + 2 * m["H"] * m["P"] * m["N"])


def _pair_flops(cfg: dict, pairs: int) -> int:
    """Over every attention layer, ``q kᵀ`` and the weights times ``v`` for
    ``pairs`` (query, key) pairs."""
    m = _dims(cfg)
    return m["attention"] * 2 * 2 * m["heads"] * m["d"] * pairs


def attention_flops(cfg: dict, chunks: int, kv_positions: int,
                    positions: int) -> int:
    """Over every attention layer, the products ``q kᵀ`` and the weights
    times ``v`` of ``chunks`` chunks of ``positions`` queries whose key
    positions (carried and the chunk's) sum to ``kv_positions``: query
    ``i`` of a chunk attends the carried ones and ``i + 1`` of its own."""
    return _pair_flops(cfg, positions * kv_positions
                       - chunks * positions * (positions - 1) // 2)


def attention_flops_fed(cfg: dict, carried: int, queries: int) -> int:
    """As :func:`attention_flops` for the ``queries`` real positions of one
    slot's chunk after ``carried`` positions (a chunk's padding left
    out)."""
    return _pair_flops(cfg, queries * carried + queries * (queries + 1) // 2)


def attention_bytes(cfg: dict, chunks: int, kv_positions: int,
                    positions: int) -> int:
    """Over every attention layer: each chunk's queries read and outputs
    written once, the attended keys and values read once."""
    m = _dims(cfg)
    return m["attention"] * 4 * (chunks * 2 * positions * m["C"]
                                 + kv_positions * 2 * m["kv"])

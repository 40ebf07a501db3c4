"""Jang-MTL: the two mel-scale towers, three 3x3 conv blocks, the dense
layers of 2048 and 1024 and the heads."""


def forward_flops(cfg: dict) -> int:
    a = cfg["arch"]
    W, F = a["patch_size"], 1 + cfg["features"]["n_fft"] // 2
    mels, t, c0 = a["n_mels"], a["t_dim"], a["mel_channels"]
    flops = 2 * (2 * W * mels * c0 * F * t)                    # two towers
    H, cin = 2 * mels, c0
    for cout in a["conv_channels"]:
        flops += 2 * H * W * cout * cin * 9
        H, W, cin = -(-H // 2), -(-W // 2), cout
    width = H * W * cin
    for d in a["dense"]:
        flops += 2 * width * d
        width = d
    hw = a["head_width"]
    return flops + 2 * width * hw * 3 + 2 * hw * (1 + 1 + 2) + 2 * width * 3

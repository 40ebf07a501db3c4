"""Lemaire-MTL: the TCN's convolutions and the heads' dense layers."""


def forward_flops(cfg: dict) -> int:
    a = cfg["arch"]
    W, D, C, k = a["patch_size"], a["in_dim"], a["n_filters"], \
        a["kernel_size"]
    trunk = 2 * W * C * D * k                                  # initial conv
    trunk += a["nb_stacks"] * a["Nd"] * 2 * W * C * C * (k + 1)  # blocks
    flat, hw = W * C, a["head_width"]
    heads = 2 * flat * hw * 3 + 2 * hw * (1 + 1 + 2) + 2 * flat * 3
    return trunk + heads

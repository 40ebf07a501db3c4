"""One training step of the original system, in plain PyTorch: features
of each audio crop, row standardization over the crop, the first ``k``
68-frame patches of each clip (patch ``j`` of clip ``b`` is row ``j*B +
b``, each carrying its clip's labels), Gaussian noise augmentation, the
model in training mode, the Keras losses with the l2 penalty, the
gradient and the optimizer's update (``optimizers/<kind>.py``), from a
fresh optimizer or going on from the state another one reached.

The losses: binary cross-entropy for S and M, mean squared error for R,
categorical cross-entropy for 3C, each a batch mean of probabilities
clipped at 1e-7, summed with weight 1.  The model and its input layout and
l2 kernels are its family's (``models/<family>.py``).  Products run in
float32 on the card, TF32 off, whatever the process set
(``precision.products``).

Random numbers come from one ``torch.Generator`` in this order each step:
the index of the noise scale (``torch.randint`` over 4), the noise
(``torch.randn`` over the patches), then the dropout masks
(``layers.Draws``).  A caller hands the generator's state as the program's
step found it, so both sides draw the same numbers.
"""

from __future__ import annotations

import torch

from . import frontend, layers, models, optimizers, precision

NOISE_SCALES = (5e-3, 1e-3, 5e-4, 1e-4)
BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def is_parameter(name: str) -> bool:
    return name.rsplit(".", 1)[-1] not in BUFFERS


def patches(audio: torch.Tensor, cfg: dict, mix: dict) -> torch.Tensor:
    """``(B, N)`` crops -> ``(B*k, ...)`` model inputs."""
    fv = frontend.standardize_halves(
        frontend.featuregram(audio, cfg["features"]))       # (B, D, T)
    W = mix["patch_size"]
    starts = frontend.patch_starts(fv.shape[-1], W, mix["patch_shift"])
    starts = starts[:mix["clip_patches"]]
    x = torch.cat([fv[..., s:s + W] for s in starts], dim=0)  # (k*B, D, W)
    return models.family(cfg).layout(x)


def row_labels(labels: dict, k: int) -> dict:
    return {h: y.repeat((k,) + (1,) * (y.ndim - 1)) for h, y in labels.items()}


def loss(out: dict, y: dict, W: dict, l2: float, cfg: dict) -> torch.Tensor:
    eps = 1e-7

    def bce(p, t):
        p = p.squeeze(-1).clamp(eps, 1 - eps)
        return -torch.mean(t * torch.log(p) + (1 - t) * torch.log(1 - p))

    total = (bce(out["S"], y["S"]) + bce(out["M"], y["M"])
             + torch.mean((out["R"] - y["R"]) ** 2)
             - torch.mean(torch.sum(y["3C"] * torch.log(
                 out["3C"].clamp(eps, 1.0)), dim=-1)))
    if l2:
        total = total + l2 * sum(W[k].square().sum()
                                 for k in models.family(cfg).l2_names(W))
    return total


def run_steps(weights: dict, batches: list, gen_state: torch.Tensor,
              cfg: dict, mix: dict, device, *, start: dict | None = None,
              keep: slice = slice(None), tf32: bool = False) -> dict:
    """The training steps of ``batches`` (``(audio (B, N), clip labels)``)
    from ``weights``, drawing from a generator in ``gen_state``, with a
    fresh optimizer or one going on from ``start`` (as
    ``optimizers.__init__`` describes it).  Returns each step's loss, the
    first step's gradients as the optimizer takes them, and the parameters
    after the last step.  ``keep`` selects the rows of each batch that
    count (a fault check leaves half out); ``tf32`` computes the products
    in TF32 (the control)."""
    with precision.products(tf32):
        return _run_steps(weights, batches, gen_state, cfg, mix, device,
                          start, keep)


def _run_steps(weights, batches, gen_state, cfg, mix, device, start, keep):
    W = {k: v.detach().to(device=device, dtype=torch.float32).clone()
         for k, v in weights.items()}
    params = {k: v.requires_grad_() for k, v in W.items() if is_parameter(k)}
    gen = torch.Generator(device=device)
    gen.set_state(gen_state)
    draws = layers.Draws(gen)
    opt = optimizers.optimizer(cfg["optimizer"], params, start)
    scales = torch.tensor(NOISE_SCALES, device=device)
    out = {"loss": [], "first_grad": None}
    for audio, labels in batches:
        audio = audio.to(device=device, dtype=torch.float32)
        labels = {h: y.to(device=device, dtype=torch.float32)
                  for h, y in labels.items()}
        with torch.no_grad():
            x = patches(audio, cfg, mix)
            y = row_labels(labels, x.shape[0] // audio.shape[0])
            i = torch.randint(len(NOISE_SCALES), (), generator=gen,
                              device=device)
            x = x + scales[i] * torch.randn(x.shape, generator=gen,
                                            device=device, dtype=x.dtype)
        x, y = x[keep], {h: t[keep] for h, t in y.items()}
        total = loss(models.forward(x, W, cfg, draws, train=True), y, W,
                     cfg["l2_reg"], cfg)
        grads = dict(zip(params, torch.autograd.grad(total,
                                                     list(params.values()))))
        if out["first_grad"] is None:
            out["first_grad"] = {k: opt.seen(g).detach()
                                 for k, g in grads.items()}
        opt.update(params, grads)
        out["loss"].append(float(total.detach()))
    out["params"] = {k: p.detach() for k, p in params.items()}
    return out

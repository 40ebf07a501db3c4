"""Sequence labelling of one broadcast, in plain PyTorch and NumPy: a
sequence model (Whisper-MTL) over consecutive contexts.

The wav, its features and the smoothing are ``segment.py``'s.  The
featuregram is cut into consecutive contexts of ``context_frames`` frames;
each is standardized per row and HPSS component over its real frames, and
the last is zero-padded to the full length after that.  The model labels
each context's positions; position ``p`` of a context labels its frames
``f p`` to ``f p + f - 1`` (``f`` = frames over positions), and the tracks
are cut to the broadcast's frames.  Products run in float32 on the card,
TF32 off, whatever the process set.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import frontend, layers, models, precision
from .segment import features, read_wav, smooth


def contexts(fv: torch.Tensor, L: int) -> torch.Tensor:
    """``(D, T)`` -> ``(ceil(T / L), D, L)`` standardized, zero-padded
    contexts."""
    out = []
    for s in range(0, fv.shape[1], L):
        ctx = frontend.standardize_halves(fv[:, s:s + L])
        out.append(F.pad(ctx, (0, L - ctx.shape[1])))
    return torch.stack(out)


def tracks(fv: torch.Tensor, W: dict, cfg: dict, serve: dict
           ) -> dict[str, np.ndarray]:
    """Per-frame head outputs over a ``(D, T)`` featuregram."""
    L, T = serve["context_frames"], fv.shape[1]
    x = contexts(fv, L)
    layout, step = models.family(cfg).layout, serve["reference_batch"]
    out: dict[str, list] = {}
    for b in range(0, len(x), step):
        with torch.no_grad():
            heads = models.forward(layout(x[b:b + step]), W, cfg,
                                   layers.Draws(None), train=False)
        for h, v in heads.items():
            out.setdefault(h, []).append(v.float().cpu().numpy())
    result = {}
    for h, v in out.items():
        v = np.concatenate(v)                         # (contexts, P, units)
        frames = np.repeat(v, L // v.shape[1], axis=1)
        result[h] = frames.reshape(-1, v.shape[2])[:T]
    return result


def segment(path: str, W: dict, cfg: dict, serve: dict, device, *,
            tf32: bool = False) -> dict:
    """The tracks, the smoothed S track and the labels of one broadcast,
    with float32 products (TF32 off) or, with ``tf32``, in TF32 (the
    control)."""
    with precision.products(tf32):
        W = {k: v.to(device=device, dtype=torch.float32)
             for k, v in W.items() if v.is_floating_point()}
        fv = features(read_wav(path), cfg, serve, device)
        out = tracks(fv, W, cfg, serve)
        sm = smooth(out["S"][:, 0], serve["smooth_win"], device)
    return {"tracks": out, "smoothed": sm, "labels": (sm > 0.5).astype(int)}

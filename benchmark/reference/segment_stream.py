"""Streamed labelling of one broadcast, in plain PyTorch and NumPy: a causal
stream model (Granite-Hybrid-MTL) over the broadcast's consecutive chunks.

The wav, its features and the smoothing are ``segment.py``'s.  The
featuregram is cut into consecutive chunks of ``context_frames`` frames,
each standardized per row and HPSS component over its real frames, the
last zero-padded after that (``segment_seq.contexts``).  The first
``chunks`` of them (default: all) are joined into one sequence and the
model makes one causal pass over it; position ``p`` labels frames ``f p``
to ``f p + f - 1`` (``f`` = frames over positions), and the tracks are cut
to the frames the chunks hold.  The model is causal, so these are the
tracks a stream that has read those chunks gives.  Products run in float32
on the card, TF32 off, whatever the process set.

The control that drops the carried state makes one pass per chunk instead
(``reset=True``), each from a fresh state.
"""

from __future__ import annotations

import numpy as np
import torch

from . import layers, models, precision
from .segment import features, read_wav, smooth
from .segment_seq import contexts


def tracks(fv: torch.Tensor, W: dict, cfg: dict, serve: dict,
           chunks: int | None = None, reset: bool = False
           ) -> dict[str, np.ndarray]:
    """Per-frame head outputs over the first ``chunks`` chunks of a ``(D,
    T)`` featuregram."""
    L = serve["context_frames"]
    x = contexts(fv, L)[:chunks]                       # (n, D, L)
    T = min(fv.shape[1], len(x) * L)
    seqs = x if reset else x.permute(1, 0, 2).reshape(1, x.shape[1], -1)
    out: dict[str, list] = {}
    for s in seqs:
        with torch.no_grad():
            heads = models.forward(models.family(cfg).layout(s[None]), W,
                                   cfg, layers.Draws(None), train=False)
        for h, v in heads.items():
            out.setdefault(h, []).append(v[0].float().cpu().numpy())
    result = {}
    for h, v in out.items():
        v = np.concatenate(v)                          # (positions, units)
        result[h] = np.repeat(v, len(x) * L // len(v), axis=0)[:T]
    return result


def segment(path: str, W: dict, cfg: dict, serve: dict, device, *,
            chunks: int | None = None, tf32: bool = False,
            reset: bool = False) -> dict:
    """The tracks of the first ``chunks`` chunks of one broadcast and, where
    they are all of it, the smoothed S track and the labels; with float32
    products (TF32 off) or, with ``tf32``, in TF32 (a control); ``reset``:
    each chunk from a fresh state (a control)."""
    with precision.products(tf32):
        W = {k: v.to(device=device, dtype=torch.float32)
             for k, v in W.items() if v.is_floating_point()}
        fv = features(read_wav(path), cfg, serve, device)
        out = tracks(fv, W, cfg, serve, chunks, reset)
        result = {"tracks": out, "frames": fv.shape[1]}
        if len(out["S"]) == fv.shape[1]:
            sm = smooth(out["S"][:, 0], serve["smooth_win"], device)
            result.update(smoothed=sm, labels=(sm > 0.5).astype(int))
    return result

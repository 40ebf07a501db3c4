"""Streaming segmentation of one broadcast, in plain PyTorch and NumPy:
the original system's ``cli.segment`` semantics.

The wav is read as 16-bit PCM over 32768.  A broadcast of more than
``slab_threshold`` frames is featurized whole (its slabs are an
implementation of the same function); a shorter one is first padded to a
geometric length bucket (16000 samples growing by 10%) by repeated
symmetric reflection, featurized with its dB floor taken over the real
frames, and cut back to them.  Shift-1 windows of ``patch_size`` frames
go through the model in chunks of ``chunk_frames`` windows, each chunk's
frames standardized per row and HPSS component.  The S track is
median-smoothed over ``smooth_win`` windows (zero-padded, as
``scipy.signal.medfilt``) and thresholded at 0.5.  Products run in
float32 on the card, TF32 off, whatever the process set.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from scipy.io import wavfile

from . import frontend, layers, models, precision


def read_wav(path: str) -> np.ndarray:
    sr, x = wavfile.read(path)
    if sr != 16000 or x.dtype != np.int16 or x.ndim != 1:
        raise ValueError(f"{path}: expected 16 kHz mono 16-bit PCM")
    return x.astype(np.float32) / 32768.0


def bucket_length(n: int, min_n: int = 16000, ratio: float = 1.1) -> int:
    m = min_n
    while m < n:
        m = int(m * ratio) + 1
    return m


def reflect_pad(x: np.ndarray, target: int) -> np.ndarray:
    out, flip = x, True
    while len(out) < target:
        out = np.concatenate([out, x[::-1] if flip else x])
        flip = not flip
    return out[:target]


def features(x: np.ndarray, cfg: dict, serve: dict, device) -> torch.Tensor:
    feat = cfg["features"]
    T = frontend.n_frames(len(x), feat["n_fft"], feat["hop_length"])
    if T > serve["slab_threshold"]:
        y = torch.as_tensor(x, device=device)[None]
        return frontend.featuregram(y, feat)[0]
    y = torch.as_tensor(reflect_pad(x, bucket_length(len(x))), device=device)
    return frontend.featuregram(y[None], feat, valid_frames=T)[0, :, :T]


def tracks(fv: torch.Tensor, W: dict, cfg: dict, serve: dict
           ) -> dict[str, np.ndarray]:
    """Per-window head outputs over a ``(D, T)`` featuregram."""
    P, chunk, calls = serve["patch_size"], serve["chunk_frames"], \
        serve["reference_batch"]
    n = fv.shape[1] - P + 1
    out: dict[str, list] = {}
    draws = layers.Draws(None)
    layout = models.family(cfg).layout
    for s in range(0, n, chunk):
        count = min(chunk, n - s)
        seg = frontend.standardize_halves(fv[:, s:s + count + P - 1])
        for b in range(0, count, calls):
            idx = torch.arange(b, min(count, b + calls), device=fv.device)
            win = seg[:, idx[:, None] + torch.arange(P, device=fv.device)]
            win = win.permute(1, 0, 2)                        # (n, D, P)
            with torch.no_grad():
                for h, v in models.forward(layout(win), W, cfg, draws,
                                           train=False).items():
                    out.setdefault(h, []).append(v.float().cpu().numpy())
    return {h: np.concatenate(v) for h, v in out.items()}


def smooth(prob: np.ndarray, win: int, device) -> np.ndarray:
    win += 1 - win % 2
    p = F.pad(torch.as_tensor(prob, device=device)[None], (win // 2,) * 2)[0]
    return p.unfold(0, win, 1).median(-1).values.cpu().numpy()


def segment(path: str, W: dict, cfg: dict, serve: dict, device, *,
            tf32: bool = False) -> dict:
    """The tracks, the smoothed S track and the labels of one broadcast,
    with float32 products (TF32 off) or, with ``tf32``, in TF32 (the
    control)."""
    with precision.products(tf32):
        return _segment(path, W, cfg, serve, device)


def _segment(path, W, cfg, serve, device):
    W = {k: v.to(device=device, dtype=torch.float32) for k, v in W.items()
         if v.is_floating_point()}
    fv = features(read_wav(path), cfg, serve, device)
    out = tracks(fv, W, cfg, serve)
    sm = smooth(out["S"][:, 0], serve["smooth_win"], device)
    return {"tracks": out, "smoothed": sm, "labels": (sm > 0.5).astype(int)}

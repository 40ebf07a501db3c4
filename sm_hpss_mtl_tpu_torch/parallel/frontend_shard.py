"""Time-sharded fused audio -> feature front end (counterpart of
the JAX package's ``parallel/frontend_shard.py``).

The raw audio is cut along time over the mesh's ``time`` axis; each shard
receives ``l_harm//2 * hop`` samples of its left neighbour's audio and
``l_harm//2 * hop + n_fft - hop`` of its right neighbour's (a copy to the
shard's device, none between repeated devices: the JAX package's
``ppermute``), and runs K1 (mel) or K2 (full resolution) in halo mode on
its own device's current stream (``ops.frontend``, ``halo_in_audio``).
Interior joins read real neighbour frames, so their median windows are
exact; the edge flags ``(shard == 0, shard == n-1)`` keep the symmetric
mirror at the two global edges only.  Equal to the unsharded
``stft_hpss_mel`` up to float32 rounding.  On CPU tensors the same
shards run the plain versions.

Each shard holds its audio and its features only, never the
full-resolution spectrogram of the whole recording: the multi-hour
broadcast featurization of the reference's DAFx12 driver scaled past one
device.
"""

from __future__ import annotations

import torch

from ..ops import frontend
from ..ops import mel as mel_mod
from ..ops.featuregram import _MEL_SR_QUIRK, _parse
from ..ops.stft import n_frames
from .mesh import Mesh


def stft_hpss_mel_time_sharded(
        y: torch.Tensor, mel_basis, mesh: Mesh, *, n_fft: int = 400,
        win_length: int = 400, hop_length: int = 160, l_harm: int = 21,
        l_perc: int = 11, power: float = 2.0,
        dft_precision: str = "highest", axis: str = "time"
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Audio ``(B, n_samples)`` -> ``(mel(H), mel(P))``, each ``(B, n_mels,
    T)``, time-sharded, gathered on ``y``'s device.

    ``mel_basis=None`` emits the full-resolution masked magnitudes ``(H,
    P)``, ``(B, F, T)`` (the HarmSpec/PercSpec families, K2).  The frame
    count ``T = 1 + (n - n_fft) // hop`` must divide evenly by the
    ``axis`` size, and each local block must hold at least ``2 *
    (l_harm // 2)`` frames.  ``power`` and ``dft_precision`` reach every
    shard's kernel (``ops.frontend``)."""
    B, N = y.shape
    ht = l_harm // 2
    n = mesh.shape[axis]
    T = n_frames(N, n_fft, hop_length)
    if T % n:
        raise ValueError(f"T={T} not divisible by {axis}={n}")
    T_local = T // n
    if T_local < 2 * ht:
        raise ValueError("local time block smaller than 2*(l_harm//2)")
    mesh.check(y)

    halo = ht * hop_length
    tail_len = n_fft - hop_length   # samples past the last frame start
    span = T_local * hop_length
    body = y[:, :T * hop_length].to(torch.float32)
    tail = y[:, T * hop_length:(T - 1) * hop_length + n_fft].to(torch.float32)
    devices = mesh.along(axis)
    local = [body[:, i * span:(i + 1) * span].to(dev, non_blocking=True)
             for i, dev in enumerate(devices)]
    # One copy of the basis per device (K1 keeps its band ranges per
    # basis tensor).
    bases = {dev: None if mel_basis is None else torch.as_tensor(
        mel_basis, dtype=torch.float32, device=dev) for dev in devices}
    kw = dict(n_fft=n_fft, win_length=win_length, hop_length=hop_length,
              l_harm=l_harm, l_perc=l_perc, power=power,
              dft_precision=dft_precision, halo_in_audio=True)
    outs_h, outs_p = [], []
    for i, (x, dev) in enumerate(zip(local, devices)):
        # Left halo: my left neighbour's last `halo` samples (zeros at the
        # global edge, where the mirror applies instead).
        left = (torch.zeros((B, halo), device=dev) if i == 0
                else local[i - 1][:, -halo:].to(dev, non_blocking=True))
        # Right extension: my right neighbour's first `halo + tail_len`
        # samples; the last shard takes the global tail and zeros.
        right = (torch.cat([tail.to(dev, non_blocking=True),
                            torch.zeros((B, halo), device=dev)], dim=-1)
                 if i == n - 1 else
                 local[i + 1][:, :halo + tail_len].to(dev, non_blocking=True))
        y_ext = torch.cat([left, x, right], dim=-1)
        flags = (int(i == 0), int(i == n - 1))
        if mel_basis is None:
            H, P = frontend.stft_hpss(y_ext, edge_flags=flags, **kw)
        else:
            H, P = frontend.stft_hpss_mel(y_ext, bases[dev],
                                          edge_flags=flags, **kw)
        outs_h.append(H.to(y.device))
        outs_p.append(P.to(y.device))
    return torch.cat(outs_h, dim=-1), torch.cat(outs_p, dim=-1)


def featuregram_time_sharded(y: torch.Tensor, mesh: Mesh, *,
                             feat_name: str = "LogMelHarmPercSpec",
                             sr: int = 16000, n_fft: int = 400,
                             win_length: int = 400, hop_length: int = 160,
                             n_mels: int = 120, l_harm: int = 21,
                             l_perc: int = 11,
                             axis: str = "time") -> torch.Tensor:
    """Multi-device featuregram of long recordings, ``(n,)`` or ``(B, n)``
    -> ``(D, T)`` or ``(B, D, T)`` on ``y``'s device: the HPSS featName
    families (Mel/LogMel and full-resolution (Log)Harm/Perc/HarmPerc)
    through the time-sharded front end.

    Frame counts that do not divide the ``axis`` size are zero-padded to
    the next multiple and trimmed; the last ``l_harm//2`` frames (whose
    median windows would see pad audio instead of the symmetric boundary)
    are recomputed on a ``3*(l_harm//2)``-frame slab through
    ``ops.frontend``'s dispatchers (K1 or K2 on CUDA) and spliced in."""
    log, is_mel, harm, perc = _parse(feat_name)
    if not (harm or perc):
        raise ValueError(
            f"featuregram_time_sharded supports the HPSS featName "
            f"families, got {feat_name!r}")

    squeeze = y.ndim == 1
    if squeeze:
        y = y[None]
    y = y.to(torch.float32)
    B, N = y.shape
    n = mesh.shape[axis]
    ht = l_harm // 2
    T = n_frames(N, n_fft, hop_length)
    Tpad = -(-T // n) * n
    extra = Tpad - T
    M = (mel_mod.mel_filterbank(_MEL_SR_QUIRK, n_fft, n_mels,
                                device=y.device) if is_mel else None)
    kw = dict(n_fft=n_fft, win_length=win_length, hop_length=hop_length,
              l_harm=l_harm, l_perc=l_perc)

    n_need = (Tpad - 1) * hop_length + n_fft
    yp = torch.nn.functional.pad(y, (0, max(0, n_need - N)))[:, :n_need]
    H, P = stft_hpss_mel_time_sharded(yp, M, mesh, axis=axis, **kw)
    H, P = H[..., :T], P[..., :T]
    if extra:
        # Tail splice: recompute the last ht frames against the TRUE
        # right boundary (the padded run mirrored at Tpad, not T).
        k = 3 * ht
        t0 = (T - k) * hop_length
        t1 = (T - 1) * hop_length + n_fft
        th, tp = (frontend.stft_hpss(y[:, t0:t1], **kw) if M is None
                  else frontend.stft_hpss_mel(y[:, t0:t1], M, **kw))
        H = torch.cat([H[..., :T - ht], th[..., -ht:]], dim=-1)
        P = torch.cat([P[..., :T - ht], tp[..., -ht:]], dim=-1)

    def _post(fv):
        if log:
            fv = mel_mod.power_to_db(fv ** 2)
        return fv.to(torch.float32)

    parts = ([_post(H)] if harm else []) + ([_post(P)] if perc else [])
    out = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-2)
    return out[0] if squeeze else out

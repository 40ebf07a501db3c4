"""Featuregrams: audio -> ``(D, T)`` feature matrix per reference featName.

Counterpart of ``sm_hpss_mtl_tpu/ops/featuregram.py``; names, shapes and
values match it (see that module's table).  Devices:

- On the CPU every family runs in plain PyTorch.
- On CUDA the Mel-HPSS families (``MelHarmSpec`` ... ``LogMelHarmPercSpec``)
  go through kernel K1 (``ops.frontend.stft_hpss_mel``), the
  full-resolution HPSS families (``HarmSpec`` ... ``LogHarmPercSpec``)
  through kernel K2 (``ops.frontend.stft_hpss``).  The plain STFT, Spec
  and Mel families are plain PyTorch there too, as XLA computed them
  outside Pallas in the JAX package.

The "sr=22050 quirk": the reference builds the mel bank for HPSS branches
with librosa's default sampling rate instead of 16 kHz.  Kept for parity.
"""

from __future__ import annotations

import torch

from . import frontend
from . import mel as mel_mod
from . import stft as stft_mod

#: Feature names supported, mirroring the reference's featName values.
FEATURE_NAMES = (
    "Spec", "LogSpec", "MelSpec", "LogMelSpec",
    "HarmSpec", "PercSpec", "HarmPercSpec",
    "LogHarmSpec", "LogPercSpec", "LogHarmPercSpec",
    "MelHarmSpec", "MelPercSpec", "MelHarmPercSpec",
    "LogMelHarmSpec", "LogMelPercSpec", "LogMelHarmPercSpec",
)

#: librosa's default sr, used by the reference for mel banks over HPSS output.
_MEL_SR_QUIRK = 22050


def _parse(feat_name: str):
    """Split a featName into (log, mel, harm, perc) flags."""
    if feat_name not in FEATURE_NAMES:
        raise ValueError(f"unknown featName {feat_name!r}")
    name = feat_name
    log = name.startswith("Log")
    if log:
        name = name[len("Log"):]
    mel = name.startswith("Mel")
    if mel:
        name = name[len("Mel"):]
    harm = name.startswith("Harm")
    perc = "Perc" in name
    return log, mel, harm, perc


def feature_dim(feat_name: str, *, n_fft: int = 400, n_mels: int = 120) -> int:
    """Number of feature rows D for a featName."""
    _, mel, harm, perc = _parse(feat_name)
    base = n_mels if mel else 1 + n_fft // 2
    return base * (2 if (harm and perc) else 1)


def featuregram(y: torch.Tensor, *, feat_name: str, sr: int = 16000,
                n_fft: int = 400, win_length: int = 400,
                hop_length: int = 160, n_mels: int = 120, l_harm: int = 21,
                l_perc: int = 11, valid_frames=None,
                dft_precision: str = "highest",
                top_db: float | None = 80.0) -> torch.Tensor:
    """Audio ``(..., n_samples)`` -> ``(..., D, T)`` on the audio's device.

    ``valid_frames`` (int or tensor broadcastable to ``(..., 1, 1)``)
    limits the ``power_to_db`` clamp to real frames when the audio was
    length-padded.  ``dft_precision`` ('highest' | 'bf16x3') reaches the
    fused front end of the HPSS families (``ops.frontend``); the port's
    default is ``'highest'``, the JAX package's ``'bf16x3'``.
    ``top_db=None`` skips the clamp, which makes the log map elementwise
    (``featuregram_slabbed`` clamps once at the end)."""
    log, mel, harm, perc = _parse(feat_name)
    stft_kw = dict(n_fft=n_fft, win_length=win_length, hop_length=hop_length)

    def to_db(fv):
        return mel_mod.power_to_db(fv ** 2, valid_len=valid_frames,
                                   top_db=top_db)

    if not (harm or perc):
        fv = stft_mod.stft_mag(y, **stft_kw)
        if mel:
            fv = mel_mod.apply_mel(fv ** 2, sr=sr, n_mels=n_mels)
        return to_db(fv) if log else fv

    if mel:
        M = mel_mod.mel_filterbank(_MEL_SR_QUIRK, n_fft, n_mels,
                                   device=y.device)
        H, P = frontend.stft_hpss_mel(y.to(torch.float32), M, l_harm=l_harm,
                                      l_perc=l_perc,
                                      dft_precision=dft_precision, **stft_kw)
    else:
        H, P = frontend.stft_hpss(y.to(torch.float32), l_harm=l_harm,
                                  l_perc=l_perc, dft_precision=dft_precision,
                                  **stft_kw)

    # power_to_db runs per component, so each part is clamped by its own max.
    parts = [c for c, on in ((H, harm), (P, perc)) if on]
    if log:
        parts = [to_db(c) for c in parts]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-2)


def featuregram_slabbed(y: torch.Tensor, *, feat_name: str,
                        slab_frames: int = 16384, sr: int = 16000,
                        n_fft: int = 400, win_length: int = 400,
                        hop_length: int = 160, n_mels: int = 120,
                        l_harm: int = 21, l_perc: int = 11,
                        dft_precision: str = "highest",
                        top_db: float | None = 80.0) -> torch.Tensor:
    """Featuregram of one long recording ``(n_samples,)`` -> ``(D, T)``, on
    the recording's device, computed as ``slab_frames``-frame windows.

    Each window carries ``l_harm//2`` frames of real-audio margin at
    interior seams, which are trimmed, so every frame equals the
    whole-signal featuregram's; the first and last windows keep the true
    edges, where the symmetric mirror applies.  Windows are computed
    unclamped and the ``top_db`` clamp is applied once all frames exist:
    per component block for two-part [H; P] features, over the whole
    matrix otherwise.  Slabs bound the plain version's memory; on CUDA
    each is one kernel launch.  ``dft_precision`` as in
    :func:`featuregram`."""
    if y.ndim != 1:
        raise ValueError("featuregram_slabbed takes one recording (1-D)")
    log, _, harm, perc = _parse(feat_name)
    hop, S = hop_length, int(slab_frames)
    T = stft_mod.n_frames(int(y.shape[0]), n_fft, hop)
    margin = (l_harm // 2) if (harm or perc) else 0
    if S <= margin:
        raise ValueError(f"slab_frames {S} must exceed the harmonic "
                         f"median margin {margin}")
    kw = dict(feat_name=feat_name, sr=sr, n_fft=n_fft, win_length=win_length,
              hop_length=hop_length, n_mels=n_mels, l_harm=l_harm,
              l_perc=l_perc, dft_precision=dft_precision)
    if T <= S + margin:
        return featuregram(y, top_db=top_db, **kw)

    def window(f0, f1):
        return featuregram(y[f0 * hop:(f1 - 1) * hop + n_fft], top_db=None,
                           **kw)

    parts = [window(0, S + margin)[:, :S]]                  # true left edge
    n_cores = -(-T // S)
    for k in range(1, n_cores - 1):
        w = window(k * S - margin, (k + 1) * S + margin)
        parts.append(w[:, margin:margin + S])
    tail = T - (n_cores - 1) * S                            # in (0, S]
    w = window(T - S - margin, T)                           # true right edge
    parts.append(w[:, S + margin - tail:])
    fv = torch.cat(parts, dim=-1)
    if log and top_db is not None:
        blocks = fv.chunk(2, dim=0) if (harm and perc) else (fv,)
        fv = torch.cat([torch.maximum(b, b.max() - top_db) for b in blocks],
                       dim=0)
    return fv

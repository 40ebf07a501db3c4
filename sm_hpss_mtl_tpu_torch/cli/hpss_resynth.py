"""HPSS resynthesis: audio -> harmonic / percussive wav files.

Counterpart of ``python -m sm_hpss_mtl_tpu.cli.hpss_resynth``, the
reference's missing demo-audio generator: STFT -> median-filter soft masks
(kernel K3, ``ops.hpss.hpss_masks``, on the GPU) -> masked complex
spectrogram -> iSTFT.  Runs on CUDA unless ``--device cpu`` is given.

    python -m sm_hpss_mtl_tpu_torch.cli.hpss_resynth in.wav --out-dir out/
    python -m sm_hpss_mtl_tpu_torch.cli.hpss_resynth sp.wav --mix mu.wav \\
        --smr 5 --out-dir out/
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..data.audio import read_audio, write_wav
from ..device import resolve_device
from ..ops import stft as st
from ..ops.hpss import hpss_masks
from ..ops.mixing import mix_signals_np, normalize_signal_np


def resynthesize(x: np.ndarray, *, device: str | torch.device = "cuda",
                 n_fft: int = 400, win_length: int = 400,
                 hop_length: int = 160, l_harm: int = 21, l_perc: int = 11
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Returns the (harmonic, percussive) time-domain signals of ``x``,
    each as long as ``x``, computed on ``device``."""
    device = resolve_device(device)
    y = torch.as_tensor(np.asarray(x, np.float32), device=device)
    kw = dict(n_fft=n_fft, win_length=win_length, hop_length=hop_length)
    S = st.stft(y, **kw)
    mh, mp = hpss_masks(S.abs(), l_harm=l_harm, l_perc=l_perc)
    yh = st.istft(S * mh, length=len(x), **kw)
    yp = st.istft(S * mp, length=len(x), **kw)
    return yh.cpu().numpy(), yp.cpu().numpy()


def main(argv=None) -> list[str]:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("input", help="input wav (speech if --mix is given)")
    p.add_argument("--mix", default=None, help="music wav to mix in")
    p.add_argument("--smr", type=float, default=0.0,
                   help="speech-to-music ratio in dB for --mix")
    p.add_argument("--out-dir", default=".")
    p.add_argument("--l-harm", type=int, default=21)
    p.add_argument("--l-perc", type=int, default=11)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    x, sr = read_audio(args.input)
    stem = os.path.splitext(os.path.basename(args.input))[0]
    if args.mix:
        m, _ = read_audio(args.mix)
        x = mix_signals_np(normalize_signal_np(x), normalize_signal_np(m),
                           args.smr).astype(np.float32)
        mix_stem = os.path.splitext(os.path.basename(args.mix))[0]
        stem = f"{stem}+{mix_stem}_{args.smr:g}dB"
    yh, yp = resynthesize(x, device=device, l_harm=args.l_harm,
                          l_perc=args.l_perc)

    os.makedirs(args.out_dir, exist_ok=True)
    paths = []
    for name, y in (("", x), ("_Harmonic", yh), ("_Percussive", yp)):
        path = os.path.join(args.out_dir, f"{stem}{name}.wav")
        write_wav(path, np.asarray(y) / max(np.max(np.abs(y)), 1e-9), sr)
        print(path)
        paths.append(path)
    return paths


if __name__ == "__main__":
    main()

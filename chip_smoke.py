#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``sm_hpss_mtl_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which must pass:

1. card: the GPU's name and power limit (nvidia-smi);
2. build: the CUDA sources of ``sm_hpss_mtl_tpu_torch/csrc`` with nvcc, one
   process per source, all started together;
3. kernels: K1 (``stft_hpss_mel``), K2 (``stft_hpss``) and K3 (``hpss``,
   ``hpss_masks``) against their plain PyTorch versions on the card, at
   every launch shape of the paths below and at edge geometries;
4. Lemaire-MTL whole-signal serving: ``cli.segment.main`` on a synthetic
   60 s broadcast with full-width weights from a seeded init, and the same
   run on the CPU as its reference;
5. Lemaire-MTL slabbed serving: a 10-minute broadcast (~60k frames,
   featurized in 16384-frame slabs, 10000-window chunks);
6. Lemaire-MTL features of the 10-minute broadcast through K1 against the
   plain version on the card (max |delta| <= 0.02 dB);
7. Jang-MTL serving (``--model Jang_et_al_MTL``, features through K2): the
   60 s and 10-minute broadcasts on the card, a 10 s broadcast on the card
   and on the CPU (tracks within 1e-3), and the 10-minute features through
   K2 against the plain version (<= 0.02 dB);
8. HPSS resynthesis: ``cli.hpss_resynth.main`` on the 60 s broadcast on
   the card (masks through K3) and on the CPU;
9. checks on the launch counts, and that every launch shape of phases 4-8
   was checked in phase 3.

Each path runs with the launch counts set to 0 just before it and read
just after.  Prints a ``{"kernels": [...]}`` line, a serving-times line, a
resynthesis line, the card line, and last ``{"ok": true, "device":
{...}}``.  Exits non-zero, and prints no result, if any phase fails or no
GPU is present.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SR = 16000
SEED = 0
#: K1 and K2 tolerance against their plain version, as the JAX package
#: holds its Pallas kernel to the jnp oracle (tests/test_frontend_pallas.py).
RTOL, ATOL = 2e-4, 2e-5
#: K3 tolerance against its plain version, as tests/test_hpss_pallas.py
#: holds the spectral Pallas kernel.
K3_RTOL, K3_ATOL = 1e-5, 1e-6
#: Feature fidelity bar of the serving path (BASELINE.md).
FEATURE_DB_TOL = 0.02
#: Probability tracks, GPU run against the CPU run of the same CLI.
TRACK_TOL = 1e-3
#: Resynthesized signals, GPU run against the CPU run: max |delta| over the
#: CPU signal's peak, both weighted by min(1, overlap-added squared window)
#: (see ``resynth_delta``).  The two runs differ by float32 summation
#: order in the STFT, the iFFT and the overlap-add (~1e-6 of the peak);
#: a wrong mask, edge rule or frame offset moves the signals by 1e-2 or
#: more.
RESYNTH_TOL = 1e-4
#: H100 peaks (NVIDIA data sheet): HBM bytes/s and float32 CUDA-core FLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = {"PCIe": 51e12, "default": 67e12}
#: Comparators of the pruned median networks (csrc/median.cuh).
COMPARATORS = {21: 91, 11: 32, 5: 8}
#: Operations per bin of the soft masks (both masks and both products).
MASK_OPS = 10


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def synth_broadcast(seconds: float, seed: int) -> np.ndarray:
    """Alternating 5 s segments of music (chords), speech-like bursts
    (a formant-filtered pulse train with syllabic gaps) and both, with
    clicks, as 16 kHz float32 in [-1, 1]."""
    from scipy.signal import lfilter
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    seg = (t // 5.0).astype(np.int64) % 3          # 0 music, 1 speech, 2 both
    roots = rng.choice([220.0, 246.9, 293.7, 329.6], size=int(seconds) // 5 + 1)
    f0 = roots[(t // 5.0).astype(np.int64)]
    music = sum(a * np.sin(2 * np.pi * f0 * m * t)
                for m, a in ((1, 1.0), (1.5, 0.6), (2, 0.5), (3, 0.25)))
    pitch = 120 + 40 * np.sin(2 * np.pi * 2.3 * t)
    phase = np.cumsum(pitch) / SR
    glottal = np.sign(np.sin(2 * np.pi * phase)) * np.sin(2 * np.pi * phase) ** 2
    speech = glottal * np.clip(np.sin(2 * np.pi * 3.7 * t) + 0.4, 0, None)
    for fc in (700.0, 1900.0):
        r = np.exp(-2 * np.pi * 150 / SR)
        speech = lfilter([1.0], [1.0, -2 * r * np.cos(2 * np.pi * fc / SR),
                                 r * r], speech)
    speech /= np.abs(speech).max()
    x = (0.25 * music * (seg != 1) + 0.5 * speech * (seg != 0)
         + 0.01 * rng.standard_normal(n))
    clicks = np.zeros(n)
    clicks[rng.integers(0, n - 64, int(seconds * 2))] = 1.0
    x += np.convolve(clicks, np.hanning(64), mode="same")
    return (x / np.abs(x).max() * 0.9).astype(np.float32)


def write_broadcast(tmp: str, name: str, seconds: float, seed: int
                    ) -> tuple[str, np.ndarray]:
    """The broadcast as a 16-bit wav, and the float signal a reader of
    that wav gets back."""
    from scipy.io import wavfile
    x = synth_broadcast(seconds, seed)
    path = os.path.join(tmp, name)
    wavfile.write(path, SR, (x * 32767).astype(np.int16))
    return path, (x * 32767).astype(np.int16).astype(np.float32) / 32768.0


def cuda_ms(fn, reps: int = 20) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound(nbytes: float, flops: float, card: str) -> tuple[float, str]:
    """The larger of bytes over HBM and f32 operations over the CUDA-core
    peak, in ms, and which of the two it is."""
    peak = F32_FLOPS["PCIe" if "PCIe" in card else "default"]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes > t_ops else "operations")


def frontend_bound_ms(T: int, N: int, n_fft: int, l_harm: int, l_perc: int,
                      card: str, n_mels: int = 0, mel_nnz: int = 0
                      ) -> tuple[float, str, float]:
    """Least time for K1's function (``n_mels`` > 0) or K2's on this card:
    the larger of its bytes (each input read once, each output written
    once) over HBM and the f32 operations it needs over the CUDA-core peak.
    Operations per frame: the window (n_fft), a real FFT (2.5 n_fft log2
    n_fft), the magnitude (3 per bin), both median networks (min and max
    per comparator), the masks (10 per bin) and, for K1, the mel projection
    over the basis's nonzeros (two outputs, one FMA each).  Bytes: the
    audio in, and two (n_mels, T) maps out plus the basis (K1) or two
    (F, T) maps out (K2).  Also returns the operations bound with the DFT
    and the mel projection priced as the dense products the kernels
    compute (2 n_fft 2F and 2 F n_mels per output per frame)."""
    F = 1 + n_fft // 2
    out_rows = n_mels if n_mels else F
    nbytes = 4 * (N + n_mels * F + 2 * out_rows * T)
    common = (n_fft + 3 * F
              + (COMPARATORS[l_harm] + COMPARATORS[l_perc]) * 2 * F
              + MASK_OPS * F)
    flops = T * (2.5 * n_fft * np.log2(n_fft) + common + 2 * 2 * mel_nnz)
    direct = T * (2 * n_fft * 2 * F + common + 2 * 2 * F * n_mels)
    bound, by = _bound(nbytes, flops, card)
    return bound, by, _bound(nbytes, direct, card)[0]


def k3_bound_ms(B: int, F: int, T: int, l_harm: int, l_perc: int,
                card: str) -> tuple[float, str]:
    """Least time for K3's function: one (B, F, T) read and two written,
    against both median networks and the masks per bin."""
    ops = (COMPARATORS[l_harm] + COMPARATORS[l_perc]) * 2 + MASK_OPS
    return _bound(4 * 3 * B * F * T, ops * B * F * T, card)


def compare(tag: str, got, want, rtol: float, atol: float) -> float:
    """Both outputs of a kernel against its plain version; max |delta|."""
    import torch
    torch.cuda.synchronize()
    err = 0.0
    for g, w in zip(got, want):
        check(g.shape == w.shape, f"{tag}: shape {tuple(g.shape)} vs "
                                  f"{tuple(w.shape)}")
        d = (g - w).abs()
        ok = bool((d <= atol + rtol * w.abs()).all())
        check(ok and bool(torch.isfinite(g).all()),
              f"{tag} disagrees with plain: max |delta| {d.max().item():.3e}")
        err = max(err, d.max().item())
    return err


def phase_kernels(card: str) -> tuple[list[dict], dict]:
    """K1, K2 and K3 against their plain versions on the card, at edge
    geometries and at every launch shape of the paths: K1 at the 60 s
    Lemaire broadcast bucketed to 6024 frames and the 10-minute slabs
    (16394 and 16404 frames); K2 at n_fft 512 at the bucketed 10 s (1081)
    and 60 s (6023) Jang broadcasts and the same slabs; K3 at the 60 s
    resynthesis (201 bins, 5998 frames).
    Returns the kernel entries (launches still None) and, per kernel, the
    launch shapes checked."""
    import torch
    from sm_hpss_mtl_tpu_torch.ops import frontend, hpss
    from sm_hpss_mtl_tpu_torch.ops.mel import mel_filterbank

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    checked = {"K1": set(), "K2": set(), "K3": set()}

    def audio(n_fft, B, T):
        return torch.randn((B, n_fft + (T - 1) * 160), generator=gen,
                           device="cuda")

    k1_cases = [(400, 21, 11, 2, T) for T in (1, 7, 19, 21, 48, 58, 98)]
    k1_cases += [(512, 11, 5, 2, 71)]
    k1_cases += [(512, 21, 11, 2, T) for T in (1, 19, 98)]
    k1_cases += [(400, 21, 11, 1, T) for T in (6024, 16384, 16394, 16404)]
    k1_err = 0.0
    for n_fft, lh, lp, B, T in k1_cases:
        y = audio(n_fft, B, T)
        M = mel_filterbank(22050, n_fft, 120, device="cuda")
        kw = dict(n_fft=n_fft, win_length=400, hop_length=160, l_harm=lh,
                  l_perc=lp)
        k1_err = max(k1_err, compare(
            f"K1 n_fft={n_fft} l=({lh},{lp}) B={B} T={T}",
            frontend.stft_hpss_mel(y, M, **kw),
            frontend.stft_hpss_mel_plain(y, M, **kw), RTOL, ATOL))
        checked["K1"].add((n_fft, lh, lp, B, T))
    print(f"kernel K1 stft_hpss_mel: {len(k1_cases)} shapes ok, "
          f"max |delta| {k1_err:.3e}", flush=True)

    k2_cases = [(n_fft, lh, lp, 2, T) for n_fft in (400, 512)
                for lh, lp in ((21, 11), (11, 5))
                for T in (1, 7, 19, 21, 48, 98)]
    k2_cases += [(512, 21, 11, 1, T) for T in (1081, 6023, 16394, 16404)]
    k2_err = 0.0
    for n_fft, lh, lp, B, T in k2_cases:
        y = audio(n_fft, B, T)
        kw = dict(n_fft=n_fft, win_length=400, hop_length=160, l_harm=lh,
                  l_perc=lp)
        k2_err = max(k2_err, compare(
            f"K2 n_fft={n_fft} l=({lh},{lp}) B={B} T={T}",
            frontend.stft_hpss(y, **kw), frontend.stft_hpss_plain(y, **kw),
            RTOL, ATOL))
        checked["K2"].add((n_fft, lh, lp, B, T))
    print(f"kernel K2 stft_hpss: {len(k2_cases)} shapes ok, "
          f"max |delta| {k2_err:.3e}", flush=True)

    k3_cases = [(mo, 21, 11, 2, 201, T) for mo in (False, True)
                for T in (1, 19, 364, 365)]
    k3_cases += [(mo, 21, 11, 1, 201, 5998) for mo in (False, True)]
    k3_err = 0.0
    for mo, lh, lp, B, F, T in k3_cases:
        S = torch.rand((B, F, T), generator=gen, device="cuda") ** 3
        fn, plain = ((hpss.hpss_masks, hpss.hpss_masks_plain) if mo
                     else (hpss.hpss, hpss.hpss_plain))
        k3_err = max(k3_err, compare(
            f"K3 mask_only={mo} l=({lh},{lp}) B={B} F={F} T={T}",
            fn(S, l_harm=lh, l_perc=lp), plain(S, l_harm=lh, l_perc=lp),
            K3_RTOL, K3_ATOL))
        checked["K3"].add((mo, lh, lp, B, F, T))
    print(f"kernel K3 hpss: {len(k3_cases)} shapes ok, "
          f"max |delta| {k3_err:.3e}", flush=True)

    # Times at each kernel's dominant launch on its path: an interior slab
    # of the slabbed featurizer (16384 frames plus a 10-frame margin on
    # each side) for K1 (Lemaire, n_fft 400) and K2 (Jang, n_fft 512); the
    # 60 s resynthesis for K3.
    entries = []
    T = 16384 + 2 * 10
    for name, n_fft, err in (("stft_hpss_mel", 400, k1_err),
                             ("stft_hpss", 512, k2_err)):
        y = audio(n_fft, 1, T)
        kw = dict(n_fft=n_fft)
        if name == "stft_hpss_mel":
            M = mel_filterbank(22050, n_fft, 120, device="cuda")
            run = lambda: frontend.stft_hpss_mel(y, M, **kw)  # noqa: E731
            plain = lambda: frontend.stft_hpss_mel_plain(y, M, **kw)  # noqa
            mel = dict(n_mels=120, mel_nnz=int((M != 0).sum()))
            replaces = "sm_hpss_mtl_tpu/ops/frontend_pallas.py:207"
        else:
            run = lambda: frontend.stft_hpss(y, **kw)  # noqa: E731
            plain = lambda: frontend.stft_hpss_plain(y, **kw)  # noqa: E731
            mel = {}
            replaces = "sm_hpss_mtl_tpu/ops/frontend_pallas.py:219"
        bound, by, direct = frontend_bound_ms(T, y.shape[-1], n_fft, 21, 11,
                                              card, **mel)
        entries.append({
            "name": name, "route": "cuda",
            "source": "sm_hpss_mtl_tpu_torch/csrc/frontend.cu",
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": cuda_ms(run), "plain_ms": cuda_ms(plain, reps=5),
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "bound_direct_dft_ms": direct, "timed_shape": list(y.shape)})
    S = torch.rand((1, 201, 5998), generator=gen, device="cuda")
    bound, by = k3_bound_ms(1, 201, 5998, 21, 11, card)
    entries.append({
        "name": "hpss", "route": "cuda",
        "source": "sm_hpss_mtl_tpu_torch/csrc/hpss.cu",
        "replaces": "sm_hpss_mtl_tpu/ops/hpss_pallas.py:146",
        "launches": None, "max_abs_err": k3_err,
        "ms": cuda_ms(lambda: hpss.hpss_masks(S)),
        "plain_ms": cuda_ms(lambda: hpss.hpss_masks_plain(S), reps=5),
        "bound_ms": bound, "bound_by": by, "library_ms": None,
        "timed_shape": list(S.shape), "timed_mode": "mask_only"})
    return entries, checked


@contextlib.contextmanager
def recorded():
    """Counts every kernel launch of the code run inside, and the shape of
    each: the launch counts are set to 0 on entry and read on exit."""
    from sm_hpss_mtl_tpu_torch.ops import frontend, hpss
    rec = {"shapes": {"K1": set(), "K2": set(), "K3": set()},
           "launches": {}}
    f_launch, h_launch = frontend._launch, hpss._launch

    def f_rec(y, M, **kw):
        rec["shapes"]["K2" if M is None else "K1"].add(
            (kw["n_fft"], kw["l_harm"], kw["l_perc"],
             y.numel() // y.shape[-1],
             1 + (y.shape[-1] - kw["n_fft"]) // kw["hop_length"]))
        return f_launch(y, M, **kw)

    def h_rec(S, **kw):
        F, T = S.shape[-2:]
        rec["shapes"]["K3"].add((kw["mask_only"], kw["l_harm"],
                                 kw["l_perc"], S.numel() // (F * T), F, T))
        return h_launch(S, **kw)

    counters = (frontend.stft_hpss_mel, frontend.stft_hpss, hpss.hpss,
                hpss.hpss_masks)
    frontend._launch, hpss._launch = f_rec, h_rec
    try:
        for fn in counters:
            fn.launches = 0
        yield rec
        rec["launches"] = {
            "K1": frontend.stft_hpss_mel.launches,
            "K2": frontend.stft_hpss.launches,
            "K3": hpss.hpss.launches + hpss.hpss_masks.launches}
    finally:
        frontend._launch, hpss._launch = f_launch, h_launch


def serve(model: str, wav: str, weights: str, out: str, device: str,
          x: np.ndarray, chunk_frames: int = 10000) -> dict:
    """One ``cli.segment`` run (host clock around it); outputs checked.
    Also returns the launches and launch shapes of each kernel."""
    from sm_hpss_mtl_tpu_torch.cli import segment as cli

    with recorded() as rec:
        t0 = time.perf_counter()
        prob, labels = cli.main([wav, "--model", model, "--weights", weights,
                                 "--device", device, "--chunk-frames",
                                 str(chunk_frames), "--out", out])
        total_s = time.perf_counter() - t0

    n_fft = cli.MODEL_PRESETS[model]["n_fft"]
    T = 1 + (len(x) - n_fft) // 160
    with np.load(out) as z:
        tracks = {k: z[k] for k in z.files}
    for k in ("track_S", "track_M"):
        v = tracks[k]
        check(v.shape == (T - 67, 1), f"{k} shape {v.shape}, want {(T - 67, 1)}")
        check(bool(np.isfinite(v).all()), f"{k} not finite")
        check(bool(((v >= 0) & (v <= 1)).all()), f"{k} outside [0, 1]")
    check(prob.shape == labels.shape == (T - 67,), "smoothed track length")
    for k in ("track_R", "track_3C"):
        check(bool(np.isfinite(tracks[k]).all()), f"{k} not finite")

    return {"tracks": tracks, "launches": rec["launches"], "frames": T,
            "total_s": total_s, "shapes": rec["shapes"]}


def time_legs(model: str, x: np.ndarray, wav: str, weights: str, out: str,
              first_s: float, chunk_frames: int = 10000) -> dict:
    """A served broadcast timed again, warm: the whole CLI run, then its
    featurize and model legs on their own (host clock around work that
    ends in a synchronise or a copy to the host)."""
    import torch
    from sm_hpss_mtl_tpu_torch.cli import segment as cli
    from sm_hpss_mtl_tpu_torch.data.audio import read_wav
    from sm_hpss_mtl_tpu_torch.eval.segment import smooth_predictions

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cli.main([wav, "--model", model, "--weights", weights,
              "--chunk-frames", str(chunk_frames), "--out", out])
    total_s = time.perf_counter() - t0
    legs = {}

    def leg(name, fn, sync=False):
        t0 = time.perf_counter()
        r = fn()
        if sync:
            torch.cuda.synchronize()
        legs[name] = 1e3 * (time.perf_counter() - t0)
        return r

    leg("read_wav_ms", lambda: read_wav(wav))
    fv = leg("featurize_ms", lambda: cli._featurize_broadcast(
        x, cli.MODEL_PRESETS[model], dev), sync=True)
    net = leg("load_model_ms", lambda: cli.load_model(weights, dev, model),
              sync=True)
    seg = cli.segmenter(model, net, chunk_frames=chunk_frames)
    # frame_probabilities ends with the tracks on the host.
    tracks = leg("model_ms", lambda: seg.frame_probabilities(fv))
    leg("smooth_ms", lambda: smooth_predictions(tracks["S"][:, 0], 501))
    return {"audio_s": len(x) / SR, **legs, "total_ms": 1e3 * total_s,
            "first_run_total_ms": 1e3 * first_s,
            "rtf": total_s / (len(x) / SR)}


def phase_features(model: str, x: np.ndarray) -> float:
    """Kernel-path features of a long broadcast against the plain path,
    both on the card; max |delta| in dB."""
    import torch
    from sm_hpss_mtl_tpu_torch.cli import segment as cli
    from sm_hpss_mtl_tpu_torch.ops import frontend

    preset = cli.MODEL_PRESETS[model]
    dev = torch.device("cuda")
    got = cli._featurize_broadcast(x, preset, dev)
    k1, k2 = frontend.stft_hpss_mel, frontend.stft_hpss
    frontend.stft_hpss_mel = (
        lambda y, M, dft_precision="highest", **kw:
        frontend.stft_hpss_mel_plain(y, M, **kw))
    frontend.stft_hpss = (
        lambda y, dft_precision="highest", **kw:
        frontend.stft_hpss_plain(y, **kw))
    try:
        want = cli._featurize_broadcast(x, preset, dev)
    finally:
        frontend.stft_hpss_mel, frontend.stft_hpss = k1, k2
    check(got.shape == want.shape, "feature shapes differ")
    return (got - want).abs().max().item()


def resynth(wav: str, out_dir: str, device: str) -> dict:
    """One ``cli.hpss_resynth`` run (host clock around it); its three wavs
    checked, and the harmonic and percussive signals it computed kept."""
    from sm_hpss_mtl_tpu_torch.cli import hpss_resynth as cli

    kept = {}
    resynthesize = cli.resynthesize

    def keep(x, **kw):
        kept["yh"], kept["yp"] = resynthesize(x, **kw)
        return kept["yh"], kept["yp"]

    cli.resynthesize = keep
    try:
        with recorded() as rec:
            t0 = time.perf_counter()
            paths = cli.main([wav, "--out-dir", out_dir, "--device", device])
            total_s = time.perf_counter() - t0
    finally:
        cli.resynthesize = resynthesize
    check(len(paths) == 3 and all(os.path.getsize(p) > 44 for p in paths),
          "hpss_resynth did not write its three wavs")
    for k in ("yh", "yp"):
        check(bool(np.isfinite(kept[k]).all()), f"resynthesis {k} not finite")
    return {**kept, "launches": rec["launches"], "shapes": rec["shapes"],
            "total_s": total_s}


def resynth_delta(got: np.ndarray, want: np.ndarray, n_fft: int = 400,
                  hop: int = 160) -> float:
    """max |got - want| / max |want|, both weighted by min(1, wsum), the
    overlap-added squared window.  The iSTFT divides by wsum, which is
    ~1e-9 at the first and last samples, so there it multiplies rounding
    by up to ~1e9 (the JAX package's iSTFT too); the weight keeps those
    samples from deciding the comparison."""
    from sm_hpss_mtl_tpu_torch.ops.stft import hann_window
    w = hann_window(n_fft, n_fft).numpy().astype(np.float64) ** 2
    T = 1 + (len(want) - n_fft) // hop
    wsum = np.zeros(len(want))
    for t in range(T):
        wsum[t * hop:t * hop + n_fft] += w
    weight = np.minimum(wsum, 1.0)
    return float(np.abs((got - want) * weight).max()
                 / np.abs(want * weight).max())


def build_all() -> tuple[float, list[str]]:
    """Compile every CUDA source at once, one nvcc process each; load the
    libraries.  Returns the wall time and the ptxas reports."""
    from sm_hpss_mtl_tpu_torch.ops import _nvcc, frontend, hpss
    sources = sorted(p.name for p in _nvcc.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as ex:
        libs = list(ex.map(_nvcc.build, sources))
    frontend.build()
    hpss.build()
    logs = [f"{lib.name}:\n" + lib.with_suffix(".so.log").read_text().strip()
            for lib in libs if lib.with_suffix(".so.log").exists()]
    return time.perf_counter() - t0, logs


def run() -> None:
    import torch
    card = card_line()
    print(f"[1 card] {card}", flush=True)

    build_s, logs = build_all()
    print(f"[2 build] {build_s:.2f} s", flush=True)
    for log in logs:
        print(log, flush=True)

    entries, checked = phase_kernels(card)
    print("[3 kernels] ok; " + "; ".join(
        f"{e['name']} {e['ms']:.4f} ms at {e['timed_shape']}"
        for e in entries), flush=True)

    from sm_hpss_mtl_tpu_torch import weights
    from sm_hpss_mtl_tpu_torch.models.lemaire import init_weights
    from sm_hpss_mtl_tpu_torch.models.zoo import get_model
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        def out(name):
            return os.path.join(tmp, name)

        wpath = {}
        for model in ("Lemaire_et_al_MTL", "Jang_et_al_MTL"):
            wpath[model] = out(f"{model}.npz")
            net = init_weights(get_model(model),
                               torch.Generator().manual_seed(SEED))
            weights.save_npz(wpath[model], weights.to_flax(net.state_dict()))
            del net

        wav60, x60 = write_broadcast(tmp, "b60.wav", 60.0, SEED)
        wav600, x600 = write_broadcast(tmp, "b600.wav", 600.0, SEED + 1)
        wav10, x10 = write_broadcast(tmp, "b10.wav", 10.0, SEED + 2)

        lem = "Lemaire_et_al_MTL"
        runs["lemaire_60"] = whole = serve(lem, wav60, wpath[lem],
                                           out("g60.npz"), "cuda", x60)
        check(whole["launches"]["K1"] > 0, "whole-signal run launched no K1")
        ref = serve(lem, wav60, wpath[lem], out("c60.npz"), "cpu", x60)
        for k in ("track_S", "track_M"):
            d = np.abs(whole["tracks"][k] - ref["tracks"][k]).max()
            check(d <= TRACK_TOL, f"{k}: GPU vs CPU max |delta| {d:.3e}")
        print(f"[4 whole] {whole['frames']} frames, "
              f"{whole['launches']['K1']} K1 launches, tracks match the CPU "
              "run", flush=True)

        runs["lemaire_600"] = slabbed = serve(lem, wav600, wpath[lem],
                                              out("g600.npz"), "cuda", x600)
        check(slabbed["launches"]["K1"] > 0, "slabbed run launched no K1")
        print(f"[5 slabbed] {slabbed['frames']} frames, "
              f"{slabbed['launches']['K1']} K1 launches", flush=True)

        db = phase_features(lem, x600)
        check(db <= FEATURE_DB_TOL, f"features differ by {db:.4f} dB")
        print(f"[6 features] kernel vs plain max |delta| {db:.5f} dB",
              flush=True)

        jang = "Jang_et_al_MTL"
        jw = wpath[jang]
        runs["jang_60"] = j60 = serve(jang, wav60, jw, out("j60.npz"), "cuda",
                                      x60)
        runs["jang_600"] = j600 = serve(jang, wav600, jw, out("j600.npz"),
                                        "cuda", x600)
        runs["jang_10"] = j10 = serve(jang, wav10, jw, out("j10.npz"), "cuda",
                                      x10)
        j10_cpu = serve(jang, wav10, jw, out("c10.npz"), "cpu", x10)
        for r in (j60, j600, j10):
            check(r["launches"]["K2"] > 0, "a Jang run launched no K2")
        jang_track = max(
            float(np.abs(j10["tracks"][k] - j10_cpu["tracks"][k]).max())
            for k in ("track_S", "track_M"))
        check(jang_track <= TRACK_TOL,
              f"Jang tracks: GPU vs CPU max |delta| {jang_track:.3e}")
        jang_db = phase_features(jang, x600)
        check(jang_db <= FEATURE_DB_TOL,
              f"Jang features differ by {jang_db:.4f} dB")
        print(f"[7 jang] {j60['frames']} + {j600['frames']} + "
              f"{j10['frames']} frames, K2 launches "
              f"{j60['launches']['K2']} + {j600['launches']['K2']} + "
              f"{j10['launches']['K2']}; 10 s tracks vs CPU max |delta| "
              f"{jang_track:.3e} (CPU run {j10_cpu['total_s']:.1f} s); "
              f"10 min features vs plain {jang_db:.5f} dB", flush=True)

        runs["resynth_60"] = rs = resynth(wav60, out("rg"), "cuda")
        check(rs["launches"]["K3"] > 0, "resynthesis launched no K3")
        rs_cpu = resynth(wav60, out("rc"), "cpu")
        rs_delta = max(resynth_delta(rs[k], rs_cpu[k]) for k in ("yh", "yp"))
        check(rs_delta <= RESYNTH_TOL,
              f"resynthesis GPU vs CPU {rs_delta:.3e} of the peak")
        rs_warm = resynth(wav60, out("rw"), "cuda")
        print(f"[8 resynth] {rs['launches']['K3']} K3 launches, GPU vs CPU "
              f"{rs_delta:.3e} of the peak", flush=True)

        lem_t = {"whole_60s": time_legs(lem, x60, wav60, wpath[lem],
                                        out("t60.npz"), whole["total_s"]),
                 "slabbed_600s": time_legs(lem, x600, wav600, wpath[lem],
                                           out("t600.npz"),
                                           slabbed["total_s"])}
        jang_t = {"whole_60s": time_legs(jang, x60, wav60, jw,
                                         out("u60.npz"), j60["total_s"]),
                  "slabbed_600s": time_legs(jang, x600, wav600, jw,
                                            out("u600.npz"),
                                            j600["total_s"])}

    paths = {"K1": ("lemaire_60", "lemaire_600"),
             "K2": ("jang_60", "jang_600", "jang_10"),
             "K3": ("resynth_60",)}
    for entry, (kernel, names) in zip(entries, paths.items()):
        entry["launches"] = sum(runs[n]["launches"][kernel] for n in names)
        check(entry["launches"] > 0, f"{kernel} never launched on its path")
        shapes = set().union(*(runs[n]["shapes"][kernel] for n in names))
        unchecked = shapes - checked[kernel]
        check(not unchecked, f"{kernel} launched at shapes phase 3 did not "
              f"check: {sorted(unchecked)}")
        others = [n for n in runs if n not in names
                  and runs[n]["launches"][kernel]]
        check(not others, f"{kernel} launched on another path: {others}")
    print("[9 checks] ok", flush=True)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"serving": {
        "card": card, "lemaire_mtl": lem_t, "jang_mtl": jang_t,
        "feature_max_abs_db": {"lemaire_mtl": db, "jang_mtl": jang_db},
        "jang_track_max_abs_delta_vs_cpu": jang_track,
        "jang_cpu_10s_total_ms": 1e3 * j10_cpu["total_s"],
        "build_s": build_s}}))
    print(json.dumps({"resynthesis": {
        "card": card, "audio_s": len(x60) / SR,
        "first_run_total_ms": 1e3 * rs["total_s"],
        "total_ms": 1e3 * rs_warm["total_s"],
        "cpu_total_ms": 1e3 * rs_cpu["total_s"],
        "gpu_vs_cpu_peak_rel": rs_delta}}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    try:
        import sm_hpss_mtl_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable: {e}", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    run()
    return 0


if __name__ == "__main__":
    sys.exit(main())

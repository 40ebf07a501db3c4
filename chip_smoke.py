#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``sm_hpss_mtl_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which must pass:

1. card: the GPU's name and power limit (nvidia-smi);
2. build: the CUDA kernels of ``sm_hpss_mtl_tpu_torch/csrc`` with nvcc;
3. kernels: each kernel against its plain PyTorch version on the card at
   the main path's shapes and at edge geometries;
4. whole-signal serving: ``cli.segment.main`` on a synthetic 60 s
   broadcast with full-width Lemaire-MTL weights from a seeded init, and
   the same run on the CPU as its reference;
5. slabbed serving: the same on a 10-minute broadcast (~60k frames,
   featurized in 16384-frame slabs, 10000-window chunks);
6. features of the 10-minute broadcast through the kernel against the
   plain version on the card (max |delta| <= 0.02 dB);
7. checks on the outputs, on the kernel launch counts, and that every
   launch shape of phases 4-5 was checked in phase 3.

Prints a ``{"kernels": [...]}`` line, a serving-times line, the card line,
and last ``{"ok": true, "device": {...}}``.  Exits non-zero, and prints no
result, if any phase fails or no GPU is present.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SR = 16000
SEED = 0
#: Kernel tolerance against its plain version, as the JAX package holds its
#: Pallas kernel to the jnp oracle (tests/test_frontend_pallas.py).
RTOL, ATOL = 2e-4, 2e-5
#: Feature fidelity bar of the serving path (BASELINE.md).
FEATURE_DB_TOL = 0.02
#: Probability tracks, GPU run against the CPU run of the same CLI.
TRACK_TOL = 1e-3
#: H100 peaks (NVIDIA data sheet): HBM bytes/s and float32 CUDA-core FLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = {"PCIe": 51e12, "default": 67e12}


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


def write_wav(path: str, x: np.ndarray) -> None:
    from scipy.io import wavfile
    wavfile.write(path, SR, (x * 32767).astype(np.int16))


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


def k1_bound_ms(T: int, N: int, n_fft: int, n_mels: int, mel_nnz: int,
                l_harm: int, l_perc: int, card: str
                ) -> tuple[float, str, float]:
    """Least time for K1's function on this card: the larger of its bytes
    (each input read once, each output written once) over HBM and the f32
    operations it needs over the CUDA-core peak.  Operations per frame:
    the window (n_fft), a real FFT (2.5 n_fft log2 n_fft), the magnitude
    (3 per bin), both median networks (min and max per comparator), the
    masks (10 per bin) and the mel projection over the basis's nonzeros
    (two outputs, one FMA each).  Also returns the operations bound with
    the DFT and the mel projection priced as the dense products the
    kernel computes (2 n_fft 2F and 2 F n_mels per output per frame)."""
    from sm_hpss_mtl_tpu_torch.ops.frontend import KERNEL_MEDIANS
    comparators = {21: 91, 11: 32, 5: 8}
    check((l_harm, l_perc) in KERNEL_MEDIANS, "no comparator count")
    F = 1 + n_fft // 2
    nbytes = 4 * (N + n_mels * F + 2 * n_mels * T)
    common = (n_fft + 3 * F
              + (comparators[l_harm] + comparators[l_perc]) * 2 * F + 10 * F)
    flops = T * (2.5 * n_fft * np.log2(n_fft) + common + 2 * 2 * mel_nnz)
    direct = T * (2 * n_fft * 2 * F + common + 2 * 2 * F * n_mels)
    peak = F32_FLOPS["PCIe" if "PCIe" in card else "default"]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes > t_ops else "operations",
            1e3 * max(t_bytes, direct / peak))


def phase_kernels(card: str) -> tuple[dict, set]:
    """K1 against its plain version on the card, at edge geometries and at
    every launch shape of the serving runs: the 60 s broadcast bucketed
    to 6024 frames, and the slabs of the 10-minute one (16394 and 16404
    frames).
    Returns the kernel's entry and the (n_fft, l_harm, l_perc, B, T)
    shapes checked."""
    import torch
    from sm_hpss_mtl_tpu_torch.ops import frontend
    from sm_hpss_mtl_tpu_torch.ops.mel import mel_filterbank

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [(400, 21, 11, 120, 2, T) for T in (1, 7, 19, 21, 48, 58, 98)]
    cases += [(512, 11, 5, 120, 2, 71)]
    cases += [(400, 21, 11, 120, 1, T) for T in (6024, 16384, 16394, 16404)]
    max_err = 0.0
    for n_fft, lh, lp, n_mels, B, T in cases:
        N = n_fft + (T - 1) * 160
        y = torch.randn((B, N), generator=gen, device="cuda")
        M = mel_filterbank(22050, n_fft, n_mels, device="cuda")
        kw = dict(n_fft=n_fft, win_length=400, hop_length=160, l_harm=lh,
                  l_perc=lp)
        got = frontend.stft_hpss_mel(y, M, **kw)
        want = frontend.stft_hpss_mel_plain(y, M, **kw)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            check(g.shape == w.shape == (B, n_mels, T),
                  f"K1 shape {tuple(g.shape)} at n_fft={n_fft} T={T}")
            err = (g - w).abs()
            ok = bool((err <= ATOL + RTOL * w.abs()).all())
            check(ok and bool(torch.isfinite(g).all()),
                  f"K1 disagrees with plain at n_fft={n_fft} T={T} B={B}: "
                  f"max |delta| {err.max().item():.3e}")
            max_err = max(max_err, err.max().item())
        print(f"kernel stft_hpss_mel n_fft={n_fft} l=({lh},{lp}) B={B} "
              f"T={T}: ok, max |delta| {max_err:.3e}", flush=True)
    checked = {(n_fft, lh, lp, B, T) for n_fft, lh, lp, _, B, T in cases}

    # Time at the main path's dominant launch: an interior slab of the
    # slabbed featurizer, 16384 frames plus a 10-frame margin on each side.
    T, n_fft = 16384 + 2 * 10, 400
    N = n_fft + (T - 1) * 160
    y = torch.randn((1, N), generator=gen, device="cuda")
    M = mel_filterbank(22050, n_fft, 120, device="cuda")
    ms = cuda_ms(lambda: frontend.stft_hpss_mel(y, M))
    plain_ms = cuda_ms(lambda: frontend.stft_hpss_mel_plain(y, M), reps=5)
    bound, bound_by, direct = k1_bound_ms(
        T, N, n_fft, 120, int((M != 0).sum()), 21, 11, card)
    return {"name": "stft_hpss_mel", "route": "cuda",
            "source": "sm_hpss_mtl_tpu_torch/csrc/frontend.cu",
            "replaces": "sm_hpss_mtl_tpu/ops/frontend_pallas.py:207",
            "launches": None, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": None, "bound_direct_dft_ms": direct,
            "timed_shape": [1, N]}, checked


def serve(wav: str, weights: str, out: str, device: str, x: np.ndarray,
          chunk_frames: int = 10000) -> dict:
    """One ``cli.segment`` run (host clock around it); outputs checked.
    Also returns the (n_fft, l_harm, l_perc, B, T) shape of each K1
    launch."""
    from sm_hpss_mtl_tpu_torch.cli import segment as cli
    from sm_hpss_mtl_tpu_torch.ops import frontend

    shapes = set()
    launch = frontend._launch

    def recording(y, M, **kw):
        shapes.add((kw["n_fft"], kw["l_harm"], kw["l_perc"],
                    y.numel() // y.shape[-1],
                    1 + (y.shape[-1] - kw["n_fft"]) // kw["hop_length"]))
        return launch(y, M, **kw)

    frontend._launch = recording
    try:
        frontend.stft_hpss_mel.launches = 0
        t0 = time.perf_counter()
        prob, labels = cli.main([wav, "--weights", weights, "--device",
                                 device, "--chunk-frames", str(chunk_frames),
                                 "--out", out])
        total_s = time.perf_counter() - t0
        launches = frontend.stft_hpss_mel.launches
    finally:
        frontend._launch = launch

    T = 1 + (len(x) - 400) // 160
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

    return {"tracks": tracks, "launches": launches, "frames": T,
            "total_s": total_s, "shapes": shapes}


def time_legs(x: np.ndarray, wav: str, weights: str, out: str,
              first_s: float, chunk_frames: int = 10000) -> dict:
    """A served broadcast timed again, warm: the whole CLI run, then its
    featurize and model legs on their own (host clock around work that
    ends in a synchronise or a copy to the host)."""
    import torch
    from sm_hpss_mtl_tpu_torch.cli import segment as cli
    from sm_hpss_mtl_tpu_torch.eval.segment import StreamingSegmenter

    from sm_hpss_mtl_tpu_torch.data.audio import read_wav
    from sm_hpss_mtl_tpu_torch.eval.segment import smooth_predictions

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cli.main([wav, "--weights", weights, "--chunk-frames", str(chunk_frames),
              "--out", out])
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
        x, cli.MODEL_PRESETS[cli.MODEL], dev), sync=True)
    model = leg("load_model_ms", lambda: cli.load_model(weights, dev),
                sync=True)
    seg = StreamingSegmenter(predict_fn=model, chunk_frames=chunk_frames)
    # frame_probabilities ends with the tracks on the host.
    tracks = leg("model_ms", lambda: seg.frame_probabilities(fv))
    leg("smooth_ms", lambda: smooth_predictions(tracks["S"][:, 0], 501))
    return {"audio_s": len(x) / SR, **legs, "total_ms": 1e3 * total_s,
            "first_run_total_ms": 1e3 * first_s,
            "rtf": total_s / (len(x) / SR)}


def phase_features(x: np.ndarray) -> float:
    """Kernel-path features of a long broadcast against the plain path,
    both on the card."""
    import torch
    from sm_hpss_mtl_tpu_torch.cli import segment as cli
    from sm_hpss_mtl_tpu_torch.ops import frontend

    preset = cli.MODEL_PRESETS[cli.MODEL]
    dev = torch.device("cuda")
    got = cli._featurize_broadcast(x, preset, dev)
    kernel = frontend.stft_hpss_mel
    frontend.stft_hpss_mel = (
        lambda y, M, dft_precision="highest", **kw:
        frontend.stft_hpss_mel_plain(y, M, **kw))
    try:
        want = cli._featurize_broadcast(x, preset, dev)
    finally:
        frontend.stft_hpss_mel = kernel
    check(got.shape == want.shape, "feature shapes differ")
    return (got - want).abs().max().item()


def run() -> None:
    import torch
    card = card_line()
    print(f"[1 card] {card}", flush=True)

    from sm_hpss_mtl_tpu_torch.ops import _nvcc, frontend
    t0 = time.perf_counter()
    frontend.build()
    build_s = time.perf_counter() - t0
    log = _nvcc.library_path("frontend.cu").with_suffix(".so.log")
    print(f"[2 build] frontend.cu in {build_s:.2f} s", flush=True)
    if log.exists():
        print(log.read_text().strip(), flush=True)

    k1, k1_checked = phase_kernels(card)
    print(f"[3 kernels] ok; K1 {k1['ms']:.4f} ms at {k1['timed_shape']} "
          "samples", flush=True)

    from sm_hpss_mtl_tpu_torch import weights
    from sm_hpss_mtl_tpu_torch.models.lemaire import init_weights
    from sm_hpss_mtl_tpu_torch.models.zoo import get_model
    with tempfile.TemporaryDirectory() as tmp:
        wpath = os.path.join(tmp, "lemaire_mtl.npz")
        model = init_weights(get_model("Lemaire_et_al_MTL"),
                             torch.Generator().manual_seed(SEED))
        weights.save_npz(wpath, weights.to_flax(model.state_dict()))

        x60 = synth_broadcast(60.0, SEED)
        wav60 = os.path.join(tmp, "b60.wav")
        write_wav(wav60, x60)
        x60 = (x60 * 32767).astype(np.int16).astype(np.float32) / 32768.0
        whole = serve(wav60, wpath, os.path.join(tmp, "g60.npz"), "cuda", x60)
        check(whole["launches"] > 0, "whole-signal run launched no K1")
        ref = serve(wav60, wpath, os.path.join(tmp, "c60.npz"), "cpu", x60)
        for k in ("track_S", "track_M"):
            d = np.abs(whole["tracks"][k] - ref["tracks"][k]).max()
            check(d <= TRACK_TOL, f"{k}: GPU vs CPU max |delta| {d:.3e}")
        print(f"[4 whole] {whole['frames']} frames, {whole['launches']} K1 "
              f"launches, tracks match the CPU run", flush=True)

        x600 = synth_broadcast(600.0, SEED + 1)
        wav600 = os.path.join(tmp, "b600.wav")
        write_wav(wav600, x600)
        x600 = (x600 * 32767).astype(np.int16).astype(np.float32) / 32768.0
        slabbed = serve(wav600, wpath, os.path.join(tmp, "g600.npz"), "cuda",
                        x600)
        check(slabbed["launches"] > 0, "slabbed run launched no K1")
        print(f"[5 slabbed] {slabbed['frames']} frames, "
              f"{slabbed['launches']} K1 launches", flush=True)

        db = phase_features(x600)
        check(db <= FEATURE_DB_TOL, f"features differ by {db:.4f} dB")
        print(f"[6 features] kernel vs plain max |delta| {db:.5f} dB",
              flush=True)

        whole_t = time_legs(x60, wav60, wpath, os.path.join(tmp, "t60.npz"),
                            whole["total_s"])
        slabbed_t = time_legs(x600, wav600, wpath,
                              os.path.join(tmp, "t600.npz"),
                              slabbed["total_s"])

    k1["launches"] = whole["launches"] + slabbed["launches"]
    unchecked = (whole["shapes"] | slabbed["shapes"]) - k1_checked
    check(not unchecked, f"K1 launched at shapes phase 3 did not check: "
          f"{sorted(unchecked)}")
    print("[7 checks] ok", flush=True)
    print(json.dumps({"kernels": [k1]}))
    print(json.dumps({"serving": {
        "card": card, "whole_60s": whole_t,
        "slabbed_600s": slabbed_t, "feature_max_abs_db": db,
        "build_s": build_s}}))
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

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``sm_hpss_mtl_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which must pass:

1. card: the GPU's name and power limit (nvidia-smi);
2. build: the CUDA sources of ``sm_hpss_mtl_tpu_torch/csrc`` with nvcc, one
   process per source, all started together;
3. kernels: K1 and K2 (``frontend.launch``, the fused kernel at any
   length), K3 (``hpss``, ``hpss_masks``) and K4 (``hpss_mel``) against
   their plain PyTorch versions on the card, at every launch shape of the
   paths below and at edge geometries;
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
   K2 against the plain version (<= 0.02 dB); Papakostas-MTL serving (K2
   at n_fft 400): the 60 s broadcast on the card, the 10 s one on the card
   and on the CPU (tracks within 1e-3); Lemaire's variants,
   ``--model Lemaire_et_al_Cascaded_MTL`` (``LogMelHarmSpec``, K1 with its
   harmonic half kept) and ``--model Lemaire_et_al_MTL_5class``, on the
   60 s broadcast on the card and on the CPU (tracks within 1e-3);
8. HPSS resynthesis: ``cli.hpss_resynth.main`` on the 60 s broadcast on
   the card (masks through K3) and on the CPU;
9. file-wise evaluation: on a MUSAN-shaped toy corpus (3-30 s files of
   music, speech and noise, and clips of 0.12-0.2 s),
   ``FileWiseTester.test_model`` and ``smr_sweep`` with Lemaire-MTL through
   ``Featurizer(bucket=False)`` (K1, and K4 for items under 20 frames) on
   the card and on the CPU (predictions within 1e-3, labels and confusion
   matrices equal but for near-ties); ``Classifier.classify_file`` on the
   60 s broadcast on both; one Jang-MTL ``test_model`` on the card (K2,
   and K3 for short items), and one Papakostas-MTL ``test_model`` (K2 at
   n_fft 400, K3 for short items); on the card and on the CPU as
   Lemaire-MTL's, a 5-class ``test_model`` (noise singles and
   speech+noise pairs, a (5, 5) confusion matrix), an intermediate-fusion
   ``test_model`` (``dual_tower``), and ``cli.fuse_late.main`` over two
   checkpoints (``LogMelHarmSpec`` and ``LogMelPercSpec`` models; the
   driver's bucketed featurizer, K1 once per item and leg);
10. training at full width on a ``make_toy_musan`` corpus (9 files of 4 s
   per class), each through ``cli.mtl.main`` or ``cli.baseline.main`` for
   fold 0: Lemaire-MTL (2 epochs of 10 train and 2 val steps) by the
   device pipeline (K1 once per train or eval step, at 48 clips x 11120
   samples) and by the host pipeline (K1 once per featurized file), and
   with ``--frame-level-scaling`` (the statistics pass: K1 once per
   training file); Jang-MTL by both pipelines (K2 at n_fft 512: 67 frames
   a clip), Papakostas-MTL (K2 at n_fft 400) and Doukhan-MTL (K1) by the
   device pipeline; the single-task Jang and Papakostas models through
   ``cli.baseline`` for one epoch (no kernel); after ``cli.make_folds
   --with-noise``, Lemaire's variants by the device pipeline:
   Cascaded-MTL through ``cli.mtl``, the 5-class model through
   ``cli.five_class`` (K1 at 80 clips x 11120 samples) and the
   intermediate-fusion model through ``cli.fuse_intermediate`` (by the
   host pipeline too, the dual batcher).  One Lemaire-MTL train step
   from the same weights on the card and on the CPU (loss, every update,
   BatchNorm statistics), and with K1 inside; the same for Jang-MTL with
   K2 inside and for Papakostas-MTL on patches, the intermediate-fusion
   model with K1 inside and the 5-class model on patches; 20 steps on one
   batch for Lemaire-MTL, Jang-MTL and the intermediate-fusion model (the
   loss falls); the device pipeline's step time (CUDA events) and the
   kernel's and the device's share of it (profiler), for Lemaire-MTL,
   Jang-MTL, the intermediate-fusion and the 5-class models;
11. checks on the launch counts, and that every launch shape of phases 4-10
   was checked in phase 3 (K1 and K2 also at 12 clips x 43760 samples, the
   device pipeline's launch on a corpus of MUSAN's size, and K1 at 20 x
   43760, the 5-class model's there).

Each path runs with the launch counts set to 0 just before it and read
just after.  Every kernel also reports its profiler device time, blocks
per SM, the ptxas registers and spills, and the comparators per output
of its median networks, counted in the ``csrc/`` it was built from; K1
and K2 their max |delta| against a float64 run of the plain version at
the timed shape, and their bound also with the medians priced at their
own networks; K3 its times on a rotation of inputs larger than L2 and at
Jang's short evaluation shape, and K4 the short-clip route (``stft_mag``
and K4) against K1 at the same length.  Every bound prices the medians
at the shared-core networks' count, the least work known.  Prints a
``{"kernels": [...]}`` line, a serving-times line, a resynthesis line,
an evaluation line, a training line, the script's total seconds, the card
line, and last ``{"ok": true, "device": {...}}``.  Exits non-zero, and
prints no result, if any phase fails or no GPU is present.  Imports
nothing of JAX.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

SR = 16000
SEED = 0
#: K1 and K2 tolerance against their plain version, as the JAX package
#: holds its Pallas kernel to the jnp oracle (tests/test_frontend_pallas.py).
RTOL, ATOL = 2e-4, 2e-5
#: K3 and K4 tolerance against their plain versions, as
#: tests/test_hpss_pallas.py holds the spectral Pallas kernels.
K3_RTOL, K3_ATOL = 1e-5, 1e-6
#: Feature fidelity bar of the serving path (BASELINE.md).
FEATURE_DB_TOL = 0.02
#: Probability tracks, GPU run against the CPU run of the same CLI; also
#: the evaluation's predictions and the Classifier's probabilities.
TRACK_TOL = 1e-3
#: A patch whose CPU top two 3C probabilities lie this close may take
#: another label on the card.
TIE_TOL = 1e-3
#: Evaluation corpus: files per class of 3-30 s, short clips per class,
#: and the sweep's SMR levels (the reference's).
EVAL_FILES, EVAL_SHORT = 6, 3
SMR_LEVELS = (-5, 0, 5, 10, 15, 20)
#: Training corpus: files per class and seconds per file.
TRAIN_FILES, TRAIN_SECONDS = 9, 4.0
#: Training run of each pipeline: epochs, train and val steps per epoch.
TRAIN_EPOCHS, TRAIN_STEPS, VAL_STEPS = 2, 10, 2
#: K1's and K2's launches in the device training pipeline, (clips,
#: samples): 16 clips per class of one 68-frame patch (the toy corpus
#: resolves ``clip_patches`` to 1), and 4 clips per class of four patches
#: (a corpus of MUSAN's size resolves it to 4).  The crop is framed for a
#: 400-sample window: at n_fft 512 it holds 67 and 271 frames.
TRAIN_SHAPES = ((48, 11120), (12, 43760))
#: K1's launches in the 5-class device pipeline: the same crops for five
#: classes.
FIVE_CLASS_SHAPES = ((80, 11120), (20, 43760))
#: Lemaire's variants: Cascaded-MTL, the 5-class model, intermediate fusion.
CASCADED, FIVE, IF = ("Lemaire_et_al_Cascaded_MTL",
                      "Lemaire_et_al_MTL_5class", "Lemaire_et_al_MTL_IF")
#: The five classes of the 5-class folds, in batch order.
FIVE_CLASSES = ["music", "speech", "speech+music", "noise", "speech+noise"]
#: The models phase 10 trains beside Lemaire-MTL, and their run names.
IMAGE_MTL = ("Jang_et_al_MTL", "Papakostas_et_al_MTL", "Doukhan_et_al_MTL")
BASELINES = ("Jang_et_al", "Papakostas_et_al")
#: One train step on the card against the same step on the CPU: the loss
#: (relative), each parameter's update (relative to the update's L2 norm,
#: plus a rounding floor, see ``_step_card_vs_cpu``), the BatchNorm
#: statistics (absolute, or relative above 1).
STEP_LOSS_RTOL, STEP_UPDATE_RTOL, STEP_STATS_TOL = 1e-3, 1e-2, 1e-3
#: The same step with K1 inside on the card: each update's bar.  K1 holds
#: 2e-4 of its plain version, but the crop-local row standardization
#: divides rows near the dB floor by a small std and moves them by up to
#: 0.1, which moves some updates by a few percent of their norm (3.0e-2
#: on an H100 80GB HBM3 for this corpus and seed).
STEP_AUDIO_UPDATE_RTOL = 1e-1
#: Jang-MTL's step with K2 inside: each update's bar.  Its mel-scale
#: kernels read the standardized features directly, and a 67-frame row at
#: the dB floor but for one frame standardizes to 0 where the row is
#: exactly constant (the CPU's, say) and to sqrt(66) = 8.1 at that frame
#: where it is not (the card's, 1e-6 dB off): the features differ by up
#: to 8.1 in 34 rows of 24672, which moves melCl_P's update by 17% of its
#: norm (an H100 80GB HBM3 for this corpus and seed).
STEP_JANG_AUDIO_UPDATE_RTOL = 5e-1
#: The intermediate-fusion model's step with K1 inside: each update's bar.
#: Its two towers read the same standardized features as Lemaire-MTL, near-
#: floor rows up to 0.1 apart card vs CPU, and carry them further: on an
#: H100 80GB HBM3 for this corpus and seed the largest update, a bias of
#: the percussive tower whose update is 4.5% of the lr, moves by 0.108 of
#: its norm (Lemaire-MTL's largest: 3.0e-2), while the same model's patch
#: step on the CPU's features holds the patch bars.
STEP_IF_AUDIO_UPDATE_RTOL = 3e-1
#: The biases that feed a BatchNorm have a gradient of 0 in exact
#: arithmetic; their updates, rounding noise on both sides, are held to
#: this share of the first lr per element.
ZERO_GRAD_UPDATE = 1e-2
#: The optimizer of the card-against-CPU steps of the image models: plain
#: SGD (Papakostas's), whose update is lr * g, so that the update bars hold
#: the gradients.  Jang's and Doukhan's Adam takes lr * g / (|g| + eps) at
#: its first step, which turns a gradient that is 0 in exact arithmetic (a
#: conv bias before a BatchNorm) into an update of ~lr of either sign.
STEP_SGD = "Papakostas_et_al"
#: Clips under this many frames take the short-clip kernels (K4, K3).
SHORT_FRAMES = 2 * (21 // 2)
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


def cuda_ms(fn, reps: int = 20, batches: int = 7
            ) -> tuple[float, float, float]:
    """ms per call of ``fn``: the median over ``batches`` batches of
    ``reps`` back-to-back calls, each timed by CUDA events, after a warm-up
    batch; also the fastest and slowest batch.  A call that takes less than
    its host-side enqueue is timed at the enqueue rate."""
    import torch
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    times.sort()
    return times[len(times) // 2], times[0], times[-1]


def device_ms(fn, kernel: str, reps: int = 50) -> float | None:
    """Device time per launch of the CUDA kernel whose name contains
    ``kernel``, from ``torch.profiler`` over ``reps`` calls of ``fn``; None
    where the profiler records no such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = count = 0
    for ev in prof.key_averages():
        if kernel in ev.key:
            total += getattr(ev, "device_time_total",
                             getattr(ev, "cuda_time_total", 0))
            count += ev.count
    return total / count / 1e3 if count else None


def _bound(nbytes: float, flops: float, card: str) -> tuple[float, str]:
    """The larger of bytes over HBM and f32 operations over the CUDA-core
    peak, in ms, and which of the two it is."""
    peak = F32_FLOPS["PCIe" if "PCIe" in card else "default"]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes > t_ops else "operations")


def median_comparators() -> tuple[dict, dict]:
    """Comparators per output of the median networks in the checkout's
    ``csrc/``, the sources phase 2 builds, counted from their text: per
    width L, ``Median<L>`` (one network per window, as K1 and K2 run
    them); per (l_harm, l_perc), harmonic plus percussive, the shared-core
    networks K3 and K4 run, ``MedianCore<W, K>`` over its K outputs plus
    one ``MedianMerge<K>`` each, with K the frames (``QT``) and bins
    (``QF``) of ``hpss.cu``'s unit.  The shared-core count is the least
    work known for the medians; every bound prices them with it."""
    import re
    from sm_hpss_mtl_tpu_torch.ops import _nvcc
    head = (_nvcc.CSRC / "median.cuh").read_text()
    unit = (_nvcc.CSRC / "hpss.cu").read_text()

    def count(pattern):
        return {tuple(int(g) for g in m.groups()[:-1]):
                len(re.findall(r"CS\(\d+,\d+\)", m.groups()[-1]))
                for m in re.finditer(pattern, head, re.S)}

    single = count(r"struct Median<(\d+)>\s*\{(.*?)return")
    cores = count(r"struct MedianCore<(\d+), (\d+)>\s*\{(.*?)\n\};")
    merges = count(r"struct MedianMerge<(\d+)>\s*\{(.*?)return")
    qf, qt = (int(re.search(rf"constexpr int {q} = (\d+);", unit).group(1))
              for q in ("QF", "QT"))

    def shared(w, k):
        return cores[(w, k)] / k + merges[(k,)]

    return ({w: n for (w,), n in single.items()},
            {(lh, lp): shared(lh, qt) + shared(lp, qf)
             for lh, lp in ((21, 11), (11, 5))})


def frontend_bound_ms(T: int, N: int, n_fft: int, comparators: float,
                      card: str, n_mels: int = 0, mel_nnz: int = 0,
                      B: int = 1) -> tuple[float, str, float]:
    """Least time for K1's function (``n_mels`` > 0) or K2's on this card,
    over ``B`` items of ``N`` samples and ``T`` frames each: the larger of
    its bytes (each input read once, each output written once) over HBM
    and the f32 operations it needs over the CUDA-core peak.
    Operations per frame: the window (n_fft), a real FFT (2.5 n_fft log2
    n_fft), the magnitude (3 per bin), both medians (min and max per
    comparator, ``comparators`` per bin), the masks (10 per bin) and, for
    K1, the mel projection over the basis's nonzeros (two outputs, one FMA
    each).  Bytes: the audio in, and two (n_mels, T) maps out plus the
    basis (K1) or two (F, T) maps out (K2).  Also returns the operations
    bound with the DFT and the mel projection priced as the dense products
    the kernels compute (2 n_fft 2F and 2 F n_mels per output per
    frame)."""
    F = 1 + n_fft // 2
    out_rows = n_mels if n_mels else F
    nbytes = 4 * (B * N + n_mels * F + 2 * B * out_rows * T)
    common = n_fft + 3 * F + comparators * 2 * F + MASK_OPS * F
    flops = B * T * (2.5 * n_fft * np.log2(n_fft) + common
                     + 2 * 2 * mel_nnz)
    direct = B * T * (2 * n_fft * 2 * F + common + 2 * 2 * F * n_mels)
    bound, by = _bound(nbytes, flops, card)
    return bound, by, _bound(nbytes, direct, card)[0]


def k3_bound_ms(B: int, F: int, T: int, comparators: float,
                card: str) -> tuple[float, str]:
    """Least time for K3's function: one (B, F, T) read and two written,
    against ``comparators`` per bin (min and max each) and the masks."""
    ops = comparators * 2 + MASK_OPS
    return _bound(4 * 3 * B * F * T, ops * B * F * T, card)


def k4_bound_ms(B: int, F: int, T: int, n_mels: int, mel_nnz: int,
                comparators: float, card: str) -> tuple[float, str]:
    """Least time for K4's function: one (B, F, T) magnitude and the
    (n_mels, F) basis read, two (B, n_mels, T) maps written, against K3's
    operations per bin and the mel sums over the basis's nonzeros (two
    outputs, one FMA each)."""
    ops = ((comparators * 2 + MASK_OPS) * B * F * T
           + 2 * 2 * mel_nnz * B * T)
    nbytes = 4 * (B * F * T + n_mels * F + 2 * B * n_mels * T)
    return _bound(nbytes, ops, card)


def ptxas_report(source: str, kernel: str) -> dict:
    """Registers and spill bytes that ``nvcc -Xptxas -v`` reported for the
    entry function of ``csrc/<source>`` whose mangled name contains
    ``kernel``."""
    from sm_hpss_mtl_tpu_torch.ops import _nvcc
    return parse_ptxas(
        Path(str(_nvcc.library_path(source)) + ".log").read_text(), kernel)


def parse_ptxas(log: str, kernel: str) -> dict:
    """``ptxas_report`` of one ``nvcc -Xptxas -v`` log."""
    import re
    part = log.split(kernel, 1)[1].split("Compiling entry function", 1)[0]
    spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                       part)
    return {"registers": int(re.search(r"Used (\d+) registers",
                                       part).group(1)),
            "spill_stores": int(spills.group(1)),
            "spill_loads": int(spills.group(2))}


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


def phase_kernels(card: str, eval_frames: dict) -> tuple[list[dict], dict]:
    """K1, K2, K3 and K4 against their plain versions on the card, at edge
    geometries and at every launch shape of the paths: K1 at the 60 s
    Lemaire broadcast bucketed to 6024 frames, the 10-minute slabs (16394
    and 16404 frames), each evaluated file's length and the training
    launches (the 5-class model's at 80 and 20 clips among them); K2 at
    n_fft 512 at the bucketed 10 s (1081) and 60 s (6023) Jang
    broadcasts, the same slabs and each evaluated file's length, at
    n_fft 400 at Papakostas's served and evaluated lengths, and both at the
    training launches; K3 at the 60 s resynthesis (201 bins, 5998 frames)
    and at 257 and 201 bins, every T under 20 (Jang's and Papakostas's
    short items); K4 at 201 bins, every T under 20 (Lemaire's short
    items).
    K1 and K2 run through ``frontend.launch``, which launches the fused
    kernel at every length (the dispatchers send T < 20 to K4 and K3).
    ``eval_frames`` holds the evaluation's frame counts per kernel and the
    most frequent K4 length.  Returns the kernel entries (launches still
    None) and, per kernel, the launch shapes checked."""
    import torch
    from sm_hpss_mtl_tpu_torch.ops import frontend, hpss
    from sm_hpss_mtl_tpu_torch.ops.mel import mel_filterbank
    from sm_hpss_mtl_tpu_torch.ops.stft import n_frames

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    checked = {"K1": set(), "K2": set(), "K3": set(), "K4": set()}

    def audio(n_fft, B, T):
        return torch.randn((B, n_fft + (T - 1) * 160), generator=gen,
                           device="cuda")

    def bank(n_fft):
        return mel_filterbank(22050, n_fft, 120, device="cuda")

    k1_cases = [(400, 21, 11, 2, T) for T in (1, 7, 19, 21, 48, 58, 98)]
    k1_cases += [(512, 11, 5, 2, 71)]
    k1_cases += [(512, 21, 11, 2, T) for T in (1, 19, 98)]
    k1_cases += [(400, 21, 11, 1, T) for T in sorted(
        {6024, 16384, 16394, 16404} | eval_frames["K1"])]
    k1_cases += [(400, 21, 11, B, n_frames(N, 400, 160))
                 for B, N in TRAIN_SHAPES + FIVE_CLASS_SHAPES]
    k1_err = 0.0
    for n_fft, lh, lp, B, T in k1_cases:
        y = audio(n_fft, B, T)
        M = bank(n_fft)
        kw = dict(n_fft=n_fft, win_length=400, hop_length=160, l_harm=lh,
                  l_perc=lp)
        k1_err = max(k1_err, compare(
            f"K1 n_fft={n_fft} l=({lh},{lp}) B={B} T={T}",
            frontend.launch(y, M, **kw),
            frontend.stft_hpss_mel_plain(y, M, **kw), RTOL, ATOL))
        checked["K1"].add((n_fft, lh, lp, B, T))
    print(f"kernel K1 stft_hpss_mel: {len(k1_cases)} shapes ok, "
          f"max |delta| {k1_err:.3e}", flush=True)

    k2_cases = [(n_fft, lh, lp, 2, T) for n_fft in (400, 512)
                for lh, lp in ((21, 11), (11, 5))
                for T in (1, 7, 19, 21, 48, 98)]
    k2_cases += [(512, 21, 11, 1, T) for T in sorted(
        {1081, 6023, 16394, 16404} | eval_frames["K2"])]
    k2_cases += [(400, 21, 11, 1, T) for T in sorted(eval_frames["K2_400"])]
    k2_cases += [(n_fft, 21, 11, B, n_frames(N, n_fft, 160))
                 for n_fft in (512, 400) for B, N in TRAIN_SHAPES]
    k2_err = 0.0
    for n_fft, lh, lp, B, T in k2_cases:
        y = audio(n_fft, B, T)
        kw = dict(n_fft=n_fft, win_length=400, hop_length=160, l_harm=lh,
                  l_perc=lp)
        k2_err = max(k2_err, compare(
            f"K2 n_fft={n_fft} l=({lh},{lp}) B={B} T={T}",
            frontend.launch(y, None, **kw),
            frontend.stft_hpss_plain(y, **kw),
            RTOL, ATOL))
        checked["K2"].add((n_fft, lh, lp, B, T))
    print(f"kernel K2 stft_hpss: {len(k2_cases)} shapes ok, "
          f"max |delta| {k2_err:.3e}", flush=True)

    k3_cases = [(mo, 21, 11, 2, 201, T) for mo in (False, True)
                for T in (1, 19, 364, 365)]
    k3_cases += [(mo, 21, 11, 1, 201, 5998) for mo in (False, True)]
    k3_cases += [(False, 21, 11, 1, F, T) for F in (257, 201)
                 for T in range(1, SHORT_FRAMES)]
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

    # K4: the short-clip domain (B = 1, F = 201, every T under 20), edge
    # lengths at B = 2, the narrow medians, and F = 257.
    k4_cases = [(21, 11, 1, 201, T) for T in range(1, SHORT_FRAMES)]
    k4_cases += [(21, 11, 2, 201, T) for T in (1, 7, 19, 32, 33, 5998)]
    k4_cases += [(11, 5, 2, 201, T) for T in (1, 9, 40)]
    k4_cases += [(21, 11, 2, 257, T) for T in (1, 19, 300)]
    k4_err = 0.0
    for lh, lp, B, F, T in k4_cases:
        S = torch.rand((B, F, T), generator=gen, device="cuda") ** 3
        M = bank(2 * (F - 1))
        got = hpss.hpss_mel(S, M, l_harm=lh, l_perc=lp)
        k4_err = max(k4_err, compare(
            f"K4 l=({lh},{lp}) B={B} F={F} T={T}", got,
            hpss.hpss_mel_plain(S, M, l_harm=lh, l_perc=lp),
            K3_RTOL, K3_ATOL))
        empty = (M == 0).all(dim=1)
        check(all(bool((g[:, empty] == 0).all()) for g in got),
              f"K4 F={F} T={T}: empty mel rows are not exact zeros")
        checked["K4"].add((lh, lp, B, F, T))
    # A basis whose bands all span F = 600 bins: the span is taken in
    # several passes, so no F is refused.
    S = torch.rand((1, 600, 5), generator=gen, device="cuda")
    M = torch.rand((8, 600), generator=gen, device="cuda")
    k4_err = max(k4_err, compare(
        "K4 F=600 dense basis", hpss.hpss_mel(S, M),
        hpss.hpss_mel_plain(S, M), K3_RTOL, K3_ATOL))
    print(f"kernel K4 hpss_mel: {len(k4_cases) + 1} shapes ok (F=600 with "
          f"a dense basis among them), max |delta| {k4_err:.3e}", flush=True)

    # Times at each kernel's dominant launch on its path: an interior slab
    # of the slabbed featurizer (16384 frames plus a 10-frame margin on
    # each side) for K1 (Lemaire, n_fft 400) and K2 (Jang, n_fft 512); the
    # 60 s resynthesis for K3; the evaluation's most frequent short clip
    # for K4, and K4 at the 60 s length, where it is more than latency.
    single, shared = median_comparators()
    entries = []
    T = 16384 + 2 * 10
    for name, n_fft, err in (("stft_hpss_mel", 400, k1_err),
                             ("stft_hpss", 512, k2_err)):
        y = audio(n_fft, 1, T)
        kw = dict(n_fft=n_fft)
        if name == "stft_hpss_mel":
            M = bank(n_fft)
            run = lambda: frontend.stft_hpss_mel(y, M, **kw)  # noqa: E731
            plain = lambda: frontend.stft_hpss_mel_plain(y, M, **kw)  # noqa
            mel = dict(n_mels=120, mel_nnz=int((M != 0).sum()))
            replaces = "sm_hpss_mtl_tpu/ops/frontend_pallas.py:207"
        else:
            run = lambda: frontend.stft_hpss(y, **kw)  # noqa: E731
            plain = lambda: frontend.stft_hpss_plain(y, **kw)  # noqa: E731
            mel = {}
            replaces = "sm_hpss_mtl_tpu/ops/frontend_pallas.py:219"
        bound, by, direct = frontend_bound_ms(
            T, y.shape[-1], n_fft, shared[(21, 11)], card, **mel)
        per_window = frontend_bound_ms(T, y.shape[-1], n_fft,
                                       single[21] + single[11], card, **mel)
        ms, plain_ms = cuda_ms(run), cuda_ms(plain, reps=5, batches=3)
        ref = (frontend.stft_hpss_mel_plain(y.double(), M.double(), **kw)
               if mel else frontend.stft_hpss_plain(y.double(), **kw))
        f64_err = [max((g.double() - w).abs().max().item()
                       for g, w in zip(fn(), ref)) for fn in (run, plain)]
        del ref
        fullres = name == "stft_hpss"
        entries.append({
            "name": name, "route": "cuda",
            "source": "sm_hpss_mtl_tpu_torch/csrc/frontend.cu",
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": ms[0], "plain_ms": plain_ms[0],
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "ms_spread": ms[1:], "plain_ms_spread": plain_ms[1:],
            "device_ms": device_ms(run, "frontend_kernel"),
            "max_err_vs_f64": f64_err[0], "plain_err_vs_f64": f64_err[1],
            "blocks_per_sm": frontend.blocks_per_sm(
                fullres=fullres, n_fft=n_fft, hop_length=160, l_harm=21,
                l_perc=11),
            **ptxas_report("frontend.cu",
                           f"frontend_kernelILi21ELi11ELb{int(fullres)}E"),
            "bound_direct_dft_ms": direct,
            "comparators_per_output": single[21] + single[11],
            "bound_comparators_per_output": shared[(21, 11)],
            "bound_ms_at_own_networks": per_window[0],
            "timed_shape": list(y.shape)})
    # K1 at the device training pipeline's batched launches, the 5-class
    # model's among them.
    M = bank(400)
    nnz = int((M != 0).sum())
    trained = {}
    for B, N in TRAIN_SHAPES + FIVE_CLASS_SHAPES:
        T = n_frames(N, 400, 160)
        y = audio(400, B, T)
        run = lambda: frontend.stft_hpss_mel(y, M)  # noqa: E731
        ms = cuda_ms(run, reps=50)
        plain_ms = cuda_ms(lambda: frontend.stft_hpss_mel_plain(y, M),
                           reps=3, batches=3)
        bound, by, _ = frontend_bound_ms(T, N, 400, shared[(21, 11)], card,
                                         n_mels=120, mel_nnz=nnz, B=B)
        trained[f"{B}x{N}"] = {
            "frames": T, "ms": ms[0], "ms_spread": ms[1:],
            "device_ms": device_ms(run, "frontend_kernel"),
            "plain_ms": plain_ms[0], "bound_ms": bound, "bound_by": by}
    entries[0]["training_shapes"] = trained
    # K2 at the same launches, for Jang-MTL (n_fft 512) and Papakostas-MTL
    # (n_fft 400).
    trained = {}
    for n_fft in (512, 400):
        for B, N in TRAIN_SHAPES:
            T = n_frames(N, n_fft, 160)
            y = torch.randn((B, N), generator=gen, device="cuda")
            run = lambda: frontend.stft_hpss(y, n_fft=n_fft)  # noqa: E731
            ms = cuda_ms(run, reps=50)
            plain_ms = cuda_ms(
                lambda: frontend.stft_hpss_plain(y, n_fft=n_fft), reps=3,
                batches=3)
            bound, by, _ = frontend_bound_ms(T, N, n_fft, shared[(21, 11)],
                                             card, B=B)
            trained[f"n_fft{n_fft}_{B}x{N}"] = {
                "frames": T, "ms": ms[0], "ms_spread": ms[1:],
                "device_ms": device_ms(run, "frontend_kernel"),
                "plain_ms": plain_ms[0], "bound_ms": bound, "bound_by": by,
                "blocks_per_sm": frontend.blocks_per_sm(
                    fullres=True, n_fft=n_fft, hop_length=160, l_harm=21,
                    l_perc=11),
                **ptxas_report("frontend.cu",
                               "frontend_kernelILi21ELi11ELb1E")}
    entries[1]["training_shapes"] = trained
    # K3: the 60 s resynthesis (mask-only), on one resident input and on
    # a rotation of 12 inputs (58 MB, over the 50 MB L2), and Jang's most
    # frequent short evaluation item (1 x 257 x T, masked components).
    k3 = {"comparators_per_output": shared[(21, 11)],
          "blocks_per_sm": hpss.blocks_per_sm(mel=False),
          **ptxas_report("hpss.cu", "hpss_kernelILi21ELi11ELb1E")}
    S = torch.rand((1, 201, 5998), generator=gen, device="cuda")
    bound, by = k3_bound_ms(1, 201, 5998, shared[(21, 11)], card)
    run = lambda: hpss.hpss_masks(S)  # noqa: E731
    ms = cuda_ms(run, reps=100)
    plain_ms = cuda_ms(lambda: hpss.hpss_masks_plain(S), reps=5, batches=3)
    rotation = [torch.rand((1, 201, 5998), generator=gen, device="cuda")
                for _ in range(12)]
    inputs = itertools.cycle(rotation)
    rotating = lambda: hpss.hpss_masks(next(inputs))  # noqa: E731
    cold = cuda_ms(rotating, reps=96)
    T3 = eval_frames["K3_T"]
    S3 = torch.rand((1, 257, T3), generator=gen, device="cuda") ** 3
    short_run = lambda: hpss.hpss(S3)  # noqa: E731
    short_ms = cuda_ms(short_run, reps=100)
    short_plain = cuda_ms(lambda: hpss.hpss_plain(S3), reps=5, batches=3)
    entries.append({
        "name": "hpss", "route": "cuda",
        "source": "sm_hpss_mtl_tpu_torch/csrc/hpss.cu",
        "replaces": "sm_hpss_mtl_tpu/ops/hpss_pallas.py:146",
        "launches": None, "max_abs_err": k3_err,
        "ms": ms[0], "plain_ms": plain_ms[0],
        "bound_ms": bound, "bound_by": by, "library_ms": None,
        "ms_spread": ms[1:], "plain_ms_spread": plain_ms[1:],
        "device_ms": device_ms(run, "hpss_kernel"),
        "timed_shape": list(S.shape), "timed_mode": "mask_only",
        "ms_rotating_58MB": cold[0], "ms_rotating_58MB_spread": cold[1:],
        "device_ms_rotating_58MB": device_ms(rotating, "hpss_kernel"),
        "short_shape": [1, 257, T3], "short_mode": "masked components",
        "ms_short": short_ms[0], "ms_short_spread": short_ms[1:],
        "device_ms_short": device_ms(short_run, "hpss_kernel"),
        "plain_ms_short": short_plain[0],
        "bound_ms_short": k3_bound_ms(1, 257, T3, shared[(21, 11)],
                                      card)[0], **k3})
    del rotation
    M = bank(400)
    nnz = int((M != 0).sum())
    k4 = {}
    for T in (eval_frames["K4_T"], 5998):
        S = torch.rand((1, 201, T), generator=gen, device="cuda") ** 3
        ms = cuda_ms(lambda: hpss.hpss_mel(S, M), reps=100)
        plain_ms = cuda_ms(lambda: hpss.hpss_mel_plain(S, M), reps=5,
                           batches=3)
        k4[T] = dict(ms=ms, plain_ms=plain_ms,
                     bound=k4_bound_ms(1, 201, T, 120, nnz,
                                       shared[(21, 11)], card),
                     device_ms=device_ms(lambda: hpss.hpss_mel(S, M),
                                         "hpss_mel_kernel"))
    # The short-clip route against K1 at the same length: frontend.launch
    # runs K1 at any length; stft_hpss_mel sends a clip this short to the
    # plain stft_mag and K4.
    y = audio(400, 1, eval_frames["K4_T"])
    kw = dict(n_fft=400, win_length=400, hop_length=160, l_harm=21,
              l_perc=11)
    route = {"frames": eval_frames["K4_T"],
             "k1_ms": cuda_ms(lambda: frontend.launch(y, M, **kw),
                              reps=100)[0],
             "k1_device_ms": device_ms(lambda: frontend.launch(y, M, **kw),
                                       "frontend_kernel"),
             "stft_mag_k4_ms": cuda_ms(lambda: frontend.stft_hpss_mel(y, M),
                                       reps=100)[0]}
    short, full = k4[eval_frames["K4_T"]], k4[5998]
    entries.append({
        "name": "hpss_mel", "route": "cuda",
        "source": "sm_hpss_mtl_tpu_torch/csrc/hpss.cu",
        "replaces": "sm_hpss_mtl_tpu/ops/hpss_pallas.py:125",
        "launches": None, "max_abs_err": k4_err,
        "ms": short["ms"][0], "plain_ms": short["plain_ms"][0],
        "bound_ms": short["bound"][0], "bound_by": short["bound"][1],
        "library_ms": None,
        "ms_spread": short["ms"][1:], "plain_ms_spread":
        short["plain_ms"][1:], "device_ms": short["device_ms"],
        "timed_shape": [1, 201, eval_frames["K4_T"]],
        "ms_at_5998": full["ms"][0], "ms_at_5998_spread": full["ms"][1:],
        "plain_ms_at_5998": full["plain_ms"][0],
        "bound_ms_at_5998": full["bound"][0],
        "bound_by_at_5998": full["bound"][1],
        "device_ms_at_5998": full["device_ms"],
        "comparators_per_output": shared[(21, 11)],
        "blocks_per_sm": hpss.blocks_per_sm(mel=True),
        **ptxas_report("hpss.cu", "hpss_mel_kernelILi21ELi11E"),
        "short_clip_route": route})
    return entries, checked


@contextlib.contextmanager
def recorded():
    """Counts every kernel launch of the code run inside, and the shape of
    each: the launch counts are set to 0 on entry and read on exit."""
    from sm_hpss_mtl_tpu_torch.ops import frontend, hpss
    rec = {"shapes": {"K1": set(), "K2": set(), "K3": set(), "K4": set()},
           "launches": {}}
    f_launch, h_launch, m_launch = (frontend.launch, hpss._launch,
                                    hpss._launch_mel)

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

    def m_rec(S, M, **kw):
        F, T = S.shape[-2:]
        rec["shapes"]["K4"].add((kw["l_harm"], kw["l_perc"],
                                 S.numel() // (F * T), F, T))
        return m_launch(S, M, **kw)

    counters = (frontend.stft_hpss_mel, frontend.stft_hpss, hpss.hpss,
                hpss.hpss_masks, hpss.hpss_mel)
    frontend.launch, hpss._launch, hpss._launch_mel = f_rec, h_rec, m_rec
    try:
        for fn in counters:
            fn.launches = 0
        yield rec
        rec["launches"] = {
            "K1": frontend.stft_hpss_mel.launches,
            "K2": frontend.stft_hpss.launches,
            "K3": hpss.hpss.launches + hpss.hpss_masks.launches,
            "K4": hpss.hpss_mel.launches}
    finally:
        frontend.launch, hpss._launch, hpss._launch_mel = (
            f_launch, h_launch, m_launch)


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


def make_eval_corpus(root: str) -> dict:
    """The evaluation corpus: ``make_toy_musan`` music, speech and noise of
    3-30 s, and ``EVAL_SHORT`` clips of 0.12-0.2 s per class of music and
    speech beside them with their annotation rows (stratum 'short', so fold
    0 holds one of each); its 3-class folds saved where ``cli.fuse_late``
    reads them.  Returns the corpus root, fold 0's test files of the
    3-class folds (``test``) and of the 5-class ones (``test5``), and each
    file's length in samples after the loader's chain (silence removal may
    shorten a file), from which every launch shape of the phase follows."""
    from sm_hpss_mtl_tpu_torch.data import audio
    from sm_hpss_mtl_tpu_torch.data.folds import (create_cv_folds,
                                                  get_train_test_files,
                                                  save_cv_folds)
    from sm_hpss_mtl_tpu_torch.ops.mixing import normalize_signal_np
    audio.make_toy_musan(root, n_per_class=EVAL_FILES,
                         duration_s=(3.0, 30.0), with_noise=True, seed=SEED)
    rng = np.random.default_rng(SEED + 3)
    for cls, synth in (("music", audio._synth_music),
                       ("speech", audio._synth_speech)):
        with open(os.path.join(root, "annotations", cls + ".csv"), "a") as f:
            for i in range(EVAL_SHORT):
                name = f"{cls}-short-{i:04d}"
                n = int(rng.uniform(0.12, 0.2) * SR)
                audio.write_wav(os.path.join(root, cls, name + ".wav"),
                                normalize_signal_np(synth(rng, n, SR)))
                f.write(f"{name},short\n")
    cv = create_cv_folds(root, seed=SEED)
    save_cv_folds(cv, os.path.join(root, "cv_info"))
    _, test = get_train_test_files(cv, 0)
    _, test5 = get_train_test_files(
        create_cv_folds(root, with_noise=True, seed=SEED), 0,
        class_names=FIVE_CLASSES)
    samples = {os.path.join(root, c, f): len(
        audio.load_and_preprocess_signal(os.path.join(root, c, f))[0])
        for c in ("music", "speech", "noise")
        for f in os.listdir(os.path.join(root, c)) if f.endswith(".wav")}
    return {"root": root, "test": test, "test5": test5, "samples": samples}


def eval_item_frames(corpus: dict, n_fft: int, sweep: bool,
                     test: str = "test", bucketed: bool = False
                     ) -> list[int]:
    """Frames of every item the tester featurizes, in order: test_model's
    single files and pairs of fold 0's ``test`` files (a mixture takes its
    speech file's length), then, with ``sweep``, the speech+music pairs
    again at each SMR level; with ``bucketed``, at the length bucket a
    bucketed featurizer launches."""
    from sm_hpss_mtl_tpu_torch.data.featurize import bucket_length
    from sm_hpss_mtl_tpu_torch.ops.stft import n_frames
    root, files, samples = corpus["root"], corpus[test], corpus["samples"]
    singles = [samples[os.path.join(root, c, f)]
               for c in ("music", "speech", "noise") for f in files.get(c, [])]
    pairs = [samples[os.path.join(root, "speech", p["speech"])]
             for k in ("speech+music", "speech+noise")
             for p in files.get(k, [])]
    swept = [samples[os.path.join(root, "speech", p["speech"])]
             for p in files["speech+music"]] * len(SMR_LEVELS)
    items = singles + pairs + (swept if sweep else [])
    return [n_frames(bucket_length(n) if bucketed else n, n_fft, 160)
            for n in items]


def evaluate(model: str, corpus: dict, weights: str, device: str,
             sweep: bool) -> dict:
    """``FileWiseTester.test_model`` (and ``smr_sweep``) of ``model`` on
    fold 0 of the corpus through ``Featurizer(bucket=False)`` on
    ``device`` (the 5-class model on the 5-class folds, the fusion model
    with ``dual_tower``); the host clock around each, the time inside the
    featurizer, and the frames of each featurized item."""
    from sm_hpss_mtl_tpu_torch.cli import segment as cli
    from sm_hpss_mtl_tpu_torch.data.featurize import (FeatureConfig,
                                                      Featurizer)
    from sm_hpss_mtl_tpu_torch.device import resolve_device
    from sm_hpss_mtl_tpu_torch.eval.tester import FileWiseTester
    from sm_hpss_mtl_tpu_torch.models.zoo import INPUT_KIND, load_model
    from sm_hpss_mtl_tpu_torch.ops.stft import n_frames

    preset = cli.MODEL_PRESETS[model]
    cfg = FeatureConfig(feat_name=preset["feat_name"], n_fft=preset["n_fft"],
                        n_mels=preset["n_mels"])
    feat = Featurizer(cfg, bucket=False, device=device)
    seen = {"frames": [], "samples": 0, "featurize_s": 0.0}
    compute, featuregram = feat._compute, feat.featuregram

    def counted(audio):
        seen["frames"].append(n_frames(len(audio), cfg.n_fft,
                                       cfg.hop_length))
        seen["samples"] += len(audio)
        return compute(audio)

    def timed(*args, **kw):
        t0 = time.perf_counter()
        fv = featuregram(*args, **kw)
        seen["featurize_s"] += time.perf_counter() - t0
        return fv

    feat._compute, feat.featuregram = counted, timed
    net = load_model(weights, resolve_device(device), model)
    dual = INPUT_KIND[model] == "dual"
    test, n_classes = ("test5", 5) if model == FIVE else ("test", 3)
    tester = FileWiseTester(featurizer=feat, predict_fn=net,
                            folder=corpus["root"], feat_name=cfg.feat_name,
                            input_kind="time_mel" if dual
                            else INPUT_KIND[model], dual_tower=dual)
    with recorded() as rec:
        t0 = time.perf_counter()
        res = tester.test_model(corpus[test])
        t1 = time.perf_counter()
        swept = (tester.smr_sweep(corpus[test], levels=SMR_LEVELS)
                 if sweep else {})
        t2 = time.perf_counter()
    for r in [res] + [swept[db] for db in SMR_LEVELS if db in swept]:
        p = r["Predictions"]
        check(p.ndim == 2 and p.shape[1] == n_classes and len(p) == len(
            r["PtdLabels"]) == len(r["GroundTruth"]), "prediction shapes")
        check(bool(np.isfinite(p).all()), "predictions not finite")
        check(bool((np.abs(p.sum(axis=1) - 1) < 1e-4).all()),
              "class probabilities do not sum to 1")
    check(res["ConfMat"].shape == (n_classes, n_classes),
          f"{model}: confusion matrix {res['ConfMat'].shape}")
    want = eval_item_frames(corpus, cfg.n_fft, sweep, test)
    check(sorted(seen["frames"]) == sorted(want),
          f"{model}: featurized frames {sorted(seen['frames'])}, planned "
          f"{sorted(want)}")
    return {"result": res, "sweep": swept, "launches": rec["launches"],
            "shapes": rec["shapes"], "test_model_s": t1 - t0,
            "sweep_s": t2 - t1, **seen}


def fuse_late(corpus: dict, ckpts: tuple, out: str, device: str) -> dict:
    """``cli.fuse_late.main`` on fold 0 of the corpus's 3-class folds over
    the harmonic-feature and percussive-feature checkpoints on ``device``
    (host clock around it); its row and results checked, K1 launched once
    per item and leg at the items' length buckets."""
    from sm_hpss_mtl_tpu_torch.cli import fuse_late as cli
    with recorded() as rec:
        t0 = time.perf_counter()
        res = cli.main(["--data", corpus["root"], "--ckpt-harm", ckpts[0],
                        "--ckpt-perc", ckpts[1], "--output", out,
                        "--device", device])
        total_s = time.perf_counter() - t0
    check(res["ConfMat"].shape == (3, 3) and bool(np.isfinite(
        res["Predictions"]).all()), f"fuse_late results {res['ConfMat']}")
    check(os.path.exists(os.path.join(out, "Late_Fusion",
                                      "Lemaire_et_al_MTL",
                                      "Performance.csv")),
          "fuse_late wrote no Performance.csv")
    return {"result": res, "launches": rec["launches"],
            "shapes": rec["shapes"], "total_s": total_s,
            "items": len(eval_item_frames(corpus, 400, sweep=False))}


def same_labels(tag: str, got: dict, want: dict) -> tuple[float, list]:
    """The card's results against the CPU's: predictions within
    ``TRACK_TOL``; labels equal but at near-ties (the CPU's top two 3C
    probabilities within ``TIE_TOL``), which are returned; confusion
    matrices equal where no label differs."""
    d = float(np.abs(got["Predictions"] - want["Predictions"]).max())
    check(d <= TRACK_TOL, f"{tag}: predictions GPU vs CPU max |delta| "
                          f"{d:.3e}")
    top2 = np.sort(want["Predictions"], axis=1)[:, -2:]
    differ = np.flatnonzero(got["PtdLabels"] != want["PtdLabels"])
    ties = [(tag, int(i), top2[i].tolist()) for i in differ
            if top2[i, 1] - top2[i, 0] <= TIE_TOL]
    check(len(ties) == len(differ), f"{tag}: labels differ at patches "
          f"{differ.tolist()}, not all near-ties")
    if not len(differ):
        check(np.array_equal(got["ConfMat"], want["ConfMat"]),
              f"{tag}: confusion matrices differ")
    return d, ties


def classify(wav: str, weights: str, device: str) -> dict:
    """``Classifier.classify_file`` of Lemaire-MTL on one wav (bucketed
    featurizer, as the JAX entry point)."""
    from sm_hpss_mtl_tpu_torch.infer import Classifier
    clf = Classifier.from_weights(weights, device=device)
    with recorded() as rec:
        t0 = time.perf_counter()
        out = clf.classify_file(wav)
        total_s = time.perf_counter() - t0
    check(out["probabilities"].shape == (3,)
          and bool(np.isfinite(out["probabilities"]).all()),
          "classifier probabilities")
    return {"out": out, "launches": rec["launches"], "shapes": rec["shapes"],
            "total_s": total_s}


def make_train_corpus(root: str) -> dict:
    """The training corpus: ``make_toy_musan`` with ``TRAIN_FILES`` files
    of ``TRAIN_SECONDS`` per class of music, speech and noise, and its
    3-class folds where ``cli.mtl`` reads them (the 5-class ones are
    ``cli.make_folds``'s, in phase 10).  Returns the root, fold 0's
    training split, and per n_fft (400, 512) the frames of every item the
    host pipeline's featurizer can compute: each music, speech and noise
    file's length bucket (a mixture takes its speech file's length),
    launched one item at a time."""
    from sm_hpss_mtl_tpu_torch.cli.experiment import (load_or_create_folds,
                                                      split_train_val)
    from sm_hpss_mtl_tpu_torch.data import audio
    from sm_hpss_mtl_tpu_torch.data.featurize import bucket_length
    from sm_hpss_mtl_tpu_torch.data.folds import get_train_test_files
    from sm_hpss_mtl_tpu_torch.ops.stft import n_frames
    from sm_hpss_mtl_tpu_torch.train.config import ExperimentConfig
    audio.make_toy_musan(root, n_per_class=TRAIN_FILES,
                         duration_s=TRAIN_SECONDS, with_noise=True, seed=SEED)
    cv = load_or_create_folds(ExperimentConfig(data_root=root))
    tr, _ = split_train_val(get_train_test_files(cv, 0)[0])
    lengths = {bucket_length(len(audio.load_and_preprocess_signal(
        os.path.join(root, c, f))[0]))
        for c in ("music", "speech", "noise")
        for f in os.listdir(os.path.join(root, c)) if f.endswith(".wav")}
    return {"root": root, "train_files": tr,
            "frames": {n_fft: {n_frames(n, n_fft, 160) for n in lengths}
                       for n_fft in (400, 512)}}


def make_five_class_folds(corpus: dict) -> None:
    """``cli.make_folds --with-noise`` into ``<root>/cv_info_5_class``,
    where ``cli.five_class`` reads them (host work only: no kernel may
    launch); adds fold 0's 5-class training split to ``corpus`` as
    ``train_files5``."""
    from sm_hpss_mtl_tpu_torch.cli import make_folds
    from sm_hpss_mtl_tpu_torch.cli.experiment import split_train_val
    from sm_hpss_mtl_tpu_torch.data.folds import (get_train_test_files,
                                                  load_cv_folds)
    out = os.path.join(corpus["root"], "cv_info_5_class")
    with recorded() as rec:
        make_folds.main(["--data", corpus["root"], "--with-noise",
                         "--output", out])
    check(not any(rec["launches"].values()),
          f"make_folds launched {rec['launches']}")
    cv5 = load_cv_folds(out)
    check(all(cv5[k]["fold0"] for k in FIVE_CLASSES),
          "the 5-class folds lack a class")
    corpus["train_files5"], _ = split_train_val(
        get_train_test_files(cv5, 0, class_names=FIVE_CLASSES)[0])


def model_kernel(model: str) -> str | None:
    """The kernel a model's features launch: K1 for the Mel-HPSS families,
    K2 for the full-resolution HPSS ones, none for the plain spectrograms
    of the single-task baselines."""
    from sm_hpss_mtl_tpu_torch.train.config import MODEL_PRESETS
    name = MODEL_PRESETS[model]["feat_name"]
    if "Harm" not in name and "Perc" not in name:
        return None
    return "K1" if "Mel" in name else "K2"


def train_cli(corpus: dict, out: str, pipeline: str,
              model: str = "Lemaire_et_al_MTL", extra: tuple = (),
              epochs: int = TRAIN_EPOCHS) -> dict:
    """One run of fold 0 on the card (host clock around it) through the
    model's driver: ``cli.five_class`` for the 5-class model,
    ``cli.fuse_intermediate`` for the fusion model, ``cli.mtl`` for the
    other MTL models and ``cli.baseline`` for a single-task one; its
    outputs checked, and the model's kernel launched once per
    device-pipeline train or eval step and once per featurized file (the
    statistics pass's too), nothing else."""
    from sm_hpss_mtl_tpu_torch.cli import (baseline, five_class,
                                           fuse_intermediate, mtl)
    from sm_hpss_mtl_tpu_torch.models.zoo import MTL
    main = {FIVE: five_class.main, IF: fuse_intermediate.main}.get(
        model, mtl.main if MTL[model] else baseline.main)
    tag = f"{model} {pipeline} {' '.join(extra)}".strip()
    with recorded() as rec:
        t0 = time.perf_counter()
        res = main(["--data", corpus["root"], "--output", out, "--model",
                    model, "--pipeline", pipeline, "--epochs", str(epochs),
                    "--tr-steps", str(TRAIN_STEPS), "--v-steps",
                    str(VAL_STEPS), "--lr-schedule-steps", "100000",
                    "--folds", "0", *extra])
        total_s = time.perf_counter() - t0
    fold = res[0]
    row, hist = fold["row"], fold["fit"].history
    check(fold["pipeline"] == pipeline, f"{tag}: ran the {fold['pipeline']} "
          f"pipeline")
    check(len(hist) == epochs, f"{tag}: {len(hist)} epochs")
    check(all(np.isfinite(h["loss"]) and np.isfinite(h["val_loss"])
              for h in hist), f"{tag}: losses not finite: {hist}")
    check(np.isfinite(row["val_loss"]) and 0 <= row["accuracy"] <= 1,
          f"{tag}: fold row {row}")
    n_classes = 5 if model == FIVE else 3
    check(fold["test"]["ConfMat"].shape == (n_classes, n_classes),
          f"{tag}: confusion matrix {fold['test']['ConfMat'].shape}")
    for name in ("Performance.csv", "fold0_log.csv",
                 "fold0_ckpt/state/model.npz"):
        check(os.path.exists(os.path.join(fold["op_dir"], name)),
              f"{tag}: {name} not written")
    computes = fold["cache_stats"]["featurizer"]["computes"]
    steps = epochs * (TRAIN_STEPS + VAL_STEPS)
    want = {"K1": 0, "K2": 0, "K3": 0, "K4": 0}
    kernel = model_kernel(model)
    if kernel:
        want[kernel] = computes + (steps if pipeline == "device" else 0)
    check(rec["launches"] == want, f"{tag}: launches {rec['launches']}, "
          f"want {want} ({computes} featurized files)")
    return {"launches": rec["launches"], "shapes": rec["shapes"],
            "total_s": total_s, "featurized_files": computes,
            "epoch_train_s": [h["epoch_train_s"] for h in hist],
            "fit_wall_s": fold["fit"].wall_time,
            "val_loss": row["val_loss"], "accuracy": row["accuracy"],
            "history": hist}


def _feature_config(model: str):
    from sm_hpss_mtl_tpu_torch.data.featurize import FeatureConfig
    from sm_hpss_mtl_tpu_torch.train.config import (MODEL_PRESETS,
                                                    preset_n_mels)
    preset = MODEL_PRESETS[model]
    return FeatureConfig(feat_name=preset["feat_name"], n_fft=preset["n_fft"],
                         n_mels=preset_n_mels(preset))


def _train_setup(device: str, net, seed: int, audio: bool = True,
                 model: str = "Lemaire_et_al_MTL",
                 optimizer: str | None = None, **step_kw):
    """A copy of ``net`` on ``device``, an optimizer (``model``'s, or that
    of the ``optimizer`` family) and a train step at full width: the device
    pipeline's (``audio``: 16 clips per class, one 68-frame patch each, the
    model's kernel inside) or the patch step.  Also the first lr."""
    import copy

    import torch
    from sm_hpss_mtl_tpu_torch.models.zoo import INPUT_KIND
    from sm_hpss_mtl_tpu_torch.train.endtoend import make_audio_train_step
    from sm_hpss_mtl_tpu_torch.train.optimizers import for_model
    from sm_hpss_mtl_tpu_torch.train.state import TrainState, make_train_step
    model_ = copy.deepcopy(net).to(device)
    opt, sched = for_model(optimizer or model, model_.parameters(),
                           tr_steps=100000)
    kw = dict(generator=torch.Generator(device=device).manual_seed(seed),
              l2_reg=0.01, **step_kw)
    step = (make_audio_train_step(model_, opt, _feature_config(model),
                                  patch_size=68, patch_shift=68,
                                  n_patches_per_clip=1,
                                  input_kind=INPUT_KIND[model], **kw)
            if audio else make_train_step(model_, opt, mtl=True, **kw))
    return model_, TrainState(model_, opt), step, float(sched(0))


def _crops(corpus: dict, seed: int, model: str = "Lemaire_et_al_MTL"):
    """The device pipeline's crop batches of fold 0's training files (the
    5-class split for the 5-class model)."""
    from sm_hpss_mtl_tpu_torch.data.audiostream import (AudioCache,
                                                        AudioCropBatcher)
    files = corpus["train_files5" if model == FIVE else "train_files"]
    return AudioCropBatcher(AudioCache(), corpus["root"],
                            files, _feature_config(model),
                            clips_per_class=16, n_patches_per_clip=1,
                            patch_size=68, seed=seed)


def _bn_fed_biases(model) -> set[str]:
    """The biases of the layers that feed a BatchNorm (``X.conv``/``X.dense``
    before ``X.bn``, Jang's ``fc1`` before ``fc1_bn``): a train-mode
    BatchNorm subtracts the batch mean, so their gradient is 0 in exact
    arithmetic and what a step computes for them is rounding noise."""
    import torch
    names = set(model.state_dict())
    out = set()
    for path, mod in model.named_modules():
        if not isinstance(mod, torch.nn.modules.batchnorm._BatchNorm):
            continue
        base, _, leaf = path.rpartition(".")
        feeds = ([f"{base}.conv", f"{base}.dense"] if leaf == "bn"
                 else [path[:-len("_bn")]] if path.endswith("_bn") else [])
        out |= {f"{f.lstrip('.')}.bias" for f in feeds} & names
    return out


def _step_card_vs_cpu(net, batch, labels, audio: bool, update_rtol: float,
                      model: str = "Lemaire_et_al_MTL",
                      optimizer: str | None = None) -> dict:
    """One train step of ``net`` on ``batch`` on the CPU and on the card:
    the loss, the BatchNorm statistics and every parameter's update (to
    ``update_rtol`` of its norm) held to their bars; the biases that feed
    a BatchNorm, whose updates are rounding noise on both sides, to
    ``ZERO_GRAD_UPDATE`` of the first lr per element instead.  Every
    violation is reported."""
    import torch
    from sm_hpss_mtl_tpu_torch.data.prefetch import to_device
    before = {k: v.clone() for k, v in net.state_dict().items()}
    noise = _bn_fed_biases(net)
    got = {}
    for dev in ("cpu", "cuda"):
        model_, state, step, lr = _train_setup(dev, net, SEED, audio=audio,
                                               model=model,
                                               optimizer=optimizer)
        d = torch.device(dev)
        loss = float(step(state, to_device(batch, d),
                          to_device(labels, d))["loss"])
        got[dev] = (loss, {k: v.detach().cpu()
                           for k, v in model_.state_dict().items()})
    (loss_cpu, cpu), (loss_gpu, gpu) = got["cpu"], got["cuda"]
    tag = f"{model} {'audio' if audio else 'patch'} step"
    loss_rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    bad = [] if loss_rel <= STEP_LOSS_RTOL else [
        f"loss card {loss_gpu} vs CPU {loss_cpu}"]
    rels, stats_err, noise_max = {}, 0.0, 0.0
    for k, b in before.items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith(("running_mean", "running_var")):
            err = float(((gpu[k] - cpu[k]).abs()
                         / cpu[k].abs().clamp_min(1.0)).max())
            stats_err = max(stats_err, err)
            if err > STEP_STATS_TOL:
                bad.append(f"{k} card vs CPU {err:.3e}")
            continue
        b = b.double()
        d_cpu, d_gpu = cpu[k].double() - b, gpu[k].double() - b
        if k in noise:
            bar = ZERO_GRAD_UPDATE * lr * b.numel() ** 0.5
            norm = float(max(d_cpu.norm(), d_gpu.norm()))
            noise_max = max(noise_max, norm / (lr * b.numel() ** 0.5))
            if norm > bar:
                bad.append(f"{k} (feeds a BatchNorm) update norm {norm:.3e} "
                           f"over {bar:.3e}")
            continue
        # Below the relative bar: two float32 ulps of the parameter, and
        # 1e-6 of the largest update (the first lr) per element.
        floor = 2 * 2.0 ** -23 * b.norm() + 1e-6 * lr * b.numel() ** 0.5
        tol = update_rtol * d_cpu.norm() + floor
        diff = (d_gpu - d_cpu).norm()
        if diff > tol:
            bad.append(f"{k} update card vs CPU |delta| {diff:.3e} over "
                       f"{tol:.3e} (update norm {d_cpu.norm():.3e})")
        if d_cpu.norm() > floor:
            rels[k] = float(diff / d_cpu.norm())
    top = sorted(rels.items(), key=lambda kv: -kv[1])[:5]
    check(not bad, f"{tag}: " + "; ".join(bad))
    return {"loss_card": loss_gpu, "loss_cpu": loss_cpu,
            "loss_rel": loss_rel, "update_rel_max": top[0][1],
            "update_rel_max_at": top[0][0], "update_rel_top": dict(top),
            "stats_err_max": stats_err,
            "bn_fed_bias_update_max_per_lr": noise_max}


def _seeded(model: str, dropout: bool = True):
    """``model`` at full width with Keras's initialisation from SEED; with
    ``dropout=False`` every dropout's rate is 0."""
    import torch
    from sm_hpss_mtl_tpu_torch.models import layers
    from sm_hpss_mtl_tpu_torch.models.lemaire import init_weights
    from sm_hpss_mtl_tpu_torch.models.zoo import get_model
    kw = {} if dropout or not model.startswith("Lemaire") else {
        "dropout_rate": 0.0}
    net = init_weights(get_model(model, **kw),
                       torch.Generator().manual_seed(SEED))
    if not dropout:
        for m in net.modules():
            if isinstance(m, layers.Dropout):
                m.rate = 0.0
    return net


def _features_card_vs_cpu(audio, model: str) -> tuple[dict, "object"]:
    """The device pipeline's patches of ``audio`` on the card (the model's
    kernel) and on the CPU (the plain version): the CPU's patches (a dict
    of two for the fusion model) and the difference's statistics."""
    import torch
    from sm_hpss_mtl_tpu_torch.data.prefetch import to_device
    from sm_hpss_mtl_tpu_torch.models.zoo import INPUT_KIND
    from sm_hpss_mtl_tpu_torch.train.endtoend import device_featurize_patches
    def host(f):
        return ({k: v.cpu() for k, v in f.items()} if isinstance(f, dict)
                else f.cpu())

    feats = {dev: host(device_featurize_patches(
        to_device(audio, torch.device(dev)), _feature_config(model),
        patch_size=68, patch_shift=68, max_patches=1,
        input_kind=INPUT_KIND[model])) for dev in ("cpu", "cuda")}

    def joined(f):                  # the fusion model's two inputs, as one
        return torch.cat([f["harm_input"], f["perc_input"]], dim=-1) \
            if isinstance(f, dict) else f

    fdiff = (joined(feats["cuda"]) - joined(feats["cpu"])).abs()
    rows = fdiff.amax(dim=1) if fdiff.ndim == 3 else fdiff.amax(dim=2)
    return {"features_max_abs_delta": float(fdiff.max()),
            "features_mean_abs_delta": float(fdiff.mean()),
            "features_rows_over_1e-2": int((rows > 1e-2).sum())}, feats["cpu"]


def _falls(model: str, net, audio, labels, steps: int = 20) -> list:
    """``steps`` audio steps on one batch on the card with the model's own
    optimizer; the loss stays finite and falls."""
    import torch
    from sm_hpss_mtl_tpu_torch.data.prefetch import to_device
    _, state, step, _ = _train_setup("cuda", net, SEED, model=model)
    dev = torch.device("cuda")
    a, y = to_device(audio, dev), to_device(labels, dev)
    losses = torch.stack([step(state, a, y)["loss"]
                          for _ in range(steps)]).tolist()
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"{model}: {steps} steps on one batch: losses {losses}")
    return losses


def train_step_checks(corpus: dict) -> dict:
    """One crop batch and one set of weights, dropout and augmentation off:
    the features on the card (K1) against the CPU's (the plain version);
    one patch step on the CPU's features on the card and on the CPU, held
    to every bar (loss, each update, BatchNorm statistics); one audio step
    (K1 inside on the card) on both, held to the same loss and statistics
    bars and to ``STEP_AUDIO_UPDATE_RTOL`` on each update.  Then 20 audio
    steps on that batch on the card: the loss stays finite and falls."""
    model = "Lemaire_et_al_MTL"
    audio, labels = next(_crops(corpus, SEED, model))
    net = _seeded(model, dropout=False)
    feat_stats, patches = _features_card_vs_cpu(audio, model)
    # Patch j of clip b is row j*B + b; one patch a clip, so the clips'
    # labels are the rows'.
    patch = _step_card_vs_cpu(net, patches, labels, audio=False,
                              update_rtol=STEP_UPDATE_RTOL)
    audio_step = _step_card_vs_cpu(net, audio, labels, audio=True,
                                   update_rtol=STEP_AUDIO_UPDATE_RTOL)
    return {**feat_stats, "patch_step": patch, "audio_step": audio_step,
            "fixed_batch_losses": _falls(model, net, audio, labels)}


def image_step_checks(corpus: dict) -> dict:
    """Jang-MTL: the features on the card (K2, n_fft 512) against the
    CPU's, one audio step (K2 inside on the card) on the card and on the
    CPU with plain SGD (``STEP_SGD``) at the loss and statistics bars and
    ``STEP_JANG_AUDIO_UPDATE_RTOL`` on each update, and 20
    audio steps on one batch with its own Adam (the loss falls).
    Papakostas-MTL: one patch step on the CPU's features (HarmPercSpec,
    n_fft 400) on the card and on the CPU at the patch step's bars.  One
    crop batch each, dropout and augmentation off."""
    out = {}
    jang = "Jang_et_al_MTL"
    audio, labels = next(_crops(corpus, SEED, jang))
    net = _seeded(jang, dropout=False)
    feat_stats, _ = _features_card_vs_cpu(audio, jang)
    out[jang] = {**feat_stats, "audio_step": _step_card_vs_cpu(
        net, audio, labels, audio=True,
        update_rtol=STEP_JANG_AUDIO_UPDATE_RTOL, model=jang,
        optimizer=STEP_SGD),
        "fixed_batch_losses": _falls(jang, net, audio, labels)}
    del net
    pap = "Papakostas_et_al_MTL"
    audio, labels = next(_crops(corpus, SEED, pap))
    net = _seeded(pap, dropout=False)
    feat_stats, patches = _features_card_vs_cpu(audio, pap)
    out[pap] = {**feat_stats, "patch_step": _step_card_vs_cpu(
        net, patches, labels, audio=False, update_rtol=STEP_UPDATE_RTOL,
        model=pap)}
    return out


def variant_step_checks(corpus: dict) -> dict:
    """Lemaire's variants, one crop batch each, dropout and augmentation
    off.  The intermediate-fusion model: the features on the card (K1)
    against the CPU's; one patch step on the CPU's features (a dict of the
    two towers' inputs) on the card and on the CPU at the patch step's
    bars; one audio step (K1 inside on the card) on both at the loss and
    statistics bars and ``STEP_IF_AUDIO_UPDATE_RTOL`` on each update; and
    20 audio steps on one batch (the loss falls).  The 5-class model: one
    patch step on the CPU's features on the card and on the CPU at the
    patch step's bars."""
    out = {}
    audio, labels = next(_crops(corpus, SEED, IF))
    net = _seeded(IF, dropout=False)
    feat_stats, patches = _features_card_vs_cpu(audio, IF)
    out[IF] = {**feat_stats, "patch_step": _step_card_vs_cpu(
        net, patches, labels, audio=False, update_rtol=STEP_UPDATE_RTOL,
        model=IF), "audio_step": _step_card_vs_cpu(
        net, audio, labels, audio=True,
        update_rtol=STEP_IF_AUDIO_UPDATE_RTOL, model=IF),
        "fixed_batch_losses": _falls(IF, net, audio, labels)}
    del net
    audio, labels = next(_crops(corpus, SEED, FIVE))
    check(audio.shape == (5 * 16, 11120), f"5-class crops {audio.shape}")
    net = _seeded(FIVE, dropout=False)
    feat_stats, patches = _features_card_vs_cpu(audio, FIVE)
    out[FIVE] = {**feat_stats, "patch_step": _step_card_vs_cpu(
        net, patches, labels, audio=False, update_rtol=STEP_UPDATE_RTOL,
        model=FIVE)}
    return out


def time_device_steps(corpus: dict, model: str = "Lemaire_et_al_MTL",
                      steps: int = 30, profiled: int = 10) -> dict:
    """Device-pipeline train steps of ``model`` at full width on the card,
    fed by the crop batcher through the prefetcher, dropout and
    augmentation on.  Each step's period (its start to the next one's, CUDA
    events) and its own span; over a further ``profiled`` steps, the
    kernel's (K1 or K2) device time and all device time per step from
    ``torch.profiler``, against the host clock around them."""
    import torch
    from sm_hpss_mtl_tpu_torch.data.prefetch import DevicePrefetcher
    from torch.profiler import ProfilerActivity, profile

    _, state, step, _ = _train_setup("cuda", _seeded(model), SEED,
                                     model=model, augment_noise=True)
    it = DevicePrefetcher(_crops(corpus, SEED + 100, model), "cuda")
    try:
        marks = []
        for _ in range(steps):
            audio, labels = next(it)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            step(state, audio, labels)
            end.record()
            marks.append((start, end))
        torch.cuda.synchronize()
        # Steps 3 and after: the first two build the kernel plans.
        period = sorted(marks[i][0].elapsed_time(marks[i + 1][0])
                        for i in range(2, steps - 1))
        span = sorted(a.elapsed_time(b) for a, b in marks[2:])
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(profiled):
                audio, labels = next(it)
                step(state, audio, labels)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        it.close()
    device = [e for e in prof.events()
              if e.device_type != torch.autograd.DeviceType.CPU]
    busy = sum(e.device_time_total for e in device) / 1e3
    kern = sum(e.device_time_total for e in device
               if "frontend_kernel" in e.name) / 1e3
    k = model_kernel(model).lower()
    # Where the host's time goes: the operators with the most self CPU
    # time per step (the profiler's own cost is in them too).
    host_ops = sorted(prof.key_averages(),
                      key=lambda e: -e.self_cpu_time_total)
    mid = len(period) // 2
    return {"steps_timed": len(period), "step_ms": period[mid],
            "step_ms_spread": [period[0], period[-1]],
            "step_span_ms": span[len(span) // 2],
            "step_span_ms_spread": [span[0], span[-1]],
            "profiled_steps": profiled,
            "profiled_wall_ms_per_step": wall_ms / profiled,
            "device_busy_ms_per_step": busy / profiled if device else None,
            "device_idle_share": 1 - busy / wall_ms if device else None,
            f"{k}_device_ms_per_step": kern / profiled if device else None,
            f"{k}_share_of_step": (kern / profiled) / period[mid]
            if device else None,
            "device_busy_share_of_step": (busy / profiled) / period[mid]
            if device else None,
            "host_top_ops_ms_per_step": {
                e.key: e.self_cpu_time_total / 1e3 / profiled
                for e in host_ops[:8]}}


def late_fusion_checkpoints(root: str) -> tuple[str, str]:
    """Fold checkpoints of two full-width Lemaire-MTL models from seeded
    inits, one on ``LogMelHarmSpec`` and one on ``LogMelPercSpec`` (120
    rows each), as ``cli.mtl --feat-name ...`` writes them; the paths that
    ``cli.fuse_late`` takes."""
    import torch
    from sm_hpss_mtl_tpu_torch.models.lemaire import init_weights
    from sm_hpss_mtl_tpu_torch.models.zoo import get_model
    from sm_hpss_mtl_tpu_torch.train.checkpoint import save_checkpoint
    from sm_hpss_mtl_tpu_torch.train.optimizers import for_model
    from sm_hpss_mtl_tpu_torch.train.state import TrainState
    paths = []
    for k, feat in enumerate(("LogMelHarmSpec", "LogMelPercSpec")):
        net = init_weights(get_model("Lemaire_et_al_MTL", in_dim=120),
                           torch.Generator().manual_seed(SEED + k))
        opt, _ = for_model("Lemaire_et_al_MTL", net.parameters(), tr_steps=1)
        paths.append(os.path.join(root, feat, "fold0_ckpt"))
        save_checkpoint(paths[-1], TrainState(net, opt), {"epoch": 0})
    return tuple(paths)


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
    t_start = time.perf_counter()
    card = card_line()
    print(f"[1 card] {card}", flush=True)

    build_s, logs = build_all()
    print(f"[2 build] {build_s:.2f} s", flush=True)
    for log in logs:
        print(log, flush=True)

    from sm_hpss_mtl_tpu_torch import weights
    from sm_hpss_mtl_tpu_torch.data.audio import load_and_preprocess_signal
    from sm_hpss_mtl_tpu_torch.data.featurize import bucket_length
    from sm_hpss_mtl_tpu_torch.models.lemaire import init_weights
    from sm_hpss_mtl_tpu_torch.models.zoo import get_model
    from sm_hpss_mtl_tpu_torch.ops.stft import n_frames
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        def out(name):
            return os.path.join(tmp, name)

        # The evaluation's inputs come first: phase 3 checks each kernel at
        # the shapes they give it.
        wav60, x60 = write_broadcast(tmp, "b60.wav", 60.0, SEED)
        wav600, x600 = write_broadcast(tmp, "b600.wav", 600.0, SEED + 1)
        wav10, x10 = write_broadcast(tmp, "b10.wav", 10.0, SEED + 2)
        corpus = make_eval_corpus(out("corpus"))
        train_corpus = make_train_corpus(out("train_corpus"))
        lem_frames = eval_item_frames(corpus, 400, sweep=True)
        jang_frames = eval_item_frames(corpus, 512, sweep=False)
        pap_frames = eval_item_frames(corpus, 400, sweep=False)
        five_frames = eval_item_frames(corpus, 400, sweep=False,
                                       test="test5")
        late_frames = eval_item_frames(corpus, 400, sweep=False,
                                       bucketed=True)
        n60 = len(load_and_preprocess_signal(wav60)[0])
        short = Counter(T for T in lem_frames if T < SHORT_FRAMES)
        check(short and any(T < SHORT_FRAMES for T in jang_frames),
              "the evaluation corpus has no short item")
        served_400 = {n_frames(bucket_length(len(x)), 400, 160)
                      for x in (x60, x10)}
        eval_frames = {
            "K1": {T for T in lem_frames + five_frames if T >= SHORT_FRAMES}
            | {n_frames(bucket_length(n60), 400, 160)}
            | set(late_frames) | train_corpus["frames"][400],
            "K2": {T for T in jang_frames if T >= SHORT_FRAMES}
            | train_corpus["frames"][512],
            "K2_400": {T for T in pap_frames if T >= SHORT_FRAMES}
            | served_400 | train_corpus["frames"][400],
            "K4_T": short.most_common(1)[0][0],
            "K3_T": Counter(T for T in jang_frames
                            if T < SHORT_FRAMES).most_common(1)[0][0]}

        entries, checked = phase_kernels(card, eval_frames)
        print("[3 kernels] ok; " + "; ".join(
            f"{e['name']} {e['ms']:.4f} ms [{e['ms_spread'][0]:.4f}, "
            f"{e['ms_spread'][1]:.4f}] at {e['timed_shape']}"
            for e in entries), flush=True)

        wpath = {}
        for model in ("Lemaire_et_al_MTL", "Jang_et_al_MTL",
                      "Papakostas_et_al_MTL", CASCADED, FIVE, IF):
            wpath[model] = out(f"{model}.npz")
            net = init_weights(get_model(model),
                               torch.Generator().manual_seed(SEED))
            weights.save_npz(wpath[model], weights.to_flax(net.state_dict()))
            del net
        late_ckpts = late_fusion_checkpoints(out("late"))

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
        pap = "Papakostas_et_al_MTL"
        pw = wpath[pap]
        runs["pap_60"] = p60 = serve(pap, wav60, pw, out("p60.npz"), "cuda",
                                     x60)
        runs["pap_10"] = p10 = serve(pap, wav10, pw, out("p10.npz"), "cuda",
                                     x10)
        p10_cpu = serve(pap, wav10, pw, out("q10.npz"), "cpu", x10)
        for r in (p60, p10):
            check(r["launches"]["K2"] == 1,
                  f"a Papakostas run launched K2 {r['launches']['K2']} times")
        pap_track = max(
            float(np.abs(p10["tracks"][k] - p10_cpu["tracks"][k]).max())
            for k in ("track_S", "track_M"))
        check(pap_track <= TRACK_TOL,
              f"Papakostas tracks: GPU vs CPU max |delta| {pap_track:.3e}")
        p60_warm = serve(pap, wav60, pw, out("p60w.npz"), "cuda", x60)
        print(f"[7 papakostas] {p60['frames']} + {p10['frames']} frames, one "
              f"K2 launch each; 10 s tracks vs CPU max |delta| "
              f"{pap_track:.3e} (CPU run {p10_cpu['total_s']:.1f} s); 60 s "
              f"warm {p60_warm['total_s']:.3f} s", flush=True)
        variants_serving = {}
        for model, tag in ((CASCADED, "cascaded"), (FIVE, "five")):
            runs[f"{tag}_60"] = g = serve(model, wav60, wpath[model],
                                          out(f"{tag}_g60.npz"), "cuda", x60)
            c = serve(model, wav60, wpath[model], out(f"{tag}_c60.npz"),
                      "cpu", x60)
            check(g["launches"]["K1"] > 0 and not any(
                g["launches"][k] for k in ("K2", "K3", "K4")),
                  f"{model} serving launches {g['launches']}")
            d = max(float(np.abs(g["tracks"][k] - c["tracks"][k]).max())
                    for k in ("track_S", "track_M"))
            check(d <= TRACK_TOL, f"{model} tracks: GPU vs CPU max |delta| "
                                  f"{d:.3e}")
            if model == FIVE:
                check(g["tracks"]["track_N"].shape[1] == 1
                      and g["tracks"]["track_3C"].shape[1] == 5,
                      "5-class tracks")
            variants_serving[model] = {
                "first_run_60s_total_ms": 1e3 * g["total_s"],
                "cpu_60s_total_ms": 1e3 * c["total_s"],
                "launches": g["launches"],
                "track_max_abs_delta_vs_cpu": d}
        print("[7 variants] 60 s, " + "; ".join(
            f"{m}: launches {v['launches']}, tracks vs CPU max |delta| "
            f"{v['track_max_abs_delta_vs_cpu']:.3e}"
            for m, v in variants_serving.items()), flush=True)

        runs["resynth_60"] = rs = resynth(wav60, out("rg"), "cuda")
        check(rs["launches"]["K3"] > 0, "resynthesis launched no K3")
        rs_cpu = resynth(wav60, out("rc"), "cpu")
        rs_delta = max(resynth_delta(rs[k], rs_cpu[k]) for k in ("yh", "yp"))
        check(rs_delta <= RESYNTH_TOL,
              f"resynthesis GPU vs CPU {rs_delta:.3e} of the peak")
        rs_warm = resynth(wav60, out("rw"), "cuda")
        print(f"[8 resynth] {rs['launches']['K3']} K3 launches, GPU vs CPU "
              f"{rs_delta:.3e} of the peak", flush=True)

        lem_eval = evaluate(lem, corpus, wpath[lem], "cuda", sweep=True)
        runs["eval_lemaire"] = lem_eval
        lem_eval_cpu = evaluate(lem, corpus, wpath[lem], "cpu", sweep=True)
        n_short = sum(T < SHORT_FRAMES for T in lem_eval["frames"])
        check(lem_eval["launches"]["K4"] == n_short,
              f"K4 launched {lem_eval['launches']['K4']} times for "
              f"{n_short} items under {SHORT_FRAMES} frames")
        check(lem_eval["launches"]["K1"]
              == len(lem_eval["frames"]) - n_short,
              "K1 did not launch once per item of 20 frames or more")
        eval_delta, ties = same_labels("test_model", lem_eval["result"],
                                       lem_eval_cpu["result"])
        for level in SMR_LEVELS:
            d, t = same_labels(f"sweep {level} dB", lem_eval["sweep"][level],
                               lem_eval_cpu["sweep"][level])
            eval_delta, ties = max(eval_delta, d), ties + t
        for tie in ties:
            print(f"near-tie, label differs: {tie}", flush=True)
        runs["classify_60"] = clf = classify(wav60, wpath[lem], "cuda")
        clf_cpu = classify(wav60, wpath[lem], "cpu")
        clf_delta = float(np.abs(clf["out"]["probabilities"]
                                 - clf_cpu["out"]["probabilities"]).max())
        check(clf_delta <= TRACK_TOL,
              f"Classifier GPU vs CPU max |delta| {clf_delta:.3e}")
        runs["eval_jang"] = jang_eval = evaluate(jang, corpus, jw, "cuda",
                                                 sweep=False)
        j_short = sum(T < SHORT_FRAMES for T in jang_eval["frames"])
        check(jang_eval["launches"]["K3"] == j_short
              and jang_eval["launches"]["K2"] == len(jang_eval["frames"])
              - j_short, f"Jang evaluation launches {jang_eval['launches']}"
                         f" for {j_short} short of "
                         f"{len(jang_eval['frames'])} items")
        runs["eval_papakostas"] = pap_eval = evaluate(pap, corpus, pw,
                                                      "cuda", sweep=False)
        p_short = sum(T < SHORT_FRAMES for T in pap_eval["frames"])
        check(pap_eval["launches"] == {
            "K1": 0, "K2": len(pap_eval["frames"]) - p_short, "K3": p_short,
            "K4": 0}, f"Papakostas evaluation launches "
                      f"{pap_eval['launches']} for {p_short} short of "
                      f"{len(pap_eval['frames'])} items")
        variants_eval, variant_ties = {}, []
        for model, tag in ((FIVE, "eval_five"), (IF, "eval_if")):
            runs[tag] = r = evaluate(model, corpus, wpath[model], "cuda",
                                     sweep=False)
            c = evaluate(model, corpus, wpath[model], "cpu", sweep=False)
            short_n = sum(T < SHORT_FRAMES for T in r["frames"])
            check(r["launches"] == {"K1": len(r["frames"]) - short_n,
                                    "K2": 0, "K3": 0, "K4": short_n},
                  f"{model} evaluation launches {r['launches']} for "
                  f"{short_n} short of {len(r['frames'])} items")
            d, t = same_labels(f"{model} test_model", r["result"],
                               c["result"])
            variant_ties += t
            variants_eval[model] = {
                "items": len(r["frames"]), "short_items": short_n,
                "audio_s": r["samples"] / SR,
                "test_model_ms": 1e3 * r["test_model_s"],
                "cpu_test_model_ms": 1e3 * c["test_model_s"],
                "featurize_ms": 1e3 * r["featurize_s"],
                "launches": r["launches"],
                "conf_mat_shape": list(r["result"]["ConfMat"].shape),
                "predictions_max_abs_delta_vs_cpu": d}
        runs["fuse_late"] = fl = fuse_late(corpus, late_ckpts, out("fl_g"),
                                           "cuda")
        fl_cpu = fuse_late(corpus, late_ckpts, out("fl_c"), "cpu")
        check(fl["launches"] == {"K1": 2 * fl["items"], "K2": 0, "K3": 0,
                                 "K4": 0},
              f"fuse_late launches {fl['launches']} for {fl['items']} "
              "items in two legs")
        d, t = same_labels("fuse_late", fl["result"], fl_cpu["result"])
        variant_ties += t
        variants_eval["late_fusion"] = {
            "items": fl["items"], "total_ms": 1e3 * fl["total_s"],
            "cpu_total_ms": 1e3 * fl_cpu["total_s"],
            "launches": fl["launches"],
            "predictions_max_abs_delta_vs_cpu": d}
        for tie in variant_ties:
            print(f"near-tie, label differs: {tie}", flush=True)
        print("[9 variants] " + "; ".join(
            f"{m}: launches {v['launches']}, predictions vs CPU max |delta| "
            f"{v['predictions_max_abs_delta_vs_cpu']:.3e}"
            for m, v in variants_eval.items())
            + f"; {len(variant_ties)} near-ties", flush=True)
        print(f"[9 evaluation] Lemaire {len(lem_eval['frames'])} items "
              f"({n_short} under {SHORT_FRAMES} frames), launches "
              f"{lem_eval['launches']}; predictions GPU vs CPU max |delta| "
              f"{eval_delta:.3e}, {len(ties)} near-ties; classifier 60 s "
              f"{clf_delta:.3e}; Jang {len(jang_eval['frames'])} items, "
              f"launches {jang_eval['launches']}; Papakostas "
              f"{len(pap_eval['frames'])} items, launches "
              f"{pap_eval['launches']}", flush=True)

        runs["train_device"] = tdev = train_cli(train_corpus, out("td"),
                                                "device")
        runs["train_host"] = thost = train_cli(train_corpus, out("th"),
                                               "host")
        runs["train_lemaire_fls"] = tfls = train_cli(
            train_corpus, out("tf"), "device",
            extra=("--frame-level-scaling",))
        step_checks = train_step_checks(train_corpus)
        step_times = time_device_steps(train_corpus)
        image = {}
        for model in IMAGE_MTL:
            image[model] = {"device_pipeline": train_cli(
                train_corpus, out(f"t_{model}_d"), "device", model=model)}
        runs["train_jang_device"] = image["Jang_et_al_MTL"]["device_pipeline"]
        runs["train_jang_host"] = image["Jang_et_al_MTL"]["host_pipeline"] = \
            train_cli(train_corpus, out("t_jang_h"), "host",
                      model="Jang_et_al_MTL")
        runs["train_papakostas"] = image[pap]["device_pipeline"]
        runs["train_doukhan"] = image["Doukhan_et_al_MTL"]["device_pipeline"]
        for model in BASELINES:
            runs[f"train_{model}"] = train_cli(
                train_corpus, out(f"t_{model}"), "device", model=model,
                epochs=1)
            image[model] = {"device_pipeline": runs[f"train_{model}"]}
        image_checks = image_step_checks(train_corpus)
        jang_times = time_device_steps(train_corpus, "Jang_et_al_MTL")
        make_five_class_folds(train_corpus)
        variants = {model: {"device_pipeline": train_cli(
            train_corpus, out(f"t_{model}_d"), "device", model=model)}
            for model in (CASCADED, FIVE, IF)}
        variants[IF]["host_pipeline"] = train_cli(
            train_corpus, out("t_if_h"), "host", model=IF)
        runs["train_cascaded"] = variants[CASCADED]["device_pipeline"]
        runs["train_five"] = variants[FIVE]["device_pipeline"]
        runs["train_if_device"] = variants[IF]["device_pipeline"]
        runs["train_if_host"] = variants[IF]["host_pipeline"]
        variant_checks = variant_step_checks(train_corpus)
        for model in (IF, FIVE):
            variants[model]["device_steps"] = time_device_steps(train_corpus,
                                                                model)
        if_step = variant_checks[IF]["audio_step"]
        five_step = variant_checks[FIVE]["patch_step"]
        print("[10 variants] " + "; ".join(
            f"{m}: " + ", ".join(f"{p} {r['launches']} val loss "
                                 f"{r['val_loss']}" for p, r in v.items()
                                 if p != "device_steps")
            for m, v in variants.items())
            + f"; fusion one step card vs CPU on the same patches: updates "
              f"{variant_checks[IF]['patch_step']['update_rel_max']:.2e};"
              f" with K1 inside: loss "
              f"{if_step['loss_rel']:.2e}, updates "
              f"{if_step['update_rel_max']:.2e}, statistics "
              f"{if_step['stats_err_max']:.2e}; 20 steps "
              f"{variant_checks[IF]['fixed_batch_losses'][0]:.4f} -> "
              f"{variant_checks[IF]['fixed_batch_losses'][-1]:.4f}; 5-class "
              f"patch step loss {five_step['loss_rel']:.2e}, updates "
              f"{five_step['update_rel_max']:.2e}; steps "
              f"{variants[IF]['device_steps']['step_ms']:.3f} ms (fusion), "
              f"{variants[FIVE]['device_steps']['step_ms']:.3f} ms "
              "(5-class)", flush=True)
        jang_step = image_checks["Jang_et_al_MTL"]["audio_step"]
        pap_step = image_checks[pap]["patch_step"]
        print("[10 image training] " + "; ".join(
            f"{m}: " + ", ".join(f"{p} {r['launches']} val loss "
                                 f"{r['val_loss']}" for p, r in v.items())
            for m, v in image.items())
            + f"; Jang one step card vs CPU (K2 inside): loss "
              f"{jang_step['loss_rel']:.2e}, updates "
              f"{jang_step['update_rel_max']:.2e}; Papakostas patch step "
              f"updates {pap_step['update_rel_max']:.2e}; Jang step "
              f"{jang_times['step_ms']:.3f} ms", flush=True)
        print(f"[10 training] device pipeline {tdev['launches']['K1']} K1 "
              f"launches, epochs {tdev['epoch_train_s']} s; host pipeline "
              f"{thost['launches']['K1']} K1 launches, epochs "
              f"{thost['epoch_train_s']} s; one step card vs CPU, on the "
              f"same patches: loss "
              f"{step_checks['patch_step']['loss_rel']:.2e}, updates "
              f"{step_checks['patch_step']['update_rel_max']:.2e}, "
              f"statistics {step_checks['patch_step']['stats_err_max']:.2e};"
              f" with K1 inside: loss "
              f"{step_checks['audio_step']['loss_rel']:.2e}, updates "
              f"{step_checks['audio_step']['update_rel_max']:.2e} (features "
              f"{step_checks['features_max_abs_delta']:.2e}); 20 steps "
              f"{step_checks['fixed_batch_losses'][0]:.4f} -> "
              f"{step_checks['fixed_batch_losses'][-1]:.4f}; step "
              f"{step_times['step_ms']:.3f} ms", flush=True)

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

    paths = {"K1": ("lemaire_60", "lemaire_600", "eval_lemaire",
                    "classify_60", "train_device", "train_host",
                    "train_lemaire_fls", "train_doukhan", "cascaded_60",
                    "five_60", "eval_five", "eval_if", "fuse_late",
                    "train_cascaded", "train_five", "train_if_device",
                    "train_if_host"),
             "K2": ("jang_60", "jang_600", "jang_10", "eval_jang", "pap_60",
                    "pap_10", "eval_papakostas", "train_jang_device",
                    "train_jang_host", "train_papakostas"),
             "K3": ("resynth_60", "eval_jang", "eval_papakostas"),
             "K4": ("eval_lemaire", "eval_five", "eval_if")}
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
    print("[11 checks] ok", flush=True)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"serving": {
        "card": card, "lemaire_mtl": lem_t, "jang_mtl": jang_t,
        "feature_max_abs_db": {"lemaire_mtl": db, "jang_mtl": jang_db},
        "jang_track_max_abs_delta_vs_cpu": jang_track,
        "jang_cpu_10s_total_ms": 1e3 * j10_cpu["total_s"],
        "papakostas_mtl": {
            "first_run_60s_total_ms": 1e3 * p60["total_s"],
            "warm_60s_total_ms": 1e3 * p60_warm["total_s"],
            "10s_total_ms": 1e3 * p10["total_s"],
            "cpu_10s_total_ms": 1e3 * p10_cpu["total_s"],
            "track_max_abs_delta_vs_cpu": pap_track},
        "variants": variants_serving,
        "build_s": build_s}}))
    print(json.dumps({"resynthesis": {
        "card": card, "audio_s": len(x60) / SR,
        "first_run_total_ms": 1e3 * rs["total_s"],
        "total_ms": 1e3 * rs_warm["total_s"],
        "cpu_total_ms": 1e3 * rs_cpu["total_s"],
        "gpu_vs_cpu_peak_rel": rs_delta}}))
    print(json.dumps({"evaluation": {
        "card": card, "model": lem, "items": len(lem_eval["frames"]),
        "short_items": n_short, "audio_s": lem_eval["samples"] / SR,
        "test_model_ms": 1e3 * lem_eval["test_model_s"],
        "sweep_ms": 1e3 * lem_eval["sweep_s"],
        "featurize_ms": 1e3 * lem_eval["featurize_s"],
        "featurize_share": lem_eval["featurize_s"]
        / (lem_eval["test_model_s"] + lem_eval["sweep_s"]),
        "launches": lem_eval["launches"],
        "cpu_test_model_ms": 1e3 * lem_eval_cpu["test_model_s"],
        "cpu_sweep_ms": 1e3 * lem_eval_cpu["sweep_s"],
        "predictions_max_abs_delta_vs_cpu": eval_delta,
        "near_ties": len(ties),
        "classify_60s": {"total_ms": 1e3 * clf["total_s"],
                         "cpu_total_ms": 1e3 * clf_cpu["total_s"],
                         "launches": clf["launches"],
                         "probabilities_max_abs_delta_vs_cpu": clf_delta},
        "jang_mtl": {"items": len(jang_eval["frames"]), "short_items":
                     j_short, "audio_s": jang_eval["samples"] / SR,
                     "test_model_ms": 1e3 * jang_eval["test_model_s"],
                     "featurize_ms": 1e3 * jang_eval["featurize_s"],
                     "launches": jang_eval["launches"]},
        "papakostas_mtl": {"items": len(pap_eval["frames"]), "short_items":
                           p_short, "audio_s": pap_eval["samples"] / SR,
                           "test_model_ms": 1e3 * pap_eval["test_model_s"],
                           "featurize_ms": 1e3 * pap_eval["featurize_s"],
                           "launches": pap_eval["launches"]},
        "variants": variants_eval}}))
    k1_train = entries[0]["training_shapes"]

    def brief(run):
        return {k: v for k, v in run.items() if k not in ("shapes",
                                                          "history")}
    print(json.dumps({"training": {
        "card": card, "model": lem, "width": "32 filters, 3 stacks, Nd 8, "
        "D 240, patch 68, head width 16, 16 clips per class",
        "corpus": {"files_per_class": TRAIN_FILES,
                   "seconds_per_file": TRAIN_SECONDS},
        "epochs": TRAIN_EPOCHS, "train_steps": TRAIN_STEPS,
        "val_steps": VAL_STEPS,
        "device_pipeline": {**{k: v for k, v in tdev.items()
                               if k not in ("shapes", "history")},
                            **step_times},
        "host_pipeline": {k: v for k, v in thost.items()
                          if k not in ("shapes", "history")},
        "k1_at_48x11120": k1_train["48x11120"],
        "k1_at_12x43760": k1_train["12x43760"],
        "one_step_card_vs_cpu": {k: v for k, v in step_checks.items()
                                 if k != "fixed_batch_losses"},
        "fixed_batch_losses": step_checks["fixed_batch_losses"],
        "frame_level_scaling": brief(tfls),
        **{model: {**{p: brief(r) for p, r in image[model].items()},
                   **image_checks.get(model, {}),
                   **({"device_steps": jang_times}
                      if model == "Jang_et_al_MTL" else {})}
           for model in IMAGE_MTL + BASELINES},
        "variants": {model: {
            **{p: (brief(r) if p != "device_steps" else r)
               for p, r in v.items()},
            **variant_checks.get(model, {})}
            for model, v in variants.items()},
        "k1_at_80x11120": k1_train["80x11120"],
        "k1_at_20x43760": k1_train["20x43760"],
        "k2_training_shapes": entries[1]["training_shapes"]}}))
    print(f"[12 total] {time.perf_counter() - t_start:.1f} s", flush=True)
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

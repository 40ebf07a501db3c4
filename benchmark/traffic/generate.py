"""The benchmark's traffic, made from a seed: a MUSAN-layout training
corpus and a pool of broadcasts, written as 16 kHz 16-bit wavs.

The sounds are those of ``sm_hpss_mtl_tpu_torch/data/audio.py::
make_toy_musan``, copied here so that a change to the program cannot move
them: music is a chord progression of stacked harmonics under a slow
envelope, speech a formant-filtered pulse train with syllabic gaps and a
wobbling pitch.  The same seed writes the same bytes.

A broadcast alternates segments of music, speech and both (at a random
speech-to-music ratio), cut from a bank of seeded snippets, under a faint
noise floor.  The pool's lengths do not depend on the seed: they are a
log-uniform distribution's quantiles over the mix's range, so every seed
serves the same amount of audio in another order and with other sounds.
"""

from __future__ import annotations

import csv
import os

import numpy as np
from scipy.io import wavfile
from scipy.signal import lfilter

SR = 16000
_GENRES = ("jazz", "rock", "classical")
_GENDERS = ("f", "m")


def synth_music(rng: np.random.Generator, n: int) -> np.ndarray:
    """Chord progression: stacked harmonics with slow envelopes."""
    t = np.arange(n) / SR
    roots = rng.choice([220.0, 246.9, 293.7, 329.6], size=4)
    x = np.zeros(n)
    seg = n // len(roots)
    for i, f0 in enumerate(roots):
        sl = slice(i * seg, (i + 1) * seg if i < len(roots) - 1 else n)
        tt = t[sl]
        for mult, amp in [(1, 1.0), (1.5, 0.6), (2, 0.5), (3, 0.25)]:
            x[sl] += amp * np.sin(2 * np.pi * f0 * mult * tt
                                  + rng.uniform(0, 2 * np.pi))
    x *= 0.2 + 0.1 * np.sin(2 * np.pi * 0.5 * t)
    return x


def synth_speech(rng: np.random.Generator, n: int) -> np.ndarray:
    """Formant-filtered pulse train with syllabic gaps and pitch wobble."""
    t = np.arange(n) / SR
    f0 = 120 + 40 * np.sin(2 * np.pi * 2.3 * t) + rng.uniform(-10, 10)
    phase = np.cumsum(f0) / SR
    glottal = (np.sign(np.sin(2 * np.pi * phase))
               * np.sin(2 * np.pi * phase) ** 2)
    env = np.clip(np.sin(2 * np.pi * 3.7 * t) + 0.4, 0, None)
    x = glottal * env + 0.02 * rng.standard_normal(n)
    for fc in (700.0, 1900.0):
        r = np.exp(-2 * np.pi * 150 / SR)
        theta = 2 * np.pi * fc / SR
        x = lfilter([1.0], [1.0, -2 * r * np.cos(theta), r ** 2], x)
    return x


def normalize(x: np.ndarray) -> np.ndarray:
    """Zero mean, unit peak."""
    x = x - np.mean(x)
    return x / np.max(np.abs(x))


def write_wav(path: str, x: np.ndarray) -> None:
    """``x`` nominally in [-1, 1] as 16-bit PCM, clipped."""
    wavfile.write(path, SR, (np.clip(x, -1.0, 1.0) * 32767.0)
                  .astype(np.int16))


def make_corpus(root: str, seed: int, spec: dict) -> str:
    """``root/{music,speech}/*.wav`` and ``root/annotations/<class>.csv``
    (genre and gender strata), ``spec[cls] = {"files": n, "seconds": [lo,
    hi]}`` per class, each file's length uniform in that range."""
    rng = np.random.default_rng(seed)
    annot = os.path.join(root, "annotations")
    os.makedirs(annot, exist_ok=True)
    for cls, synth in (("music", synth_music), ("speech", synth_speech)):
        os.makedirs(os.path.join(root, cls), exist_ok=True)
        rows = []
        for i in range(spec[cls]["files"]):
            name = f"{cls}-bench-{i:04d}"
            n = int(rng.uniform(*spec[cls]["seconds"]) * SR)
            write_wav(os.path.join(root, cls, name + ".wav"),
                      normalize(synth(rng, n)))
            strata = _GENRES if cls == "music" else _GENDERS
            rows.append([name, strata[i % len(strata)]])
        with open(os.path.join(annot, cls + ".csv"), "w", newline="") as f:
            csv.writer(f).writerows(rows)
    return root


def pool_seconds(spec: dict) -> list[float]:
    """The pool's lengths in seconds: a log-uniform distribution over
    ``minutes`` at the middles of ``count`` equal shares of it (quantiles
    ``(i + 1/2) / count``), shortest first."""
    lo, hi = spec["minutes"]
    k = spec["count"]
    return [60.0 * lo * (hi / lo) ** ((i + 0.5) / k) for i in range(k)]


def broadcast(rng: np.random.Generator, n: int, bank: dict,
              spec: dict) -> np.ndarray:
    """``n`` samples of alternating music, speech and both."""
    x = np.empty(n, np.float32)
    lo, hi = spec["segment_s"]
    pos = 0
    while pos < n:
        m = min(n - pos, int(rng.uniform(lo, hi) * SR))
        kind = rng.integers(3)                 # 0 music, 1 speech, 2 both
        seg = np.zeros(m, np.float32)
        for cls, on in (("music", kind != 1), ("speech", kind != 0)):
            if not on:
                continue
            snip = bank[cls][rng.integers(len(bank[cls]))]
            off = int(rng.integers(0, len(snip) - m + 1))
            gain = rng.uniform(0.3, 0.6) if cls == "music" else \
                rng.uniform(0.5, 0.9)
            seg += gain * snip[off:off + m]
        x[pos:pos + m] = seg
        pos += m
    x += spec["noise_floor"] * rng.standard_normal(n, dtype=np.float32)
    return 0.9 * x / np.abs(x).max()


def make_pool(root: str, seed: int, spec: dict) -> list[dict]:
    """The pool's wavs under ``root``: a list of ``{"path", "seconds"}`` in
    the order of :func:`pool_seconds`."""
    rng = np.random.default_rng(seed)
    n_snip = int(spec["segment_s"][1] * SR)
    bank = {cls: [normalize(synth(rng, n_snip)).astype(np.float32)
                  for _ in range(spec["bank"])]
            for cls, synth in (("music", synth_music),
                               ("speech", synth_speech))}
    os.makedirs(root, exist_ok=True)
    pool = []
    for i, seconds in enumerate(pool_seconds(spec)):
        path = os.path.join(root, f"broadcast-{i:02d}.wav")
        write_wav(path, broadcast(rng, int(seconds * SR), bank, spec))
        pool.append({"path": path, "seconds": seconds})
    return pool


def request_order(seed: int, n_pool: int):
    """Pool indices without end: seeded permutations of the pool, one
    after another (a closed loop serves them in this order)."""
    rng = np.random.default_rng([seed, 1])
    while True:
        yield from (int(i) for i in rng.permutation(n_pool))

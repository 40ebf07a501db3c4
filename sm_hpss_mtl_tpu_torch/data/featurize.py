"""File-level featurization with an ``.npy`` cache (counterpart of
``sm_hpss_mtl_tpu/data/featurize.py``).

Per (class, file[, mix partner, SMR]) featuregrams, cached as
``<cache_dir>/<classname>/<name>.npy`` with the reference's naming
(``spstem_mustem_<dB>dB`` for mixtures), so a cache written by one run is
read by any other.  The features are computed on the featurizer's device
by ``ops.featuregram.featuregram``: on CUDA through kernel K1 (Mel-HPSS
families) or K2 (full-resolution HPSS families), and for clips under
``2*(l_harm//2)`` frames through K4 or K3 (``ops/frontend.py``).

Whole-signal inputs are padded to a geometric length bucket, as the JAX
package does to bound its compiled shapes; the port keeps the rule so
that both packages featurize the same padded signal.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..ops import featuregram as fg
from ..ops.mixing import mix_signals_np
from ..ops.stft import n_frames
from .audio import load_and_preprocess_signal


@dataclass(frozen=True)
class FeatureConfig:
    """Per-model feature settings (the reference's featName / n_fft / n_mels
    / l_harm / l_perc parameters).

    ``dft_precision`` defaults to ``'highest'`` (split TF32 on the card,
    held to the JAX package's ``'highest'`` bars), where the JAX package's
    default is ``'bf16x3'``; ``dft_precision='bf16x3'`` computes the JAX
    default's bf16x3 DFT (``ops.frontend``).  The port keeps ``'highest'``
    because every accepted card bar and CPU parity test is held there, and
    the JAX default rests on a TPU throughput reading that does not carry
    over to the card."""
    feat_name: str = "LogMelHarmPercSpec"
    sr: int = 16000
    n_fft: int = 400
    win_length: int = 400
    hop_length: int = 160
    n_mels: int = 120
    l_harm: int = 21
    l_perc: int = 11
    Tw: int = 25
    Ts: int = 10
    dft_precision: str = "highest"

    @property
    def dim(self) -> int:
        return fg.feature_dim(self.feat_name, n_fft=self.n_fft,
                              n_mels=self.n_mels)


def mixture_cache_name(sp_path: str, mu_path: str, target_db) -> str:
    """The reference's cache name of an item: the file stem, or
    ``<speech stem>_<music stem>_<dB>dB`` for a mixture."""
    def stem(p):
        return os.path.basename(p).rsplit(".", 1)[0]
    if sp_path and mu_path:
        return f"{stem(sp_path)}_{stem(mu_path)}_{target_db}dB"
    return stem(sp_path or mu_path)


def bucket_length(n: int, min_n: int = 16000, ratio: float = 1.1) -> int:
    """Geometric length buckets: the smallest grid point >= n."""
    m = min_n
    while m < n:
        m = int(m * ratio) + 1
    return m


def _reflect_pad_to(x: np.ndarray, target: int) -> np.ndarray:
    """Pad 1-D ``x`` to ``target`` samples by repeated symmetric
    reflection (handles pads longer than the signal)."""
    out = x
    flip = True
    while len(out) < target:
        out = np.concatenate([out, x[::-1] if flip else x])
        flip = not flip
    return out[:target]


class Featurizer:
    """Callable file -> ``(D, T)`` float32 featuregram on the host, with an
    optional disk cache and a bounded in-memory LRU.

    ``bucket=True`` (default) reflect-pads the audio up to a geometric
    length bucket, limits the dB clamp to the real frames and slices the
    result to them: frames 0..T-1 of the STFT are those of the exact
    length, but the harmonic median of the last ``l_harm//2`` frames sees
    reflected-tail context instead of the symmetric edge.  ``bucket=False``
    is the exact-boundary path (file-wise evaluation when exactness
    matters); there a clip under ``2*(l_harm//2)`` frames takes the
    short-clip kernels.  ``device`` is where the features are computed
    (CUDA unless the caller asks for the CPU)."""

    def __init__(self, config: FeatureConfig, cache_dir: str | None = None,
                 bucket: bool = True, mem_cache_mb: int = 512,
                 device: str | torch.device = "cuda"):
        self.config = config
        self.cache_dir = cache_dir
        self.bucket = bucket
        self.device = resolve_device(device)
        self._mem_cache: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self._mem_bytes = 0
        self._mem_limit = mem_cache_mb * (1 << 20)
        self._lock = threading.Lock()
        #: cache behaviour counters
        self.stats = {"mem_hits": 0, "disk_hits": 0, "computes": 0}

    def _count(self, key: str) -> None:
        with self._lock:
            self.stats[key] += 1

    def _mem_get(self, key: str):
        with self._lock:
            fv = self._mem_cache.get(key)
            if fv is not None:
                self._mem_cache.move_to_end(key)
            return fv

    def _mem_put(self, key: str, fv: np.ndarray):
        if fv.nbytes > self._mem_limit:
            return
        with self._lock:
            if key in self._mem_cache:
                return
            self._mem_cache[key] = fv
            self._mem_bytes += fv.nbytes
            while self._mem_bytes > self._mem_limit:
                _, old = self._mem_cache.popitem(last=False)
                self._mem_bytes -= old.nbytes

    def _featuregram(self, audio: np.ndarray, valid_frames=None
                     ) -> torch.Tensor:
        c = self.config
        return fg.featuregram(
            torch.as_tensor(audio, dtype=torch.float32, device=self.device),
            feat_name=c.feat_name, sr=c.sr, n_fft=c.n_fft,
            win_length=c.win_length, hop_length=c.hop_length,
            n_mels=c.n_mels, l_harm=c.l_harm, l_perc=c.l_perc,
            valid_frames=valid_frames, dft_precision=c.dft_precision)

    def _compute(self, audio: np.ndarray) -> np.ndarray:
        if not self.bucket:
            return self._featuregram(audio).cpu().numpy()
        c = self.config
        true_T = n_frames(len(audio), c.n_fft, c.hop_length)
        padded = _reflect_pad_to(audio, bucket_length(len(audio)))
        out = self._featuregram(padded, valid_frames=true_T)
        return out[:, :true_T].cpu().numpy()

    def _load(self, classname: str, sp_path: str, mu_path: str, target_db
              ) -> np.ndarray:
        """The item's audio after the reference's load chain (and mixing)."""
        c = self.config
        if classname in ("speech_music", "speech_noise"):
            sp, _ = load_and_preprocess_signal(sp_path, c.Tw, c.Ts)
            mu, _ = load_and_preprocess_signal(mu_path, c.Tw, c.Ts)
            return mix_signals_np(sp, mu, target_db).astype(np.float32)
        if classname in ("speech", "muspeak"):
            return load_and_preprocess_signal(sp_path, c.Tw, c.Ts)[0]
        return load_and_preprocess_signal(mu_path, c.Tw, c.Ts)[0]

    def _cache_path(self, classname: str, name: str) -> str | None:
        if not self.cache_dir:
            return None
        return os.path.join(self.cache_dir, classname, name + ".npy")

    def featuregram(self, classname: str, sp_path: str = "",
                    mu_path: str = "", target_db=None,
                    save_feat: bool = True) -> np.ndarray:
        """Featuregram of one item; ``classname`` in {'speech', 'music',
        'speech_music', 'speech_noise', 'noise', 'muspeak'}."""
        name = mixture_cache_name(sp_path, mu_path, target_db)
        key = f"{classname}/{name}"
        cached = self._mem_get(key)
        if cached is not None:
            self._count("mem_hits")
            return cached
        cache_path = self._cache_path(classname, name)
        if cache_path and os.path.exists(cache_path):
            fv = np.load(cache_path, allow_pickle=False)
            self._mem_put(key, fv)
            self._count("disk_hits")
            return fv
        self._count("computes")
        fv = self._compute(self._load(classname, sp_path, mu_path,
                                      target_db))
        if save_feat:
            if cache_path:
                os.makedirs(os.path.dirname(cache_path), exist_ok=True)
                np.save(cache_path, fv)
            self._mem_put(key, fv)
        return fv

    def precompute(self, items: list[tuple], batch_size: int = 16,
                   verbose: bool = False) -> int:
        """Featurize many items at once, grouped by length bucket.

        ``items``: (classname, sp_path, mu_path, target_db) tuples (the
        :meth:`featuregram` signature).  Items sharing a length bucket are
        stacked into batches of up to ``batch_size``, each featurized in
        one call with a per-item ``valid_frames``, then cached one by one.
        Items already in the disk cache are skipped.  Returns the number of
        featuregrams computed."""
        c = self.config
        by_bucket: dict[int, list] = {}
        for classname, sp_path, mu_path, target_db in items:
            name = mixture_cache_name(sp_path, mu_path, target_db)
            cache_path = self._cache_path(classname, name)
            if cache_path and os.path.exists(cache_path):
                continue
            audio = self._load(classname, sp_path, mu_path, target_db)
            true_T = n_frames(len(audio), c.n_fft, c.hop_length)
            bucket = bucket_length(len(audio))
            by_bucket.setdefault(bucket, []).append(
                (f"{classname}/{name}", cache_path, audio, true_T))

        done = 0
        n_pending = sum(len(g) for g in by_bucket.values())
        for bucket, group in sorted(by_bucket.items()):
            for i in range(0, len(group), batch_size):
                chunk = group[i:i + batch_size]
                batch = np.stack([_reflect_pad_to(e[2], bucket)
                                  for e in chunk])
                valid = torch.tensor([e[3] for e in chunk],
                                     device=self.device)[:, None, None]
                out = self._featuregram(batch, valid_frames=valid)
                out = out.cpu().numpy()
                for (key, cache_path, _, true_T), fv in zip(chunk, out):
                    fv = fv[:, :true_T]
                    if cache_path:
                        os.makedirs(os.path.dirname(cache_path),
                                    exist_ok=True)
                        np.save(cache_path, fv)
                    self._mem_put(key, fv)
                    done += 1
                if verbose:
                    print(f"bucket {bucket}: {done}/{n_pending} done",
                          flush=True)
        return done

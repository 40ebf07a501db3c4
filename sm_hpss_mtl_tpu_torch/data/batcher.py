"""Class-balanced infinite batch stream with MTL labels, the host training
pipeline (counterpart of ``sm_hpss_mtl_tpu/data/batcher.py``).

Semantics follow the reference's ``generator``:

- Per class, files are shuffled and consumed; the list refills (and
  reshuffles) when exhausted.  Every file contributes *all* its patches;
  leftovers beyond the per-class quota carry over to later batches.
- Each batch stacks ``batch_size`` patches per class in the order
  music(0), speech(1)[, speech_music(2)[, noise(3), speech_noise(4)]].
- Labels (:func:`mtl_labels`): S=1 for speech only, M=1 for music only
  (the mixture class gets 0 on both, a quirk of the reference's training
  script, kept); R = [music_ratio, speech_ratio] with music [1, 0], speech
  [0, 1] and mixtures [10^(-dB/10), 1] (dB >= 0) or [1, 10^(dB/10)]
  (dB < 0); 3C one-hot.  The 5-class encodings differ (see there).
- Per-file row standardization (split per HPSS component) is the port's
  ``ops.patches.standardize_rows`` (constant rows centred to 0), which
  equals the JAX package's native host kernel; or frame-level corpus
  scaling with per-fold statistics.  Optionally each patch is replaced by
  its skewness vector per row ('Row') or column ('Col',
  ``ops.stats.patch_statistics``).
- Optional Gaussian noise augmentation, scale drawn from {5e-3, 1e-3,
  5e-4, 1e-4}, from the batcher's numpy generator (the JAX package draws
  the field from its native sampler; the training runner keeps this off
  and augments on the device).
- Lemaire models take (N, T, D) patches ('time_mel'), CNNs (N, D, W, 1);
  with ``dual_tower`` a batch is ``{"harm_input", "perc_input"}``, the
  two halves of the features (the intermediate-fusion model).
"""

from __future__ import annotations

import os
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.patches import extract_patches_np, standardize_rows
from ..ops.stats import skewness_vectors
from ..train.state import NOISE_SCALES
from .featurize import Featurizer

#: The class streams in batch order, each with its key in a fold's file
#: dict; 2-, 3- and 5-class folds take the first 2, 3 or 5.
FOLD_KEY = {"music": "music", "speech": "speech",
            "speech_music": "speech+music", "noise": "noise",
            "speech_noise": "speech+noise"}


def scale_frames(fv: np.ndarray, mean: np.ndarray, stdev: np.ndarray
                 ) -> np.ndarray:
    """Frame-level corpus scaling: ``(FV - mean) / (stdev + 1e-10)`` with
    per-row statistics."""
    return (fv - mean[:, None]) / (stdev[:, None] + 1e-10)


@dataclass
class BatcherConfig:
    batch_size: int = 16
    patch_size: int = 68
    patch_shift: int = 68
    feat_name: str = "LogMelHarmPercSpec"
    #: 'time_mel' (TCN) or 'image' (CNNs) patch layout.
    input_kind: str = "time_mel"
    augment_noise: bool = True
    frame_level_scaling: bool = False
    #: None | 'Row' | 'Col'
    skewness_vector: str | None = None
    #: {'harm_input', 'perc_input'} dict batches (intermediate fusion)
    dual_tower: bool = False
    seed: int = 0
    #: LRU byte budget for per-file extracted patches (0 disables).
    patch_cache_mb: int = 512


def split_dual(x: np.ndarray, input_kind: str) -> dict:
    """A batch of stacked [harmonic; percussive] patches as the twin
    towers' ``{"harm_input", "perc_input"}``: split along the features,
    the last axis of 'time_mel' patches, the second of 'image' ones."""
    if input_kind == "time_mel":
        d = x.shape[-1] // 2
        return {"harm_input": x[..., :d], "perc_input": x[..., d:]}
    h = x.shape[1] // 2
    return {"harm_input": x[:, :h], "perc_input": x[:, h:]}


def class_streams(file_list: dict) -> list[str]:
    """The class streams of a fold's file dict, in batch order: music,
    speech[, speech_music[, noise, speech_noise]]."""
    n = (5 if "speech+noise" in file_list
         else 3 if "speech+music" in file_list else 2)
    return list(FOLD_KEY)[:n]


def mtl_labels(per_class: int, dbs: list) -> dict:
    """The MTL labels of a batch of ``per_class`` rows per class, classes
    in :func:`class_streams` order; ``dbs[i]`` holds the SMR in dB of
    class ``i``'s rows (read for the mixtures).

    5 classes: speech+music counts as S=1 and M=1, and R is 3-wide [music,
    speech, noise] with the reference's speech+noise convention
    (inconsistent with the 3-class one, kept)."""
    n_classes, bs = len(dbs), per_class
    n = n_classes * bs
    onehot = np.zeros((n, n_classes), np.float32)
    onehot[np.arange(n), np.repeat(np.arange(n_classes), bs)] = 1.0
    if n_classes == 5:
        s = np.array([0, 1, 1, 0, 1], np.float32).repeat(bs)
        m = np.array([1, 0, 1, 0, 0], np.float32).repeat(bs)
        no = np.array([0, 0, 0, 1, 1], np.float32).repeat(bs)
        r = np.ones((n, 3), np.float32)
        r[:bs] = [1, 0, 0]
        r[bs:2 * bs] = [0, 1, 0]
        for i, db in enumerate(dbs[2]):          # speech+music
            if db >= 0:
                r[2 * bs + i] = [10.0 ** (-db / 10.0), 1.0, 0.0]
            else:
                r[2 * bs + i] = [1.0, 10.0 ** (db / 10.0), 0.0]
        r[3 * bs:4 * bs] = [0, 0, 1]
        for i, db in enumerate(dbs[4]):          # speech+noise
            if db >= 0:
                r[4 * bs + i] = [0.0, 10.0 ** (-db / 10.0), 1.0]
            else:
                r[4 * bs + i] = [0.0, 1.0, 10.0 ** (db / 10.0)]
        return {"S": s, "M": m, "N": no, "R": r, "3C": onehot}

    s = np.zeros(n, np.float32)
    s[bs:2 * bs] = 1.0          # speech rows only (spmu=0, as the reference)
    m = np.zeros(n, np.float32)
    m[:bs] = 1.0                # music rows only
    r = np.ones((3 * bs, 2), np.float32)
    r[:bs] = [1.0, 0.0]
    r[bs:2 * bs] = [0.0, 1.0]
    if n_classes == 3:
        for i, db in enumerate(dbs[2]):
            if db >= 0:
                r[2 * bs + i] = [10.0 ** (-db / 10.0), 1.0]
            else:
                r[2 * bs + i] = [1.0, 10.0 ** (db / 10.0)]
    return {"S": s, "M": m, "R": r[:n], "3C": onehot}


class FileQueue:
    """A class's files, drawn from a fresh shuffle each time the list runs
    out."""

    def __init__(self, items: list, rng: np.random.Generator):
        self.items = list(items)
        self.queue: list = []
        self.rng = rng

    def next_item(self):
        if not self.queue:
            self.queue = list(self.items)
            self.rng.shuffle(self.queue)
        return self.queue.pop()


class _ClassStream(FileQueue):
    """One class's file queue and leftover patch buffer; ``take_into``
    consumes from the front through a cursor and copies only the patches
    it returns."""

    def __init__(self, items: list, rng: np.random.Generator):
        super().__init__(items, rng)
        self.buf: list[np.ndarray] = []
        self.dbs: list[np.ndarray] = []
        self.offset = 0  # consumed rows of buf[0]
        self.count = 0

    def push(self, patches: np.ndarray, db=None):
        self.buf.append(patches)
        n = patches.shape[0]
        self.dbs.append(np.full((n,), np.nan if db is None else db))
        self.count += n

    def take_into(self, out: np.ndarray) -> np.ndarray:
        """Consume ``len(out)`` patches into ``out``; returns their
        per-patch dB values."""
        n = out.shape[0]
        db_out = np.empty((n,))
        filled = 0
        while filled < n:
            arr, dbs = self.buf[0], self.dbs[0]
            avail = arr.shape[0] - self.offset
            k = min(avail, n - filled)
            out[filled:filled + k] = arr[self.offset:self.offset + k]
            db_out[filled:filled + k] = dbs[self.offset:self.offset + k]
            self.offset += k
            filled += k
            if self.offset == arr.shape[0]:
                self.buf.pop(0)
                self.dbs.pop(0)
                self.offset = 0
        self.count -= n
        return db_out


class BalancedBatcher:
    """Infinite iterator of ``(x, labels)`` class-balanced numpy batches.

    ``file_list`` is the fold dict of ``folds.get_train_test_files``:
    {'music': [...], 'speech': [...], 'speech+music': [{'speech', 'music',
    'SMR'}, ...]}; the mixture key is optional (2-class mode).
    """

    def __init__(self, featurizer: Featurizer, folder: str, file_list: dict,
                 config: BatcherConfig, fold_stats: tuple | None = None):
        self.fz = featurizer
        self.folder = folder
        self.cfg = config
        self.fold_stats = fold_stats
        self.rng = np.random.default_rng(config.seed)
        self.order = class_streams(file_list)
        self.streams = {cls: _ClassStream(file_list[FOLD_KEY[cls]], self.rng)
                        for cls in self.order}
        self._patch_cache: OrderedDict = OrderedDict()
        self._patch_bytes = 0
        self._patch_limit = config.patch_cache_mb * (1 << 20)
        #: patch-LRU counters
        self.cache_stats = {"hits": 0, "misses": 0, "evictions": 0}

    # -- featurization ----------------------------------------------------
    def _pc_get(self, key):
        hit = self._patch_cache.get(key)
        if hit is not None:
            self._patch_cache.move_to_end(key)
            self.cache_stats["hits"] += 1
        else:
            self.cache_stats["misses"] += 1
        return hit

    def _pc_put(self, key, patches: np.ndarray, db):
        if patches.nbytes > self._patch_limit:
            return
        self._patch_cache[key] = (patches, db)
        self._patch_bytes += patches.nbytes
        while self._patch_bytes > self._patch_limit:
            _, (old, _db) = self._patch_cache.popitem(last=False)
            self._patch_bytes -= old.nbytes
            self.cache_stats["evictions"] += 1

    def _patches_for(self, classname: str, item):
        if self._patch_limit > 0:
            if isinstance(item, dict):
                key = (classname, item["speech"],
                       item.get("music") or item.get("noise"), item["SMR"])
            else:
                key = (classname, item)
            hit = self._pc_get(key)
            if hit is not None:
                return hit
            patches, db = self._patches_for_uncached(classname, item)
            if patches is not None:
                self._pc_put(key, patches, db)
            return patches, db
        return self._patches_for_uncached(classname, item)

    def _patches_for_uncached(self, classname: str, item):
        if classname in ("speech_music", "speech_noise"):
            partner_dir = "music" if classname == "speech_music" else "noise"
            sp = os.path.join(self.folder, "speech", item["speech"])
            mu = os.path.join(self.folder, partner_dir, item[partner_dir])
            if not (os.path.exists(sp) and os.path.exists(mu)):
                return None, None
            fv = self.fz.featuregram(classname, sp, mu, item["SMR"])
            db = item["SMR"]
        elif classname == "speech":
            sp = os.path.join(self.folder, "speech", item)
            if not os.path.exists(sp):
                return None, None
            fv = self.fz.featuregram("speech", sp_path=sp)
            db = None
        else:  # music / noise
            mu = os.path.join(self.folder, classname, item)
            if not os.path.exists(mu):
                return None, None
            fv = self.fz.featuregram(classname, mu_path=mu)
            db = None

        if self.cfg.frame_level_scaling and self.fold_stats is not None:
            fv = scale_frames(fv, *self.fold_stats)
        return self._extract(fv), db

    def _extract(self, fv: np.ndarray) -> np.ndarray:
        """Per-featName patching, with the harmonic and percussive halves
        standardized apart and put back together."""
        cfg = self.cfg
        dual = "HarmPerc" in cfg.feat_name
        half = fv.shape[0] // 2
        parts = [fv[:half], fv[half:]] if dual else [fv]
        out = []
        for part in parts:
            if not cfg.frame_level_scaling:
                part = standardize_rows(torch.from_numpy(
                    np.ascontiguousarray(part, np.float32))).numpy()
            out.append(extract_patches_np(part, cfg.patch_size,
                                          cfg.patch_shift))
        patches = np.concatenate(out, axis=1) if dual else out[0]
        if cfg.skewness_vector:
            patches = skewness_vectors(torch.from_numpy(np.ascontiguousarray(
                patches, np.float32)), cfg.skewness_vector).numpy()
        patches = np.asarray(patches, dtype=np.float32)
        if cfg.input_kind == "time_mel":
            # Stored in the model's (N, T, D) layout, so batch assembly is
            # a contiguous copy (amortized over the patch cache).
            patches = np.ascontiguousarray(np.transpose(patches, (0, 2, 1)))
        return patches

    # -- assembly ---------------------------------------------------------
    def _fill(self, classname: str):
        stream = self.streams[classname]
        while stream.count < self.cfg.batch_size:
            patches, db = self._patches_for(classname, stream.next_item())
            if patches is None:
                continue
            stream.push(patches, db)

    def __iter__(self):
        return self

    def __next__(self):
        bs = self.cfg.batch_size
        for cls in self.order:
            self._fill(cls)
        patch_shape = self.streams[self.order[0]].buf[0].shape[1:]
        x = np.empty((len(self.order) * bs, *patch_shape), np.float32)
        dbs = [self.streams[cls].take_into(x[i * bs:(i + 1) * bs])
               for i, cls in enumerate(self.order)]

        if self.cfg.input_kind != "time_mel":
            x = x[..., None]

        if self.cfg.augment_noise:
            scale = float(self.rng.choice(NOISE_SCALES))
            x += (self.rng.standard_normal(x.shape, dtype=np.float32)
                  * np.float32(scale))
        if self.cfg.dual_tower:
            x = split_dual(x, self.cfg.input_kind)
        return x, mtl_labels(bs, dbs)

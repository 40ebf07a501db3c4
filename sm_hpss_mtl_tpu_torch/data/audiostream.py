"""Raw-audio crops for the device training pipeline (counterpart of
``sm_hpss_mtl_tpu/data/audiostream.py``; pure numpy, so the same seed gives
the same crops and labels as the JAX package, bit for bit).

The host serves class-balanced **raw audio crops** (a memmap slice per
clip); STFT, HPSS, mel, patching and the model run on the device in one
train step (``train.endtoend``).

Semantics against the host batcher (documented deltas, not quirks):

- The host batcher walks *whole files* and carries leftover patches
  across batches (the reference's stateful generator).  Here each step
  samples a fixed-length **random crop** per clip; a crop of
  ``k * patch_size`` frames yields exactly ``k`` patches on the device.
  Class balance per step is the same (equal clips per class); file
  coverage is sampling from shuffled queues rather than exhaustive
  sweeps.
- Labels are **clip-level** and broadcast patch-wise on the device, the
  values the host batcher assigns (every patch of a file carries the
  file's class and SMR labels there too).
- Per-featuregram row standardization runs on the device over the crop's
  frames rather than the whole file's (a crop-local mean and std).
"""

from __future__ import annotations

import os

import numpy as np

from ..ops.mixing import mix_signals_np
from .audio import load_and_preprocess_signal
from .batcher import FOLD_KEY, FileQueue, class_streams, mtl_labels
from .featurize import FeatureConfig, mixture_cache_name


def crop_samples(n_patches: int, patch_size: int, cfg: FeatureConfig,
                 patch_shift: int | None = None) -> int:
    """Samples for exactly ``n_patches`` windows of ``patch_size`` frames
    at stride ``patch_shift`` (center=False framing: T frames need
    (T-1)*hop + win samples)."""
    shift = patch_size if patch_shift is None else patch_shift
    frames = (n_patches - 1) * shift + patch_size
    return (frames - 1) * cfg.hop_length + cfg.win_length


class AudioCache:
    """Preprocessed-audio cache (the audio-domain analog of the
    featuregram cache): ``load_and_preprocess_signal`` (+ SMR mixing for
    mixture classes) computed once per (class, file[, partner, SMR]) and
    stored as float32 ``.npy``; reads are ``mmap`` so a random crop only
    touches its own pages."""

    def __init__(self, cache_dir: str | None = None, Tw: int = 25,
                 Ts: int = 10, max_open: int = 512):
        self.cache_dir = cache_dir
        self.Tw, self.Ts = Tw, Ts
        self._mem: dict[str, np.ndarray] = {}
        # Open-memmap LRU: np.load(mmap_mode) costs ~0.3 ms in open+header
        # parse — at 12 clips/step that alone would dwarf the device step.
        self._open: "dict[str, np.ndarray]" = {}
        self._max_open = max_open

    def _compute(self, classname: str, sp_path, mu_path, smr):
        if classname in ("speech_music", "speech_noise"):
            sp, _ = load_and_preprocess_signal(sp_path, self.Tw, self.Ts)
            mu, _ = load_and_preprocess_signal(mu_path, self.Tw, self.Ts)
            return mix_signals_np(sp, mu, smr).astype(np.float32)
        path = sp_path or mu_path
        audio, _ = load_and_preprocess_signal(path, self.Tw, self.Ts)
        return audio.astype(np.float32)

    def get(self, classname: str, sp_path=None, mu_path=None, smr=None
            ) -> np.ndarray:
        key = f"{classname}/{mixture_cache_name(sp_path, mu_path, smr)}"
        if self.cache_dir is None:
            if key not in self._mem:
                self._mem[key] = self._compute(classname, sp_path, mu_path,
                                               smr)
            return self._mem[key]
        npy = os.path.join(self.cache_dir, key + ".npy")
        mm = self._open.get(npy)
        if mm is not None:
            return mm
        if not os.path.exists(npy):
            os.makedirs(os.path.dirname(npy), exist_ok=True)
            audio = self._compute(classname, sp_path, mu_path, smr)
            tmp = npy + f".tmp{os.getpid()}.npy"
            np.save(tmp, audio)
            os.replace(tmp, npy)
        mm = np.load(npy, mmap_mode="r")
        if len(self._open) >= self._max_open:
            self._open.pop(next(iter(self._open)))
        self._open[npy] = mm
        return mm


class AudioCropBatcher:
    """Infinite iterator of ``(audio (n_classes*c, L), clip labels)``.

    ``c = clips_per_class``; ``L = crop_samples(n_patches_per_clip,
    patch_size, cfg)``.  Per-step patch budget per class is
    ``c * n_patches_per_clip`` (pick them so it equals the host
    batcher's ``batch_size``).  Labels are the host batcher's
    (``batcher.mtl_labels``), one row per clip.
    """

    def __init__(self, cache: AudioCache, folder: str, file_list: dict,
                 cfg: FeatureConfig, *, clips_per_class: int,
                 n_patches_per_clip: int, patch_size: int,
                 patch_shift: int | None = None, seed: int = 0,
                 min_crop_s: float = 0.0):
        self.cache = cache
        self.folder = folder
        self.cfg = cfg
        self.c = clips_per_class
        # min_crop_s floors the crop length: the device step standardizes
        # over the WHOLE crop but trains only on the first
        # n_patches_per_clip windows (endtoend.device_featurize_patches
        # max_patches) — longer crops give stabler crop-local stats on
        # non-stationary real audio without reducing clips per step.
        self.L = max(crop_samples(n_patches_per_clip, patch_size, cfg,
                                  patch_shift=patch_shift),
                     int(min_crop_s * cfg.sr))
        self.rng = np.random.default_rng(seed)
        self.order = class_streams(file_list)
        self.queues = {cls: FileQueue(file_list[FOLD_KEY[cls]], self.rng)
                       for cls in self.order}
        self._exists: dict[str, bool] = {}

    def _path_ok(self, path: str) -> bool:
        # Memoized positives only: os.path.exists is a syscall per clip
        # per STEP on the hot path, and present corpus files don't vanish
        # mid-run — but absent ones may appear later (cache warm-up,
        # late mount), so misses are re-checked.
        if path in self._exists:
            return True
        ok = os.path.exists(path)
        if ok:
            self._exists[path] = True
        return ok

    # -- clip sampling ------------------------------------------------------

    def _clip_audio(self, classname: str, item):
        if classname in ("speech_music", "speech_noise"):
            partner = "music" if classname == "speech_music" else "noise"
            sp = os.path.join(self.folder, "speech", item["speech"])
            mu = os.path.join(self.folder, partner, item[partner])
            if not (self._path_ok(sp) and self._path_ok(mu)):
                return None, None
            audio = self.cache.get(classname, sp, mu, item["SMR"])
            db = float(item["SMR"])
        else:
            sub = "speech" if classname == "speech" else classname
            path = os.path.join(self.folder, sub, item)
            if not self._path_ok(path):
                return None, None
            kw = ({"sp_path": path} if classname == "speech"
                  else {"mu_path": path})
            audio = self.cache.get(classname, **kw)
            db = None
        return audio, db

    def _crop_into(self, out: np.ndarray, audio: np.ndarray) -> None:
        """Write one random crop into ``out`` (one copy, straight from
        the mmap; no intermediate materialization)."""
        n = audio.shape[0]
        if n >= self.L:
            start = int(self.rng.integers(0, n - self.L + 1))
            out[:] = audio[start:start + self.L]
            return
        # Short clip: wrap-tile (the patching wrap rule, tools.pyx:29-38),
        # rotated to a random phase — a fixed phase would make every crop
        # of a short clip identical (no crop augmentation), which
        # silently collapses training when ``min_crop_s`` exceeds the
        # corpus clip length (observed: 0.82 -> 0.44 accuracy).
        off = int(self.rng.integers(0, n))
        pos = 0
        while pos < self.L:
            m = min(n - off, self.L - pos)
            out[pos:pos + m] = audio[off:off + m]
            pos += m
            off = 0 if off + m >= n else off + m

    def __iter__(self):
        return self

    def __next__(self):
        batch = np.empty((len(self.order) * self.c, self.L), np.float32)
        row, dbs = 0, []
        for cls in self.order:
            got, cls_dbs = 0, []
            misses = 0
            max_misses = 4 * max(len(self.queues[cls].items), 1)
            while got < self.c:
                if misses >= max_misses:
                    raise FileNotFoundError(
                        f"class '{cls}': no readable audio after "
                        f"{misses} attempts — corpus files missing under "
                        f"{self.folder}")
                audio, db = self._clip_audio(cls, self.queues[cls].next_item())
                if audio is None:
                    misses += 1
                    continue
                self._crop_into(batch[row], audio)
                row += 1
                cls_dbs.append(np.nan if db is None else db)
                got += 1
            dbs.append(np.asarray(cls_dbs))
        return batch, mtl_labels(self.c, dbs)

"""The device training pipeline: raw audio -> features -> model in one
step on the card (counterpart of ``sm_hpss_mtl_tpu/train/endtoend.py``).

The host streams raw-audio crops (``data.audiostream``); each train or
eval step featurizes them on the device (``ops.featuregram``: on CUDA the
fused STFT + HPSS kernel over the whole ``(B, L)`` batch in one launch, K1
for the Mel-HPSS families, K2 for the full-resolution ones), standardizes
each HPSS component's rows over the crop (or scales the frames by the
fold's corpus statistics), cuts the patches and runs the model.  The
features carry no gradient: the audio needs none, so the kernels have no
backward.

Batch convention: ``audio (B, n_samples)`` with per-clip labels (a dict of
heads, or the one-hot classes of a single-task model); every clip yields
the same number of patches ``k``, which take their clip's labels.  The
intermediate-fusion model's patches are a dict of its two inputs
(``input_kind='dual'``).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..data.featurize import FeatureConfig
from ..ops import featuregram as fg
from ..ops.patches import extract_patches, standardize_rows
from ..ops.stats import skewness_vectors
from .state import make_eval_step, make_train_step


def device_featurize_patches(audio: torch.Tensor, cfg: FeatureConfig, *,
                             patch_size: int, patch_shift: int,
                             input_kind: str = "time_mel",
                             skewness_vector: str | None = None,
                             fold_stats=None,
                             max_patches: int | None = None
                             ) -> torch.Tensor | dict[str, torch.Tensor]:
    """``(B, n) audio -> (B*k, ...) model-ready patches`` on the audio's
    device.

    Rows are standardized per featuregram (per HPSS component for the
    HarmPerc families) over all the crop's frames, unless ``fold_stats =
    (mean, stdev)`` is given: the corpus frame-level scaling
    ``(fv - mean) / (stdev + 1e-10)`` then replaces it, as in the host
    batcher.  ``max_patches`` keeps the first ``k`` windows of each clip.
    Patch ``j`` of clip ``b`` is row ``j*B + b``.  ``skewness_vector``
    ('Row' or 'Col') replaces each patch by its skewness vector, as the
    host batcher does.  ``input_kind='dual'`` (the intermediate-fusion
    model) returns ``{"harm_input", "perc_input"}``: the time-major
    patches' harmonic and percussive halves."""
    if input_kind not in ("time_mel", "image", "dual"):
        raise ValueError(f"unknown input_kind {input_kind!r}")
    fv = fg.featuregram(audio, feat_name=cfg.feat_name, sr=cfg.sr,
                        n_fft=cfg.n_fft, win_length=cfg.win_length,
                        hop_length=cfg.hop_length, n_mels=cfg.n_mels,
                        l_harm=cfg.l_harm, l_perc=cfg.l_perc,
                        dft_precision=cfg.dft_precision)      # (B, D, T)
    if fold_stats is not None:
        mean, stdev = (torch.as_tensor(a, dtype=torch.float32,
                                       device=fv.device) for a in fold_stats)
        fv = (fv - mean[:, None]) / (stdev[:, None] + 1e-10)
    elif "HarmPerc" in cfg.feat_name:
        half = fv.shape[1] // 2
        fv = torch.cat([standardize_rows(fv[:, :half]),
                        standardize_rows(fv[:, half:])], dim=1)
    else:
        fv = standardize_rows(fv)
    patches = extract_patches(fv, patch_size=patch_size,
                              patch_shift=patch_shift)        # (k, B, D, W)
    if max_patches is not None:
        patches = patches[:max_patches]
    patches = patches.reshape((-1,) + patches.shape[2:])
    if skewness_vector:
        patches = skewness_vectors(patches, skewness_vector)
    if input_kind == "dual":
        half = patches.shape[1] // 2
        return {"harm_input": patches[:, :half].transpose(1, 2).contiguous(),
                "perc_input": patches[:, half:].transpose(1, 2).contiguous()}
    if input_kind == "time_mel":
        return patches.transpose(1, 2).contiguous()
    return patches[..., None]


def _broadcast_labels(labels, k: int):
    """Per-clip labels (a dict of heads, or one tensor) -> per-patch, in
    :func:`device_featurize_patches`'s ``(k, B)`` order: clip ``b``'s
    labels at rows ``j*B + b``."""
    def tile(y):
        return y.repeat((k,) + (1,) * (y.ndim - 1))
    if isinstance(labels, dict):
        return {key: tile(y) for key, y in labels.items()}
    return tile(labels)


def _featurizer(cfg: FeatureConfig, **patch_kw) -> Callable:
    def featurize(audio: torch.Tensor, labels):
        batch = device_featurize_patches(audio, cfg, **patch_kw)
        rows = next(iter(batch.values())) if isinstance(batch, dict) else batch
        return batch, _broadcast_labels(labels, rows.shape[0]
                                        // audio.shape[0])
    return featurize


def make_audio_train_step(model, optimizer, cfg: FeatureConfig, *,
                          patch_size: int, patch_shift: int,
                          generator: torch.Generator,
                          input_kind: str = "time_mel", mtl: bool = True,
                          skewness_vector: str | None = None,
                          fold_stats=None,
                          loss_weights: dict | None = None,
                          l2_reg: float = 0.0,
                          augment_noise: bool = False,
                          n_patches_per_clip: int | None = None
                          ) -> Callable:
    """``(state, audio (B, n), clip_labels) -> metrics``: featurization,
    the forward and backward passes and the optimizer update
    (``train.state.make_train_step`` after the device featurizer)."""
    featurize = _featurizer(cfg, patch_size=patch_size,
                            patch_shift=patch_shift, input_kind=input_kind,
                            skewness_vector=skewness_vector,
                            fold_stats=fold_stats,
                            max_patches=n_patches_per_clip)
    return make_train_step(model, optimizer, mtl=mtl, generator=generator,
                           loss_weights=loss_weights, l2_reg=l2_reg,
                           augment_noise=augment_noise, featurize=featurize)


def make_audio_eval_step(model, cfg: FeatureConfig, *, patch_size: int,
                         patch_shift: int, input_kind: str = "time_mel",
                         mtl: bool = True,
                         skewness_vector: str | None = None,
                         fold_stats=None,
                         loss_weights: dict | None = None,
                         n_patches_per_clip: int | None = None) -> Callable:
    """``(state, audio, clip_labels) -> metrics``, the eval analog of
    :func:`make_audio_train_step` (keys of ``train.state.make_eval_step``)."""
    featurize = _featurizer(cfg, patch_size=patch_size,
                            patch_shift=patch_shift, input_kind=input_kind,
                            skewness_vector=skewness_vector,
                            fold_stats=fold_stats,
                            max_patches=n_patches_per_clip)
    return make_eval_step(model, mtl=mtl, loss_weights=loss_weights,
                          featurize=featurize)

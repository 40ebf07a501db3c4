"""Model presets and the experiment configuration (counterpart of
``sm_hpss_mtl_tpu/train/config.py``).

``MODEL_PRESETS`` holds the feature settings each model of the zoo is
trained and served with: the JAX table, and the port's own, served only:
``Whisper_MTL`` (Whisper large-v3's STFT geometry at 128 bands) and
``Granite_Hybrid_MTL`` (the same features).
``n_mels = -1`` marks a full-resolution feature family; the mel-scale
layer of Jang's models is then built with 120 bands, as the JAX CLI
does.  :class:`ExperimentConfig`
has the JAX fields and defaults, which are the reference's values (Tw 25
ms, Ts 10 ms, W 68, batch 16 per class, 3 folds, 50 epochs, SMR levels
-5..20 dB, the TR/V/TS step counts derived from the corpus duration), but
for ``dft_precision``: the port defaults to ``'highest'`` where the JAX
package defaults to ``'bf16x3'``; ``dft_precision='bf16x3'`` (``cli.mtl
--dft-precision bf16x3``) gives the JAX package's default computation.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

from ..data.featurize import FeatureConfig

MODEL_PRESETS = {
    "Lemaire_et_al": dict(feat_name="LogMelSpec", n_fft=400, n_mels=120),
    "Lemaire_et_al_MTL": dict(feat_name="LogMelHarmPercSpec", n_fft=400,
                              n_mels=120),
    "Lemaire_et_al_Cascaded_MTL": dict(feat_name="LogMelHarmSpec", n_fft=400,
                                       n_mels=120),
    "Lemaire_et_al_MTL_5class": dict(feat_name="LogMelHarmPercSpec",
                                     n_fft=400, n_mels=120),
    "Lemaire_et_al_MTL_IF": dict(feat_name="LogMelHarmPercSpec", n_fft=400,
                                 n_mels=120),
    "Doukhan_et_al": dict(feat_name="MelSpec", n_fft=400, n_mels=21),
    "Doukhan_et_al_MTL": dict(feat_name="MelHarmPercSpec", n_fft=400,
                              n_mels=120),
    "Papakostas_et_al": dict(feat_name="Spec", n_fft=400, n_mels=-1),
    "Papakostas_et_al_MTL": dict(feat_name="HarmPercSpec", n_fft=400,
                                 n_mels=-1),
    "Jang_et_al": dict(feat_name="LogSpec", n_fft=512, n_mels=-1),
    "Jang_et_al_MTL": dict(feat_name="LogHarmPercSpec", n_fft=512, n_mels=-1),
    "Whisper_MTL": dict(feat_name="LogMelHarmPercSpec", n_fft=400, n_mels=128),
    "Granite_Hybrid_MTL": dict(feat_name="LogMelHarmPercSpec", n_fft=400,
                               n_mels=128),
}

#: Models (name prefixes) that take time-major ``(B, T, D)`` patches,
#: 'time_mel'; the others take ``(B, D, T, 1)`` images, 'image'.
TIME_MAJOR_MODELS = ("Lemaire_et_al",)
#: Models (name prefixes) that label every position of a whole context,
#: ``(B, D, L)``, 'sequence'.
SEQUENCE_MODELS = ("Whisper",)
#: Models (name prefixes) that read a stream causally, chunk by chunk,
#: carrying their state from one chunk to the next, 'stream'.
STREAM_MODELS = ("Granite",)
#: The input kinds of the port's served-only models.
SERVED_KINDS = ("sequence", "stream")


def input_kind_of(model: str) -> str:
    """A model's input layout, as the JAX ``ModelSpec`` names the patch
    layouts ('time_mel', 'image'), or 'sequence' or 'stream'."""
    if model.startswith(SEQUENCE_MODELS):
        return "sequence"
    if model.startswith(STREAM_MODELS):
        return "stream"
    return "time_mel" if model.startswith(TIME_MAJOR_MODELS) else "image"


def preset_n_mels(preset: dict) -> int:
    """The preset's mel count, 120 where it is -1."""
    return preset["n_mels"] if preset["n_mels"] > 0 else 120


@dataclass(frozen=True)
class ExperimentConfig:
    model: str = "Lemaire_et_al_MTL"
    data_root: str = ""
    feature_dir: str = ""
    output_dir: str = "./results"
    cv_folds: int = 3
    epochs: int = 50
    batch_size: int = 16
    n_classes: int = 3
    patch_size: int = 68          # W; 249 for the 2.5 s variant
    patch_shift: int = 68         # W_shift (training)
    test_patch_shift: int = 68    # the reference hard-codes 68 at test time
    Tw: int = 25
    Ts: int = 10
    l_harm: int = 21
    l_perc: int = 11
    test_smr_levels: tuple = (-5, 0, 5, 10, 15, 20)
    loss_weights: dict | None = None
    augment_noise: bool = True
    frame_level_scaling: bool = False
    skewness_vector: str | None = None
    dropout_rate: float = 0.275
    #: override the preset mel count; None = preset value
    n_mels_override: int | None = None
    #: override the preset featName; None = preset value
    feat_name_override: str | None = None
    #: architecture overrides for the Lemaire family
    arch_kwargs: dict | None = None
    #: Keras kernel_regularizer=l2() strength on head/mel-kernel weights
    l2_reg: float = 0.01
    #: parallel host pipelines feeding the training stream
    prefetch_workers: int = 2
    #: 'auto' (device pipeline on CUDA, host on the CPU), 'host' or 'device'
    pipeline: str = "auto"
    #: device pipeline: patches per sampled clip crop; 0 = adaptive
    #: (``cli.experiment.resolve_clip_patches``)
    clip_patches: int = 0
    #: device pipeline: floor on the crop length in seconds
    min_crop_s: float = 0.0
    #: 'float32' (reference parity) or 'bfloat16' (mixed precision)
    compute_dtype: str = "float32"
    #: fused-frontend DFT precision: 'highest' (the port's default) or
    #: 'bf16x3' (the JAX package's default)
    dft_precision: str = "highest"
    seed: int = 0
    # Derived step counts (0 = compute from durations).
    tr_steps: int = 0
    v_steps: int = 0
    ts_steps: int = 0
    #: cap on the generator evaluation's TS steps; 0 = uncapped
    max_eval_steps: int = 200
    #: horizon of the Lemaire SGD decay (0 = tr_steps)
    lr_schedule_steps: int = 0

    @property
    def feat_name(self) -> str:
        return (self.feat_name_override
                or MODEL_PRESETS[self.model]["feat_name"])

    @property
    def input_kind(self) -> str:
        return input_kind_of(self.model)

    def feature_config(self) -> FeatureConfig:
        preset = MODEL_PRESETS[self.model]
        n_mels = (self.n_mels_override if self.n_mels_override is not None
                  else preset["n_mels"])
        return FeatureConfig(
            feat_name=self.feat_name, n_fft=preset["n_fft"],
            win_length=int(self.Tw * 16000 / 1000),
            hop_length=int(self.Ts * 16000 / 1000),
            n_mels=n_mels, l_harm=self.l_harm, l_perc=self.l_perc,
            Tw=self.Tw, Ts=self.Ts, dft_precision=self.dft_precision)

    def with_steps_from_durations(self, total_duration_hours: dict
                                  ) -> "ExperimentConfig":
        """The reference's TR/V/TS step derivation from the corpus
        duration per class (hours)."""
        dt_ms = sum(total_duration_hours.values()) * 3600 * 1000
        tr_frac = ((self.cv_folds - 1) / self.cv_folds) * 0.7
        vl_frac = ((self.cv_folds - 1) / self.cv_folds) * 0.3
        ts_frac = 1 / self.cv_folds
        shift_ms = self.patch_shift * self.Ts
        denom = self.n_classes * self.batch_size
        n = math.floor(dt_ms / shift_ms)
        return replace(self,
                       tr_steps=int(n * tr_frac / denom),
                       v_steps=int(n * vl_frac / denom),
                       ts_steps=int(n * ts_frac / denom))

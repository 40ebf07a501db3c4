"""Model presets (counterpart of ``MODEL_PRESETS`` in
``sm_hpss_mtl_tpu/train/config.py``): the feature settings each model is
trained and served with, for the ported models.  ``n_mels = -1`` marks a
full-resolution feature family; the mel-scale layer of Jang's models is
then built with 120 bands, as the JAX CLI does."""

from __future__ import annotations

MODEL_PRESETS = {
    "Lemaire_et_al_MTL": dict(feat_name="LogMelHarmPercSpec", n_fft=400,
                              n_mels=120),
    "Jang_et_al": dict(feat_name="LogSpec", n_fft=512, n_mels=-1),
    "Jang_et_al_MTL": dict(feat_name="LogHarmPercSpec", n_fft=512, n_mels=-1),
}


def preset_n_mels(preset: dict) -> int:
    """The preset's mel count, 120 where it is -1."""
    return preset["n_mels"] if preset["n_mels"] > 0 else 120

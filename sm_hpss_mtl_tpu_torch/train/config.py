"""Model presets (counterpart of ``MODEL_PRESETS`` in
``sm_hpss_mtl_tpu/train/config.py``): the feature settings each model is
trained and served with.  Only the paper's proposed model is ported."""

from __future__ import annotations

MODEL_PRESETS = {
    "Lemaire_et_al_MTL": dict(feat_name="LogMelHarmPercSpec", n_fft=400,
                              n_mels=120),
}

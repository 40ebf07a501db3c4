"""Model registry (counterpart of ``sm_hpss_mtl_tpu/models/zoo.py``).
Only the paper's proposed model, ``Lemaire_et_al_MTL``, is ported."""

from __future__ import annotations

import torch

from ..ops.featuregram import feature_dim
from ..train.config import MODEL_PRESETS
from .lemaire import LemaireMTL


def get_model(name: str, *, n_classes: int = 3, n_mels: int = 120,
              patch_size: int = 68, dropout_rate: float = 0.275
              ) -> LemaireMTL:
    """Build a model by its reference name, sized for its preset's
    features (``D = 2 * n_mels`` for LogMelHarmPercSpec)."""
    if name != "Lemaire_et_al_MTL":
        raise ValueError(f"model {name!r} is not ported")
    # The reference computes in float32 (train/config.py compute_dtype).
    # cuDNN convolutions default to TF32 on the GPU, which keeps ~3 decimal
    # digits, so both TF32 switches are turned off where a model is built.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    in_dim = feature_dim(MODEL_PRESETS[name]["feat_name"], n_mels=n_mels)
    return LemaireMTL(in_dim, patch_size=patch_size, n_classes=n_classes,
                      dropout_rate=dropout_rate)

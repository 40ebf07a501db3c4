"""Model registry (counterpart of ``sm_hpss_mtl_tpu/models/zoo.py``).
Ported: the paper's proposed model ``Lemaire_et_al_MTL`` and Jang's
mel-scale CNN, ``Jang_et_al`` and ``Jang_et_al_MTL``."""

from __future__ import annotations

import torch
from torch import nn

from ..ops.featuregram import feature_dim
from ..train.config import MODEL_PRESETS, input_kind_of, preset_n_mels
from ..weights import from_flax, load_npz
from .jang import JangCNN
from .lemaire import LemaireMTL

#: ``input_kind`` of each ported model (``train.config.input_kind_of``).
INPUT_KIND = {name: input_kind_of(name) for name in
              ("Lemaire_et_al_MTL", "Jang_et_al", "Jang_et_al_MTL")}

#: Windows per model call for 'image' models: a whole 10000-window chunk
#: of Jang-MTL holds ~21 GB in its first conv block alone (~2 MB a window).
IMAGE_BATCH_WINDOWS = 1024


def get_model(name: str, *, n_classes: int = 3, n_mels: int = 120,
              patch_size: int = 68, dropout_rate: float = 0.275,
              **arch_kwargs) -> nn.Module:
    """Build a model by its reference name.  Lemaire-MTL is sized for its
    preset's features (``D = 2 * n_mels`` for LogMelHarmPercSpec); for
    Jang-MTL ``n_mels`` is the mel-scale layer's band count (the JAX zoo
    builds the single-task Jang model with 64 bands whatever it is
    given).  ``arch_kwargs`` (Lemaire-MTL only, as in the JAX zoo):
    ``n_filters``, ``nb_stacks``, ``kernel_size``, ``Nd``, ``head_width``."""
    if name not in INPUT_KIND:
        raise ValueError(f"model {name!r} is not ported")
    if arch_kwargs and not name.startswith("Lemaire"):
        raise ValueError(f"arch_kwargs not supported for {name!r}")
    # The reference computes in float32 (train/config.py compute_dtype).
    # cuDNN convolutions default to TF32 on the GPU, which keeps ~3 decimal
    # digits, so both TF32 switches are turned off where a model is built.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if name == "Jang_et_al":
        return JangCNN(n_classes=n_classes, n_mels=64, patch_size=patch_size)
    if name == "Jang_et_al_MTL":
        return JangCNN(n_classes=n_classes, mtl=True, n_mels=n_mels,
                       patch_size=patch_size)
    in_dim = feature_dim(MODEL_PRESETS[name]["feat_name"], n_mels=n_mels)
    return LemaireMTL(in_dim, patch_size=patch_size, n_classes=n_classes,
                      dropout_rate=dropout_rate, **arch_kwargs)


def load_model(weights: str, device: torch.device, model: str,
               patch_size: int = 68) -> nn.Module:
    """The named model, sized by its preset, in eval mode on ``device``
    with weights from an npz (flax keys)."""
    net = get_model(model, n_mels=preset_n_mels(MODEL_PRESETS[model]),
                    patch_size=patch_size)
    net.load_state_dict(from_flax(load_npz(weights)))
    return net.to(device).eval()

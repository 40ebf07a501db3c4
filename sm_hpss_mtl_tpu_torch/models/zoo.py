"""Model registry (counterpart of ``sm_hpss_mtl_tpu/models/zoo.py``): every
model of the JAX zoo.  Lemaire's TCN models (single-task, MTL, Cascaded-MTL,
the 5-class MTL with the noise head, and the intermediate-fusion twin
towers), and the image family: Doukhan's and Papakostas's CNNs and Jang's
mel-scale CNN, each single-task and MTL."""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..ops.featuregram import feature_dim
from ..train.config import MODEL_PRESETS, input_kind_of, preset_n_mels
from ..weights import from_flax, load_npz
from .cnn import DoukhanCNN, PapakostasCNN
from .jang import JangCNN
from .lemaire import LemaireMTL, LemaireMTLIntermediateFusion, LemaireTCN

#: ``mtl`` of each model: MTL heads, or one softmax output.
MTL = {"Lemaire_et_al": False, "Lemaire_et_al_MTL": True,
       "Lemaire_et_al_Cascaded_MTL": True, "Lemaire_et_al_MTL_5class": True,
       "Lemaire_et_al_MTL_IF": True,
       "Doukhan_et_al": False, "Doukhan_et_al_MTL": True,
       "Papakostas_et_al": False, "Papakostas_et_al_MTL": True,
       "Jang_et_al": False, "Jang_et_al_MTL": True}

#: ``input_kind`` of each model, as the JAX ``ModelSpec`` has it: the
#: patch layout of ``train.config.input_kind_of``, but 'dual' (a dict of
#: two 'time_mel' inputs) for the intermediate-fusion model.
INPUT_KIND = {name: input_kind_of(name) for name in MTL}
INPUT_KIND["Lemaire_et_al_MTL_IF"] = "dual"

#: The JAX zoo's keyword arguments that the intermediate-fusion model
#: drops: its towers keep the TCN's kernel size and dilations.
IF_DROPPED = ("head_width", "head_layers", "kernel_size", "Nd",
              "use_skip_connections")

#: Windows per model call for 'image' models: a whole 10000-window chunk
#: of Jang-MTL holds ~21 GB in its first conv block alone (~2 MB a window).
IMAGE_BATCH_WINDOWS = 1024


@dataclass(frozen=True)
class ModelSpec:
    """A built model with what the runner needs to feed it: its patch
    layout ('time_mel', 'image' or 'dual') and whether it has MTL heads
    (JAX's ``ModelSpec`` without the head names)."""
    module: nn.Module
    input_kind: str
    mtl: bool


def get_model(name: str, *, n_classes: int = 3, n_mels: int | None = None,
              patch_size: int = 68, dropout_rate: float = 0.275,
              in_dim: int | None = None, **arch_kwargs) -> nn.Module:
    """Build a model by its reference name, sized for ``patch_size``-frame
    patches of ``in_dim`` feature rows (default: its preset's features at
    ``n_mels`` bands, by default the preset's, 120 where that is -1; flax
    infers both from the data; the intermediate-fusion model's towers take
    half the rows each).  ``Lemaire_et_al_MTL_5class`` has 5 classes
    whatever ``n_classes`` says, as in the JAX zoo.  For Jang-MTL
    ``n_mels`` is the mel-scale layer's band count (the JAX zoo builds the
    single-task Jang model with 64 bands whatever it is given), and the
    rows are its n_fft's.  ``arch_kwargs`` (the Lemaire family only, as in
    the JAX zoo): ``n_filters``, ``nb_stacks``, ``kernel_size``, ``Nd``,
    ``head_width``, ``head_layers`` (MTL); the intermediate-fusion model
    drops all but ``n_filters`` and ``nb_stacks``."""
    if name not in MTL:
        raise ValueError(f"unknown model {name!r}")
    if arch_kwargs and not name.startswith("Lemaire"):
        raise ValueError(f"arch_kwargs not supported for {name!r}")
    # The reference computes in float32 (train/config.py compute_dtype).
    # cuDNN convolutions default to TF32 on the GPU, which keeps ~3 decimal
    # digits, so both TF32 switches are turned off where a model is built.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    preset = MODEL_PRESETS[name]
    if n_mels is None:
        n_mels = preset_n_mels(preset)
    if name.startswith("Jang"):
        return JangCNN(n_classes=n_classes, mtl=MTL[name],
                       n_mels=n_mels if MTL[name] else 64,
                       patch_size=patch_size)
    if in_dim is None:
        in_dim = feature_dim(preset["feat_name"], n_fft=preset["n_fft"],
                             n_mels=n_mels)
    cnn = {"Doukhan": DoukhanCNN, "Papakostas": PapakostasCNN}.get(
        name.split("_")[0])
    if cnn is not None:
        return cnn(in_dim, patch_size=patch_size, n_classes=n_classes,
                   mtl=MTL[name])
    if name == "Lemaire_et_al_MTL_IF":
        kw = {k: v for k, v in arch_kwargs.items() if k not in IF_DROPPED}
        return LemaireMTLIntermediateFusion(
            in_dim // 2, patch_size=patch_size, n_classes=n_classes,
            dropout_rate=dropout_rate, **kw)
    if MTL[name]:
        variant = {"Lemaire_et_al_Cascaded_MTL": dict(cascaded=True),
                   "Lemaire_et_al_MTL_5class": dict(with_noise=True,
                                                    n_classes=5)}
        kw = {"n_classes": n_classes, **variant.get(name, {})}
        return LemaireMTL(in_dim, patch_size=patch_size,
                          dropout_rate=dropout_rate, **kw, **arch_kwargs)
    arch_kwargs.pop("head_width", None)
    return LemaireTCN(in_dim, patch_size=patch_size, n_classes=n_classes,
                      dropout_rate=dropout_rate, **arch_kwargs)


def get_spec(name: str, **kwargs) -> ModelSpec:
    """:func:`get_model` with the model's input kind and ``mtl``."""
    return ModelSpec(get_model(name, **kwargs), INPUT_KIND[name], MTL[name])


def load_model(weights: str, device: torch.device, model: str,
               patch_size: int = 68) -> nn.Module:
    """The named model, sized by its preset, in eval mode on ``device``
    with weights from an npz (flax keys)."""
    net = get_model(model, patch_size=patch_size)
    net.load_state_dict(from_flax(load_npz(weights)))
    return net.to(device).eval()

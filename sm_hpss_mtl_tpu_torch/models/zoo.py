"""Model registry (counterpart of ``sm_hpss_mtl_tpu/models/zoo.py``): every
model of the JAX zoo.  Lemaire's TCN models (single-task, MTL, Cascaded-MTL,
the 5-class MTL with the noise head, and the intermediate-fusion twin
towers), and the image family: Doukhan's and Papakostas's CNNs and Jang's
mel-scale CNN, each single-task and MTL.  Beside them the port's own
``Whisper_MTL`` (``models/whisper.py``): Whisper large-v3's encoder with
the MTL heads at every position, a 'sequence' model that labels 30-s
contexts; and ``Granite_Hybrid_MTL`` (``models/granite.py``, imported
only where it is built): Granite-4.0-H-Micro's hybrid Mamba-2 / attention
trunk with the heads at every position, a 'stream' model that reads a
broadcast causally, chunk by chunk, its state carried between calls.  Both
are served (``cli.segment``), not trained."""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..ops.featuregram import feature_dim
from ..train.config import (MODEL_PRESETS, SERVED_KINDS, input_kind_of,
                            preset_n_mels)
from ..weights import load_state_npz
from .cnn import DoukhanCNN, PapakostasCNN
from .jang import JangCNN
from .lemaire import LemaireMTL, LemaireMTLIntermediateFusion, LemaireTCN
from .whisper import WhisperMTL

#: ``mtl`` of each model: MTL heads, or one softmax output.
MTL = {"Lemaire_et_al": False, "Lemaire_et_al_MTL": True,
       "Lemaire_et_al_Cascaded_MTL": True, "Lemaire_et_al_MTL_5class": True,
       "Lemaire_et_al_MTL_IF": True,
       "Doukhan_et_al": False, "Doukhan_et_al_MTL": True,
       "Papakostas_et_al": False, "Papakostas_et_al_MTL": True,
       "Jang_et_al": False, "Jang_et_al_MTL": True,
       "Whisper_MTL": True, "Granite_Hybrid_MTL": True}

#: ``input_kind`` of each model, as the JAX ``ModelSpec`` has it: the
#: layout of ``train.config.input_kind_of`` ('sequence' for Whisper-MTL,
#: 'stream' for Granite-Hybrid-MTL), but 'dual' (a dict of two 'time_mel'
#: inputs) for the intermediate-fusion model.
INPUT_KIND = {name: input_kind_of(name) for name in MTL}
INPUT_KIND["Lemaire_et_al_MTL_IF"] = "dual"

#: The JAX zoo's keyword arguments that the intermediate-fusion model
#: drops: its towers keep the TCN's kernel size and dilations.
IF_DROPPED = ("head_width", "head_layers", "kernel_size", "Nd",
              "use_skip_connections")

#: Windows per model call for 'image' models: a whole 10000-window chunk
#: of Jang-MTL holds ~21 GB in its first conv block alone (~2 MB a window).
IMAGE_BATCH_WINDOWS = 1024

#: 30-s contexts per model call for 'sequence' models: 8 are 4 minutes of
#: audio; Whisper-large's widest activation (its MLP) is then 245 MB.
SEQUENCE_BATCH_CONTEXTS = 8


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
              in_dim: int | None = None, dtype: torch.dtype | None = None,
              **arch_kwargs) -> nn.Module:
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
    ``use_skip_connections``, ``head_width``, ``head_layers`` (MTL); the
    intermediate-fusion model drops all but ``n_filters`` and
    ``nb_stacks``.  ``Whisper_MTL`` takes its own, large-v3's by default
    (``d_model``, ``encoder_layers``, ``encoder_attention_heads``,
    ``encoder_ffn_dim``, ``max_source_positions``, ``head_width``),
    ignores ``patch_size`` and ``dropout_rate`` (it takes whole contexts;
    its heads keep their 0.4) and computes in float32 only;
    ``Granite_Hybrid_MTL`` likewise (granite-4.0-h-micro's by default:
    ``hidden_size``, ``layer_types``, ``num_attention_heads``,
    ``num_key_value_heads``, ``mamba_n_heads``, ``mamba_d_head``,
    ``mamba_d_state``, ``shared_intermediate_size``, ``head_width``, ...).
    ``dtype=torch.bfloat16``: mixed-precision compute with float32
    parameters and outputs, layer by layer as flax's ``dtype=``
    (``models.layers``); None (default) computes in float32."""
    if name not in MTL:
        raise ValueError(f"unknown model {name!r}")
    served = INPUT_KIND[name] in SERVED_KINDS
    if arch_kwargs and not (name.startswith("Lemaire") or served):
        raise ValueError(f"arch_kwargs not supported for {name!r}")
    # The float32 layers compute in float32 in either mode (a bfloat16 model
    # keeps its BatchNorms, output layers and Jang's mel-scale layers in
    # float32, as flax does).  cuDNN convolutions default to TF32 on the
    # GPU, which keeps ~3 decimal digits, so both TF32 switches are turned
    # off where a model is built.  A bfloat16 layer's products accumulate in
    # float32 as XLA's do: cuBLAS may otherwise reduce split-K partial sums
    # in bfloat16.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    preset = MODEL_PRESETS[name]
    if n_mels is None:
        n_mels = preset_n_mels(preset)
    if name.startswith("Jang"):
        return JangCNN(n_classes=n_classes, mtl=MTL[name],
                       n_mels=n_mels if MTL[name] else 64,
                       patch_size=patch_size, dtype=dtype)
    if in_dim is None:
        in_dim = feature_dim(preset["feat_name"], n_fft=preset["n_fft"],
                             n_mels=n_mels)
    if served:
        if dtype not in (None, torch.float32):
            raise ValueError(f"{name} computes in float32 only, got {dtype}")
        if INPUT_KIND[name] == "stream":
            # Imported here: no other model's build loads it or its kernel.
            from .granite import GraniteHybridMTL
            return GraniteHybridMTL(in_dim, n_classes=n_classes,
                                    **arch_kwargs)
        return WhisperMTL(in_dim, n_classes=n_classes, **arch_kwargs)
    cnn = {"Doukhan": DoukhanCNN, "Papakostas": PapakostasCNN}.get(
        name.split("_")[0])
    if cnn is not None:
        return cnn(in_dim, patch_size=patch_size, n_classes=n_classes,
                   mtl=MTL[name], dtype=dtype)
    if name == "Lemaire_et_al_MTL_IF":
        kw = {k: v for k, v in arch_kwargs.items() if k not in IF_DROPPED}
        return LemaireMTLIntermediateFusion(
            in_dim // 2, patch_size=patch_size, n_classes=n_classes,
            dropout_rate=dropout_rate, dtype=dtype, **kw)
    if MTL[name]:
        variant = {"Lemaire_et_al_Cascaded_MTL": dict(cascaded=True),
                   "Lemaire_et_al_MTL_5class": dict(with_noise=True,
                                                    n_classes=5)}
        kw = {"n_classes": n_classes, **variant.get(name, {})}
        return LemaireMTL(in_dim, patch_size=patch_size,
                          dropout_rate=dropout_rate, dtype=dtype, **kw,
                          **arch_kwargs)
    arch_kwargs.pop("head_width", None)
    return LemaireTCN(in_dim, patch_size=patch_size, n_classes=n_classes,
                      dropout_rate=dropout_rate, dtype=dtype, **arch_kwargs)


def get_spec(name: str, **kwargs) -> ModelSpec:
    """:func:`get_model` with the model's input kind and ``mtl``."""
    return ModelSpec(get_model(name, **kwargs), INPUT_KIND[name], MTL[name])


def load_model(weights: str, device: torch.device, model: str,
               patch_size: int = 68) -> nn.Module:
    """The named model, sized by its preset, in eval mode on ``device``
    with weights from an npz of either layout (``weights.load_state_npz``):
    flax keys, or a ``state_dict``'s own, as a model with no flax
    counterpart (Whisper-MTL) is stored.  Serving computes in float32."""
    net = get_model(model, patch_size=patch_size)
    net.load_state_dict(load_state_npz(weights))
    return net.to(device).eval()

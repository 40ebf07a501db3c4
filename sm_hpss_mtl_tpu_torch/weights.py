"""Model weights between the flax variable tree and a torch state_dict.

The JAX package checkpoints ``{"params": ..., "batch_stats": ...}`` flax
trees with orbax (``train/checkpoint.py``).  The port cannot read orbax, so
its checkpoint is an ``.npz`` whose keys are the flat ``/``-joined flax
paths (``params/tcn/initial_conv/kernel``,
``batch_stats/heads/S_block/bn/mean``, ...).  The port's submodules carry
the flax names, so a path maps to a state_dict key by its module path and
a leaf rename:

===============================  ======================  ==========================
flax leaf                        torch key               layout
===============================  ======================  ==========================
params/.../kernel (Conv, 2-D)    ....weight              (kh,kw,in,out) -> (out,in,kh,kw)
params/.../kernel (Conv, 1-D)    ....weight              (W,in,out) -> (out,in,W)
params/.../kernel (Dense)        ....weight              (in,out) -> (out,in)
params/melCl*/kernel             melCl*.kernel           kept (Jang's mel-scale layer)
params/.../bias                  ....bias
params/<bn>/scale                <bn>.weight
batch_stats/<bn>/mean            <bn>.running_mean
batch_stats/<bn>/var             <bn>.running_var
===============================  ======================  ==========================

A kernel is mapped by its module: the mel-scale layers (``melCl``,
``melCl_H``, ``melCl_P``) own a 4-D ``kernel`` that is no convolution
kernel and keeps its layout under the same name; every other kernel is a
convolution's or a dense layer's ``weight``.  A BatchNorm is any module
with running statistics, whatever its name (``bn``, Jang's ``fc1_bn``).
The image models (``models/jang.py``, ``models/cnn.py``) flatten their
activations in flax's NHWC order before the first dense layer, so that
layer's kernel maps like any other dense kernel.

A model with no flax counterpart (Whisper-MTL) is stored by the port
alone, as an ``.npz`` of its ``state_dict``: the
torch keys (``conv1.weight``, ``layers.0.self_attn.q_proj.weight``,
``heads.S_block.bn.running_mean``, ...) with the torch layouts
(``Conv1d`` ``(out, in, k)``, ``Linear`` ``(out, in)``), float32, and the
BatchNorms' ``num_batches_tracked`` as int64 (:func:`save_state_npz`).
:func:`load_state_npz` reads either layout, told apart by the keys.
"""

from __future__ import annotations

import numpy as np
import torch

_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}
#: Modules whose ``kernel`` keeps its flax layout and name.
_KEPT_KERNELS = ("melCl", "melCl_H", "melCl_P")
#: flax kernel -> torch weight, by number of dimensions (Dense, Conv1D,
#: Conv2D), and back.
_TO_TORCH = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}
_TO_FLAX = {2: (1, 0), 3: (2, 1, 0), 4: (2, 3, 1, 0)}


def _flatten(tree: dict, prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(_flatten(v, prefix + (k,)))
        else:
            flat[prefix + (k,)] = np.asarray(v)
    return flat


def from_flax(variables: dict) -> dict[str, torch.Tensor]:
    """Flax ``{"params", "batch_stats"}`` tree of arrays -> state_dict."""
    state = {}
    for path, arr in _flatten(variables).items():
        collection, mod, leaf = path[0], ".".join(path[1:-1]), path[-1]
        if collection == "params":
            if leaf == "kernel":
                if path[-2] not in _KEPT_KERNELS:
                    arr = arr.transpose(_TO_TORCH[arr.ndim])
                    leaf = "weight"
            elif leaf == "scale":
                leaf = "weight"
            elif leaf != "bias":
                raise KeyError(f"unknown parameter {'/'.join(path)}")
        elif collection == "batch_stats":
            if leaf not in _STAT_NAMES:
                raise KeyError(f"unknown statistic {'/'.join(path)}")
            leaf = _STAT_NAMES[leaf]
            state[f"{mod}.num_batches_tracked"] = torch.tensor(0)
        else:
            raise KeyError(f"unknown collection {collection!r}")
        state[f"{mod}.{leaf}"] = torch.from_numpy(
            np.array(arr, dtype=np.float32, order="C"))
    return state


def to_flax(state_dict: dict[str, torch.Tensor]) -> dict:
    """state_dict -> flax ``{"params", "batch_stats"}`` tree (numpy)."""
    tree: dict = {}
    stat_leaves = {v: k for k, v in _STAT_NAMES.items()}
    bn_modules = {k.rsplit(".", 1)[0] for k in state_dict
                  if k.endswith(".running_mean")}
    for key, t in state_dict.items():
        *mod, leaf = key.split(".")
        if leaf == "num_batches_tracked":
            continue
        arr = t.detach().cpu().numpy().astype(np.float32)
        if leaf in stat_leaves:
            collection, leaf = "batch_stats", stat_leaves[leaf]
        else:
            collection = "params"
            if leaf == "weight" and ".".join(mod) in bn_modules:
                leaf = "scale"
            elif leaf == "weight":
                arr = arr.transpose(_TO_FLAX[arr.ndim])
                leaf = "kernel"
        node = tree.setdefault(collection, {})
        for m in mod:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(arr)
    return tree


def save_npz(path: str, variables: dict) -> None:
    """Write a flax variable tree as an ``.npz`` of ``/``-joined keys."""
    np.savez(path, **{"/".join(k): v
                      for k, v in _flatten(variables).items()})


def load_npz(path: str) -> dict:
    """Read an ``.npz`` written by :func:`save_npz` back into a tree."""
    with np.load(path, allow_pickle=False) as z:
        return _unflatten(z)


def _unflatten(z) -> dict:
    tree: dict = {}
    for key in z.files:
        *mods, leaf = key.split("/")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = z[key]
    return tree


def save_state_npz(path: str, state_dict: dict[str, torch.Tensor]) -> None:
    """Write a ``state_dict`` as an ``.npz`` under its own keys."""
    np.savez(path, **{k: v.detach().cpu().numpy()
                      for k, v in state_dict.items()})


def load_state_npz(path: str) -> dict[str, torch.Tensor]:
    """A ``state_dict`` from an ``.npz`` of either layout: flax's
    ``/``-joined keys (:func:`save_npz`) through :func:`from_flax`, or a
    ``state_dict``'s own (:func:`save_state_npz`), which hold no ``/``."""
    with np.load(path, allow_pickle=False) as z:
        if any("/" in k for k in z.files):
            return from_flax(_unflatten(z))
        return {k: torch.from_numpy(z[k]) for k in z.files}

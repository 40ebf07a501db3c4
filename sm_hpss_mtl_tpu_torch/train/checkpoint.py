"""Training checkpoints as ``.npz`` (counterpart of
``sm_hpss_mtl_tpu/train/checkpoint.py``, which writes orbax).

A checkpoint directory holds ``state/model.npz`` (the flax variable tree of
``weights.to_flax``, which ``weights.load_npz`` and the serving entry
points read), ``state/optimizer.npz`` (the optimizer's per-parameter state,
such as momentum buffers and step counts, keyed ``<index>/<name>``, and the
train step as ``step``) and ``metadata.json`` (``epoch``, ``val_loss``,
and the runner's ``completed`` and ``epochs_run`` stamps).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..weights import from_flax, load_npz, save_npz, to_flax
from .state import TrainState


def _state_dir(path: str) -> str:
    return os.path.join(os.path.abspath(path), "state")


def model_npz(path: str) -> str:
    """The model's ``.npz`` (flax keys) in the checkpoint at ``path``."""
    return os.path.join(_state_dir(path), "model.npz")


def save_checkpoint(path: str, state: TrainState,
                    metadata: dict | None = None) -> None:
    out = _state_dir(path)
    os.makedirs(out, exist_ok=True)
    save_npz(model_npz(path), to_flax(state.module.state_dict()))
    opt = {"step": np.asarray(state.step)}
    for idx, entries in state.optimizer.state_dict()["state"].items():
        for name, value in entries.items():
            opt[f"{idx}/{name}"] = (value.detach().cpu().numpy()
                                    if torch.is_tensor(value)
                                    else np.asarray(value))
    np.savez(os.path.join(out, "optimizer.npz"), **opt)
    if metadata is not None:
        with open(os.path.join(path, "metadata.json"), "w") as f:
            json.dump(metadata, f, indent=2, default=str)


def restore_checkpoint(path: str, template: TrainState
                       ) -> tuple[TrainState, dict]:
    """Load a checkpoint into ``template``'s model and optimizer (in
    place); returns the state and the metadata."""
    out = _state_dir(path)
    template.module.load_state_dict(
        from_flax(load_npz(model_npz(path))))
    saved: dict = {}
    with np.load(os.path.join(out, "optimizer.npz")) as z:
        step = int(z["step"])
        for key in z.files:
            if key != "step":
                idx, name = key.split("/", 1)
                saved.setdefault(int(idx), {})[name] = torch.from_numpy(
                    z[key])
    opt_state = template.optimizer.state_dict()
    opt_state["state"] = saved
    template.optimizer.load_state_dict(opt_state)
    meta = {}
    meta_path = os.path.join(path, "metadata.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return TrainState(template.module, template.optimizer, step), meta


def checkpoint_exists(path: str) -> bool:
    return os.path.exists(model_npz(path))


def update_metadata(path: str, fields: dict) -> None:
    """Merge ``fields`` into the checkpoint's ``metadata.json`` (the runner
    stamps ``completed`` and ``epochs_run`` after training, so that a
    resume tells a finished fold from one whose process died)."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    meta_path = os.path.join(path, "metadata.json")
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    meta.update(fields)
    with open(meta_path, "w") as f:
        json.dump(meta, f, indent=2, default=str)

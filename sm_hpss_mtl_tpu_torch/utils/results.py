"""Result and configuration CSV writers (counterpart of
``sm_hpss_mtl_tpu/utils/results.py``, the reference's ``lib/misc.py``):
the same files and columns as the JAX package writes."""

from __future__ import annotations

import json
import os
from dataclasses import asdict, is_dataclass

from torch import nn


def append_results(op_dir: str, fold: int, res: dict,
                   suffix: str = "") -> str:
    """Append one fold's row to the tab-separated ``Performance.csv`` (or
    ``Performance_<suffix>.csv``), writing the header with the first row."""
    os.makedirs(op_dir, exist_ok=True)
    name = f"Performance_{suffix}.csv" if suffix else "Performance.csv"
    path = os.path.join(op_dir, name)
    new_file = not os.path.exists(path) or os.path.getsize(path) == 0
    heading = "fold" + "".join(f"\t{k}" for k in res)
    values = str(fold) + "".join(f"\t{v}" for v in res.values())
    with open(path, "a", encoding="utf-8") as f:
        if new_file:
            f.write(heading + "\n")
        f.write(values + "\n")
    return path


def dump_configuration(op_dir: str, config) -> str:
    """Append ``key<TAB>json value`` rows of a config to
    ``Configuration.csv``."""
    os.makedirs(op_dir, exist_ok=True)
    path = os.path.join(op_dir, "Configuration.csv")
    items = asdict(config) if is_dataclass(config) else dict(config)
    with open(path, "a", encoding="utf-8") as f:
        for k, v in items.items():
            try:
                f.write(f"{k}\t{json.dumps(v)}\n")
            except TypeError:
                f.write(f"{k}\tERROR\n")
    return path


def dump_model_summary(path: str, module: nn.Module) -> str:
    """Write the module's structure and its parameter counts (the
    reference's ``print_model_summary``)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n_train = sum(p.numel() for p in module.parameters() if p.requires_grad)
    n_all = sum(p.numel() for p in module.parameters())
    n_buffers = sum(b.numel() for b in module.buffers())
    with open(path, "w", encoding="utf-8") as f:
        f.write(f"{module}\n\nTrainable params: {n_train}\n"
                f"Non-trainable params: {n_all - n_train}\n"
                f"Buffers (BatchNorm statistics): {n_buffers}\n")
    return path

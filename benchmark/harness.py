"""What every cell's run shares: finding a cell's files by name, the
seeded weights, the benchmark's own spans, the card, and the result.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``)
and a traffic mix (``mixes/<name>.json``).  The mix names the kind of run
it is (``kinds/<kind>.py``), the configuration the family whose
FLOPs it has (``flops/<family>.py``); the limits of the cell's output
check are ``limits/<cell>.json``, and each per-layer metric is read by
``metrics/<metric>.py``.  Adding any of them adds files and entries only.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import time
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
#: Top-level modules no run may hold once its window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "sm_hpss_mtl_tpu")
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def check_name(name: str) -> str:
    if not isinstance(name, str) or not _NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files."""
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: list
    bench_dir: Path = BENCH_DIR


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: dict | None = None,
              bench_dir: Path = BENCH_DIR) -> Cell:
    """The workload ``name`` of ``bench`` (default: the repository's
    ``BENCHMARK.json``) and its files under ``bench_dir``."""
    bench = bench if bench is not None else read_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = read_json(bench_dir / "configs"
                       / f"{check_name(entry['config'])}.json")
    mix = read_json(bench_dir / "mixes" / f"{check_name(entry['traffic'])}.json")
    limits = read_json(bench_dir / "limits" / f"{check_name(name)}.json")
    return Cell(name=name, chips=int(entry["chips"]), config=config, mix=mix,
                limits=limits,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
                bench_dir=bench_dir)


def load_kind(cell: Cell):
    return importlib.import_module(
        f"benchmark.kinds.{check_name(cell.mix['kind'])}")


def load_flops(cell: Cell):
    return importlib.import_module(
        f"benchmark.flops.{check_name(cell.config['family'])}")


def load_reader(cell: Cell, metric: str):
    """``metrics/<metric>.py`` of the cell's benchmark folder, whose
    ``read(run)`` returns the metric or None where it finds nothing."""
    path = cell.bench_dir / "metrics" / f"{check_name(metric)}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def process_start() -> float:
    """When this process started, on ``time.time()``'s clock (Linux: its
    start tick against the uptime; elsewhere the import of this module)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.time()


def configure_process() -> None:
    """Before torch is imported: keep the kernel caches a run may fill
    inside the checkout, at fixed paths (the port's own nvcc and g++
    builds already go to ``build/torch_kernels`` and ``build/torch_native``
    there), keep ``transformers``, should anything load it, from loading
    flax, and give the host's library thread pools (OpenMP, MKL,
    OpenBLAS, and so torch's intra-op pool) one thread each.  The
    program computes on the card; idle pool threads that spin after a
    host copy take cores from the thread that launches its kernels, and
    the training cells spread about half again as widely with the pools
    at their defaults.  The program's own threads are not touched."""
    cache = ROOT / "build" / "bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    for pool in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                 "OPENBLAS_NUM_THREADS"):
        os.environ[pool] = "1"


def card() -> dict:
    """The card's name and power limit (``nvidia-smi``; None where it is
    not there)."""
    import torch
    out = {"name": torch.cuda.get_device_name(0), "power_limit_w": None}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True)
        out["power_limit_w"] = float(smi.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        pass
    return out


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    """The process's peak of allocated device memory (0 off the card)."""
    import torch
    if torch.device(device).type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# Seeded weights


def seeded_weights(module, seed: int, device, cfg: dict) -> dict:
    """A value for every entry of ``module.state_dict()``, made on
    ``device`` from ``seed`` in one draw, returned on the host: Glorot-
    uniform kernels, biases and BatchNorm shifts and running means uniform
    in +-0.05, BatchNorm scales and running variances in [0.9, 1.1], and
    whatever the configuration's reference family makes of a leaf itself
    (its ``init_leaf``: Jang-MTL's mel-scale kernels)."""
    import torch

    from .reference import models
    own = getattr(models.family(cfg), "init_leaf", None)
    shapes = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    sizes = {k: int(torch.Size(s).numel()) for k, s in shapes.items()}
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(sum(sizes.values()), generator=gen, device=device)
    out, pos = {}, 0
    for name, shape in shapes.items():
        v = u[pos:pos + sizes[name]].view(shape)
        pos += sizes[name]
        if name.endswith("num_batches_tracked"):
            out[name] = torch.zeros(shape, dtype=torch.long)
            continue
        w = own(name, v, cfg) if own is not None else None
        out[name] = (w if w is not None else _default_leaf(name, v)).cpu()
    return out


def _default_leaf(name: str, v):
    """A leaf's seeded value from uniform draws ``v`` of its shape."""
    leaf, shape = name.rsplit(".", 1)[-1], tuple(v.shape)
    if leaf in ("bias", "running_mean"):
        return 0.05 * (2 * v - 1)
    if leaf == "running_var" or len(shape) == 1:
        return 0.9 + 0.2 * v
    rec = 1
    for n in shape[2:]:
        rec *= n
    bound = (6.0 / (shape[1] * rec + shape[0] * rec)) ** 0.5
    return bound * (2 * v - 1)


# ---------------------------------------------------------------------------
# Spans and the run's record


class Spans:
    """The benchmark's host-clock spans around its calls into the program.
    In a traced run each is also a ``bench.<name>`` profiler annotation,
    and a span given ``sync=True`` ends in a synchronise."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.records: dict[str, list] = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str, sync: bool = False):
        import torch
        note = (torch.profiler.record_function("bench." + name)
                if self.traced else contextlib.nullcontext())
        with note:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if sync and self.traced:
                    torch.cuda.synchronize()
                self.records[name].append((t0, time.perf_counter()))

    def total(self, name: str) -> float:
        return sum(b - a for a, b in self.records.get(name, ()))


class Phases:
    """Host seconds of each part of set-up, for the run's standard error."""

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self._t = time.perf_counter()

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self._t
        self._t = now


@dataclass
class Run:
    """What a kind's run hands back: the end-to-end metrics, the numbers its
    output check compared, and what the per-layer readers read."""
    cell: Cell
    card: dict
    e2e: dict = field(default_factory=dict)
    readings: dict = field(default_factory=dict)
    faults: list = field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    window_s: float = 0.0
    window_start: float = 0.0
    memory_peak_bytes: int = 0
    counters: dict = field(default_factory=dict)
    spans: Spans | None = None
    trace: object = None
    setup: Phases = field(default_factory=Phases)


def compare(readings: dict, limits: dict) -> list[dict]:
    """Each compared number beside its limit, in the limits' order."""
    out = []
    for name, lim in limits.items():
        value = readings.get(name)
        out.append({"name": name, "value": value, "limit": lim["limit"],
                    "ok": value is not None and value <= lim["limit"]})
    return out

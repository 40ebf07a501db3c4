"""Arithmetic the per-layer metrics share; each ``metrics/<name>.py``
binds one of these to its name.  A reader returns None where the run has
nothing for it to read, and the metric is then left out of the line."""

from __future__ import annotations

from . import counts, harness
from .reference.frontend import mel_filterbank


def _frontend(cfg: dict):
    """(n_fft, comparators, n_mels, mel_nnz) of the configuration."""
    f = cfg["features"]
    n_mels = f.get("n_mels") or 0
    nnz = int((mel_filterbank(f["mel_sr"], f["n_fft"], n_mels) > 0).sum()) \
        if n_mels else 0
    return f["n_fft"], cfg["median_comparators"], n_mels, nnz


def frontend_flops(cfg: dict, frames: int, items: int = 1) -> float:
    n_fft, comp, _, nnz = _frontend(cfg)
    return counts.frontend_flops(frames, n_fft, comp, nnz, items)


def frontend_bound_s(run: harness.Run, frames: int, samples: int,
                     items: int = 1) -> float:
    n_fft, comp, n_mels, nnz = _frontend(run.cell.config)
    return counts.frontend_bound_s(frames, samples, n_fft, comp,
                                   run.card["name"], n_mels, nnz, items)


def idle_share(run: harness.Run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def span_share(run: harness.Run, parts: tuple, minus: tuple = (),
               of: str | None = None):
    """The spans ``parts`` less ``minus``, as a share of the spans ``of``
    (default: the window)."""
    s = run.spans
    if s is None or not any(s.records.get(p) for p in parts):
        return None
    whole = s.total(of) if of else run.window_s
    if whole <= 0:
        return None
    return 100.0 * (sum(s.total(p) for p in parts)
                    - sum(s.total(m) for m in minus)) / whole


def train_mfu(run: harness.Run):
    c = run.counters
    if not c.get("steps") or run.window_s <= 0:
        return None
    f = run.cell.config["features"]
    fwd = harness.load_flops(run.cell).forward_flops(run.cell.config)
    frames = 1 + (c["crop_samples"] - f["n_fft"]) // f["hop_length"]
    per_step = (3 * fwd * c["patches_per_step"]
                + frontend_flops(run.cell.config, frames, c["clips"]))
    peak = counts.f32_peak(run.card["name"])
    return 100.0 * c["steps"] * per_step / (run.window_s * peak)


def train_frontend_roofline(run: harness.Run):
    t, c = run.trace, run.counters
    if t is None:
        return None
    seconds, launches = t.kernels(run.cell.config["frontend_kernel"])
    if not launches:
        return None
    f = run.cell.config["features"]
    frames = 1 + (c["crop_samples"] - f["n_fft"]) // f["hop_length"]
    bound = frontend_bound_s(run, frames, c["crop_samples"], c["clips"])
    return 100.0 * bound / (seconds / launches)


def segment_mfu(run: harness.Run):
    reqs = run.counters.get("requests")
    if not reqs or run.window_s <= 0:
        return None
    fwd = harness.load_flops(run.cell).forward_flops(run.cell.config)
    work = sum(fwd * r["windows"] + frontend_flops(run.cell.config,
                                                   r["frames"])
               for r in reqs)
    return 100.0 * work / (run.window_s * counts.f32_peak(run.card["name"]))


def segment_frontend_roofline(run: harness.Run):
    t = run.trace
    reqs = [r for r in run.counters.get("requests", ()) if r["traced"]]
    if t is None or not reqs or not t.span_device_s.get("featurize"):
        return None
    bound = sum(frontend_bound_s(run, r["frames"], r["n_samples"])
                for r in reqs)
    return 100.0 * bound / t.span_device_s["featurize"]

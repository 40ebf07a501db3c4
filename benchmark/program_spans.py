"""Arithmetic of the per-layer metrics that read the program's own spans
(``sm_hpss_mtl_tpu_torch.utils.profiling``), which the program records
while the traced run's profiler records; each ``metrics/<name>.py`` binds
one of these to its name.  A reader takes the records that start at or
after the window's start, divides by the traced window, and returns None
where the run has no trace, the program no such span (a program without
the store has none), or the store dropped records."""

from __future__ import annotations

from sm_hpss_mtl_tpu_torch.utils import profiling


def records(run, name: str):
    """The program's spans ``name`` of the traced window, or None."""
    spans = getattr(profiling, "spans", None)
    dropped = getattr(profiling, "dropped", None)
    t = run.trace
    if spans is None or dropped is None or t is None or t.window_s <= 0 \
            or dropped():
        return None
    start = int(run.window_start * 1e9)
    out = [r for r in spans() if r.name == name and r.start_ns >= start]
    return out or None


def seconds(recs) -> float:
    return sum(r.end_ns - r.start_ns for r in recs) / 1e9


def share(run, name: str):
    """Host time inside the spans ``name``, as a share of the traced
    window (%)."""
    recs = records(run, name)
    if recs is None:
        return None
    return 100.0 * seconds(recs) / run.trace.window_s


def ops_per_step(run):
    """Device operations in the trace (kernels, copies and sets) over the
    ``train.forward`` spans, one a step."""
    recs = records(run, "train.forward")
    if recs is None:
        return None
    return sum(n for _, n in run.trace.by_name.values()) / len(recs)


def read_rate(run):
    """Audio seconds read (``audio.read``'s samples over the
    configuration's sample rate) per second inside ``audio.read``."""
    recs = records(run, "audio.read")
    if recs is None or any(r.n is None for r in recs):
        return None
    s = seconds(recs)
    if s <= 0:
        return None
    return sum(r.n for r in recs) / run.cell.config["features"]["sr"] / s

"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over CPU and
CUDA activity, reduced to what the per-layer metrics and the breakdown
read.

- ``busy_s``: the union of the intervals in which a device operation
  (kernel, copy or set) ran; ``window_s``: the host's clock over the
  profiled part, which starts and ends in a synchronise.
- ``device_ops``: device time by operation name.
- ``idle_gaps``: the gaps between device operations, each named by what
  the host was doing at its middle (the innermost ``bench.*`` span and the
  top-level host operation running then), summed by name.
- ``span_device_s``: device time of the kernels launched from inside
  each ``bench.*`` span (by the launch's correlation id and thread;
  copies and sets are not kernels).

Operation names are cut to ``NAME_CHARS`` characters in the breakdown.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np
import torch

NAME_CHARS = 160
#: Host events that are the runtime or the profiler, not the program's work.
_NOT_WORK = ("cuda", "cu", "Activity Buffer", "Runtime Triggered",
             "Lazy Function", "bench.")


@dataclass
class TraceSummary:
    busy_s: float
    window_s: float
    device_ops: list
    idle_gaps: list
    by_name: dict = field(default_factory=dict)      # name -> [s, count]
    span_device_s: dict = field(default_factory=dict)

    def kernels(self, pattern: str) -> tuple[float, int]:
        """Device seconds and launches of operations whose name holds
        ``pattern``."""
        s = n = 0
        for name, (t, c) in self.by_name.items():
            if pattern in name:
                s, n = s + t, n + c
        return s, n


class Profiler:
    """Start and stop ``torch.profiler`` around part of a window."""

    def __init__(self):
        self.prof = None
        self.summary: TraceSummary | None = None

    @property
    def active(self) -> bool:
        return self.prof is not None

    @staticmethod
    def _profile():
        return torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])

    def prime(self) -> None:
        """Profile one small operation, so that the tracer's one-time
        start-up happens in set-up and not inside the window."""
        with self._profile():
            torch.ones(8, device="cuda").sum().item()

    def start(self) -> None:
        torch.cuda.synchronize()
        self.prof = self._profile()
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        torch.cuda.synchronize()
        window = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        events = self.prof.profiler.kineto_results.events()
        self.prof = None
        self.summary = reduce_events(events, window)


def _merge(iv: np.ndarray) -> np.ndarray:
    """Union of ``(start, end)`` rows, sorted."""
    if not len(iv):
        return iv
    iv = iv[np.argsort(iv[:, 0])]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out)


def _covering(starts, ends, names, t, depth=32):
    """The latest-starting interval of a start-sorted list that covers
    ``t``, or None."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - depth, -1), -1):
        if ends[j] >= t:
            return names[j]
    return None


def _top_level(ops: list) -> list:
    """Per thread, the host operations not nested in another."""
    out = []
    by_tid = defaultdict(list)
    for op in ops:
        by_tid[op[3]].append(op)
    for rows in by_tid.values():
        rows.sort(key=lambda r: (r[0], -r[1]))
        end = -1
        for r in rows:
            if r[0] >= end:
                out.append(r)
                end = r[1]
    out.sort(key=lambda r: r[0])
    return out


def reduce_events(events, window_s: float, top: int = 10) -> TraceSummary:
    dev, host, spans, launches = [], [], [], {}
    for e in events:
        name = e.name()
        start = e.start_ns()
        end = start + e.duration_ns()
        if str(e.device_type()).endswith("CUDA"):
            if not (e.is_user_annotation() or name.startswith("bench.")):
                dev.append((start, end, name, e.correlation_id()))
            continue
        tid = e.start_thread_id()
        if name.startswith("bench."):
            spans.append((start, end, name[len("bench."):], tid))
        elif name.startswith("cu"):
            launches[e.correlation_id()] = (start, tid)
        elif not name.startswith(_NOT_WORK):
            host.append((start, end, name, tid))

    by_name: dict = defaultdict(lambda: [0.0, 0])
    for s, e, name, _ in dev:
        by_name[name][0] += (e - s) / 1e9
        by_name[name][1] += 1
    busy = _merge(np.asarray([(s, e) for s, e, _, _ in dev], dtype=np.int64)
                  .reshape(-1, 2))
    busy_s = float((busy[:, 1] - busy[:, 0]).sum()) / 1e9 if len(busy) else 0.0

    # Device time launched from inside each benchmark span.
    span_iv = defaultdict(list)
    for s, e, name, tid in spans:
        span_iv[(name, tid)].append((s, e))
    for iv in span_iv.values():
        iv.sort()
    span_device_s: dict = defaultdict(float)
    for s, e, name, corr in dev:
        launch = launches.get(corr)
        if launch is None or name.startswith(("Memcpy", "Memset")):
            continue
        for (span, tid), iv in span_iv.items():
            if tid != launch[1]:
                continue
            i = bisect.bisect_right(iv, (launch[0], float("inf"))) - 1
            if i >= 0 and iv[i][0] <= launch[0] <= iv[i][1]:
                span_device_s[span] += (e - s) / 1e9

    # Idle gaps, named by the innermost span and the top-level host op.
    spans.sort(key=lambda r: r[0])
    sp_s = [r[0] for r in spans]
    sp_e = [r[1] for r in spans]
    sp_n = [r[2] for r in spans]
    tops = _top_level(host)
    op_s = [r[0] for r in tops]
    op_e = [r[1] for r in tops]
    op_n = [r[2] for r in tops]
    gaps: dict = defaultdict(float)
    for (s0, e0), (s1, _) in zip(busy[:-1], busy[1:]):
        mid = (e0 + s1) / 2
        span = _covering(sp_s, sp_e, sp_n, mid) or "-"
        op = _covering(op_s, op_e, op_n, mid) or "python"
        gaps[f"{span} / {op}"] += (s1 - e0) / 1e9

    def ranked(d):
        return [[k[:NAME_CHARS], v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return TraceSummary(
        busy_s=busy_s, window_s=window_s,
        device_ops=ranked({k: v[0] for k, v in by_name.items()}),
        idle_gaps=ranked(gaps), by_name=dict(by_name),
        span_device_s=dict(span_device_s))

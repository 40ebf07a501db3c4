"""Tracing and profiling helpers (counterpart of
``sm_hpss_mtl_tpu/utils/profiling.py``).

The reference records only coarse ``time.process_time()`` spans; the same
wall and process timing is kept here (:func:`stage_timer`, the JAX
function), and :func:`device_trace` captures a ``torch.profiler`` trace
(host activity, and the GPU's kernels on a CUDA run) as a Chrome trace in
place of ``jax.profiler``'s XProf trace.

The program's own spans and counters:

- :func:`span` marks a part of the work at a layer boundary (the train
  step's phases, the prefetched stream's wait, the segmenter's chunks, the
  audio read).  A span is recorded only while the calling thread's
  ``torch.profiler`` session is recording (:func:`device_trace`, or any
  other ``torch.profiler.profile``): it is then also a
  ``record_function`` annotation of the same name, so it names that part
  of the trace, and its record goes to an in-memory store that
  :func:`spans` reads.  Otherwise a span costs one check of the
  profiler's state.  Records are on the profiler's clock (the Unix epoch,
  in ns), so they line up with the trace's events.
- :func:`request` groups the spans of one unit of work (a train step, a
  segmented broadcast) under one id; it annotates nothing.
- :func:`count` and :func:`counters` keep named counts (the K1–K4, TCN
  block and conv block kernel launches: ``conv_block.launches`` and
  ``conv_block.launches_by_pool.<same|valid>``, three a Jang model call
  at inference on CUDA) under one lock, at all times; :func:`counted`
  also hands the counts one thread adds inside it to that thread (what a
  CUDA graph's capture launched, which its replays count again), and
  :func:`counting` names that dict, so that a backward pass counts into
  it from autograd's thread.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import deque
from typing import NamedTuple

import torch

_trace_ids = itertools.count()
#: Whether this thread's ``torch.profiler`` session is recording.
_profiling = torch._C._autograd._profiler_enabled
#: The span records the store keeps; past it the oldest go and are counted.
SPAN_CAPACITY = 65536


@contextlib.contextmanager
def stage_timer(name: str, sink: dict | None = None, verbose: bool = True):
    """Time a pipeline stage; record into ``sink[name]`` seconds."""
    t0 = time.perf_counter()
    tp0 = time.process_time()
    try:
        yield
    finally:
        wall = time.perf_counter() - t0
        cpu = time.process_time() - tp0
        if sink is not None:
            sink[name] = {"wall_s": wall, "process_s": cpu}
        if verbose:
            print(f"[timer] {name}: wall {wall:.3f}s process {cpu:.3f}s",
                  flush=True)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the code run inside with ``torch.profiler`` (CPU activity,
    plus CUDA activity where a GPU is present) and write a Chrome trace
    (open with Perfetto or ``chrome://tracing``) into ``log_dir`` as
    ``trace.<pid>.<n>.json``.  Yields the profiler, whose
    ``key_averages()`` hold the same events.  The program's spans are
    recorded inside (:func:`spans`)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace.{os.getpid()}.{next(_trace_ids)}.json"))


# ---------------------------------------------------------------------------
# Spans


class SpanRecord(NamedTuple):
    """One span: its name, its start and end (Unix epoch, ns), the name of
    the program span around it on the same thread (None at the top), its
    request id (None outside a :func:`request`), its work count ``n``
    (samples, windows, frames, clips or rows; None where not given) and
    the native id of its thread."""
    name: str
    start_ns: int
    end_ns: int
    parent: str | None
    request: int | None
    n: int | None
    thread: int


class _Thread(threading.local):
    """Per thread: its native id (read once: on some hosts the call is a
    system call of ~10 µs), the names of the open spans and the open
    request."""

    def __init__(self):
        self.id = threading.get_native_id()
        self.open: list[str] = []
        self.request: int | None = None
        self.counted: dict | None = None


class _Store:
    """The span records, at most ``capacity`` of them, and how many older
    ones were dropped for newer."""

    def __init__(self, capacity: int):
        self.lock = threading.Lock()
        self.records: deque = deque(maxlen=capacity)
        self.dropped = 0

    def add(self, record: SpanRecord) -> None:
        with self.lock:
            if len(self.records) == self.records.maxlen:
                self.dropped += 1
            self.records.append(record)


_thread = _Thread()
_store = _Store(SPAN_CAPACITY)
_request_ids = itertools.count(1)


class _Off:
    """What :func:`span` and :func:`request` hand out while nothing records:
    one shared object that does nothing (a work count set on it is
    dropped)."""
    __slots__ = ()

    n = property(lambda self: None, lambda self, value: None)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "n", "_parent", "_start", "_note")

    def __init__(self, name: str, n: int | None):
        self.name, self.n = name, n

    def __enter__(self):
        t = _thread
        self._parent = t.open[-1] if t.open else None
        t.open.append(self.name)
        self._start = time.time_ns()
        self._note = torch.profiler.record_function(self.name)
        self._note.__enter__()
        return self

    def __exit__(self, *exc):
        self._note.__exit__(*exc)
        end = time.time_ns()
        t = _thread
        t.open.pop()
        _store.add(SpanRecord(self.name, self._start, end, self._parent,
                              t.request, self.n, t.id))
        return False


def span(name: str, n: int | None = None):
    """A context manager around one part of the work: recorded, and a
    ``record_function(name)`` annotation, while this thread's profiler
    records; else a shared object that does nothing.  ``n`` is the work
    done inside; where it is known only at the end, set ``.n`` on what the
    ``with`` statement binds."""
    if not _profiling():
        return _OFF
    return _Span(name, n)


class _Request:
    __slots__ = ("_outer",)

    def __enter__(self):
        t = _thread
        self._outer = t.request
        if t.request is None:
            t.request = next(_request_ids)
        return self

    def __exit__(self, *exc):
        _thread.request = self._outer
        return False


def request():
    """A scope whose spans on this thread share one request id (a request
    opened inside another keeps the outer one's).  Nothing is annotated,
    and nothing is done while the profiler is off."""
    if not _profiling():
        return _OFF
    return _Request()


def spans() -> list[SpanRecord]:
    """A copy of the stored span records, oldest first."""
    with _store.lock:
        return list(_store.records)


def dropped() -> int:
    """Span records dropped for newer ones since the last :func:`reset`."""
    return _store.dropped


def reset() -> None:
    """Empty the span store (the counters are kept)."""
    with _store.lock:
        _store.records.clear()
        _store.dropped = 0


# ---------------------------------------------------------------------------
# Counters

_counts: dict[str, int] = {}
_counts_lock = threading.Lock()


def count(name: str, n: int = 1, sink: dict | None = None) -> None:
    """Add ``n`` to the counter ``name`` (counted at all times; the host
    training pipeline counts from several worker threads).  ``sink``, a
    dict :func:`counted` handed some thread, receives the count too, from
    whatever thread counts (a backward pass, which autograd runs on its
    own thread, into what its forward's thread collects)."""
    with _counts_lock:
        _counts[name] = _counts.get(name, 0) + n
    mine = _thread.counted
    if mine is not None:
        mine[name] = mine.get(name, 0) + n
    if sink is not None and sink is not mine:
        sink[name] = sink.get(name, 0) + n


@contextlib.contextmanager
def counted():
    """Yield a dict that receives, besides the counters, what this thread
    counts inside (other threads' counts stay out of it)."""
    t = _thread
    t.counted = {}
    try:
        yield t.counted
    finally:
        t.counted = None


def counting() -> dict | None:
    """The dict :func:`counted` handed the calling thread, or None outside
    one."""
    return _thread.counted


def counters() -> dict[str, int]:
    """A copy of every counter; a name never counted is absent (0)."""
    with _counts_lock:
        return dict(_counts)

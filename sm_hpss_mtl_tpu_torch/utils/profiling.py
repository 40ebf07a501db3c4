"""Tracing and profiling helpers (counterpart of
``sm_hpss_mtl_tpu/utils/profiling.py``).

The reference records only coarse ``time.process_time()`` spans; the same
wall and process timing is kept here (:func:`stage_timer`, the JAX
function), and :func:`device_trace` captures a ``torch.profiler`` trace
(host activity, and the GPU's kernels on a CUDA run) as a Chrome trace in
place of ``jax.profiler``'s XProf trace.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time

import torch

_trace_ids = itertools.count()


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
    ``key_averages()`` hold the same events."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace.{os.getpid()}.{next(_trace_ids)}.json"))

"""Device timing by chained, differenced applications (counterpart of
``sm_hpss_mtl_tpu/utils/benchmarking.py``).

:func:`time_op` keeps the JAX function's contract: the seconds per
application of a data-dependent ``step(carry) -> carry``, found by running
chains of two lengths and differencing them,
``t_iter = (t(n2) - t(n1)) / (n2 - n1)``, which cancels the chain's fixed
cost.  A chain applies ``step`` ``n`` times and ends in one scalar
reduction over the carry's tensors.  On a CUDA carry each chain runs
between two CUDA events on the current stream and the time is read after
the end event has completed, so the fixed cost is the reduction and the
events; on the CPU the chain is timed with ``perf_counter``.

``stat='min'`` differences the minimum over ``repeats`` of each chain
length; ``stat='median'`` times the two lengths as adjacent pairs and
returns the median of the per-pair differences, which rejects a pair that
straddles a change of the device's clock or of the host's load.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable

import torch


def _leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in _leaves(item)]
    return []


def _chain(step: Callable, carry, n: int) -> torch.Tensor:
    for _ in range(n):
        carry = step(carry)
    return sum(leaf.to(torch.float32).sum() for leaf in _leaves(carry))


def _timed_once(step: Callable, carry, n: int, cuda: bool) -> float:
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        _chain(step, carry, n)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    float(_chain(step, carry, n))
    return time.perf_counter() - t0


def time_op(step: Callable, carry, *, iters: tuple[int, int] = (4, 20),
            repeats: int = 5, stat: str = "min") -> float:
    """Seconds per application of ``step``.

    ``step(carry) -> carry`` must keep a fixed carry structure (a tensor,
    or a tuple, list or dict of tensors) and be data-dependent on its
    input (for HPSS, ``H + P``).  ``stat='min'`` differences the
    min-over-repeats of each chain length; ``stat='median'`` differences
    adjacent (n1, n2) pairs and returns the median (see the module doc).
    """
    if stat not in ("min", "median"):
        raise ValueError(f"stat must be 'min' or 'median', got {stat!r}")
    leaves = _leaves(carry)
    if not leaves:
        raise ValueError("the carry holds no tensor")
    cuda = any(leaf.is_cuda for leaf in leaves)
    n1, n2 = iters
    _timed_once(step, carry, n1, cuda)      # warm both chain lengths
    _timed_once(step, carry, n2, cuda)
    if stat == "median":
        diffs = []
        for _ in range(repeats):
            t1 = _timed_once(step, carry, n1, cuda)
            t2 = _timed_once(step, carry, n2, cuda)
            diffs.append((t2 - t1) / (n2 - n1))
        return max(statistics.median(diffs), 1e-9)
    t1 = min(_timed_once(step, carry, n1, cuda) for _ in range(repeats))
    t2 = min(_timed_once(step, carry, n2, cuda) for _ in range(repeats))
    return max((t2 - t1) / (n2 - n1), 1e-9)

#!/usr/bin/env python3
"""Generate the shared-core selection networks of ``csrc/median.cuh``.

    python3 tools/median_networks.py

K consecutive outputs of a width-W running median read W + K - 1 inputs
``x[0 .. W+K-2]``; window j is ``x[j .. j+W-1]``.  All K windows hold the
core ``x[K-1 .. W-1]`` (W - K + 1 values).  With M = (W - 1) / 2, a core
value of rank below M - K + 1 has at most M - 1 values of its window
below it, and one of rank above M at least M + 1, so neither is a median:
each window's median is the median of the core's K middle ranks
``M-K+1 .. M`` and the window's own K - 1 extra inputs, 2K - 1 values
(forgetful selection; exact, ties included).

- ``MedianCore<W, K>`` sorts those K ranks onto core wires ``M-K+1 .. M``:
  Batcher's odd-even mergesort network on W - K + 1 wires, pruned backward
  from those wires (``ops/hpss_pallas.py::median_network`` of the JAX
  package, extended to several output wires).
- ``MedianMerge<K>`` takes the K sorted core values on wires ``0 .. K-1``
  and the K - 1 extras on wires ``K .. 2K-2``: it sorts the extras
  (Batcher, K - 1 wires), then the median of two sorted lists A (K) and B
  (K - 1) is ``min(A[K-1], min over i of max(A[i-1], B[K-1-i]))`` for i in
  1 .. K-1, K - 1 comparators that leave the maxima on the B wires and K - 1
  that gather the minimum on wire K - 1.

- ``Median<L>`` (K1 and K2) is Batcher's network on L wires pruned
  backward from the median wire ``L // 2``
  (``ops/hpss_pallas.py::median_network`` of the JAX package).

Prints the C++ text of the three families for the widths and instances
the kernels use, then the comparators (and the min/max operations whose
result is used) per output of each (W, K) against the single-output
network.
"""

from __future__ import annotations

import sys

#: Median widths of the kernels' (l_harm, l_perc) pairs
#: (``ops/hpss.py::KERNEL_MEDIANS``): the presets' 21 and 11, the narrow 5,
#: and the tuner's grid of 11 to 51 (``cli/tune.py::GRID_RANGES``).
WIDTHS = (5, 11, 21, 31, 41, 51)

#: (W, K) instances of the kernels: 4 frames per thread along time for the
#: harmonic widths, 2 bins per thread along frequency for the percussive.
INSTANCES = ((21, 4), (11, 4), (11, 2), (5, 2), (31, 4), (41, 4), (51, 4),
             (21, 2), (31, 2), (41, 2), (51, 2))


def batcher_pairs(n: int) -> tuple[tuple[int, int], ...]:
    """Batcher odd-even mergesort comparators for ``n`` wires (the JAX
    package's ``hpss_pallas.batcher_pairs``)."""
    pairs = []
    p = 1
    while p < n:
        k = p
        while k >= 1:
            for j in range(k % p, n - k, 2 * k):
                for i in range(0, min(k, n - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return tuple(pairs)


def prune(pairs, targets) -> tuple[tuple[int, int], ...]:
    """The comparators of ``pairs`` that a value on a ``targets`` wire
    depends on."""
    needed = set(targets)
    kept = []
    for i, j in reversed(pairs):
        if i in needed or j in needed:
            kept.append((i, j))
            needed.update((i, j))
    return tuple(reversed(kept))


def live_ops(pairs, targets) -> int:
    """min and max operations of ``pairs`` whose result reaches a target
    wire (a comparator with one needed output costs one)."""
    needed = set(targets)
    ops = 0
    for i, j in reversed(pairs):
        used = (i in needed) + (j in needed)
        if used:
            ops += used
            needed.update((i, j))
    return ops


def median_network(n: int) -> tuple[tuple[int, int], ...]:
    """``Median<n>``: the comparators that place the median on wire
    ``n // 2``."""
    return prune(batcher_pairs(n), [n // 2])


def core_network(w: int, k: int) -> tuple[tuple[int, int], ...]:
    m = (w - 1) // 2
    return prune(batcher_pairs(w - k + 1), range(m - k + 1, m + 1))


def merge_network(k: int) -> tuple[tuple[int, int], ...]:
    extras = tuple((k + i, k + j) for i, j in batcher_pairs(k - 1))
    maxima = tuple((i - 1, k + (k - 1 - i)) for i in range(1, k))
    minima = tuple((k - 1, k + b) for b in range(k - 1))
    return extras + maxima + minima


def per_output(w: int, k: int) -> tuple[float, float]:
    """(comparators, used min/max operations) per output of K outputs."""
    m = (w - 1) // 2
    core = core_network(w, k)
    merge = merge_network(k)
    cmp = len(core) / k + len(merge)
    ops = (live_ops(core, range(m - k + 1, m + 1)) / k
           + live_ops(merge, [k - 1]))
    return cmp, ops


def _cs_lines(pairs, indent: str) -> list[str]:
    items = [f"CS({i},{j});" for i, j in pairs]
    lines, line = [], indent
    for it in items:
        if len(line) + len(it) + 1 > 78:
            lines.append(line.rstrip())
            line = indent
        line += it + " "
    if line.strip():
        lines.append(line.rstrip())
    return lines


def median_text() -> str:
    """The ``Median<L>`` structs of ``csrc/median.cuh``."""
    out = []
    for n in WIDTHS:
        out += ["template <>",
                f"struct Median<{n}> {{",
                "  __device__ __forceinline__ static float run(float* v) {"]
        out += _cs_lines(median_network(n), "    ")
        out += [f"    return v[{n // 2}];", "  }", "};", ""]
    return "\n".join(out)


def header_text() -> str:
    """The ``MedianCore<W, K>`` and ``MedianMerge<K>`` structs of
    ``csrc/median.cuh``."""
    out = []
    for w, k in INSTANCES:
        m = (w - 1) // 2
        out += [f"template <>",
                f"struct MedianCore<{w}, {k}> {{",
                f"  __device__ __forceinline__ static void run(float* v) {{"]
        out += _cs_lines(core_network(w, k), "    ")
        out += ["  }", "};", ""]
    for k in sorted({k for _, k in INSTANCES}):
        out += [f"template <>",
                f"struct MedianMerge<{k}> {{",
                f"  __device__ __forceinline__ static float run(float* v) {{"]
        out += _cs_lines(merge_network(k), "    ")
        out += [f"    return v[{k - 1}];", "  }", "};", ""]
    return "\n".join(out)


def main() -> int:
    print(median_text())
    print(header_text())
    for w, k in INSTANCES:
        cmp, ops = per_output(w, k)
        print(f"// W={w} K={k}: core {len(core_network(w, k))} comparators, "
              f"merge {len(merge_network(k))}; per output {cmp:.2f} "
              f"comparators ({ops:.2f} used min/max) against "
              f"{len(median_network(w))} for Median<{w}>")
    return 0


if __name__ == "__main__":
    sys.exit(main())

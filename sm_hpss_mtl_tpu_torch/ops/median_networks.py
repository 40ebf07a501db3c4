"""Median selection networks of the HPSS kernels, for any odd median pair.

``csrc/median.cuh`` holds the networks of the ten pairs of
``hpss.KERNEL_MEDIANS`` written out by hand (``tools/median_networks.py``
printed them).  Any other odd pair with both widths in ``[MIN_WIDTH,
MAX_WIDTH]`` gets the specialisations the header lacks from
:func:`pair_networks`, which ``_nvcc.build`` writes into the build
directory and hands the compiler as ``HPSS_PAIR_NETWORKS``; the header
includes it.  Three families (the logic of ``tools/median_networks.py``,
copied here so that the package stands alone):

- ``Median<L>`` (K1 and K2, and K3/K4 where a window is too narrow for a
  shared core): Batcher's odd-even mergesort network on L wires pruned
  backward from the median wire ``L // 2`` (the JAX package's
  ``hpss_pallas.median_network``).
- ``MedianCore<W, K>`` (K3 and K4): K consecutive windows of width W share
  a core of W - K + 1 inputs; the network sorts the core's ranks
  ``M-K+1 .. M`` (``M = (W-1)/2``) onto those wires.  It needs
  ``K <= (W+1)/2``; narrower windows take ``Median<W>`` per window
  (``running_medians`` in the header).
- ``MedianMerge<K>``: the median of the K sorted core values and a
  window's K - 1 own inputs.

Nothing here needs a GPU; the CPU tests run every network in numpy.
"""

from __future__ import annotations

import functools
import re

#: The kernels' width range.  K1 computes 64 DFT rows per block and writes
#: ``64 - 2*(l_harm//2)`` output frames, 4 at l_harm 61; each network is
#: unrolled into registers, so the range is also what is built and checked.
MIN_WIDTH, MAX_WIDTH = 3, 61

#: Outputs per thread of K3's and K4's unit (``csrc/hpss.cu``'s ``QT``
#: frames along time, ``QF`` bins along frequency): the K of the harmonic
#: and percussive shared cores.
QT, QF = 4, 2


def check_pair(l_harm: int, l_perc: int) -> None:
    """Raise ``ValueError`` unless both widths are odd integers in
    ``[MIN_WIDTH, MAX_WIDTH]``."""
    for name, w in (("l_harm", l_harm), ("l_perc", l_perc)):
        if w != int(w) or int(w) % 2 == 0:
            raise ValueError(f"{name}={w!r}: the kernels take odd median "
                             "widths (a window has a middle value)")
        if not MIN_WIDTH <= w <= MAX_WIDTH:
            raise ValueError(
                f"{name}={w}: the kernels take widths {MIN_WIDTH} to "
                f"{MAX_WIDTH}; K1's block of 64 DFT rows keeps "
                "64 - 2*(l_harm//2) output frames, and every network is "
                "unrolled into registers")


@functools.lru_cache(maxsize=None)
def batcher_pairs(n: int) -> tuple[tuple[int, int], ...]:
    """Batcher odd-even mergesort comparators for ``n`` wires."""
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


def median_network(n: int) -> tuple[tuple[int, int], ...]:
    """``Median<n>``: the comparators that place the median on wire
    ``n // 2``."""
    return prune(batcher_pairs(n), [n // 2])


def shares_core(w: int, k: int) -> bool:
    """Whether K windows of width W can share a core: rank ``M-K+1`` must
    exist, ``K <= (W+1)/2``."""
    return (w - 1) // 2 - k + 1 >= 0


def core_network(w: int, k: int) -> tuple[tuple[int, int], ...]:
    """``MedianCore<w, k>``: ranks ``M-k+1 .. M`` of the core's W - K + 1
    wires sorted onto those wires."""
    m = (w - 1) // 2
    return prune(batcher_pairs(w - k + 1), range(m - k + 1, m + 1))


def merge_network(k: int) -> tuple[tuple[int, int], ...]:
    """``MedianMerge<k>``: the K sorted core values on wires ``0 .. K-1``,
    the K - 1 extras on ``K .. 2K-2``; the median lands on wire K - 1."""
    extras = tuple((k + i, k + j) for i, j in batcher_pairs(k - 1))
    maxima = tuple((i - 1, k + (k - 1 - i)) for i in range(1, k))
    minima = tuple((k - 1, k + b) for b in range(k - 1))
    return extras + maxima + minima


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


def median_struct(n: int) -> str:
    return "\n".join(
        ["template <>", f"struct Median<{n}> {{",
         "  __device__ __forceinline__ static float run(float* v) {"]
        + _cs_lines(median_network(n), "    ")
        + [f"    return v[{n // 2}];", "  }", "};", ""])


def core_struct(w: int, k: int) -> str:
    return "\n".join(
        ["template <>", f"struct MedianCore<{w}, {k}> {{",
         "  __device__ __forceinline__ static void run(float* v) {"]
        + _cs_lines(core_network(w, k), "    ") + ["  }", "};", ""])


def merge_struct(k: int) -> str:
    return "\n".join(
        ["template <>", f"struct MedianMerge<{k}> {{",
         "  __device__ __forceinline__ static float run(float* v) {"]
        + _cs_lines(merge_network(k), "    ")
        + [f"    return v[{k - 1}];", "  }", "};", ""])


def header_specialisations(text: str) -> tuple[set, set, set]:
    """The ``Median<L>`` widths, ``MedianCore<W, K>`` and
    ``MedianMerge<K>`` instances a header's text specialises."""
    singles = {int(n) for n in re.findall(r"struct Median<(\d+)>", text)}
    cores = {(int(w), int(k)) for w, k in
             re.findall(r"struct MedianCore<(\d+), (\d+)>", text)}
    merges = {int(k) for k in re.findall(r"struct MedianMerge<(\d+)>", text)}
    return singles, cores, merges


def pair_needs(l_harm: int, l_perc: int) -> tuple[set, set, set]:
    """The specialisations the kernels of one pair instantiate: K1/K2's
    ``Median<l_harm>`` and ``Median<l_perc>``, and K3/K4's shared cores
    (``l_harm`` at K = QT, ``l_perc`` at K = QF) with their merges, or
    ``Median<W>`` per window where a width is too narrow to share one."""
    singles, cores, merges = {l_harm, l_perc}, set(), set()
    for w, k in ((l_harm, QT), (l_perc, QF)):
        if shares_core(w, k):
            cores.add((w, k))
            merges.add(k)
    return singles, cores, merges


def pair_networks(l_harm: int, l_perc: int, header: str) -> str:
    """C++ text of the specialisations the pair needs and ``header`` (the
    text of ``csrc/median.cuh``) lacks; empty when it has them all, as for
    every pair of ``hpss.KERNEL_MEDIANS``."""
    check_pair(l_harm, l_perc)
    have = header_specialisations(header)
    need = pair_needs(l_harm, l_perc)
    parts = [median_struct(n) for n in sorted(need[0] - have[0])]
    parts += [core_struct(w, k) for w, k in sorted(need[1] - have[1])]
    parts += [merge_struct(k) for k in sorted(need[2] - have[2])]
    if not parts:
        return ""
    return (f"// Median networks of the pair ({l_harm}, {l_perc}) that "
            "median.cuh lacks,\n// written by "
            "sm_hpss_mtl_tpu_torch/ops/median_networks.py.\n\n"
            + "\n".join(parts))

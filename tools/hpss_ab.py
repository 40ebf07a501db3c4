#!/usr/bin/env python3
"""A/B of kernels K3 and K4: this checkout's build against a build of
another ``csrc/`` directory (an earlier revision of the port), and
variants of this checkout's ``hpss.cu``, on the GPU.

    python3 tools/hpss_ab.py OTHER_CSRC_DIR

Builds ``OTHER_CSRC_DIR/hpss.cu`` with the port's nvcc flags into a
temporary directory and binds its ``k3_hpss`` and ``k4_hpss_mel`` with the
argument lists of the earlier design (K4 without the band ranges).  This
checkout's kernels run through ``hpss.hpss``, ``hpss.hpss_masks`` and
``hpss.hpss_mel``.  On the same seeded inputs, at the K3 and K4 shapes of
``chip_smoke.py``'s phase 3, both builds are held to the plain versions at
the K3/K4 bar (rtol 1e-5, atol 1e-6).  At the timed shapes (K4 at
1 x 201 x 13 and 1 x 201 x 5998; K3 mask-only at 1 x 201 x 5998 and with
the masked components at 1 x 257 x 13) the two builds are timed in turns
(old, new, new, old) with CUDA events, and each kernel's device time is
read from ``torch.profiler``.

The variants are this ``hpss.cu`` with a few edits each (exact text
replacements; the tool fails if a pattern is no longer in the source), all
launched through their C entry points at the timed shapes, device time
from the profiler.  Ablations, whose outputs are wrong by design:

- ``kernel``: the source as it is;
- ``no_medians``: each median is its window's middle value (no networks);
- ``no_mel_epilogue``: K4's band sums skipped (its masks still computed);
- ``one_division_per_mask``: each mask is s^2 / (h^2 + p^2) by one IEEE
  division, without the normalisation and its reciprocals;
- ``four_divisions``: the masks as the earlier port computed them, four
  IEEE divisions per bin (``soft_masks``).

And forks and load batches of the design, whose outputs must stay right
(they are held to the plain versions at the timed shapes): ``k3_rows4``
(K3 loads 4 rows a warp at once, not 8), ``k4_rows8`` (K4 loads 8,
without its bound of 3 blocks per SM), ``k3_rows8_short`` (short K3 tiles
load 8 rows a warp at once, as long ones do, not 4) and ``scalar_stores``
(K3 stores one float at a time, not float2 pairs).  Each variant also reports the
registers ptxas gave K3's and K4's (21, 11) kernels.

``host_us`` is the host time per call (``time.perf_counter`` around 300
calls, no synchronisation inside) of each build's launch path at the timed
shapes, and of the pieces a wrapper may take: the two ways to read the
current stream, and two ways to allocate two outputs.

Prints one JSON line; exits non-zero if a check fails.  Unpack the other
revision first, e.g. ``git archive ca557f0 sm_hpss_mtl_tpu_torch/csrc |
tar -x -C build/pr5``.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from sm_hpss_mtl_tpu_torch.ops import _nvcc, hpss  # noqa: E402
from sm_hpss_mtl_tpu_torch.ops.mel import (mel_band_ranges,  # noqa: E402
                                          mel_filterbank)

#: (kernel, mask_only, l_harm, l_perc, B, F, T): phase 3's fixed shapes.
CASES = [("K3", mo, 21, 11, 2, 201, T) for mo in (False, True)
         for T in (1, 19, 364, 365)]
CASES += [("K3", mo, 21, 11, 1, 201, 5998) for mo in (False, True)]
CASES += [("K3", False, 21, 11, 1, 257, T) for T in range(1, 20)]
CASES += [("K4", False, 21, 11, 1, 201, T) for T in range(1, 20)]
CASES += [("K4", False, 21, 11, 2, 201, T) for T in (1, 7, 19, 32, 33, 5998)]
CASES += [("K4", False, 11, 5, 2, 201, T) for T in (1, 9, 40)]
CASES += [("K4", False, 21, 11, 2, 257, T) for T in (1, 19, 300)]
#: The timed launches: (kernel, mask_only, F, T).
TIMED = [("K4", False, 201, 13), ("K4", False, 201, 5998),
         ("K3", True, 201, 5998), ("K3", False, 257, 13)]
VARIANTS = {
    "kernel": [],
    "no_medians": [
        ("    running_medians<LH, QT>(x, harm[q]);",
         "    for (int t = 0; t < QT; ++t) harm[q][t] = x[HT + t];"),
        ("    running_medians<LP, QF>(y[t], perc);",
         "    for (int q = 0; q < QF; ++q) perc[q] = y[t][HP + q];")],
    "no_mel_epilogue": [("for (int k = klo; k < khi; ++k) {",
                         "for (int k = klo; k < klo; ++k) {")],
    "one_division_per_mask": [(
        "      soft_masks_rcp(harm[q][t], perc[q], &mh[q][t], &mp[q][t]);",
        "      { const float h2 = harm[q][t] * harm[q][t];"
        " const float p2 = perc[q] * perc[q];"
        " mh[q][t] = h2 / (h2 + p2); mp[q][t] = p2 / (h2 + p2); }")],
    "four_divisions": [(
        "      soft_masks_rcp(harm[q][t], perc[q], &mh[q][t], &mp[q][t]);",
        "      hpss_median::soft_masks(harm[q][t], perc[q], &mh[q][t],"
        " &mp[q][t]);")],
    "k3_rows4": [("constexpr int K3_ROWS = 8;", "constexpr int K3_ROWS = 4;")],
    "k4_rows8": [("constexpr int K4_ROWS = 4;", "constexpr int K4_ROWS = 8;"),
                 ("__launch_bounds__(THREADS, K4_MIN_BLOCKS)",
                  "__launch_bounds__(THREADS)")],
    "k3_rows8_short": [("  if (R <= SHORT_ROWS * (THREADS / 32)) {",
                        "  if (false) {")],
    "scalar_stores": [("  const bool pair_stores =\n",
                       "  const bool pair_stores = false &&\n")],
}
#: Variants whose outputs are wrong by design; the others are checked.
ABLATIONS = ("no_medians", "no_mel_epilogue", "one_division_per_mask")
#: Mangled-name parts of the kernels whose registers each variant reports.
PTXAS_KERNELS = {"K3": "hpss_kernelILi21ELi11ELb1E",
                 "K4": "hpss_mel_kernelILi21ELi11E"}


def compile_lib(src: Path, out: Path, pair: tuple[int, int] = (21, 11)
                ) -> tuple[ctypes.CDLL, str]:
    """The library built from ``src`` for the median pair ``pair`` (a
    revision that predates the per-pair libraries ignores the defines) and
    nvcc's ptxas report."""
    proc = subprocess.run([_nvcc._nvcc(), *_nvcc.NVCC_FLAGS,
                           *_nvcc.pair_defines(pair), "-o", str(out),
                           str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    return ctypes.CDLL(str(out)), proc.stdout + proc.stderr


def bind(lib: ctypes.CDLL, bands: bool) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.k3_hpss.argtypes = [p, p, p] + [i] * 6 + [p]
    lib.k3_hpss.restype = i
    lib.k4_hpss_mel.argtypes = [p] * (5 if bands else 4) + [i] * 6 + [p]
    lib.k4_hpss_mel.restype = i
    return lib


class Build:
    """One build's K3 and K4 through their C entry points."""

    def __init__(self, lib: ctypes.CDLL, bands: bool):
        self.lib, self.bands = lib, bands

    def k3(self, S, mask_only, lh, lp):
        B, F, T = S.shape
        oh, op = torch.empty((2, B, F, T), device="cuda")
        err = self.lib.k3_hpss(S.data_ptr(), oh.data_ptr(), op.data_ptr(), B,
                               F, T, lh, lp, int(mask_only),
                               torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"K3 failed: error {err}")
        return oh, op

    def k4(self, S, M, lh, lp):
        B, F, T = S.shape
        oh, op = torch.empty((2, B, M.shape[0], T), device="cuda")
        head = [S.data_ptr(), M.data_ptr()]
        if self.bands:
            head.append(_RANGES[F].data_ptr())
        err = self.lib.k4_hpss_mel(*head, oh.data_ptr(), op.data_ptr(), B, F,
                                   T, lh, lp, M.shape[0],
                                   torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"K4 failed: error {err}")
        return oh, op


#: The sr=22050 bank of 120 bands per F, and its band ranges.
_BANK: dict[int, torch.Tensor] = {}
_RANGES: dict[int, torch.Tensor] = {}


def bank(F: int) -> torch.Tensor:
    if F not in _BANK:
        _BANK[F] = mel_filterbank(22050, 2 * (F - 1), 120, device="cuda")
        _RANGES[F] = mel_band_ranges(_BANK[F])
    return _BANK[F]


def launcher(build, kernel, mask_only, lh, lp, S):
    if kernel == "K4":
        M = bank(S.shape[1])
        return lambda: build.k4(S, M, lh, lp)
    return lambda: build.k3(S, mask_only, lh, lp)


def new_launcher(kernel, mask_only, lh, lp, S):
    if kernel == "K4":
        M = bank(S.shape[1])
        return lambda: hpss.hpss_mel(S, M, l_harm=lh, l_perc=lp)
    fn = hpss.hpss_masks if mask_only else hpss.hpss
    return lambda: fn(S, l_harm=lh, l_perc=lp)


def plain(kernel, mask_only, lh, lp, S):
    if kernel == "K4":
        return hpss.hpss_mel_plain(S, bank(S.shape[1]), l_harm=lh,
                                   l_perc=lp)
    fn = hpss.hpss_masks_plain if mask_only else hpss.hpss_plain
    return fn(S, l_harm=lh, l_perc=lp)


def kernel_name(kernel: str) -> str:
    return "hpss_mel_kernel" if kernel == "K4" else "hpss_kernel"


def host_us(fn, n: int = 300) -> float:
    """Host time per call of ``fn`` in microseconds: ``n`` calls timed by
    ``time.perf_counter`` without a synchronisation between them."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def host_times(old: Build, gen) -> dict:
    out = {}
    for kernel, mo, F, T in TIMED:
        S = torch.rand((1, F, T), generator=gen, device="cuda")
        for name, fn in (("old", launcher(old, kernel, mo, 21, 11, S)),
                         ("new", new_launcher(kernel, mo, 21, 11, S))):
            out[f"{name} {kernel} {F}x{T}"] = host_us(fn, 100 if T > 20
                                                      else 300)
    S = torch.rand((1, 201, 13), device="cuda")
    out["torch.cuda.current_stream().cuda_stream"] = host_us(
        lambda: torch.cuda.current_stream().cuda_stream)
    out["torch._C._cuda_getCurrentRawStream"] = host_us(
        lambda: torch._C._cuda_getCurrentRawStream(S.device.index))
    out["torch.empty((2, ...)).unbind(0)"] = host_us(
        lambda: torch.empty((2,) + S.shape, device=S.device).unbind(0))
    out["2 x torch.empty_like"] = host_us(
        lambda: (torch.empty_like(S), torch.empty_like(S)))
    return out


def measure_variants(tmp: Path, gen, failures: list) -> dict:
    src = (_nvcc.CSRC / "hpss.cu").read_text()
    shutil.copy(_nvcc.CSRC / "median.cuh", tmp / "median.cuh")
    sources = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"hpss_ab: {old!r} is not in hpss.cu")
            text = text.replace(old, new)
        (tmp / f"{name}.cu").write_text(text)
        sources[name] = tmp / f"{name}.cu"
    with ThreadPoolExecutor(len(sources)) as ex:
        libs = dict(zip(sources, ex.map(
            lambda kv: compile_lib(kv[1], tmp / f"lib{kv[0]}.so"),
            sources.items())))
    inputs = {shape: torch.rand((1,) + shape[2:], generator=gen,
                                device="cuda") ** 3 for shape in TIMED}
    out = {}
    for name, (lib, log) in libs.items():
        build = Build(bind(lib, bands=True), bands=True)
        row = {f"{k} registers": cs.parse_ptxas(log, part)["registers"]
               for k, part in PTXAS_KERNELS.items()}
        for kernel, mo, F, T in TIMED:
            S = inputs[(kernel, mo, F, T)]
            fn = launcher(build, kernel, mo, 21, 11, S)
            if name not in ABLATIONS:
                try:
                    cs.compare(f"variant {name} {kernel} {F}x{T}", fn(),
                               plain(kernel, mo, 21, 11, S), cs.K3_RTOL,
                               cs.K3_ATOL)
                except cs.PhaseError as e:
                    failures.append(str(e))
            fn()
            row[f"{kernel} {F}x{T}"] = cs.device_ms(fn, kernel_name(kernel))
        out[name] = row
    return out


def main(argv: list[str]) -> int:
    if len(argv) != 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    failures, cases, timed = [], [], []
    with tempfile.TemporaryDirectory() as tmp:
        olds = {pair: Build(bind(compile_lib(
            Path(argv[0]) / "hpss.cu",
            Path(tmp) / f"libhpss_other_{pair[0]}_{pair[1]}.so", pair)[0],
            bands=False), bands=False)
            for pair in {(c[2], c[3]) for c in CASES}}
        old = olds[(21, 11)]
        for kernel, mo, lh, lp, B, F, T in CASES:
            S = torch.rand((B, F, T), generator=gen, device="cuda") ** 3
            want = plain(kernel, mo, lh, lp, S)
            row = {"kernel": kernel, "shape": [mo, lh, lp, B, F, T]}
            for name, fn in (("old", launcher(olds[(lh, lp)], kernel, mo,
                                              lh, lp, S)),
                             ("new", new_launcher(kernel, mo, lh, lp, S))):
                try:
                    row[f"{name}_vs_plain"] = cs.compare(
                        f"{name} {kernel} {row['shape']}", fn(), want,
                        cs.K3_RTOL, cs.K3_ATOL)
                except cs.PhaseError as e:
                    failures.append(str(e))
            cases.append(row)
        for kernel, mo, F, T in TIMED:
            S = torch.rand((1, F, T), generator=gen, device="cuda") ** 3
            fns = {"old": launcher(old, kernel, mo, 21, 11, S),
                   "new": new_launcher(kernel, mo, 21, 11, S)}
            ms = {"old": [], "new": []}
            for name in ("old", "new", "new", "old"):
                ms[name].append(cs.cuda_ms(fns[name], reps=100))
            dev = {name: cs.device_ms(fn, kernel_name(kernel))
                   for name, fn in fns.items()}
            med = {k: sum(v[0] for v in ms[k]) / 2 for k in ms}
            timed.append({
                "kernel": kernel, "shape": [1, F, T],
                "mode": "mask_only" if mo else "components",
                "old_ms": med["old"], "new_ms": med["new"],
                "old_turns": ms["old"], "new_turns": ms["new"],
                "old_device_ms": dev["old"], "new_device_ms": dev["new"],
                "device_speedup": dev["old"] / dev["new"]})
        host = host_times(old, gen)
        variants = measure_variants(Path(tmp), gen, failures)
    ok = not failures
    print(json.dumps({"hpss_ab": {
        "card": card, "other": argv[0], "ok": ok, "failures": failures,
        "timed": timed, "host_us": host, "variants": variants,
        "cases": cases}}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

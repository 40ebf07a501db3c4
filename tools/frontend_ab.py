#!/usr/bin/env python3
"""A/B of kernels K1 and K2: this checkout's build against a build of
another ``csrc/`` directory (an earlier revision of the port), on the GPU.

    python3 tools/frontend_ab.py OTHER_CSRC_DIR

Builds ``OTHER_CSRC_DIR/frontend.cu`` with the port's nvcc flags into a
temporary directory and binds its ``k1_stft_hpss_mel`` and ``k2_stft_hpss``
with the argument lists of the earlier design (no basis or band
arguments).  This checkout's kernels run through ``frontend.launch``.  On
the same seeded audio, at the shapes of ``chip_smoke.py``'s phase 3 and at
1 x 16404 frames for n_fft 400 (K1) and 512 (K2), both builds are held to
the plain version at the K1/K2 bar (rtol 2e-4, atol 2e-5), and each
build's max |delta| against a float64 run of the plain version on the card
is reported.  At 1 x 16404 frames the two builds are timed in turns (old,
new, new, old) with CUDA events, and each kernel's device time is read
from ``torch.profiler``.  Prints one JSON line; exits non-zero if a check
fails.  Unpack the other revision first, e.g.
``git archive 0eecef5 sm_hpss_mtl_tpu_torch/csrc | tar -x -C build/old``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from sm_hpss_mtl_tpu_torch.ops import _nvcc, frontend  # noqa: E402
from sm_hpss_mtl_tpu_torch.ops.mel import mel_filterbank  # noqa: E402

#: (kernel, n_fft, l_harm, l_perc, B, T): phase 3's fixed shapes.
CASES = [("K1", 400, 21, 11, 2, T) for T in (1, 7, 19, 21, 48, 58, 98)]
CASES += [("K1", 512, 11, 5, 2, 71)]
CASES += [("K1", 512, 21, 11, 2, T) for T in (1, 19, 98)]
CASES += [("K2", n, lh, lp, 2, T) for n in (400, 512)
          for lh, lp in ((21, 11), (11, 5)) for T in (1, 7, 19, 21, 48, 98)]
CASES += [("K1", 400, 21, 11, 1, T) for T in (6024, 16384, 16394, 16404)]
CASES += [("K2", 512, 21, 11, 1, T) for T in (1081, 6023, 16394, 16404)]
#: The timed launches: the slabbed featurizer's interior slab.
TIMED = [("K1", 400), ("K2", 512)]
SLAB = 16404


def build_other(csrc: Path, tmp: str, pair: tuple[int, int]) -> ctypes.CDLL:
    """The other build's library for the median pair ``pair`` (a revision
    that predates the per-pair libraries ignores the defines)."""
    lib_path = Path(tmp) / f"libfrontend_other_{pair[0]}_{pair[1]}.so"
    subprocess.run([_nvcc._nvcc(), *_nvcc.NVCC_FLAGS,
                    *_nvcc.pair_defines(pair), "-o", str(lib_path),
                    str(csrc / "frontend.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.k1_stft_hpss_mel.argtypes = [p, p, p, p] + [i] * 9 + [p]
    lib.k1_stft_hpss_mel.restype = i
    lib.k2_stft_hpss.argtypes = [p, p, p] + [i] * 8 + [p]
    lib.k2_stft_hpss.restype = i
    return lib


def run_other(lib, kernel, y, M, n_fft, lh, lp):
    """The other build's kernel on ``y`` (B, N); raises if it fails."""
    B, N = y.shape
    T = 1 + (N - n_fft) // 160
    rows = M.shape[0] if kernel == "K1" else 1 + n_fft // 2
    oh = torch.empty((B, rows, T), device="cuda")
    op = torch.empty_like(oh)
    stream = torch.cuda.current_stream().cuda_stream
    if kernel == "K1":
        err = lib.k1_stft_hpss_mel(y.data_ptr(), M.data_ptr(), oh.data_ptr(),
                                   op.data_ptr(), B, N, T, n_fft, 400, 160,
                                   lh, lp, rows, stream)
    else:
        err = lib.k2_stft_hpss(y.data_ptr(), oh.data_ptr(), op.data_ptr(), B,
                               N, T, n_fft, 400, 160, lh, lp, stream)
    if err:
        raise RuntimeError(f"other build's {kernel} failed: error {err}")
    return oh, op


def max_err(got, want) -> float:
    return max((g.double() - w.double()).abs().max().item()
               for g, w in zip(got, want))


def main(argv: list[str]) -> int:
    if len(argv) != 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    failures, cases, timed = [], [], []
    with tempfile.TemporaryDirectory() as tmp:
        other = {pair: build_other(Path(argv[0]), tmp, pair)
                 for pair in {(c[2], c[3]) for c in CASES}}
        for kernel, n_fft, lh, lp, B, T in CASES:
            y = torch.randn((B, n_fft + (T - 1) * 160), generator=gen,
                            device="cuda")
            M = (mel_filterbank(22050, n_fft, 120, device="cuda")
                 if kernel == "K1" else None)
            kw = dict(n_fft=n_fft, win_length=400, hop_length=160,
                      l_harm=lh, l_perc=lp)
            new = lambda: frontend.launch(y, M, **kw)  # noqa: E731
            old = lambda: run_other(other[(lh, lp)], kernel, y,  # noqa
                                    M, n_fft, lh, lp)
            plain = (frontend.stft_hpss_mel_plain(y, M, **kw) if M is not None
                     else frontend.stft_hpss_plain(y, **kw))
            row = {"kernel": kernel, "shape": [n_fft, lh, lp, B, T]}
            for name, fn in (("old", old), ("new", new)):
                out = fn()
                try:
                    row[f"{name}_vs_plain"] = cs.compare(
                        f"{name} {kernel} {row['shape']}", out, plain,
                        cs.RTOL, cs.ATOL)
                except cs.PhaseError as e:
                    failures.append(str(e))
                    row[f"{name}_vs_plain"] = max_err(out, plain)
            if T == SLAB:
                y64 = y.double()
                ref = (frontend.stft_hpss_mel_plain(y64, M.double(), **kw)
                       if M is not None
                       else frontend.stft_hpss_plain(y64, **kw))
                for name, fn in (("old", old), ("new", new), ("plain", None)):
                    out = plain if fn is None else fn()
                    row[f"{name}_vs_f64"] = max_err(out, ref)
                del ref, y64
            cases.append(row)
            if (kernel, n_fft) in TIMED and T == SLAB:
                ms = {"old": [], "new": []}
                for name in ("old", "new", "new", "old"):
                    ms[name].append(cs.cuda_ms(new if name == "new" else old))
                dev = {name: cs.device_ms(fn, "frontend_kernel")
                       for name, fn in (("old", old), ("new", new))}
                med = {k: sum(v[0] for v in ms[k]) / 2 for k in ms}
                timed.append({
                    "kernel": kernel, "shape": [1, y.shape[-1]],
                    "frames": T, "n_fft": n_fft,
                    "old_ms": med["old"], "new_ms": med["new"],
                    "old_turns": ms["old"], "new_turns": ms["new"],
                    "old_device_ms": dev["old"], "new_device_ms": dev["new"],
                    "speedup": med["old"] / med["new"]})
    ok = not failures
    print(json.dumps({"frontend_ab": {
        "card": card, "other": argv[0], "ok": ok, "failures": failures,
        "timed": timed, "cases": cases}}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

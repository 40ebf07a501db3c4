#!/usr/bin/env python3
"""A/B of kernels K1-K4 at their default mode: this checkout's build against
a build of another ``csrc/`` directory with the halo-mode interface of
K1/K2 and no mask-power argument (the port before the power became a
kernel argument), on the GPU.

    python3 tools/kernels_ab.py OTHER_CSRC_DIR

Builds ``OTHER_CSRC_DIR/frontend.cu`` and ``hpss.cu`` for the median pair
(21, 11) with the port's nvcc flags into a temporary directory, and runs
both builds through this checkout's wrappers (``frontend.launch``,
``hpss.hpss``, ``hpss.hpss_masks``, ``hpss.hpss_mel``) at
``dft_precision='highest'`` and power 2, the other build by handing the
wrappers its library with the power argument dropped.  On the same seeded
inputs, at the fixed shapes of ``chip_smoke.py``'s phase 3 (K1 and K2
also in halo mode), every output of the two builds must be bit-identical
(``torch.equal``).  At the timed shapes
(K1 at 1 x 16404 frames, n_fft 400; K2 at 1 x 16404, n_fft 512; K3
mask-only at 1 x 201 x 5998; K4 at 1 x 201 x 13 and 1 x 201 x 5998) the
builds are timed in turns (other, this, this, other) with CUDA events, and
each kernel's device time is read from ``torch.profiler``.  Prints one
JSON line; exits non-zero if an output differs.  Unpack the other revision
first, e.g. ``git archive <commit> sm_hpss_mtl_tpu_torch/csrc | tar -x -C
build/other``.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import tempfile
import types
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from sm_hpss_mtl_tpu_torch.ops import _nvcc, frontend, hpss  # noqa: E402
from sm_hpss_mtl_tpu_torch.ops.mel import mel_filterbank  # noqa: E402

PAIR = (21, 11)
#: (kernel, n_fft, B, T, halo flags or None): phase 3's fixed K1/K2 shapes.
FRONTEND = [("K1", 400, 2, T, None) for T in (1, 7, 19, 21, 48, 58, 98)]
FRONTEND += [("K1", 512, 2, T, None) for T in (1, 19, 98)]
FRONTEND += [("K2", n, 2, T, None) for n in (400, 512)
             for T in (1, 7, 19, 21, 48, 98)]
FRONTEND += [("K1", 400, 1, T, None) for T in (6024, 16384, 16394, 16404)]
FRONTEND += [("K2", 512, 1, T, None) for T in (1081, 6023, 16394, 16404)]
FRONTEND += [("K1", 400, 48, 68, None), ("K2", 512, 48, 67, None)]
FRONTEND += [(k, 400, 2, 192, f) for k in ("K1", "K2")
             for f in cs.HALO_FLAGS]
#: (kernel, mask_only, B, F, T): phase 3's fixed K3/K4 shapes.
SPECTRAL = [("K3", mo, 2, 201, T) for mo in (False, True)
            for T in (1, 19, 364, 365)]
SPECTRAL += [("K3", mo, 1, 201, 5998) for mo in (False, True)]
SPECTRAL += [("K3", False, 1, 257, T) for T in range(1, 20)]
SPECTRAL += [("K4", False, 1, 201, T) for T in range(1, 20)]
SPECTRAL += [("K4", False, 2, 201, T) for T in (1, 7, 19, 32, 33, 5998)]


def without_power(fn):
    """``fn``, an entry point of the other build, called as this checkout's
    wrappers call theirs: the power argument (before the stream) is
    dropped, and must be 2."""
    def call(*args):
        assert args[-2] == 2.0, args[-2]
        return fn(*args[:-2], args[-1])
    return call


def build_other(csrc: Path, tmp: str) -> dict:
    """The other build's libraries by source, each bound as its own source
    declares it (``_nvcc.bind``) and called as this checkout's wrappers
    call theirs (``without_power``)."""
    libs = {}
    for source in ("frontend.cu", "hpss.cu"):
        out = Path(tmp) / f"lib{Path(source).stem}_other.so"
        subprocess.run([_nvcc._nvcc(), *_nvcc.NVCC_FLAGS,
                        *_nvcc.pair_defines(PAIR), "-o", str(out),
                        str(csrc / source)], check=True, capture_output=True)
        lib = _nvcc.bind(out, csrc / source)
        libs[source] = types.SimpleNamespace(**{
            name: getattr(lib, name) if name.endswith("_error_string")
            else without_power(getattr(lib, name))
            for name in _nvcc.signatures(csrc / source)
            if not name.endswith("_blocks_per_sm")})
    return libs


@contextlib.contextmanager
def using(libs: dict, which: str):
    """The wrappers launch the other build's libraries inside
    (``which='other'``), or this checkout's."""
    load = _nvcc.load
    if which == "other":
        _nvcc.load = lambda source, *a, **kw: libs[source]
    try:
        yield
    finally:
        _nvcc.load = load


def run(libs: dict, which: str, fn):
    """``fn()`` with the other build's libraries (``which='other'``) or
    this checkout's."""
    with using(libs, which):
        return fn()


def main(argv: list[str]) -> int:
    if len(argv) != 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    banks = {n: mel_filterbank(22050, n, 120, device="cuda")
             for n in (400, 512)}
    differ, cases, timed = [], [], []
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_other(Path(argv[0]), tmp)
        for k, n_fft, B, T, flags in FRONTEND:
            halo = 20 if flags else 0
            y = torch.randn((B, n_fft + (T + halo - 1) * 160), generator=gen,
                            device="cuda")
            M = banks[n_fft] if k == "K1" else None
            kw = dict(n_fft=n_fft, win_length=400, hop_length=160,
                      l_harm=PAIR[0], l_perc=PAIR[1])
            if flags:
                kw.update(halo_in_audio=True, edge_flags=flags)

            def fn(y=y, M=M, kw=kw):
                return frontend.launch(y, M, **kw)
            out = {w: run(libs, w, fn) for w in ("other", "this")}
            same = all(torch.equal(a, b) for a, b in zip(out["other"],
                                                          out["this"]))
            cases.append({"kernel": k, "shape": [n_fft, B, T],
                          "halo_flags": flags, "bit_identical": same})
            if not same:
                differ.append(cases[-1])
            if B == 1 and T == 16404:
                timed.append(time_turns(libs, k, fn, "frontend_kernel",
                                        [1, y.shape[-1]]))
        for k, mo, B, F, T in SPECTRAL:
            S = torch.rand((B, F, T), generator=gen, device="cuda") ** 3
            M = banks[2 * (F - 1)] if k == "K4" else None

            def fn(S=S, M=M, mo=mo, k=k):
                if k == "K4":
                    return hpss.hpss_mel(S, M)
                return (hpss.hpss_masks if mo else hpss.hpss)(S)
            out = {w: run(libs, w, fn) for w in ("other", "this")}
            same = all(torch.equal(a, b) for a, b in zip(out["other"],
                                                          out["this"]))
            cases.append({"kernel": k, "mask_only": mo, "shape": [B, F, T],
                          "bit_identical": same})
            if not same:
                differ.append(cases[-1])
            if B == 1 and F == 201 and (T == 5998 and (mo or k == "K4")
                                        or (T == 13 and k == "K4")):
                timed.append(time_turns(
                    libs, k, fn, "hpss_mel_kernel" if k == "K4"
                    else "hpss_kernel", [B, F, T]))
    ok = not differ
    print(json.dumps({"kernels_ab": {
        "card": card, "other": argv[0], "pair": list(PAIR), "ok": ok,
        "cases": len(cases), "differ": differ, "timed": timed}}))
    return 0 if ok else 1


def time_turns(libs, kernel, fn, name, shape) -> dict:
    """The two builds' ms (CUDA events, median of 7 batches) in turns
    (other, this, this, other) and their profiler device times."""
    ms = {"other": [], "this": []}
    for which in ("other", "this", "this", "other"):
        ms[which].append(run(libs, which, lambda: cs.cuda_ms(fn, reps=50)))
    dev = {w: run(libs, w, lambda: cs.device_ms(fn, name))
           for w in ("other", "this")}
    return {"kernel": kernel, "shape": shape,
            **{f"{w}_ms": sum(t[0] for t in v) / 2 for w, v in ms.items()},
            **{f"{w}_turns": v for w, v in ms.items()},
            **{f"{w}_device_ms": v for w, v in dev.items()}}


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

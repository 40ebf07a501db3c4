#!/usr/bin/env python3
"""Where K1's and K2's time goes: variants of ``csrc/frontend.cu`` with one
stage taken out, timed on the GPU against the kernel as it is.

    python3 tools/frontend_ablate.py

Each variant is the source with one edit (the edits are exact text
replacements, and the tool fails if a pattern is no longer in the source):

- ``kernel``: the source as it is;
- ``no_median_networks``: each median is the window's middle value, so the
  networks and the window loads they need are gone (masks still computed);
- ``no_dft``: the MMAs removed, so the DFT loop and its loads are dead code
  (the medians then run on zeros);
- ``hi_only``: one product per k-step (hi*hi) instead of split TF32's three;
- ``no_basis_loads``: the basis fragments made up in registers instead of
  read from L2 (the products still run).

Every variant is built with the port's nvcc flags, launched through its C
entry points at 1 x 16404 frames (K1 at n_fft 400, K2 at n_fft 512, the
slabbed featurizer's interior slab), and timed by CUDA events (median of 7
batches of 50 launches).  The outputs of the variants other than
``kernel`` are wrong by design.  Prints one JSON line with the card, each
variant's ms, spread, registers and spills.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from sm_hpss_mtl_tpu_torch.ops import _nvcc, frontend  # noqa: E402
from sm_hpss_mtl_tpu_torch.ops.mel import (mel_band_ranges,  # noqa: E402
                                          mel_filterbank)

FRAMES = 16404
#: The six products of a k-step: cos tile (e) and sin tile (o), each
#: lo*hi, hi*lo, hi*hi.
MMAS = ["mma_tf32(c, el, bh[t]);",
        "mma_tf32(c, eh, bl[t]);",
        "mma_tf32(c, eh, bh[t]);",
        "mma_tf32(d, ol, bh[t + 1]);",
        "mma_tf32(d, oh, bl[t + 1]);",
        "mma_tf32(d, oh, bh[t + 1]);"]
EDITS = {
    "kernel": [],
    "no_median_networks": [
        ("const float harm = Median<LH>::run(v);", "const float harm = v[HT];"),
        ("const float perc = Median<LP>::run(u);", "const float perc = u[HP];")],
    "no_dft": [(m, "") for m in MMAS],
    "hi_only": [(MMAS[i], "") for i in (0, 1, 3, 4)],
    "no_basis_loads": [(
        "v = __ldg(bs + ((t >> 1) * WARPS * 2 + (t & 1)) * 32);",
        "v = make_float4((float)s, (float)lane, 1.f, 2.f);")],
}


def variant_source(src: str, edits) -> str:
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"frontend_ablate: {old!r} is not in the source")
        src = src.replace(old, new)
    return src


def build(name: str, src: str, tmp: Path) -> tuple[str, ctypes.CDLL, dict]:
    cu, lib = tmp / f"{name}.cu", tmp / f"lib{name}.so"
    cu.write_text(src)
    proc = subprocess.run([_nvcc._nvcc(), *_nvcc.NVCC_FLAGS,
                           *_nvcc.pair_defines((21, 11)), "-o", str(lib),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    log = proc.stdout + proc.stderr
    report = {"registers": sorted({int(r) for r in re.findall(
                  r"Used (\d+) registers", log)}),
              "spill_stores": sorted({int(r) for r in re.findall(
                  r"(\d+) bytes spill stores", log)})}
    dll = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.k1_stft_hpss_mel.argtypes = [p] * 6 + [i] * 9 + [p]
    dll.k2_stft_hpss.argtypes = [p] * 4 + [i] * 8 + [p]
    return name, dll, report


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    src = (_nvcc.CSRC / "frontend.cu").read_text()
    sources = {k: variant_source(src, e) for k, e in EDITS.items()}
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    res = {"card": cs.card_line(), "frames": FRAMES, "variants": {}}
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copy(_nvcc.CSRC / "median.cuh", Path(tmp) / "median.cuh")
        with ThreadPoolExecutor(len(sources)) as ex:
            built = list(ex.map(lambda kv: build(*kv, Path(tmp)),
                                sources.items()))
        runs = {}
        for name, n_fft in (("K1", 400), ("K2", 512)):
            y = torch.randn((1, n_fft + (FRAMES - 1) * 160), generator=gen,
                            device="cuda")
            M = mel_filterbank(22050, n_fft, 120, device="cuda")
            rows = 120 if name == "K1" else 1 + n_fft // 2
            runs[name] = (n_fft, y, M, rows,
                          frontend._fragments_on(n_fft, 400, y.device),
                          mel_band_ranges(M))
        for variant, lib, report in built:
            row = dict(report)
            for name, (n_fft, y, M, rows, basis, bands) in runs.items():
                oh = torch.empty((1, rows, FRAMES), device="cuda")
                op = torch.empty_like(oh)
                st = torch.cuda.current_stream().cuda_stream
                if name == "K1":
                    args = (y.data_ptr(), basis.data_ptr(), M.data_ptr(),
                            bands.data_ptr(), oh.data_ptr(), op.data_ptr(), 1,
                            y.shape[-1], FRAMES, n_fft, 400, 160, 21, 11,
                            rows, st)
                    fn = lambda a=args: lib.k1_stft_hpss_mel(*a)  # noqa
                else:
                    args = (y.data_ptr(), basis.data_ptr(), oh.data_ptr(),
                            op.data_ptr(), 1, y.shape[-1], FRAMES, n_fft, 400,
                            160, 21, 11, st)
                    fn = lambda a=args: lib.k2_stft_hpss(*a)  # noqa
                if fn() != 0:
                    raise RuntimeError(f"{variant} {name} failed to launch")
                ms = cs.cuda_ms(fn, reps=50)
                row[name] = {"ms": ms[0], "spread": ms[1:]}
            res["variants"][variant] = row
    print(json.dumps({"frontend_ablate": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

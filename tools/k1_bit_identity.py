#!/usr/bin/env python3
"""Hold kernel K1 of this checkout bit for bit to K1 built from another
``csrc/`` directory (an earlier revision of the port), on the GPU.

    python3 tools/k1_bit_identity.py OTHER_CSRC_DIR

Builds ``OTHER_CSRC_DIR/frontend.cu`` with the port's nvcc flags into a
temporary directory, launches both builds' ``k1_stft_hpss_mel`` on the same
random audio at each (n_fft, l_harm, l_perc, B, T) below, and exits
non-zero unless every output is bitwise equal.  Prints one JSON line.
Needs a CUDA GPU and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from sm_hpss_mtl_tpu_torch.ops import _nvcc, frontend  # noqa: E402
from sm_hpss_mtl_tpu_torch.ops.mel import mel_filterbank  # noqa: E402

CASES = [(400, 21, 11, 2, T) for T in (1, 19, 98)]
CASES += [(512, 21, 11, 2, 71), (512, 11, 5, 2, 19),
          (400, 21, 11, 1, 16404), (512, 21, 11, 1, 16404)]


def main(argv: list[str]) -> int:
    if len(argv) != 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(argv[0]) / "frontend.cu"
    with tempfile.TemporaryDirectory() as tmp:
        lib_path = Path(tmp) / "libother.so"
        subprocess.run([_nvcc._nvcc(), *_nvcc.NVCC_FLAGS, "-o", str(lib_path),
                        str(other)], check=True, capture_output=True)
        other_lib = ctypes.CDLL(str(lib_path))
        p, i = ctypes.c_void_p, ctypes.c_int
        other_lib.k1_stft_hpss_mel.argtypes = [p, p, p, p] + [i] * 9 + [p]
        other_lib.k1_stft_hpss_mel.restype = i
        gen = torch.Generator(device="cuda").manual_seed(0)
        results = []
        for n_fft, lh, lp, B, T in CASES:
            N = n_fft + (T - 1) * 160
            y = torch.randn((B, N), generator=gen, device="cuda")
            M = mel_filterbank(22050, n_fft, 120, device="cuda")
            # The direct launcher: the dispatcher sends T < 2*(l_harm//2)
            # to K4, which is not K1.
            h, pp = frontend.launch(y, M, n_fft=n_fft, win_length=400,
                                    hop_length=160, l_harm=lh, l_perc=lp)
            oh, op = torch.empty_like(h), torch.empty_like(pp)
            err = other_lib.k1_stft_hpss_mel(
                y.data_ptr(), M.data_ptr(), oh.data_ptr(), op.data_ptr(), B,
                N, T, n_fft, 400, 160, lh, lp, 120,
                torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            same = err == 0 and torch.equal(h, oh) and torch.equal(pp, op)
            results.append({"shape": [n_fft, lh, lp, B, T], "equal": same})
    ok = all(r["equal"] for r in results)
    print(json.dumps({"k1_bit_identical": ok, "other": str(other),
                      "cases": results}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

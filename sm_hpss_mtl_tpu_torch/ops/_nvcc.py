"""Build a CUDA source of ``csrc/`` into a shared library with ``nvcc``.

Kernels have a plain C interface and are loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds).  The library lands in
``build/torch_kernels/`` at the repository root, named by a hash of its
source, of the ``csrc/`` headers it includes and of what it is built for,
so an edited source or header is rebuilt and a stale library is never
loaded.

The median kernels (``frontend.cu``, ``hpss.cu``) are built once per
(l_harm, l_perc) pair and DFT precision; a source with no median
(``tcn_block.cu``) is built once, with ``pair=None``:

- ``pair`` passes ``-DHPSS_LH=... -DHPSS_LP=...`` (``csrc/median.cuh``'s
  ``HPSS_FOR_EACH_PAIR``), so a library holds that pair's instances alone,
  a caller builds only the pairs it launches, and the pairs build in
  parallel.  A pair whose networks ``median.cuh`` does not hold gets them
  from ``median_networks.pair_networks``, written beside the libraries and
  included through ``-DHPSS_PAIR_NETWORKS``.
- ``dft_precision='bf16x3'`` (``frontend.cu`` only) builds the DFT in
  bf16x3 on the bf16 tensor cores (``-DHPSS_BF16X3=1``) in place of split
  TF32.

Both precisions keep the same C interface, and the mask power is an
argument of every kernel (2 squares, any other goes through ``powf``).

Nothing here runs at import time.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

from . import median_networks

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: The DFT precisions of ``frontend.cu`` (the JAX kernels' names).
DFT_PRECISIONS = ("highest", "bf16x3")


def pair_defines(pair: tuple[int, int]) -> list[str]:
    """The nvcc defines that make a library of ``pair``'s instances."""
    return [f"-DHPSS_LH={pair[0]}", f"-DHPSS_LP={pair[1]}"]


def check_precision(dft_precision: str) -> None:
    """Raise ``ValueError`` for a DFT precision the kernels do not have."""
    if dft_precision not in DFT_PRECISIONS:
        raise ValueError(f"dft_precision must be one of {DFT_PRECISIONS}, "
                         f"got {dft_precision!r}")


def precision_defines(source: str, dft_precision: str = "highest"
                      ) -> list[str]:
    """The nvcc defines of a DFT precision (see the module doc)."""
    check_precision(dft_precision)
    if dft_precision != "highest" and source != "frontend.cu":
        raise ValueError(f"{source} computes no DFT")
    return ["-DHPSS_BF16X3=1"] if dft_precision == "bf16x3" else []


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc at first use")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(source: str) -> list[Path]:
    """``csrc/<source>`` and every ``csrc/`` file it includes with
    ``#include "..."``, transitively, each once."""
    seen: list[Path] = []
    todo = [CSRC / source]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        todo.extend(CSRC / name.decode()
                    for name in _INCLUDE.findall(path.read_bytes()))
    return seen


def pair_networks(pair: tuple[int, int]) -> str:
    """The median networks ``pair`` needs beyond ``csrc/median.cuh``'s
    (empty for the pairs the header holds)."""
    return median_networks.pair_networks(
        *pair, (CSRC / "median.cuh").read_text())


def library_path(source: str, pair: tuple[int, int] | None = None,
                 dft_precision: str = "highest") -> Path:
    """Where the library built from ``csrc/<source>`` for the median pair
    ``pair`` (None for a source with no median) and ``dft_precision``
    lives: named by the pair, the precision and a hash of the source, the
    headers it includes and the pair's generated networks."""
    precision_defines(source, dft_precision)
    digest = hashlib.sha256()
    for path in _sources(source):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    name = f"lib{Path(source).stem}"
    if pair is not None:
        digest.update(pair_networks(pair).encode())
        name += f"_{pair[0]}_{pair[1]}"
    tag = "_bf16x3" if dft_precision == "bf16x3" else ""
    return BUILD_DIR / f"{name}{tag}_{digest.hexdigest()[:12]}.so"


def build(source: str, pair: tuple[int, int] | None = None,
          dft_precision: str = "highest") -> Path:
    """Compile ``csrc/<source>`` for the median pair ``pair`` (None for a
    source with no median) and ``dft_precision`` (see the module doc)
    unless its library exists; return the library's path.  The ptxas
    report (registers, shared memory, spills) is kept beside it as
    ``<library>.log``."""
    if pair is not None:
        median_networks.check_pair(*pair)
    out = library_path(source, pair, dft_precision)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    defines = pair_defines(pair) if pair is not None else []
    defines += precision_defines(source, dft_precision)
    networks = pair_networks(pair) if pair is not None else ""
    if networks:
        header = out.with_suffix(".cuh")
        fd, tmp = tempfile.mkstemp(suffix=".cuh", dir=BUILD_DIR)
        with os.fdopen(fd, "w") as f:
            f.write(networks)
        os.replace(tmp, header)
        defines.append(f'-DHPSS_PAIR_NETWORKS="{header}"')
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *defines, "-o", tmp, str(CSRC / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    Path(str(out) + ".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out

"""Build a CUDA source of ``csrc/`` into a shared library with ``nvcc``.

Kernels have a plain C interface and are loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds).  The library lands in
``build/torch_kernels/`` at the repository root, named by a hash of its
source and of the ``csrc/`` headers it includes, so an edited source or
header is rebuilt and a stale library is never loaded.

The median kernels are built once per (l_harm, l_perc) pair: ``pair``
passes ``-DHPSS_LH=... -DHPSS_LP=...`` (``csrc/median.cuh``'s
``HPSS_FOR_EACH_PAIR``), so a library holds that pair's instances alone,
a caller builds only the pairs it launches, and the pairs build in
parallel.  Nothing here runs at import time.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def pair_defines(pair: tuple[int, int]) -> list[str]:
    """The nvcc defines that make a library of ``pair``'s instances."""
    return [f"-DHPSS_LH={pair[0]}", f"-DHPSS_LP={pair[1]}"]


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


def library_path(source: str, pair: tuple[int, int]) -> Path:
    """Where the library built from ``csrc/<source>`` for the median pair
    ``pair`` lives: named by the pair and a hash of the source and of the
    headers it includes."""
    digest = hashlib.sha256()
    for path in _sources(source):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / (f"lib{Path(source).stem}_{pair[0]}_{pair[1]}_"
                        f"{digest.hexdigest()[:12]}.so")


def build(source: str, pair: tuple[int, int]) -> Path:
    """Compile ``csrc/<source>`` for the median pair ``pair`` (see the
    module doc) unless its library exists; return the library's path.  The
    ptxas report (registers, shared memory, spills) is kept beside it as
    ``<library>.log``."""
    out = library_path(source, pair)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *pair_defines(pair), "-o", tmp,
           str(CSRC / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    Path(str(out) + ".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out

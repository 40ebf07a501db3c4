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

This module is also the kernels' one seam to PyTorch: :func:`load` builds
and loads a library and binds every function the source exports as the
source declares it (:func:`signatures`); :func:`launch` calls a kernel on
the current stream of its tensors' device and raises on a failed launch;
:func:`occupancy` asks a library for blocks per SM; :func:`on_card` is the
ops' route, the plain version for a CPU tensor and the kernel for a CUDA
one.

Nothing here runs at import time.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

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


# ---------------------------------------------------------------------------
# Loading, binding and launching


#: An exported function's declaration in a source's ``extern "C"`` block.
_EXPORT = re.compile(r"^(int|const char\*) (\w+)\(([^)]*)\)", re.MULTILINE)


@functools.lru_cache(maxsize=None)
def signatures(source: Path) -> dict[str, tuple]:
    """The functions ``source`` exports (its ``extern "C"`` block) by name:
    ``(restype, ((parameter, ctypes type), ...))``; a pointer is
    ``c_void_p``, a ``float`` ``c_float``, an ``int`` ``c_int``."""
    exports = Path(source).read_text().split('extern "C" {', 1)[1]
    out = {}
    for ret, name, params in _EXPORT.findall(exports):
        out[name] = (ctypes.c_int if ret == "int" else ctypes.c_char_p,
                     tuple((p.split()[-1].lstrip("*"),
                            ctypes.c_void_p if "*" in p
                            else ctypes.c_float if p.split()[0] == "float"
                            else ctypes.c_int) for p in params.split(",")))
    return out


def bind(library: Path, source: Path):
    """The shared library at ``library``, loaded, every function that
    ``source`` (the file it was built from) exports bound as declared."""
    lib = ctypes.CDLL(str(library))
    for name, (restype, params) in signatures(source).items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = [kind for _, kind in params]
    return lib


@functools.lru_cache(maxsize=None)
def load(source: str, pair: tuple[int, int] | None = None,
         dft_precision: str = "highest"):
    """``csrc/<source>``'s library for the median ``pair`` and
    ``dft_precision`` (:func:`build`), loaded and bound (:func:`bind`), at
    first use."""
    return bind(build(source, pair, dft_precision), CSRC / source)


def _error_string(lib, source: str, code: int) -> str:
    """``code`` as the library's ``<prefix>_error_string`` spells it."""
    name = next(n for n in signatures(CSRC / source)
                if n.endswith("_error_string"))
    return getattr(lib, name)(code).decode()


def _made_current(device: torch.device):
    """``device`` made current for a launch: a no-op context when it already
    is, else ``torch.cuda.device``."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


#: PyTorch's private raw-stream getter (the one its generated kernels
#: use), or None where this torch has none: a CPU-only build, or a release
#: that dropped it, where a launch then fails with a message naming it.
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(device: torch.device) -> int:
    """``device``'s current stream as a ``cudaStream_t`` (inside a CUDA
    graph's capture, the capture stream), by the raw getter: 0.4 us per
    call on an H100 host, against 8.7 through the ``torch.cuda.Stream``
    object."""
    if _RAW_STREAM is None:
        raise RuntimeError(
            f"torch {torch.__version__} has no "
            "torch._C._cuda_getCurrentRawStream, which the kernels' launch "
            "reads the current stream with")
    return _RAW_STREAM(device.index)


def launch(source: str, fn: str, device: torch.device, *args,
           pair: tuple[int, int] | None = None,
           dft_precision: str = "highest", name: str,
           detail=None) -> None:
    """Call the kernel ``fn`` of ``csrc/<source>``'s library for ``pair``
    and ``dft_precision`` (:func:`load`) with ``args`` (tensors as their
    data pointers, which the caller keeps alive) and the current stream of
    ``device``, made current for the call.  A non-zero return raises
    ``RuntimeError("<name> kernel launch failed<detail()>: <the library's
    error string>")``; ``detail``, None or a callable giving the shape's
    text, is called only then."""
    lib = load(source, pair, dft_precision)
    with _made_current(device):
        err = getattr(lib, fn)(*args, _stream(device))
    if err:
        raise RuntimeError(
            f"{name} kernel launch failed{detail() if detail else ''}: "
            + _error_string(lib, source, err))


def occupancy(source: str, fn: str, *args,
              pair: tuple[int, int] | None = None,
              dft_precision: str = "highest") -> int:
    """Blocks per SM from the occupancy query ``fn`` of ``csrc/<source>``'s
    library (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` on the
    current card), which returns a negative error code on failure."""
    lib = load(source, pair, dft_precision)
    n = getattr(lib, fn)(*args)
    if n < 0:
        raise RuntimeError("occupancy query failed: "
                           + _error_string(lib, source, -n))
    return n


def on_card(op: str, t: torch.Tensor) -> bool:
    """The ops' route for ``t``: False on the CPU (the plain version), True
    on CUDA (the kernel, which raises rather than fall back); any other
    device raises ``ValueError`` naming ``op``."""
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"{op}: unsupported device {t.device}")

"""PyTorch/CUDA port of ``sm_hpss_mtl_tpu`` for NVIDIA Hopper GPUs.

The layout mirrors the JAX package (``ops/``, ``models/``, ``eval/``,
``data/``, ``cli/``), so each module has a counterpart of the same name
there.  The JAX package is the reference the port is tested against; the
port imports neither it nor ``jax``.

Every TPU kernel of the JAX package becomes a CUDA kernel in ``csrc/``,
built with ``nvcc`` at first use.  A kernel wrapper takes the plain PyTorch
version only for a tensor on the CPU; a CUDA tensor launches the kernel or
raises.
"""

from .device import resolve_device

__all__ = ["resolve_device"]

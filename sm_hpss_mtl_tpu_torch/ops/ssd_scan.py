"""Mamba-2's scan (SSD) over a model call's positions: one hand-written
kernel (``csrc/ssd_scan.cu``) and its plain version.

For each slot and head, from the carried state ``S`` (``P x N``)::

    S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_tᵀ,    y_t = S_t C_t + D x_t

``x`` is ``(batch, L, H, P)``, ``B`` and ``C`` ``(batch, L, N)`` (one
group, shared by the heads), ``dt`` ``(batch, L, H)`` after its softplus,
``A`` (negative) and ``D`` ``(H,)``, the state ``(batch, H, P, N)``.
:func:`ssd_scan` returns ``y`` ``(batch, L, H, P)`` and the state after
the ``L`` positions; a state of None starts from zeros.

Route (``_nvcc.on_card``): on a CPU tensor :func:`ssd_scan_plain`, the
recurrence position by position; on CUDA the kernel, which computes it in
Mamba-2's chunked form (chunks of :data:`CHUNK` positions from the call's
first, the last one shorter where ``L`` is no multiple) and raises on what
it does not take: a head size other than 64 or a state size other than
128 (Granite-4.0-H's), a dtype other than float32, operands on other
devices, ``x``, ``B`` and ``C`` that are not rows of one stride with
contiguous elements (the mixer's conv output holds them side by side), or
``dt``, ``A``, ``D`` or the state not contiguous.

Counter (``utils.profiling.counters()``): ``ssd_scan.launches``, counted
at each launch (one a Mamba-2 layer and model call).

The kernel is built with ``nvcc`` at its first launch, not at import.
"""

from __future__ import annotations

import torch

from . import _nvcc
from ..utils import profiling

_SOURCE = "ssd_scan.cu"
#: The scan's chunk (Granite-4.0-H's ``mamba_chunk_size``).
CHUNK = 256
#: The head and state sizes the kernel is built for.
HEAD_DIM, STATE_DIM = 64, 128


def build() -> None:
    """Build and load the kernel's library now (else at first launch)."""
    _nvcc.load(_SOURCE)


def ssd_scan_plain(x, dt, A, B, C, D, state=None):
    """The recurrence, position by position, in float32."""
    batch, L, H, P = x.shape
    N = B.shape[-1]
    S = (x.new_zeros((batch, H, P, N)) if state is None
         else state.clone())
    y = x.new_empty((batch, L, H, P))
    decay = torch.exp(dt * A)                                # (batch, L, H)
    for t in range(L):
        u = (dt[:, t, :, None] * x[:, t])[..., None]          # (b, H, P, 1)
        S = S * decay[:, t, :, None, None] + u * B[:, t, None, None, :]
        y[:, t] = (S * C[:, t, None, None, :]).sum(-1) \
            + D[:, None] * x[:, t]
    return y, S


def _check(x, dt, A, B, C, D, state) -> int:
    """Raise on what the kernel does not take; the rows' stride."""
    batch, L, H, P = x.shape
    N = B.shape[-1]
    if (P, N) != (HEAD_DIM, STATE_DIM) or B.shape != (batch, L, N) \
            or C.shape != B.shape or dt.shape != (batch, L, H) \
            or A.shape != (H,) or D.shape != (H,) or (
                state is not None and state.shape != (batch, H, P, N)):
        raise ValueError("ssd_scan: shapes " + ", ".join(
            str(tuple(t.shape)) for t in (x, dt, A, B, C, D)
            + (() if state is None else (state,)))
            + f" (the kernel takes heads of {HEAD_DIM} and states of "
            f"{STATE_DIM})")
    tensors = [x, dt, A, B, C, D] + ([] if state is None else [state])
    if any(t.dtype != torch.float32 or t.device != x.device
           for t in tensors):
        raise TypeError("ssd_scan takes float32 operands on one device, got "
                        + ", ".join(f"{t.dtype} on {t.device}"
                                    for t in tensors))
    ld = x.stride(1)
    rows = all(t.stride(0) == L * ld and t.stride(1) == ld
               and t.stride(-1) == 1 for t in (x, B, C))
    if not rows or x.stride(2) != P or not all(
            t.is_contiguous() for t in tensors[1:3] + tensors[5:]):
        raise ValueError("ssd_scan: x, B and C must be rows of one stride "
                         "with contiguous elements, dt, A, D and the state "
                         "contiguous")
    return ld


def _launch(x, dt, A, B, C, D, state):
    ld = _check(x, dt, A, B, C, D, state)
    batch, L, H, P = x.shape
    N = B.shape[-1]
    y = torch.empty((batch, L, H, P), dtype=torch.float32, device=x.device)
    out = torch.empty((batch, H, P, N), dtype=torch.float32,
                      device=x.device)
    n_chunks = -(-L // CHUNK)
    cb = torch.empty((batch, n_chunks, CHUNK, CHUNK), dtype=torch.float32,
                     device=x.device)
    _nvcc.launch(_SOURCE, "ssd_scan_forward", x.device,
                 *(t.data_ptr() for t in (x, B, C, dt, A, D)),
                 None if state is None else state.data_ptr(),
                 *(t.data_ptr() for t in (y, out, cb)),
                 batch, L, H, ld, P, N, CHUNK, name="ssd_scan",
                 detail=lambda: f" at {(batch, L, H, P, N)}")
    profiling.count("ssd_scan.launches")
    return y, out


def ssd_scan(x, dt, A, B, C, D, state=None):
    """:func:`ssd_scan_plain`'s function: by the kernel on CUDA tensors,
    by the plain version on the CPU.  Returns ``(y, state)``."""
    if not _nvcc.on_card("ssd_scan", x):
        return ssd_scan_plain(x, dt, A, B, C, D, state)
    return _launch(x, dt, A, B, C, D, state)

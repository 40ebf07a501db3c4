"""The TCN residual block's pointwise chain: two hand-written kernels and
the backward of the first (``csrc/tcn_block.cu``), and their plain
versions.

``models/tcn.py::TCNResidualBlock`` runs dilated conv -> ReLU -> channel
max-abs normalisation -> spatial dropout -> 1x1 conv -> residual add.  On
the fused route the two convolutions run without their bias (cuDNN, as
before) and the rest is two kernels:

- :func:`forward_a`, after the dilated conv: ``relu(conv + b)``, divided by
  its channel max-abs plus 1e-5, then times the dropout mask and divided by
  keep in train mode;
- :func:`forward_b`, after the 1x1 conv: ``t = conv + b`` and ``x + t``,
  with ``t`` written only where the TCN sums the skip branches.

Their gradients are :class:`torch.autograd.Function`s: forward_a's is a
kernel (its saved state is the conv's output, the bias and the mask, which
exist already: it recomputes ``relu(conv + b)`` and the channel max);
forward_b's is its output gradient, passed on.  Each bias's gradient is a
sum in two reductions, accumulated in float32 (:func:`_bias_grad`).  The
forward kernels give the chain's bits (the same float operations in the
same order, rounded where PyTorch rounds them in bfloat16); the backward
computes in float32 and rounds once.

Route: the block decides it (``TCNResidualBlock.forward``): a CUDA block
takes :func:`forward_a` and :func:`forward_b`, which launch the kernels
and raise on what they do not take (a dtype other than float32 and
bfloat16, or operands of mixed dtypes); any other keeps the chain.  The
Functions have ``vmap`` rules, so ``torch.func`` transforms reach the
kernels too: the vmapped multi-trial step (``train/multitrial.py``,
``vmap`` over ``grad``) folds its trial axis into the items, and each
trial's items read their own bias row (a ``(G, C)`` bias, G rows for the
items in order).  The chain (``channel_normalization`` and the layers' own
forwards) is the plain version; :func:`forward_a_plain`,
:func:`forward_b_plain` and :func:`backward_a_plain` write it out per
kernel, and the CPU tests and ``chip_smoke.py`` hold the kernels to
them.

Counters (``utils.profiling.counters()``): ``tcn_block.launches`` and
``tcn_block.launches_by_kernel.<forward_a|forward_b|backward_a>``, counted
at each launch; a backward launched on autograd's thread counts into what
its forward's thread collects (``profiling.counting``), so a CUDA graph's
replays count the launches its capture made, backward ones included.

The kernels are built with ``nvcc`` at their first launch, not at import.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _nvcc
from ..utils import profiling

_SOURCE = "tcn_block.cu"
#: The storage types the kernels take, by their C flag.
_BF16_FLAG = {torch.float32: 0, torch.bfloat16: 1}
#: channel_normalization's epsilon (keras-tcn's).
NORM_EPS = 1e-5


def build() -> None:
    """Build and load the kernels' library now (else at first launch)."""
    _nvcc.load(_SOURCE)


@functools.lru_cache(maxsize=None)
def inv_keep(keep: float) -> float:
    """``1 / keep`` as PyTorch's CUDA division by a Python float computes
    it: the reciprocal in double, rounded to float32 (a division of float32
    tensors by 0.725 on an H100, torch 2.11, is a product by exactly this
    number, and neither by the reciprocal of float32(0.725) nor a true
    division)."""
    return float(np.float32(1.0 / keep))


# ---------------------------------------------------------------------------
# Plain versions: the chain


def channel_normalization(x: torch.Tensor) -> torch.Tensor:
    """Per-timestep max-abs channel normalisation of ``(B, C, T)``
    (keras-tcn 'norm_relu'): ``x / (max_c |x| + 1e-5)``, in x's dtype."""
    return x / (x.abs().amax(dim=1, keepdim=True) + NORM_EPS)


def _bias(bias: torch.Tensor, items: int) -> torch.Tensor:
    """A ``(C,)`` bias, or a ``(G, C)`` one (a row for each ``items // G``
    consecutive items), as a term of ``(items, C, T)``."""
    if bias.ndim == 1:
        return bias.view(-1, 1)
    return bias.repeat_interleave(items // bias.shape[0], dim=0)[..., None]


def forward_a_plain(conv: torch.Tensor, bias: torch.Tensor,
                    mask: torch.Tensor | None, keep: float) -> torch.Tensor:
    """The chain after the dilated conv's product: ``(B, C, T)`` ->
    ``dropout(channel_normalization(relu(conv + b)))``; ``bias`` ``(C,)``
    or ``(G, C)`` (:func:`_bias`), ``mask`` ``(B, C, 1)`` or None (no
    dropout)."""
    y = channel_normalization(torch.relu(conv + _bias(bias, len(conv))))
    return y if mask is None else y * mask / keep


def forward_b_plain(x: torch.Tensor, conv: torch.Tensor, bias: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The chain after the 1x1 conv's product: ``(x + t, t)`` with ``t =
    conv + b``."""
    t = conv + _bias(bias, len(conv))
    return x + t, t


def backward_a_plain(grad: torch.Tensor, conv: torch.Tensor,
                     bias: torch.Tensor, mask: torch.Tensor | None,
                     keep: float) -> torch.Tensor:
    """The gradient of ``conv + b`` through :func:`forward_a_plain`, in
    closed form, computed in float32 (float64 for float64) from the
    forward's values and returned in grad's dtype: with ``y = relu(conv +
    b)``, ``a = max_c y``, ``m = a + 1e-5``, ``g = grad * (1/keep) *
    mask``, it is ``g / m - [y == a] * sum_c(g * y / m / m) / #{y == a}``
    where ``y > 0``, and 0 elsewhere."""
    y = torch.relu(conv + _bias(bias, len(conv)))
    m = y.abs().amax(dim=1, keepdim=True) + NORM_EPS
    f = torch.promote_types(grad.dtype, torch.float32)
    y, m, g = y.to(f), m.to(f), grad.to(f)
    if mask is not None:
        g = g * inv_keep(keep) * mask.to(f)
    a = y.amax(dim=1, keepdim=True)
    ties = y == a
    share = -(g * (y / m / m)).sum(dim=1, keepdim=True) \
        / ties.sum(dim=1, keepdim=True)
    gy = g / m + torch.where(ties, share, 0.0)
    return torch.where(y > 0, gy, 0.0).to(grad.dtype)


# ---------------------------------------------------------------------------
# Kernels


def _check(name: str, conv: torch.Tensor, bias: torch.Tensor,
           mask: torch.Tensor | None, *more: torch.Tensor) -> None:
    """Raise on what the kernels do not take: ``conv`` (and ``more``)
    ``(B, C, T)``, ``bias`` ``(C,)`` or ``(G, C)`` with G dividing B,
    ``mask`` ``(B, C, 1)`` or None, all float32 or all bfloat16, on one
    device."""
    rows = bias.shape[0] if bias.ndim == 2 else 1
    if conv.ndim != 3 or bias.shape[-1:] != conv.shape[1:2] \
            or bias.ndim not in (1, 2) or conv.shape[0] % rows or any(
            t.shape != conv.shape for t in more) or (
            mask is not None and mask.shape != conv.shape[:2] + (1,)):
        raise ValueError(
            f"tcn_block {name}: shapes " + ", ".join(
                str(tuple(t.shape)) for t in (conv, bias, mask, *more)
                if t is not None))
    tensors = [t for t in (conv, bias, mask, *more) if t is not None]
    if conv.dtype not in _BF16_FLAG:
        raise TypeError(f"tcn_block {name} takes float32 or bfloat16, got "
                        f"{conv.dtype}")
    for t in tensors:
        if t.dtype != conv.dtype or t.device != conv.device:
            raise TypeError(f"tcn_block {name}: operands of one dtype and "
                            "device, got " + ", ".join(
                                f"{u.dtype} on {u.device}" for u in tensors))


def _inv_keep(mask: torch.Tensor | None, keep: float) -> float:
    """The kernels' ``inv_keep``, which they read only with a mask."""
    return 1.0 if mask is None else inv_keep(keep)


def _run(kernel: str, conv: torch.Tensor, bias: torch.Tensor,
         tensors: tuple, numbers: tuple, sink: dict | None = None) -> None:
    """Launch ``tcn_<kernel>`` over ``conv``'s shape: its tensors'
    pointers (None for null), the shape, ``bias``'s rows and the storage
    flag, then ``numbers``; count it (and into ``sink``,
    :func:`utils.profiling.count`)."""
    B, C, T = conv.shape
    _nvcc.launch(_SOURCE, f"tcn_{kernel}", conv.device,
                 *(None if t is None else t.data_ptr() for t in tensors),
                 B, C, T, bias.numel() // C, _BF16_FLAG[conv.dtype],
                 *numbers, name=f"tcn_block {kernel}",
                 detail=lambda: f" at {(B, C, T)}")
    profiling.count("tcn_block.launches", sink=sink)
    profiling.count(f"tcn_block.launches_by_kernel.{kernel}", sink=sink)


def _launch_a(conv, bias, mask, keep) -> torch.Tensor:
    _check("forward_a", conv, bias, mask)
    out = torch.empty_like(conv)
    if out.numel():
        _run("forward_a", conv, bias, (conv, bias, mask, out),
             (_inv_keep(mask, keep),))
    return out


def _launch_b(x, conv, bias, skip: bool):
    _check("forward_b", conv, bias, None, x)
    out = torch.empty_like(conv)
    t = torch.empty_like(conv) if skip else None
    if out.numel():
        _run("forward_b", conv, bias, (x, conv, bias, out, t), ())
    return out, t


def _launch_backward_a(grad, conv, bias, mask, keep, sink) -> torch.Tensor:
    _check("backward_a", conv, bias, mask, grad)
    out = torch.empty_like(conv)
    if out.numel():
        _run("backward_a", conv, bias, (grad, conv, bias, mask, out),
             (_inv_keep(mask, keep),), sink)
    return out


def _bias_grad(g: torch.Tensor, shape: torch.Size) -> torch.Tensor:
    """The gradient of a bias of ``shape``, ``(C,)`` or ``(G, C)``
    (:func:`_bias`): the sum of ``g`` ``(B, C, T)`` over time, then over
    the items of each row, accumulated in float32 and rounded once to g's
    dtype (two reductions of 2.1 and 3.8 us on an H100 at 36 x 32 x 68,
    against 12.4 us for PyTorch's one strided reduction over both)."""
    s = g.sum(dim=2, dtype=torch.float32)
    rows = shape[0] if len(shape) == 2 else 1
    return s.reshape(rows, -1, s.shape[-1]).sum(dim=1).reshape(shape).to(
        g.dtype)


# Under torch.func.vmap the Functions' vmap rules fold the vmapped axis into
# the items and call the kernels once.

def _fold(t: torch.Tensor | None, dim: int | None, n: int):
    """``t`` ``(B, ...)`` of each of ``n`` trials (its trial axis at
    ``dim``, None where every trial shares it) as ``(n * B, ...)``."""
    if t is None:
        return None
    t = t.expand(n, *t.shape) if dim is None else t.movedim(dim, 0)
    return t.reshape(-1, *t.shape[2:]).contiguous()


def _fold_bias(bias: torch.Tensor, dim: int | None, n: int) -> torch.Tensor:
    """A bias ``(C,)`` or ``(G, C)`` of each of ``n`` trials as the
    ``(n * G, C)`` bias of the folded items."""
    b = bias.expand(n, *bias.shape) if dim is None else bias.movedim(dim, 0)
    return b.reshape(-1, b.shape[-1]).contiguous()


def _unfold(t: torch.Tensor | None, n: int):
    return None if t is None else t.view(n, -1, *t.shape[1:])


class _ForwardA(torch.autograd.Function):
    @staticmethod
    def forward(conv, bias, mask, keep):
        return _launch_a(conv, bias, mask, keep)

    @staticmethod
    def setup_context(ctx, inputs, output):
        conv, bias, mask, keep = inputs
        ctx.save_for_backward(conv, bias, mask)
        ctx.keep = keep
        ctx.sink = profiling.counting()

    @staticmethod
    def backward(ctx, grad):
        conv, bias, mask = ctx.saved_tensors
        g = _BackwardA.apply(grad.contiguous(), conv, bias, mask, ctx.keep,
                             ctx.sink)
        gb = _bias_grad(g, bias.shape) if ctx.needs_input_grad[1] else None
        return g, gb, None, None

    @staticmethod
    def vmap(info, in_dims, conv, bias, mask, keep):
        n = info.batch_size
        out = forward_a(_fold(conv, in_dims[0], n),
                        _fold_bias(bias, in_dims[1], n),
                        _fold(mask, in_dims[2], n), keep)
        return _unfold(out, n), 0


class _BackwardA(torch.autograd.Function):
    """The backward kernel as an operation of its own, which a transform
    (``vmap``) reaches through its rule; it has no gradient of its own."""

    @staticmethod
    def forward(grad, conv, bias, mask, keep, sink):
        return _launch_backward_a(grad, conv, bias, mask, keep, sink)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "tcn_block: the backward of forward_a has no gradient")

    @staticmethod
    def vmap(info, in_dims, grad, conv, bias, mask, keep, sink):
        n = info.batch_size
        out = _BackwardA.apply(_fold(grad, in_dims[0], n),
                               _fold(conv, in_dims[1], n),
                               _fold_bias(bias, in_dims[2], n),
                               _fold(mask, in_dims[3], n), keep, sink)
        return _unfold(out, n), 0


class _ForwardB(torch.autograd.Function):
    @staticmethod
    def forward(x, conv, bias, skip):
        out, t = _launch_b(x, conv, bias, skip)
        return (out, t) if skip else out

    @staticmethod
    def setup_context(ctx, inputs, output):
        # An unused output's gradient stays None (the last block's output
        # where the TCN sums the skip branches), not a tensor of zeros.
        ctx.set_materialize_grads(False)
        ctx.bias_shape = inputs[2].shape

    @staticmethod
    def backward(ctx, grad, grad_t=None):
        g = grad if grad_t is None else grad_t if grad is None \
            else grad + grad_t
        gb = None
        if g is not None and ctx.needs_input_grad[2]:
            gb = _bias_grad(g, ctx.bias_shape)
        return grad, g, gb, None

    @staticmethod
    def vmap(info, in_dims, x, conv, bias, skip):
        n = info.batch_size
        out, t = forward_b(_fold(x, in_dims[0], n),
                           _fold(conv, in_dims[1], n),
                           _fold_bias(bias, in_dims[2], n), skip)
        if skip:
            return (_unfold(out, n), _unfold(t, n)), (0, 0)
        return _unfold(out, n), 0


def _through_function(*tensors) -> bool:
    """Whether a call takes its Function: under autograd, or under a
    ``torch.func`` transform (whose ``vmap`` reaches the Function's rule)."""
    return (torch.is_grad_enabled() and any(t.requires_grad
                                            for t in tensors)) \
        or torch._C._functorch.peek_interpreter_stack() is not None


def forward_a(conv: torch.Tensor, bias: torch.Tensor,
              mask: torch.Tensor | None, keep: float) -> torch.Tensor:
    """:func:`forward_a_plain`'s function by the kernel (under autograd
    its Function, whose backward is the backward kernel), on CUDA tensors.
    ``conv`` ``(B, C, T)``, ``bias`` ``(C,)`` or ``(G, C)`` and ``mask``
    ``(B, C, 1)`` (or None) of one dtype."""
    conv = conv.contiguous()
    mask = None if mask is None else mask.contiguous()
    if _through_function(conv, bias):
        return _ForwardA.apply(conv, bias, mask, keep)
    return _launch_a(conv, bias, mask, keep)


def forward_b(x: torch.Tensor, conv: torch.Tensor, bias: torch.Tensor,
              skip: bool) -> tuple[torch.Tensor, torch.Tensor | None]:
    """:func:`forward_b_plain`'s ``(x + t, t)`` by the kernel, on CUDA
    tensors, with ``t`` None unless ``skip``."""
    x, conv = x.contiguous(), conv.contiguous()
    if _through_function(x, conv, bias):
        res = _ForwardB.apply(x, conv, bias, skip)
        return res if skip else (res, None)
    return _launch_b(x, conv, bias, skip)

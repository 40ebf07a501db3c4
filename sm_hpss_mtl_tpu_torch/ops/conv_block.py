"""The tail of Jang's conv block at inference: one hand-written kernel
(``csrc/conv_block.cu``) and its plain version.

``models/jang.py::_ConvBlock`` runs Conv 3x3 -> BatchNorm -> ReLU ->
Dropout -> max pool 2x2/2.  At inference the dropout is the identity and
BatchNorm reads its running statistics, so everything after the product is
one pass: :func:`conv_block` takes the convolution's product without its
bias (cuDNN's, as before) and the bias, and writes only the pooled float32
result.  The kernel gives the chain's bits: it adds the bias as
``Conv2d.forward`` does (rounded to bfloat16 in a bfloat16 compute dtype),
promotes the sum to float32 as ``BatchNorm2d`` does, and computes BatchNorm,
ReLU and the pool with the float operations of PyTorch's CUDA path.

Route: the block decides it (``_ConvBlock.forward``): in eval mode, with
no gradient recorded and on CUDA, :func:`conv_block`; else the chain.
:func:`conv_block` launches the kernel on a CUDA tensor and raises on what
it does not take (a dtype other than float32 and bfloat16, operands of
mixed dtypes or devices, a non-contiguous operand); on a CPU tensor it runs
:func:`conv_block_plain`, the chain written out, which the CPU tests and
``chip_smoke.py`` hold the kernel to.  Under ``torch.func.vmap`` (the
multi-trial evaluation step, ``train/multitrial.py``) a Function's ``vmap``
rule folds the trial axis into the items, and each trial's items read their
own row of ``(G, C)`` bias and BatchNorm parameters.

Counters (``utils.profiling.counters()``): ``conv_block.launches`` and
``conv_block.launches_by_pool.<same|valid>``, counted at each launch (three
a Jang-MTL model call).

The kernel is built with ``nvcc`` at its first launch, not at import.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _nvcc
from .tcn_block import _fold, _fold_bias, _unfold
from ..models.pool import _pad_amount, max_pool
from ..utils import profiling

_SOURCE = "conv_block.cu"
#: The product's storage types, by the kernel's flag.
_BF16_FLAG = {torch.float32: 0, torch.bfloat16: 1}
#: The pool's window and stride on each axis.
POOL = (2, 2)


def build() -> None:
    """Build and load the kernel's library now (else at first launch)."""
    _nvcc.load(_SOURCE)


def pooled_size(size: int, padding: str) -> int:
    """Length of an axis after the 2/2 max pool (``models/pool.py``'s
    padding: ceil for 'SAME', floor for 'VALID')."""
    lo, hi = _pad_amount(size, 2, 2, padding)
    return (size + lo + hi - 2) // 2 + 1


def conv_block_plain(conv: torch.Tensor, bias: torch.Tensor, bn,
                     padding: str) -> torch.Tensor:
    """The chain after the product, written out: ``conv`` ``(B, C, H, W)``
    plus ``bias`` ``(C,)`` in conv's dtype, promoted to BatchNorm's
    parameter type, BatchNorm ``bn`` in eval form, ReLU, then the 2x2/2 max
    pool with ``padding``."""
    t = conv + bias.view(-1, 1, 1)
    t = t.to(torch.promote_types(t.dtype, bn.weight.dtype))
    y = F.batch_norm(t, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                     False, 0.0, bn.eps)
    return max_pool(torch.relu(y), POOL, POOL, padding)


def _check(conv: torch.Tensor, bias: torch.Tensor, *params: torch.Tensor,
           padding: str) -> None:
    """Raise on what the kernel does not take: ``conv`` ``(B, C, H, W)``,
    float32 or bfloat16; ``bias`` of its dtype and BatchNorm's ``params``
    in float32, each ``(C,)`` or all ``(G, C)`` with G dividing B; every
    operand contiguous and on conv's device; ``padding`` 'SAME' or
    'VALID'."""
    if padding not in ("SAME", "VALID"):
        raise ValueError(f"conv_block: padding must be 'SAME' or 'VALID', "
                         f"got {padding!r}")
    shapes = {t.shape for t in (bias, *params)}
    rows = bias.shape[0] if bias.ndim == 2 else 1
    if conv.ndim != 4 or len(shapes) != 1 or bias.ndim not in (1, 2) \
            or bias.shape[-1] != conv.shape[1] or conv.shape[0] % rows:
        raise ValueError("conv_block: shapes " + ", ".join(
            str(tuple(t.shape)) for t in (conv, bias, *params)))
    if conv.dtype not in _BF16_FLAG:
        raise TypeError(f"conv_block takes float32 or bfloat16, got "
                        f"{conv.dtype}")
    tensors = (conv, bias, *params)
    if bias.dtype != conv.dtype or any(t.dtype != torch.float32
                                       for t in params) \
            or any(t.device != conv.device for t in tensors):
        raise TypeError("conv_block: a product and bias of one dtype and "
                        "BatchNorm's parameters in float32, on one device, "
                        "got " + ", ".join(f"{t.dtype} on {t.device}"
                                           for t in tensors))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("conv_block: operands must be contiguous")


def _launch(conv, bias, mean, var, weight, shift, eps: float,
            padding: str) -> torch.Tensor:
    _check(conv, bias, mean, var, weight, shift, padding=padding)
    B, C, H, W = conv.shape
    Ho, Wo = pooled_size(H, padding), pooled_size(W, padding)
    out = torch.empty((B, C, Ho, Wo), dtype=torch.float32,
                      device=conv.device)
    if out.numel():
        _nvcc.launch(_SOURCE, "conv_block_forward", conv.device,
                     *(t.data_ptr() for t in (conv, bias, mean, var, weight,
                                              shift, out)),
                     B, C, H, W, Ho, Wo, bias.numel() // C,
                     _BF16_FLAG[conv.dtype], eps, name="conv_block",
                     detail=lambda: f" at {(B, C, H, W)}")
        profiling.count("conv_block.launches")
        profiling.count(f"conv_block.launches_by_pool.{padding.lower()}")
    return out


class _Kernel(torch.autograd.Function):
    """The kernel as an operation of its own, which ``vmap`` reaches
    through its rule; an inference kernel, it has no gradient."""

    @staticmethod
    def forward(conv, bias, mean, var, weight, shift, eps, padding):
        return _launch(conv, bias, mean, var, weight, shift, eps, padding)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError("conv_block: an inference kernel has no "
                                  "gradient")

    @staticmethod
    def vmap(info, in_dims, conv, bias, mean, var, weight, shift, eps,
             padding):
        n = info.batch_size
        params = [_fold_bias(t, d, n) for t, d in
                  zip((bias, mean, var, weight, shift), in_dims[1:6])]
        out = _run(_fold(conv, in_dims[0], n), *params, eps, padding)
        return _unfold(out, n), 0


def _run(conv, bias, mean, var, weight, shift, eps, padding):
    """The kernel on the operands, through its Function under a
    ``torch.func`` transform."""
    if torch._C._functorch.peek_interpreter_stack() is not None:
        return _Kernel.apply(conv, bias, mean, var, weight, shift, eps,
                             padding)
    return _launch(conv, bias, mean, var, weight, shift, eps, padding)


def conv_block(conv: torch.Tensor, bias: torch.Tensor, bn,
               padding: str) -> torch.Tensor:
    """:func:`conv_block_plain`'s function: by the kernel on CUDA tensors,
    by the plain version on the CPU.  ``bn`` is an eval-mode BatchNorm2d
    (its running statistics, weight, shift and eps are read)."""
    if not _nvcc.on_card("conv_block", conv):
        return conv_block_plain(conv, bias, bn, padding)
    return _run(conv, bias, bn.running_mean, bn.running_var, bn.weight,
                bn.bias, bn.eps, padding)

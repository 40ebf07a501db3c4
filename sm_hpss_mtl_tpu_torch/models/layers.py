"""Keras-semantics BatchNorm and dropout for training the ported models,
and flax's compute-dtype rule for the dense and convolution layers.

flax's ``nn.BatchNorm`` (Keras's too) moves its running variance towards
the *biased* batch variance; torch's ``nn.BatchNorm1d``/``2d`` move it
towards the unbiased one, which drifts by ``n/(n-1)`` on every update.
:class:`BatchNorm1d` and :class:`BatchNorm2d` subclass torch's, so state_dict
keys and ``isinstance`` checks stay, and differ only in train mode: they
normalise with the batch statistics and update the running ones with the
biased variance.  Eval mode is torch's, unchanged.  With a process group
set (:func:`use_process_group`, the data-parallel step of
``parallel/dp.py``), train mode takes the mean and the biased variance over
the group's global batch, with gradients through the reduction, and moves
the running statistics by them, as flax's BatchNorm under GSPMD reduces
over the global batch.  Not ``nn.SyncBatchNorm``: its running variance is
the unbiased one, and it does not promote bfloat16 inputs.

Dropout draws from an explicit ``torch.Generator`` on the activations'
device, set on the module by :func:`use_generator` (the train steps call
it), never from torch's global RNG: a training run is then a function of
its seeds.  In train mode a dropout with no generator raises.  The
multi-trial step (``train.multitrial``), whose vmapped forward cannot draw
from a generator, draws each trial's masks beforehand and hands them to
the layers through ``Dropout.feed``.

Mixed precision follows flax's dtype promotion, layer by layer, with the
parameters kept in float32 (``models.zoo.get_model(dtype=torch.bfloat16)``):
a :class:`Linear`, :class:`Conv1d` or :class:`Conv2d` built with
``compute_dtype`` (flax's ``dtype=``) casts its input, kernel and bias to it
and returns it; one built without promotes its input and parameters to
their common type, so a bfloat16 input meets float32 parameters in
float32.  A BatchNorm has no compute dtype in flax: it promotes too, so
bfloat16 activations come out of it in float32, with float32 statistics.
No ``torch.autocast``: its list of operators is not flax's.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn


class _Compute:
    """flax's dtype rule for a dense or convolution layer (module doc).  In
    a reduced compute dtype the bias is added after the product, as flax
    adds it, so that the output is rounded where flax's is."""

    def __init__(self, *args, compute_dtype: torch.dtype | None = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def dtype_for(self, x: torch.Tensor) -> torch.dtype:
        """The dtype the layer computes ``x`` in."""
        return self.compute_dtype or torch.promote_types(x.dtype,
                                                         self.weight.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.dtype_for(x) == self.weight.dtype:
            return super().forward(x)
        y, b = self.parts(x)
        return y + b.view(-1, *(1,) * (y.ndim - 2))

    def parts(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The product without its bias, and the bias, both in the compute
        dtype: ``forward`` adds them (a caller may add them in a kernel of
        its own, ``ops.tcn_block``)."""
        dtype = self.dtype_for(x)
        if x.dtype == dtype == self.weight.dtype:
            return self._product(x, self.weight), self.bias
        x, w, b = x.to(dtype), self.weight.to(dtype), self.bias.to(dtype)
        if x.is_cpu and dtype.itemsize < 4:
            # On the CPU the product runs in float32 on the rounded operands
            # and is rounded once, as XLA:CPU computes a bf16 product: the
            # same bf16 compute with float32 accumulation.  (oneDNN's bf16
            # convolution returns NaN at some geometries, such as a
            # stride-2 3x3 kernel over 4 columns, in torch 2.13.)
            return self._product(x.float(), w.float()).to(dtype), b
        return self._product(x, w), b


class Linear(_Compute, nn.Linear):
    def _product(self, x, w):
        return F.linear(x, w)


class Conv1d(_Compute, nn.Conv1d):
    def _product(self, x, w):
        return self._conv_forward(x, w, None)


class Conv2d(_Compute, nn.Conv2d):
    def _product(self, x, w):
        return self._conv_forward(x, w, None)


class _AllReduceSum(torch.autograd.Function):
    """Sum over a process group; the gradient is summed the same way (each
    process's share of the global statistics feeds every process's
    loss)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _BiasedRunningVariance:
    """Train-mode forward shared by the two BatchNorm classes.  The input
    is promoted to the parameters' type first (float32 for bfloat16
    activations), in both modes."""

    #: The process group whose global batch train mode normalises over
    #: (:func:`use_process_group`); None for this process's batch.
    process_group = None
    sync = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, self.weight.dtype))
        if not self.training:
            return super().forward(x)
        dims = [0] + list(range(2, x.ndim))
        if self.sync:
            return self._global_batch(x, dims)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=dims, correction=0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)

    def _global_batch(self, x: torch.Tensor, dims: list) -> torch.Tensor:
        """Normalise by the group's global mean and biased variance (two
        passes, each one reduction over the group)."""
        group = self.process_group
        shape = [1, -1] + [1] * (x.ndim - 2)
        count = torch.tensor([x.numel() / x.shape[1]], dtype=x.dtype,
                             device=x.device)
        sums = _AllReduceSum.apply(torch.cat([x.sum(dims), count]), group)
        mean = sums[:-1] / sums[-1].detach()
        xc = x - mean.view(shape)
        var = _AllReduceSum.apply(xc.square().sum(dims), group) \
            / sums[-1].detach()
        with torch.no_grad():
            self.running_mean.lerp_(mean.detach(), self.momentum)
            self.running_var.lerp_(var.detach(), self.momentum)
            self.num_batches_tracked.add_(1)
        return (xc * torch.rsqrt(var + self.eps).view(shape)
                * self.weight.view(shape) + self.bias.view(shape))


class BatchNorm1d(_BiasedRunningVariance, nn.BatchNorm1d):
    pass


class BatchNorm2d(_BiasedRunningVariance, nn.BatchNorm2d):
    pass


def use_process_group(model: nn.Module, group=None) -> nn.Module:
    """Make ``model``'s BatchNorm layers take their train-mode statistics
    over the global batch of process group ``group`` (None: the default
    group, which must be initialized).  Returns ``model``."""
    for m in model.modules():
        if isinstance(m, _BiasedRunningVariance):
            m.process_group = group
            m.sync = True
    return model


class Dropout(nn.Module):
    """Inverted dropout with keep probability ``1 - rate``: elementwise, or
    with ``spatial`` one draw per (item, channel) of ``(B, C, T)``, shared
    across time (Keras SpatialDropout1D).  The identity in eval mode."""

    def __init__(self, rate: float, spatial: bool = False):
        super().__init__()
        self.rate = rate
        self.spatial = spatial
        self.generator: torch.Generator | None = None
        #: Masks drawn elsewhere (``train.multitrial``): an object whose
        #: ``pop()`` returns this call's mask, or None for a mask of ones.
        self.feed = None

    @property
    def keep(self) -> float:
        return 1.0 - self.rate

    def mask(self, x: torch.Tensor) -> torch.Tensor | None:
        """This call's mask for ``x`` (over ``(B, C, 1)`` where spatial),
        drawn or fed, in x's dtype; None where the layer is the identity.
        ``forward`` multiplies by it and divides by :attr:`keep` (the TCN
        block's kernel does both itself)."""
        if not self.training or self.rate == 0.0:
            return None
        shape = x.shape[:-1] + (1,) if self.spatial else x.shape
        if self.feed is not None:
            mask = self.feed.pop()
            return x.new_ones(shape) if mask is None else mask
        if self.generator is None:
            raise RuntimeError(
                "dropout in train mode draws from an explicit generator: "
                "set one with models.layers.use_generator (the train steps "
                "take it as generator=)")
        return torch.empty(shape, device=x.device, dtype=x.dtype).bernoulli_(
            self.keep, generator=self.generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mask = self.mask(x)
        return x if mask is None else x * mask / self.keep


def use_generator(model: nn.Module, generator: torch.Generator) -> None:
    """Make every dropout of ``model`` draw from ``generator``."""
    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.generator = generator

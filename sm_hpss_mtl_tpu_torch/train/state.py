"""Train state and the train, eval and predict steps (counterpart of
``sm_hpss_mtl_tpu/train/state.py``).

A train step is forward, loss, backward, the optimizer update and the
BatchNorm running-statistics update, on the batch's device.  Randomness
(dropout, the noise augmentation) draws from one explicit
``torch.Generator`` on that device.  Metrics stay on the device as 0-d
tensors: the caller decides when to fetch them (``train.loop`` does so
once per epoch).

On CUDA the train step runs as CUDA graphs once its shapes settle
(:class:`StepGraphs`): the same kernels on the same data, launched by four
graph replays instead of one Python and autograd dispatch per kernel.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn

from ..models.layers import use_generator
from ..utils.profiling import count, counted, request, span
from .losses import categorical_crossentropy, mtl_loss


@dataclass
class TrainState:
    """The module (parameters and BatchNorm statistics), its optimizer,
    and the number of train steps taken."""
    module: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


#: Gaussian augmentation scales (the reference's noise augmentation).
NOISE_SCALES = (5e-3, 1e-3, 5e-4, 1e-4)


@functools.lru_cache(maxsize=8)
def _scales_on(device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.tensor(NOISE_SCALES, device=device, dtype=dtype)


def _first(batch) -> torch.Tensor:
    """A batch's tensor, or the first input of a dict batch."""
    return next(iter(batch.values())) if isinstance(batch, dict) else batch


def augment(batch, generator: torch.Generator):
    """The reference's noise augmentation on the device: one scale drawn
    from :data:`NOISE_SCALES` per step, then Gaussian noise over the whole
    batch, both from ``generator`` (no host round trip).  A dict batch (the
    intermediate-fusion model's two inputs) takes the one scale and its
    own noise per input, in sorted key order, as the JAX ``_augment``."""
    first = _first(batch)
    scales = _scales_on(first.device, first.dtype)
    i = torch.randint(len(NOISE_SCALES), (1,), generator=generator,
                      device=first.device)
    # A gather, not scales[i]: indexing by a device scalar reads it on the
    # host.
    scale = scales.index_select(0, i).reshape(())

    def leaf(x):
        noise = torch.randn(x.shape, generator=generator, device=x.device,
                            dtype=x.dtype)
        return x + scale * noise

    if isinstance(batch, dict):
        return {k: leaf(v) for k, v in sorted(batch.items())}
    return leaf(batch)


def l2_kernels(model: nn.Module) -> list[torch.Tensor]:
    """The parameters the JAX step regularizes: flax ``kernel`` leaves
    whose path holds ``heads`` or ``melCl``.  A flax kernel is a dense or
    convolution weight, or a parameter named ``kernel`` (Jang's mel-scale
    layers); a BatchNorm's ``weight`` is flax's ``scale``, no kernel."""
    out = []
    for name, p in model.named_parameters():
        *path, leaf = name.split(".")
        mod = model.get_submodule(".".join(path))
        is_kernel = leaf == "kernel" or (
            leaf == "weight"
            and not isinstance(mod, nn.modules.batchnorm._BatchNorm))
        if is_kernel and any("heads" in q or "melCl" in q for q in path):
            out.append(p)
    return out


def _accuracy(out: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    return (out.argmax(-1) == onehot.argmax(-1)).float().mean()


def _losses(outputs, labels, mtl: bool, loss_weights: dict | None):
    if mtl:
        return mtl_loss(outputs, labels, loss_weights)
    total = categorical_crossentropy(outputs, labels)
    return total, {"3C": total}


#: Eager steps, on a side stream, before a train step is captured: they
#: make the optimizer's state and set up cuBLAS and cuDNN, as capture needs.
WARMUP_STEPS = 2


def graphable(device: torch.device, optimizer: torch.optim.Optimizer,
              before_update: Callable | None) -> bool:
    """Whether a train step on ``device`` may run as CUDA graphs (else it
    stays eager whatever its shapes): the batch is on CUDA, nothing runs
    between the backward pass and the update (``parallel.dp``'s
    all-reduce), and the optimizer keeps its whole schedule on the device
    (``schedule_on_device``: :class:`..optimizers.KerasSGD`; Adam and a
    ``LambdaLR`` keep the step or the learning rate on the host)."""
    return (device.type == "cuda" and before_update is None
            and getattr(optimizer, "schedule_on_device", False))


def _items(tree) -> list:
    """``(key, tensor)`` of a dict in its order, or ``[(None, tensor)]``."""
    return list(tree.items()) if isinstance(tree, dict) else [(None, tree)]


def signature(batch, labels) -> tuple:
    """The keys, shapes, dtypes and devices of a step's inputs."""
    return tuple((k, tuple(t.shape), t.dtype, t.device)
                 for tree in (batch, labels) for k, t in _items(tree))


class StepGraphs:
    """When a train step runs as CUDA graphs, and the graphs.

    :meth:`mode` decides each call from what it observes: ``'eager'`` for
    a step :func:`graphable` refuses or whose :func:`signature` is not
    the first call's (no second capture is made); else ``'warm'`` for the
    first :data:`WARMUP_STEPS`, ``'capture'`` for the next and
    ``'replay'`` after it, as long as the parameters, buffers and
    optimizer-state tensors are the ones captured (checked each call;
    ``optimizer.load_state_dict`` replaces the state's tensors, and the
    step then warms up and captures again).

    A capture is four graphs in one memory pool, replayed in capture
    order: ``featurize`` (the featurizer and the augmentation, on static
    copies of the inputs), ``forward`` (the forward pass, the losses, the
    L2 term and the metrics), ``backward`` (the gradients, into static
    ``.grad`` tensors) and ``update`` (the optimizer).  Each graph is
    registered with the step's generator, so its replays draw what the
    eager step draws, at the same offsets, and advance the generator as
    far.  Capture runs no kernel: the capturing call then replays."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 before_update: Callable | None = None):
        self.model, self.optimizer = model, optimizer
        self.before_update = before_update
        self.sig = None
        self.warm = 0
        self.held: list | None = None
        #: The current capture (:class:`Captured`), and the side stream
        #: the warm-up steps and the captures run on.
        self.captured = None
        self.stream = None

    def tensors(self) -> list:
        """The parameters, buffers and optimizer-state tensors."""
        out = []
        for p in self.model.parameters():
            out.append(p)
            out.extend(v for v in self.optimizer.state.get(p, {}).values()
                       if torch.is_tensor(v))
        out.extend(self.model.buffers())
        return out

    def _holds(self) -> bool:
        now = self.tensors()
        return len(now) == len(self.held) and all(
            a is b and a.data_ptr() == ptr
            for a, (b, ptr) in zip(now, self.held))

    def mode(self, device: torch.device, sig: tuple) -> str:
        """This call's mode (class doc); counts the warm-up steps."""
        if not graphable(device, self.optimizer, self.before_update):
            return "eager"
        if self.sig is None:
            self.sig = sig
        if sig != self.sig:
            return "eager"
        if self.held is not None and not self._holds():
            self.held = self.captured = None
            self.warm = 0
        if self.held is None:
            if self.warm < WARMUP_STEPS:
                self.warm += 1
                return "warm"
            self.held = [(t, t.data_ptr()) for t in self.tensors()]
            return "capture"
        return "replay"


@dataclass
class Captured:
    """One capture of the step: the graphs by phase, their static inputs,
    the rows and clips a step takes, the metrics' names and their static
    vector, the static gradients, and the launch counts the capture
    counted."""
    graphs: dict
    inputs: list
    rows: int
    clips: int
    keys: list
    metrics: torch.Tensor
    grads: list
    launches: dict


def _clone(tree):
    if isinstance(tree, dict):
        return {k: v.clone() for k, v in tree.items()}
    return tree.clone()


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer, *,
                    mtl: bool, generator: torch.Generator,
                    loss_weights: dict | None = None, l2_reg: float = 0.0,
                    augment_noise: bool = False,
                    featurize: Callable | None = None,
                    before_update: Callable | None = None) -> Callable:
    """``(state, batch, labels) -> metrics``: one optimizer update of
    ``model`` in place; ``state.step`` counts it.

    ``l2_reg`` adds ``l2 * sum(kernel^2)`` over :func:`l2_kernels`, as the
    reference's Keras ``kernel_regularizer=l2()``.  ``augment_noise``
    applies :func:`augment`.  Dropout and augmentation draw from
    ``generator``.  ``featurize`` maps ``(batch, labels)`` to the model's
    input and per-row labels first, outside autograd (the device pipeline,
    ``train.endtoend``).  ``before_update()`` runs between the backward
    pass and the optimizer's update (``parallel.dp`` averages the
    gradients over its process group there).  Each call is one
    ``utils.profiling.request`` of four spans: ``train.featurize`` (the
    featurizer and the augmentation; ``n`` clips), ``train.forward`` (the
    forward pass, the losses, the L2 term and the metrics; ``n`` rows),
    ``train.backward`` and ``train.optimizer``.

    On CUDA the step runs as graphs where :class:`StepGraphs` allows it:
    the spans then hold the replays (``train.featurize`` also the copy of
    the inputs into the graphs' own).  The counters ``train.eager_steps``,
    ``train.graph_captures`` and ``train.graph_replays`` of
    ``utils.profiling.counters()`` count the calls each way, and a replay
    adds the kernel launches its capture counted (K1/K2's) to their
    counters again.  The metrics of a replay are a fresh copy."""
    use_generator(model, generator)
    kernels = l2_kernels(model) if l2_reg else []
    graphs = StepGraphs(model, optimizer, before_update)

    def featurize_phase(batch, labels):
        with torch.no_grad():
            if featurize is not None:
                batch, labels = featurize(batch, labels)
            if augment_noise:
                batch = augment(batch, generator)
        return batch, labels

    def forward_phase(batch, labels):
        model.train()
        outputs = model(batch)
        total, per_head = _losses(outputs, labels, mtl, loss_weights)
        if kernels:
            total = total + l2_reg * sum(k.square().sum() for k in kernels)
        metrics = {"loss": total.detach(),
                   **{f"{k}_loss": v.detach() for k, v in per_head.items()}}
        out3 = outputs["3C"] if mtl else outputs
        lab3 = labels["3C"] if mtl else labels
        metrics["3C_accuracy" if mtl else "accuracy"] = _accuracy(
            out3.detach(), lab3)
        return total, metrics

    def backward_phase(total):
        optimizer.zero_grad(set_to_none=True)
        total.backward()

    def eager(state: TrainState, batch, labels) -> dict:
        with request():
            with span("train.featurize", n=len(_first(batch))):
                batch, labels = featurize_phase(batch, labels)
            with span("train.forward", n=len(_first(batch))):
                total, metrics = forward_phase(batch, labels)
            with span("train.backward"):
                backward_phase(total)
            if before_update is not None:
                before_update()
            with span("train.optimizer"):
                optimizer.step()
            state.step += 1
        count("train.eager_steps")
        return metrics

    def warm(state: TrainState, batch, labels) -> dict:
        main = torch.cuda.current_stream()
        graphs.stream.wait_stream(main)
        with torch.cuda.stream(graphs.stream):
            metrics = eager(state, batch, labels)
        main.wait_stream(graphs.stream)
        return metrics

    def capture(batch, labels) -> Captured:
        inputs = (_clone(batch), _clone(labels))
        pool = torch.cuda.graph_pool_handle()
        out = {}

        def graph(name, fn, *args):
            g = torch.cuda.CUDAGraph()
            g.register_generator_state(generator)
            with torch.cuda.graph(g, pool=pool, stream=graphs.stream,
                                  capture_error_mode="thread_local"):
                result = fn(*args)
            out[name] = g
            return result

        def forward(batch, labels):
            total, metrics = forward_phase(batch, labels)
            return total, list(metrics), torch.stack(
                [v.float() for v in metrics.values()])

        with counted() as launches:
            feats = (graph("featurize", featurize_phase, *inputs)
                     if featurize is not None or augment_noise else inputs)
            total, keys, vec = graph("forward", forward, *feats)
            graph("backward", backward_phase, total)
            graph("update", optimizer.step)
        count("train.graph_captures")
        return Captured(
            out, [t for tree in inputs for _, t in _items(tree)],
            rows=len(_first(feats[0])), clips=len(_first(batch)), keys=keys,
            metrics=vec, grads=[p.grad for p in model.parameters()],
            launches=launches)

    def replay(state: TrainState, cap: Captured, batch=None,
               labels=None) -> dict:
        g = cap.graphs
        with request():
            with span("train.featurize", n=cap.clips):
                if batch is not None:
                    torch._foreach_copy_(cap.inputs, [
                        t for tree in (batch, labels)
                        for _, t in _items(tree)])
                    for k, n in cap.launches.items():
                        count(k, n)
                if "featurize" in g:
                    g["featurize"].replay()
            with span("train.forward", n=cap.rows):
                model.train()
                g["forward"].replay()
                vec = cap.metrics.clone()
            with span("train.backward"):
                for p, grad in zip(model.parameters(), cap.grads):
                    if p.grad is not grad:
                        p.grad = grad
                g["backward"].replay()
            with span("train.optimizer"):
                g["update"].replay()
            state.step += 1
        count("train.graph_replays")
        return dict(zip(cap.keys, vec.unbind()))

    def train_step(state: TrainState, batch, labels) -> dict:
        mode = graphs.mode(_first(batch).device, signature(batch, labels))
        if mode == "eager":
            return eager(state, batch, labels)
        if graphs.stream is None:
            graphs.stream = torch.cuda.Stream()
        if mode == "warm":
            return warm(state, batch, labels)
        if mode == "capture":
            graphs.captured = capture(batch, labels)
            # The static inputs hold this batch, and its launches are
            # counted: replay the graphs once.
            return replay(state, graphs.captured)
        return replay(state, graphs.captured, batch, labels)

    return train_step


def make_eval_step(model: nn.Module, *, mtl: bool,
                   loss_weights: dict | None = None,
                   featurize: Callable | None = None) -> Callable:
    """``(state, batch, labels) -> metrics`` in eval mode (keys: ``loss``,
    ``accuracy`` and, for MTL models, ``<head>_loss``)."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch, labels) -> dict:
        if featurize is not None:
            batch, labels = featurize(batch, labels)
        model.eval()
        outputs = model(batch)
        total, per_head = _losses(outputs, labels, mtl, loss_weights)
        out3 = outputs["3C"] if mtl else outputs
        lab3 = labels["3C"] if mtl else labels
        metrics = {"loss": total, "accuracy": _accuracy(out3, lab3)}
        if mtl:
            metrics.update({f"{k}_loss": v for k, v in per_head.items()})
        return metrics

    return eval_step


def make_predict(model: nn.Module) -> Callable:
    """``(state, batch) -> outputs`` in eval mode."""

    @torch.no_grad()
    def predict(state: TrainState, batch):
        model.eval()
        return model(batch)

    return predict

"""The train step as CUDA graphs, on the card (``card``: skipped without a
GPU; on the card ``python -m pytest --noconftest
tests/test_torch_train_graphs.py -m card -s``, as ``tests/conftest.py``
imports JAX, which the GPU machine lacks).  This file imports no JAX: the
graphed step is held to the port's own eager step.

Lemaire-MTL at full width through ``make_audio_train_step`` (K1 and the
TCN block's kernels inside),
at the benchmark's batch: 12 clips of 43760 samples, 3 patches a clip,
the noise augmentation and dropout on, the L2 term.  The eager twin is the
same step with a ``before_update`` that does nothing, which keeps it
eager; the two are held bit for bit under cuDNN's deterministic
algorithms.  The runs print one JSON line of what they found (``-s``).
"""

import copy
import json

import numpy as np
import pytest
import torch

from sm_hpss_mtl_tpu_torch.data.featurize import FeatureConfig
from sm_hpss_mtl_tpu_torch.models.zoo import get_model
from sm_hpss_mtl_tpu_torch.train import endtoend as tendtoend
from sm_hpss_mtl_tpu_torch.train import optimizers as toptim
from sm_hpss_mtl_tpu_torch.train import state as tstate
from sm_hpss_mtl_tpu_torch.utils.profiling import counters

pytestmark = pytest.mark.card

CLIPS, SAMPLES, PATCHES = 12, 43760, 3
PATCH_KW = dict(patch_size=68, patch_shift=68)
#: The TCN block's kernels (``ops/tcn_block.py``), 24 blocks a step.
TCN_KERNELS = tuple(f"tcn_block.launches_by_kernel.{k}"
                    for k in ("forward_a", "forward_b", "backward_a"))
COUNTED = ("train.eager_steps", "train.graph_captures", "train.graph_replays",
           "stft_hpss_mel.launches",
           "stft_hpss_mel.launches_by_precision.highest") + TCN_KERNELS


def _tcn(steps: int) -> dict:
    return {k: 24 * steps for k in TCN_KERNELS}


def _batches(device, n, seed=0):
    rng = np.random.default_rng(seed)
    cls = np.repeat(np.arange(3), CLIPS // 3)
    r = np.stack([(cls != 1) * 1.0, (cls != 0) * 1.0], -1)
    r[cls == 2, 0] = 10 ** (-5 / 10)
    labels = {"S": (cls == 1) * 1.0, "M": (cls == 0) * 1.0, "R": r,
              "3C": np.eye(3)[cls]}
    labels = {k: torch.as_tensor(v, dtype=torch.float32, device=device)
              for k, v in labels.items()}
    return [(torch.as_tensor(rng.standard_normal((CLIPS, SAMPLES)) * 0.1,
                             dtype=torch.float32, device=device), labels)
            for _ in range(n)]


class Run:
    """One model, optimizer, generator and train step: graphed where the
    step may graph, or kept eager."""

    def __init__(self, weights, device, graphed: bool):
        with torch.device(device):
            self.net = get_model("Lemaire_et_al_MTL", patch_size=68)
        self.net.load_state_dict(weights)
        self.opt, _ = toptim.for_model("Lemaire_et_al_MTL",
                                       self.net.parameters(), tr_steps=3)
        self.gen = torch.Generator(device=device).manual_seed(7)
        kw = dict(generator=self.gen, l2_reg=0.01, augment_noise=True)
        cfg = FeatureConfig()
        if graphed:
            self.step = tendtoend.make_audio_train_step(
                self.net, self.opt, cfg, n_patches_per_clip=PATCHES,
                **PATCH_KW, **kw)
        else:
            self.step = tstate.make_train_step(
                self.net, self.opt, mtl=True, before_update=lambda: None,
                featurize=tendtoend.audio_featurizer(
                    cfg, max_patches=PATCHES, **PATCH_KW), **kw)
        self.state = tstate.TrainState(self.net, self.opt)

    def __call__(self, batches) -> list:
        out = []
        for audio, labels in batches:
            before = counters()
            m = self.step(self.state, audio, labels)
            after = counters()
            out.append((m, float(m["loss"]),
                        {k: after.get(k, 0) - before.get(k, 0)
                         for k in COUNTED}))
        return out

    def tensors(self):
        return ([p.detach() for p in self.net.parameters()]
                + [self.opt.state[p]["momentum_buffer"]
                   for p in self.net.parameters()]
                + list(self.net.buffers()))


def _skip_without_a_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")


@pytest.fixture
def card():
    """The CUDA device; skips where there is none."""
    _skip_without_a_card()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def weights():
    _skip_without_a_card()
    torch.manual_seed(3)
    net = get_model("Lemaire_et_al_MTL", patch_size=68)
    return {k: v.clone() for k, v in net.state_dict().items()}


def _sums(steps) -> dict:
    return {k: sum(c[k] for _, _, c in steps) for k in COUNTED}


def _compare(a: Run, b: Run, steps_a, steps_b) -> None:
    """The two runs' losses, parameters, momentum buffers, BatchNorm
    statistics and generator states, bit for bit."""
    assert [x for _, x, _ in steps_a] == [x for _, x, _ in steps_b]
    for x, y in zip(a.tensors(), b.tensors()):
        assert torch.equal(x, y)
    assert torch.equal(a.gen.get_state(), b.gen.get_state())


@pytest.fixture
def deterministic():
    """cuDNN's deterministic algorithms for the test: its default weight
    gradients sum in no fixed order, so two eager runs differ by
    round-off (the biases before a BatchNorm, whose gradients are
    round-off, by all of themselves), and bit for bit is then a test of
    nothing."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = before


def test_graphed_steps_equal_the_eager_ones(weights, card, deterministic):
    batches = _batches(card, 9)
    graphed, eager = Run(weights, card, True), Run(weights, card, False)
    g5, e5 = graphed(batches[:5]), eager(batches[:5])
    _compare(graphed, eager, g5, e5)
    # What ran: two eager warm-up steps, the capture (whose replay runs its
    # batch), two replays; K1 once a step either way, and each TCN block
    # kernel 24 times a step, the backward's among them (launched on
    # autograd's thread, counted into the capture's launches).
    assert [c for _, _, c in g5][2]["train.graph_captures"] == 1
    assert _sums(g5) == {"train.eager_steps": 2, "train.graph_captures": 1,
                         "train.graph_replays": 3,
                         "stft_hpss_mel.launches": 5,
                         "stft_hpss_mel.launches_by_precision.highest": 5,
                         **_tcn(5)}
    assert all(c[k] == 24 for _, _, c in g5 for k in TCN_KERNELS)
    assert _sums(e5) == {"train.eager_steps": 5, "train.graph_captures": 0,
                         "train.graph_replays": 0,
                         "stft_hpss_mel.launches": 5,
                         "stft_hpss_mel.launches_by_precision.highest": 5,
                         **_tcn(5)}
    # Each step's metrics are its own storage, and no later replay
    # overwrote them.
    ptrs = {m["loss"].untyped_storage().data_ptr() for m, _, _ in g5}
    assert len(ptrs) == len(g5)
    assert [float(m["loss"]) for m, _, _ in g5] == [x for _, x, _ in g5]
    assert set(g5[-1][0]) == set(e5[-1][0])
    for k in g5[-1][0]:
        assert torch.equal(g5[-1][0][k], e5[-1][0][k].float()), k

    # A resumed optimizer state (new tensors) is captured afresh, after
    # two eager steps; the eager twin loads the same state.
    for run in (graphed, eager):
        run.opt.load_state_dict(copy.deepcopy(run.opt.state_dict()))
    g4, e4 = graphed(batches[5:]), eager(batches[5:])
    _compare(graphed, eager, g4, e4)
    assert _sums(g4) == {"train.eager_steps": 2, "train.graph_captures": 1,
                         "train.graph_replays": 2,
                         "stft_hpss_mel.launches": 4,
                         "stft_hpss_mel.launches_by_precision.highest": 4,
                         **_tcn(4)}
    print(json.dumps({"graph_vs_eager": {
        "bitwise": True, "losses": [x for _, x, _ in g5 + g4],
        "card": torch.cuda.get_device_name(0)}}), flush=True)


def test_a_step_of_another_shape_runs_eager(weights, card):
    graphed = Run(weights, card, True)
    batches = _batches(card, 4)
    audio, labels = batches[0]
    short = (audio[:, :SAMPLES - 160 * 68], labels)
    steps = graphed(batches[:3] + [short] + batches[3:])
    assert _sums(steps)["train.graph_captures"] == 1
    assert [c["train.eager_steps"] for _, _, c in steps] == [1, 1, 0, 1, 0]
    assert steps[-1][2]["train.graph_replays"] == 1


def test_device_learning_rate_is_the_host_float32_one(card):
    """The schedule evaluated on the device in float64, cast once, gives
    the float32 the host value rounds to, over a long run."""
    sched = toptim.exponential_decay(0.002, 3 * 1283)
    t = torch.arange(0, 40000, 7, dtype=torch.float64, device=card)
    got = torch.as_tensor(sched(t)).float().cpu().numpy()
    want = np.array([np.float32(sched(int(s))) for s in range(0, 40000, 7)])
    np.testing.assert_array_equal(got, want)


def test_keras_sgd_on_the_card_equals_its_host_float_update(card):
    """The device-side update against ``add_(g, alpha=lr)`` with the
    learning rate from the host, the update as the port computed it before
    the schedule moved to the device: bit for bit."""
    rng = np.random.default_rng(0)
    shapes = ((32, 240, 3), (32,), (16, 32), (1,))
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) * 3 for s in shapes]
             for _ in range(12)]
    ps = [torch.nn.Parameter(torch.as_tensor(p, device=card))
          for p in params]
    opt, sched = toptim.lemaire_optimizer(ps, 2)
    host = [torch.as_tensor(p, device=card) for p in params]
    bufs = [torch.zeros_like(p) for p in host]
    for t, gs in enumerate(grads):
        for p, g in zip(ps, gs):
            p.grad = torch.as_tensor(g, device=card)
        opt.step()
        hg = [torch.as_tensor(g, device=card) for g in gs]
        toptim.clip_by_per_tensor_norm(hg, 1.0)
        torch._foreach_mul_(bufs, 0.9)
        torch._foreach_add_(bufs, hg, alpha=sched(t))
        torch._foreach_sub_(host, bufs)
    for p, q in zip(ps, host):
        assert torch.equal(p.detach(), q)

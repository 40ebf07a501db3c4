"""The TCN block's fused pointwise chain (``ops/tcn_block.py``,
``csrc/tcn_block.cu``) on the CPU.

The model's CPU route is the chain itself; these tests force the block's
fused route (``TCNResidualBlock.fused``) on CPU tensors, the autograd
Functions over the plain versions in place of the kernels' launchers, and
hold it to the chain: the forward bit for bit, the closed-form backward
to autograd of the chain, the dropout draws and the generator they leave.
The kernels' source is also built for the host with g++ (a stand-in for
the CUDA runtime in ``tests/cuda_host/``, each launch a loop over its
threads) and held to the plain versions as the card's PyTorch computes
them.  ``chip_smoke.py`` holds the kernels on the card.
"""

import contextlib
import re
import shutil
import subprocess
import threading
from pathlib import Path

import pytest
import torch

from sm_hpss_mtl_tpu_torch.models import layers
from sm_hpss_mtl_tpu_torch.models.lemaire import LemaireMTL
from sm_hpss_mtl_tpu_torch.models.tcn import TCNResidualBlock
from sm_hpss_mtl_tpu_torch.ops import _nvcc
from sm_hpss_mtl_tpu_torch.ops import tcn_block as tb
from sm_hpss_mtl_tpu_torch.utils import profiling

DTYPES = [torch.float32, torch.bfloat16]
KEEP = 1.0 - 0.275
HOST_SHIM = Path(__file__).parent / "cuda_host"


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _assert_bits(got: torch.Tensor, want: torch.Tensor) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(_bits(got), _bits(want))


def _activation(B, C, T, dtype, seed=0) -> tuple:
    """A dilated conv's product and bias with the edge cases in it: an
    all-zero column after the ReLU, exact ties at the channel max, and a
    zero channel beside them."""
    g = torch.Generator().manual_seed(seed)
    conv = (torch.randn(B, C, T, generator=g) * 3).to(dtype)
    bias = (torch.randn(C, generator=g) * 0.1).to(dtype)
    bias[:3] = 0
    conv[0, :, 0] = -1.0
    conv[0, :2, 1] = 50.0
    conv[0, 2, 1] = 0.0
    return conv, bias


def _mask(B, C, dtype, seed=1) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.empty(B, C, 1, dtype=dtype).bernoulli_(KEEP, generator=g)


def _plain_b(x, conv, bias, skip):
    out, t = tb.forward_b_plain(x, conv, bias)
    return out, (t if skip else None)


@pytest.fixture
def plain_kernels(monkeypatch):
    """The kernels' launchers replaced by their plain versions, so the
    ops' autograd Functions and ``vmap`` rules run on CPU tensors."""
    monkeypatch.setattr(tb, "_launch_a", tb.forward_a_plain)
    monkeypatch.setattr(tb, "_launch_b", _plain_b)
    monkeypatch.setattr(tb, "_launch_backward_a",
                        lambda grad, conv, bias, mask, keep, sink:
                        tb.backward_a_plain(grad, conv, bias, mask, keep))


@pytest.fixture
def fused(plain_kernels, monkeypatch):
    """The blocks' fused route on CPU tensors (the Functions over the
    plain versions), and the chain with each convolution's bias added
    after its product, as PyTorch adds a cuDNN convolution's on the card
    (oneDNN adds it inside the product, which differs in the last bit)."""
    monkeypatch.setattr(TCNResidualBlock, "forward", TCNResidualBlock.fused)

    def bias_after(self, x):
        y, b = self.parts(x)
        return y + b.view(-1, *(1,) * (y.ndim - 2))

    monkeypatch.setattr(layers.Conv1d, "forward", bias_after)


def _model(n_filters, skip, dtype):
    torch.manual_seed(0)
    return LemaireMTL(12, patch_size=20, n_filters=n_filters, nb_stacks=1,
                      Nd=3, use_skip_connections=skip, dtype=dtype)


def _step(model, batch, fuse: bool, train: bool, monkeypatch):
    """One forward, backward and SGD update; the outputs, the gradients,
    the parameters after and the generator's state."""
    with monkeypatch.context() as m:
        if not fuse:
            m.setattr(TCNResidualBlock, "forward", TCNResidualBlock.chain)
        gen = torch.Generator().manual_seed(5)
        layers.use_generator(model, gen)
        model.train(train)
        out = model(batch)
        loss = sum(v.float().square().mean() for v in out.values())
        model.zero_grad()
        loss.backward()
        grads = {k: p.grad.clone() for k, p in model.named_parameters()}
        with torch.no_grad():
            for p in model.parameters():
                p -= 0.1 * p.grad
        params = {k: p.detach().clone() for k, p in model.named_parameters()}
    return out, grads, params, gen.get_state()


@pytest.mark.parametrize("n_filters", [16, 32])
@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_route_equals_the_chain(fused, monkeypatch, dtype, train,
                                      skip, n_filters):
    import copy
    model = _model(n_filters, skip, dtype)
    twin = copy.deepcopy(model)
    batch = torch.randn(6, 20, 12, generator=torch.Generator().manual_seed(2))
    out_f, grads_f, params_f, gen_f = _step(model, batch, True, train,
                                            monkeypatch)
    out_c, grads_c, params_c, gen_c = _step(twin, batch, False, train,
                                            monkeypatch)
    # The forward bit for bit, the same dropout draws and generator state.
    for k in out_c:
        _assert_bits(out_f[k], out_c[k])
    assert torch.equal(gen_f, gen_c)
    # The closed-form backward against autograd of the chain: float32
    # round-off of the sums' order (up to 4.1e-7 of the largest gradient
    # here); in bfloat16 the chain rounds each step of its backward and the
    # closed form once (up to 1.4e-2).
    rtol = 5e-6 if dtype == torch.float32 else 0.05
    for k in grads_c:
        scale = grads_c[k].abs().max().item() + 1e-30
        err = (grads_f[k] - grads_c[k]).abs().max().item() / scale
        assert err <= rtol, (k, err)
    if dtype == torch.float32:
        for k in params_c:
            torch.testing.assert_close(params_f[k], params_c[k], rtol=1e-5,
                                       atol=1e-6)


@pytest.mark.parametrize("n_filters", [16, 32, 12])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_closed_form_backward_is_autograd_of_the_chain(dtype, with_mask,
                                                       n_filters):
    conv, bias = _activation(4, n_filters, 9, dtype)
    mask = _mask(4, n_filters, dtype) if with_mask else None
    grad = torch.randn(conv.shape, generator=torch.Generator().manual_seed(3)
                       ).to(dtype)
    c = conv.clone().requires_grad_()
    b = bias.clone().requires_grad_()
    tb.forward_a_plain(c, b, mask, KEEP).backward(grad)
    got = tb.backward_a_plain(grad, conv, bias, mask, KEEP)
    assert got.dtype == dtype
    # Where the ReLU is closed (the all-zero column, the negative side) both
    # give exact zeros.
    closed = torch.relu(conv + bias.view(-1, 1)) == 0
    assert torch.all(got[closed] == 0) and torch.all(c.grad[closed] == 0)
    scale = c.grad.float().abs().max().item()
    err = (got.float() - c.grad.float()).abs().max().item() / scale
    assert err <= (2e-6 if dtype == torch.float32 else 2 ** -5), err
    # The tie at the max splits amax's gradient evenly, as torch.amax does:
    # with the ties' own gradients equal, their results are equal too.
    g2 = grad.clone()
    g2[0, 1, 1] = g2[0, 0, 1]
    tied = tb.backward_a_plain(g2, conv, bias, mask, KEEP)[0, :2, 1]
    if mask is None or mask[0, 0] == mask[0, 1]:
        assert tied[0] == tied[1]


@pytest.mark.parametrize("dtype", DTYPES)
def test_function_backward_is_the_closed_form(plain_kernels, dtype):
    """The Function's backward on a CPU tensor is the closed form, and its
    bias gradient the sum over items and time."""
    conv, bias = _activation(3, 16, 7, dtype)
    mask = _mask(3, 16, dtype)
    grad = torch.randn(conv.shape, generator=torch.Generator().manual_seed(4)
                       ).to(dtype)
    c = conv.clone().requires_grad_()
    b = bias.clone().requires_grad_()
    out = tb.forward_a(c, b, mask, KEEP)
    _assert_bits(out.detach(), tb.forward_a_plain(conv, bias, mask, KEEP))
    out.backward(grad)
    want = tb.backward_a_plain(grad, conv, bias, mask, KEEP)
    _assert_bits(c.grad, want)
    torch.testing.assert_close(b.grad, want.sum(dim=(0, 2)))


@pytest.mark.parametrize("skip", [False, True])
def test_forward_b_function(plain_kernels, skip):
    g = torch.Generator().manual_seed(6)
    x, conv = (torch.randn(2, 8, 5, generator=g).requires_grad_()
               for _ in range(2))
    bias = torch.randn(8, generator=g).requires_grad_()
    out, t = tb.forward_b(x, conv, bias, skip)
    want_out, want_t = tb.forward_b_plain(x, conv, bias)
    _assert_bits(out.detach(), want_out.detach())
    assert (t is None) != skip
    go = torch.randn(out.shape, generator=g)
    gt = torch.randn(out.shape, generator=g)
    loss = (out * go).sum() + ((t * gt).sum() if skip else 0)
    loss.backward()
    g_conv = go + gt if skip else go
    _assert_bits(x.grad, go)
    _assert_bits(conv.grad, g_conv)
    torch.testing.assert_close(bias.grad, g_conv.sum(dim=(0, 2)))


def test_unused_block_output_takes_no_gradient(plain_kernels):
    """With skip connections the last block's output is unused: its
    gradient stays None and the skip branch alone flows back."""
    x = torch.randn(2, 4, 3).requires_grad_()
    conv = torch.randn(2, 4, 3).requires_grad_()
    bias = torch.zeros(4, requires_grad=True)
    _, t = tb.forward_b(x, conv, bias, True)
    t.sum().backward()
    assert x.grad is None
    assert torch.equal(conv.grad, torch.ones_like(conv))


def _trials(n, B, C, T, dtype=torch.float32):
    """Per-trial operands of a vmapped block: conv, bias, mask, x and two
    output weights, each with a leading trial axis (x shared)."""
    g = torch.Generator().manual_seed(8)
    conv = (torch.randn(n, B, C, T, generator=g) * 3).to(dtype)
    conv[0, 0, :2, 1] = 50.0                     # a tie at the channel max
    bias = (torch.randn(n, C, generator=g) * 0.1).to(dtype)
    mask = torch.empty(n, B, C, 1).bernoulli_(KEEP, generator=g).to(dtype)
    x = torch.randn(B, C, T, generator=g).to(dtype)
    w, w2 = (torch.randn(n, B, C, T, generator=g).to(dtype)
             for _ in range(2))
    return conv, bias, mask, x, w, w2


def _block_loss(conv, bias, mask, x, w, w2):
    y = tb.forward_a(conv, bias, mask, KEEP)
    out, t = tb.forward_b(x, y, bias, True)
    return (out * w).sum() + (t * w2).sum()


@pytest.mark.parametrize("order", ["vmap_of_grad", "grad_of_vmap"])
def test_functorch_transforms_take_the_fused_route(fused, monkeypatch,
                                                   order):
    """Under vmap the Functions' rules fold the trial axis into the items,
    with a bias row per trial: the forward is each trial's plain forward
    bit for bit, and the gradients, vmap over grad (the multi-trial step's
    order) or grad over vmap, are each trial's autograd of the chain."""
    folds = []
    fold_bias = tb._fold_bias
    monkeypatch.setattr(tb, "_fold_bias", lambda *a: (
        folds.append(a[0].shape), fold_bias(*a))[1])
    n, B, C, T = 3, 2, 8, 5
    conv, bias, mask, x, w, w2 = _trials(n, B, C, T)
    got = torch.func.vmap(tb.forward_a, in_dims=(0, 0, 0, None))(
        conv, bias, mask, KEEP)
    for i in range(n):
        _assert_bits(got[i], tb.forward_a_plain(conv[i], bias[i], mask[i],
                                                KEEP))
    if order == "vmap_of_grad":
        gc, gb = torch.func.vmap(
            torch.func.grad(_block_loss, argnums=(0, 1)),
            in_dims=(0, 0, 0, None, 0, 0))(conv, bias, mask, x, w, w2)
    else:
        gc, gb = torch.func.grad(
            lambda c, b: torch.func.vmap(
                _block_loss, in_dims=(0, 0, 0, None, 0, 0))(
                    c, b, mask, x, w, w2).sum(), argnums=(0, 1))(conv, bias)
    # forward_a, forward_b and backward_a each took their rule.
    assert len(folds) >= 3
    for i in range(n):
        c = conv[i].clone().requires_grad_()
        b = bias[i].clone().requires_grad_()
        y = tb.forward_a_plain(c, b, mask[i], KEEP)
        out, t = tb.forward_b_plain(x, y, b)
        ((out * w[i]).sum() + (t * w2[i]).sum()).backward()
        for got_g, want in ((gc[i], c.grad), (gb[i], b.grad)):
            err = (got_g - want).abs().max() / want.abs().max()
            assert err <= 5e-6, err


@pytest.mark.parametrize("skip", [False, True])
def test_vmapped_multi_trial_step_takes_the_fused_route(fused, monkeypatch,
                                                        skip):
    """The multi-trial step (vmap over grad, dropout fed per trial) on the
    fused route against the chain: the same losses bit for bit, the
    parameters after two steps within float32 round-off; the eval step's
    losses bit for bit."""
    from sm_hpss_mtl_tpu_torch.train import multitrial as tmulti
    from sm_hpss_mtl_tpu_torch.train import optimizers as toptim
    net = _model(8, skip, None)
    cls = torch.arange(6) % 3
    labels = {"S": (cls == 1).float(), "M": (cls == 0).float(),
              "R": torch.stack([(cls != 1).float(), (cls != 0).float()], -1),
              "3C": torch.nn.functional.one_hot(cls, 3).float()}
    batch = torch.randn(6, 20, 12, generator=torch.Generator().manual_seed(9))
    hyper = tmulti.stack_hyperparams([{}, {}], None)

    def sgd(params):
        return toptim.lemaire_optimizer(params, 50, trial_axis=True)[0]

    def run(fuse: bool):
        with monkeypatch.context() as m:
            if not fuse:
                m.setattr(TCNResidualBlock, "forward", TCNResidualBlock.chain)
            state = tmulti.init_trials(net, [3, 4], sgd)
            step = tmulti.make_multi_train_step(net, mtl=True, l2_reg=0.01)
            losses = [step(state, batch, labels, hyper)["loss"]
                      for _ in range(2)]
            ev = tmulti.make_multi_eval_step(net, mtl=True)(
                state, batch, labels, hyper)["loss"]
        return losses, [tmulti.unstack_trial(state, i) for i in range(2)], ev

    losses_f, trials_f, ev_f = run(True)
    losses_c, trials_c, ev_c = run(False)
    _assert_bits(losses_f[0], losses_c[0])
    for got, want in zip(trials_f, trials_c):
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=1e-5,
                                       atol=1e-6, msg=k)
    torch.testing.assert_close(ev_f, ev_c, rtol=1e-5, atol=0)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    conv = torch.zeros(2, 4, 3)
    with pytest.raises(ValueError, match="shapes"):
        tb._check("forward_a", conv, torch.zeros(5), None)
    with pytest.raises(ValueError, match="shapes"):
        tb._check("forward_a", conv, torch.zeros(4), torch.zeros(2, 4, 3))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tb._check("forward_a", conv.double(), torch.zeros(4).double(), None)
    with pytest.raises(TypeError, match="one dtype"):
        tb._check("forward_b", conv, torch.zeros(4), None,
                  conv.bfloat16())


def test_inv_keep_is_the_rounded_double_reciprocal():
    import numpy as np
    assert tb.inv_keep(KEEP) == float(np.float32(1 / KEEP))
    # The two roundings differ at the Lemaire models' keep: the kernels
    # take the one PyTorch's CUDA division by a scalar multiplies by.
    assert tb.inv_keep(KEEP) != float(np.float32(1) / np.float32(KEEP))
    assert tb._inv_keep(None, 0.0) == 1.0


def test_a_backward_counts_into_its_forwards_collection():
    """A count made on another thread (autograd's, in a backward) with the
    forward thread's dict as its sink lands in that dict and in the
    counters; counts of unrelated threads stay out of it."""
    before = profiling.counters().get("t.sink", 0)
    with profiling.counted() as mine:
        assert profiling.counting() is mine
        sink = profiling.counting()
        other = threading.Thread(target=lambda: (
            profiling.count("t.sink", 2, sink=sink),
            profiling.count("t.stranger")))
        other.start()
        other.join()
        profiling.count("t.sink", sink=sink)     # not counted twice
    assert profiling.counting() is None
    assert mine == {"t.sink": 3}
    assert profiling.counters()["t.sink"] == before + 3


def test_library_has_no_median_pair_in_its_name():
    path = _nvcc.library_path("tcn_block.cu")
    assert re.fullmatch(r"libtcn_block_[0-9a-f]{12}\.so", path.name)
    assert _nvcc._sources("tcn_block.cu") == [_nvcc.CSRC / "tcn_block.cu"]


# --- The kernels' source, built for the host ------------------------------

_LAUNCH = re.compile(r"(\w+(?:<[^<>;]*>)?)<<<(.*?)>>>\((.*?)\);", re.S)


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """``csrc/tcn_block.cu`` built with g++ against ``tests/cuda_host``,
    bound as ``ops/tcn_block.py`` binds the card's library."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the kernels' source for the host")
    src = (_nvcc.CSRC / "tcn_block.cu").read_text()
    host = _LAUNCH.sub(lambda m: f"host_launch({m.group(2)}, "
                       f"[&] {{ {m.group(1)}({m.group(3)}); }});", src)
    assert "<<<" not in host
    d = tmp_path_factory.mktemp("tcn_host")
    (d / "tcn_block.cpp").write_text(host)
    out = d / "libtcn_block_host.so"
    subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off",
                    "-shared", "-fPIC", "-Wno-unknown-pragmas",
                    f"-I{HOST_SHIM}", "-o", str(out),
                    str(d / "tcn_block.cpp")], check=True,
                   capture_output=True)
    mp = pytest.MonkeyPatch()
    mp.setattr(_nvcc, "build", lambda source, *a: out)
    mp.setattr(_nvcc, "_made_current",
               lambda device: contextlib.nullcontext())
    mp.setattr(_nvcc, "_stream", lambda device: 0)
    _nvcc.load.cache_clear()
    yield tb
    _nvcc.load.cache_clear()
    mp.undo()


def _as_on_the_card(conv, bias, mask):
    """:func:`forward_a_plain` as PyTorch's CUDA kernels compute it: the
    division by keep is a product by its float32 reciprocal there."""
    y = tb.channel_normalization(torch.relu(conv + tb._bias(bias,
                                                            len(conv))))
    return y if mask is None else y * mask * tb.inv_keep(KEEP)


@pytest.mark.parametrize("n_filters", [8, 16, 32, 12])
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_source_on_the_host(host_kernels, dtype, n_filters):
    """Forward A and B bit for bit against the plain versions, the backward
    against the closed form, at every unrolled channel count and one that
    takes the general loop, with and without dropout; the counters count
    each launch."""
    before = profiling.counters()
    for B, T in ((3, 68), (2, 5)):
        conv, bias = _activation(B, n_filters, T, dtype)
        x = torch.randn(conv.shape).to(dtype)
        grad = torch.randn(conv.shape).to(dtype)
        for mask in (None, _mask(B, n_filters, dtype)):
            _assert_bits(tb._launch_a(conv, bias, mask, KEEP),
                         _as_on_the_card(conv, bias, mask))
            got = tb._launch_backward_a(grad, conv, bias, mask, KEEP, None)
            want = tb.backward_a_plain(grad, conv, bias, mask, KEEP)
            scale = want.float().abs().max().item()
            err = (got.float() - want.float()).abs().max().item() / scale
            # The same float32 formula summed in another order; bfloat16
            # rounds both once at the end.
            assert err <= (1e-6 if dtype == torch.float32 else 2 ** -7), err
        for skip in (False, True):
            out, t = tb._launch_b(x, conv, bias, skip)
            want_out, want_t = tb.forward_b_plain(x, conv, bias)
            _assert_bits(out, want_out)
            assert (t is None) != skip
            if skip:
                _assert_bits(t, want_t)
    after = profiling.counters()
    delta = {k: after.get(k, 0) - before.get(k, 0)
             for k in ("tcn_block.launches",
                       "tcn_block.launches_by_kernel.forward_a",
                       "tcn_block.launches_by_kernel.forward_b",
                       "tcn_block.launches_by_kernel.backward_a")}
    assert delta == {"tcn_block.launches": 12,
                     "tcn_block.launches_by_kernel.forward_a": 4,
                     "tcn_block.launches_by_kernel.forward_b": 4,
                     "tcn_block.launches_by_kernel.backward_a": 4}


@pytest.mark.parametrize("n_filters", [16, 12])
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_source_takes_a_bias_row_per_trial(host_kernels, dtype,
                                                  n_filters):
    """A (G, C) bias, one row for each B / G consecutive items (a vmapped
    block's trials folded into the items): every kernel against the plain
    versions, which repeat each row over its items; bias rows that do not
    divide the items are refused."""
    B, G = 6, 3
    for T in (68, 5):
        conv, _ = _activation(B, n_filters, T, dtype)
        bias = (torch.randn(G, n_filters,
                            generator=torch.Generator().manual_seed(7))
                ).to(dtype)
        x = torch.randn(conv.shape).to(dtype)
        grad = torch.randn(conv.shape).to(dtype)
        mask = _mask(B, n_filters, dtype)
        _assert_bits(tb._launch_a(conv, bias, mask, KEEP),
                     _as_on_the_card(conv, bias, mask))
        out, t = tb._launch_b(x, conv, bias, True)
        want_out, want_t = tb.forward_b_plain(x, conv, bias)
        _assert_bits(out, want_out)
        _assert_bits(t, want_t)
        got = tb._launch_backward_a(grad, conv, bias, mask, KEEP, None)
        want = tb.backward_a_plain(grad, conv, bias, mask, KEEP)
        err = ((got.float() - want.float()).abs().max()
               / want.float().abs().max()).item()
        assert err <= (1e-6 if dtype == torch.float32 else 2 ** -7), err
        # Each row is its items' own: the plain versions per row agree.
        for r in range(G):
            items = slice(r * B // G, (r + 1) * B // G)
            _assert_bits(tb.forward_a_plain(conv[items], bias[r],
                                            mask[items], KEEP),
                         tb.forward_a_plain(conv, bias, mask, KEEP)[items])
    with pytest.raises(ValueError, match="shapes"):
        tb._launch_a(conv, torch.cat([bias, bias[:1]]), None, KEEP)


def test_vmapped_multi_trial_step_on_the_kernel_source(host_kernels,
                                                       monkeypatch):
    """The multi-trial step with the kernels' host build on the fused route
    (the meta device's shape probe keeps the chain, as on the card): one
    launch of each kernel a block, over the two trials' items folded
    together with a bias row each; the losses and the updates as the
    chain's, within float32 round-off (the kernels divide by keep as a
    product by its reciprocal, as the card does)."""
    from sm_hpss_mtl_tpu_torch.train import multitrial as tmulti
    from sm_hpss_mtl_tpu_torch.train import optimizers as toptim
    net = _model(8, False, None)
    cls = torch.arange(6) % 3
    labels = {"S": (cls == 1).float(), "M": (cls == 0).float(),
              "R": torch.stack([(cls != 1).float(), (cls != 0).float()], -1),
              "3C": torch.nn.functional.one_hot(cls, 3).float()}
    batch = torch.randn(6, 20, 12, generator=torch.Generator().manual_seed(9))
    hyper = tmulti.stack_hyperparams([{}, {}], None)
    shapes = []
    run_ = tb._run
    monkeypatch.setattr(tb, "_run", lambda kernel, conv, bias, *a: (
        shapes.append((kernel, tuple(conv.shape), tuple(bias.shape))),
        run_(kernel, conv, bias, *a))[1])

    def run(fuse: bool):
        def route(block, x, skip=True):
            on = fuse and x.device.type == "cpu"
            return (block.fused if on else block.chain)(x, skip)

        with monkeypatch.context() as m:
            m.setattr(TCNResidualBlock, "forward", route)
            state = tmulti.init_trials(net, [3, 4], lambda p: (
                toptim.lemaire_optimizer(p, 50, trial_axis=True)[0]))
            step = tmulti.make_multi_train_step(net, mtl=True)
            loss = step(state, batch, labels, hyper)["loss"]
        return loss, [tmulti.unstack_trial(state, i) for i in range(2)]

    loss_f, trials_f = run(True)
    assert sorted(set(shapes)) == [
        (k, (12, 8, 20), (2, 8)) for k in ("backward_a", "forward_a",
                                           "forward_b")]
    assert len(shapes) == 9                    # 3 blocks, 3 kernels each
    loss_c, trials_c = run(False)
    torch.testing.assert_close(loss_f, loss_c, rtol=1e-6, atol=0)
    for got, want in zip(trials_f, trials_c):
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=1e-5,
                                       atol=1e-6, msg=k)

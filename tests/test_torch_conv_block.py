"""Jang's conv block tail at inference (``ops/conv_block.py``) on the CPU.

The kernel runs only on the card (``chip_smoke.py::phase_conv_block`` holds
it to its plain version there).  Here: the plain version is the block's
eager chain bit for bit; the block takes the kernel's route only in eval
mode with no gradient recorded on CUDA; Jang's eval forward on the CPU is
the chain's; the wrapper refuses what the kernel does not take before any
launch, and passes one argument per C parameter (a stand-in library takes
the calls); under ``torch.func.vmap`` the kernel is launched once over the
trials' items with a parameter row each.  The kernel's source is also
built for the host with g++ (``tests/cuda_host/``, each launch a loop over
its blocks and threads) and held bit for bit to the chain as the card
computes it, at every load width, both pooling modes, odd sizes and a
parameter row per trial.

On the CPU oneDNN adds a float32 convolution's bias inside its product, so
the chain is held from the product plus its bias, which is what
``Conv2d.forward`` computes in bfloat16 here and in float32 on the card
(PyTorch adds cuDNN's bias after the product).
"""

import contextlib
import re
import shutil
import subprocess
import types
from pathlib import Path

import pytest
import torch

from sm_hpss_mtl_tpu_torch.cli.tune import GRID_RANGES
from sm_hpss_mtl_tpu_torch.models.heads import BN_KW
from sm_hpss_mtl_tpu_torch.models.jang import JangCNN, _ConvBlock
from sm_hpss_mtl_tpu_torch.models.pool import max_pool
from sm_hpss_mtl_tpu_torch.ops import _nvcc
from sm_hpss_mtl_tpu_torch.ops import conv_block as cb
from sm_hpss_mtl_tpu_torch.train import multitrial
from sm_hpss_mtl_tpu_torch.utils.profiling import counters

#: Jang-MTL's three blocks (input channels, features, H, W of the product)
#: at two items, and an odd square (17 -> 9 'SAME', 8 'VALID').
BLOCKS = {"b1": (3, 32, 240, 68), "b2": (32, 64, 120, 34),
          "b3": (64, 128, 60, 17), "odd": (3, 8, 17, 17)}


def _block(cin: int, features: int, padding: str, dtype=None,
           seed: int = 0) -> _ConvBlock:
    """An eval-mode block with BatchNorm statistics away from the identity
    (one weight negative, one variance near 0)."""
    torch.manual_seed(seed)
    blk = _ConvBlock(cin, features, pool_padding=padding, dtype=dtype)
    with torch.no_grad():
        blk.bn.running_mean.uniform_(-0.05, 0.05)
        blk.bn.running_var.uniform_(0.9, 1.1)
        blk.bn.running_var[2] = 1e-4
        blk.bn.weight.uniform_(0.9, 1.1)
        blk.bn.weight[1] *= -1
        blk.bn.bias.uniform_(-0.05, 0.05)
    return blk.eval()


def _input(cin: int, H: int, W: int, dtype=None, items: int = 2):
    x = torch.randn((items, cin, H, W), generator=torch.Generator()
                    .manual_seed(1))
    return x if dtype is None else x.to(dtype)


@pytest.mark.parametrize("block", list(BLOCKS))
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("dtype", [None, torch.bfloat16],
                         ids=["float32", "bf16"])
def test_plain_equals_the_eager_chain_bit_for_bit(block, padding, dtype):
    cin, features, H, W = BLOCKS[block]
    blk = _block(cin, features, padding, dtype)
    x = _input(cin, H, W, dtype)
    with torch.no_grad():
        y, b = blk.conv.parts(x)
        t = y + b.view(-1, 1, 1)
        if dtype is not None:
            # The layer's own output in a reduced compute dtype.
            assert torch.equal(blk.conv(x), t)
        chain = max_pool(blk.dropout(torch.relu(blk.bn(t))), (2, 2), (2, 2),
                         padding=padding)
        got = cb.conv_block_plain(y, b, blk.bn, padding)
    assert got.dtype == torch.float32 and got.shape == chain.shape
    assert got.shape[-2:] == (cb.pooled_size(H, padding),
                              cb.pooled_size(W, padding))
    assert torch.equal(got.view(torch.int32), chain.view(torch.int32))


@pytest.mark.parametrize("size,padding,want", [
    (17, "SAME", 9), (17, "VALID", 8), (68, "SAME", 34), (68, "VALID", 34),
    (1, "SAME", 1), (9, "VALID", 4)])
def test_pooled_size_is_the_pool_s(size, padding, want):
    assert cb.pooled_size(size, padding) == want
    x = torch.zeros(1, 1, size, size)
    assert max_pool(x, (2, 2), (2, 2), padding).shape[-1] == want


#: (mode, grad, on a card, the route taken).
ROUTES = {"eval no_grad card": ("eval", "no_grad", True, "kernel"),
          "eval inference_mode card": ("eval", "inference", True, "kernel"),
          "train no_grad card": ("train", "no_grad", True, "chain"),
          "eval recorded card": ("eval", "grad", True, "chain"),
          "eval no_grad cpu": ("eval", "no_grad", False, "chain")}


@pytest.mark.parametrize("case", list(ROUTES))
def test_block_takes_the_kernel_only_at_inference_on_a_card(monkeypatch,
                                                            case):
    mode, grad, card, want = ROUTES[case]
    calls = []

    def kernel(conv, bias, bn, padding):
        calls.append(tuple(conv.shape))
        return cb.conv_block_plain(conv, bias, bn, padding)

    monkeypatch.setattr(cb, "conv_block", kernel)
    if card:
        monkeypatch.setattr(_nvcc, "on_card", lambda op, t: True)
    blk = _block(3, 8, "SAME")
    blk.train(mode == "train")
    blk.dropout.generator = torch.Generator().manual_seed(0)
    x = _input(3, 17, 17)
    ctx = {"no_grad": torch.no_grad(), "inference": torch.inference_mode(),
           "grad": contextlib.nullcontext()}[grad]
    with ctx:
        out = blk(x)
    assert (calls == [(2, 8, 17, 17)]) == (want == "kernel")
    assert len(calls) <= 1
    assert out.shape == (2, 8, 9, 9)
    if grad == "grad":
        assert out.requires_grad


@pytest.mark.parametrize("mtl,dtype", [(True, None), (True, torch.bfloat16),
                                       (False, None)],
                         ids=["mtl-float32", "mtl-bf16", "single-float32"])
def test_jang_eval_forward_on_the_cpu_is_the_chain(monkeypatch, mtl, dtype):
    torch.manual_seed(0)
    net = JangCNN(mtl=mtl, n_mels=16, patch_size=12, dtype=dtype).eval()
    rows = 2 * 257 if mtl else 257
    x = torch.randn((3, rows, 12, 1), generator=torch.Generator()
                    .manual_seed(2))
    before = counters()
    with torch.inference_mode():
        got = net(x)
    assert not any(v - before.get(k, 0) for k, v in counters().items()
                   if k.startswith("conv_block."))
    monkeypatch.setattr(_ConvBlock, "forward", _ConvBlock.chain)
    with torch.inference_mode():
        want = net(x)
    if not mtl:
        got, want = {"out": got}, {"out": want}
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


# ---------------------------------------------------------------------------
# The wrapper against a stand-in library


def _stand_in(monkeypatch) -> list:
    """The kernel's library replaced by one that records its calls."""
    calls = []
    lib = types.SimpleNamespace(
        conv_block_forward=lambda *a: calls.append(a) or 0,
        conv_block_error_string=lambda code: b"fake error")
    monkeypatch.setattr(_nvcc, "load", lambda source, *a, **kw: lib)
    monkeypatch.setattr(_nvcc, "_made_current",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(_nvcc, "_RAW_STREAM", lambda index: 1234)
    return calls


def _operands(B=2, C=8, H=17, W=17, rows=1, dtype=torch.float32):
    shape = (rows, C) if rows > 1 else (C,)
    conv = torch.zeros((B, C, H, W), dtype=dtype)
    params = [torch.ones(shape) for _ in range(4)]
    return [conv, torch.zeros(shape, dtype=dtype), *params, BN_KW["eps"],
            "SAME"]


def test_launch_passes_shape_rows_and_storage_flag(monkeypatch):
    calls = _stand_in(monkeypatch)
    before = counters()
    args = _operands(B=4, C=8, H=17, W=34, rows=2, dtype=torch.bfloat16)
    args[-1] = "VALID"
    out = cb._launch(*args)
    assert out.shape == (4, 8, 8, 17) and out.dtype == torch.float32
    (call,) = calls
    params = _nvcc.signatures(_nvcc.CSRC / "conv_block.cu")[
        "conv_block_forward"][1]
    assert len(call) == len(params)
    named = dict(zip((n for n, _ in params), call))
    assert [named[k] for k in ("B", "C", "H", "W", "Ho", "Wo", "rows",
                               "bf16")] == [4, 8, 17, 34, 8, 17, 2, 1]
    assert named["eps"] == BN_KW["eps"] and named["stream"] == 1234
    assert named["out"] == out.data_ptr()
    now = counters()
    assert now["conv_block.launches"] - before.get(
        "conv_block.launches", 0) == 1
    assert now["conv_block.launches_by_pool.valid"] - before.get(
        "conv_block.launches_by_pool.valid", 0) == 1


def _mixed(args):
    args[1] = args[1].to(torch.bfloat16)


def _params_bf16(args):
    args[3] = args[3].to(torch.bfloat16)


def _strided_conv(args):
    args[0] = args[0].transpose(2, 3)


def _strided_bias(args):
    args[1] = torch.zeros(16)[::2]


def _float64(args):
    for i in range(6):
        args[i] = args[i].double()


def _rows_mismatch(args):
    args[2] = torch.ones(2, 8)


def _rows_not_dividing(args):
    for i in range(1, 6):
        args[i] = torch.ones(3, 8)


def _three_d(args):
    args[0] = args[0][0]


def _padding(args):
    args[-1] = "same"


REFUSED = {"mixed dtypes": (_mixed, TypeError),
           "bf16 parameters": (_params_bf16, TypeError),
           "non-contiguous product": (_strided_conv, ValueError),
           "non-contiguous bias": (_strided_bias, ValueError),
           "float64": (_float64, TypeError),
           "parameter rows differ": (_rows_mismatch, ValueError),
           "rows not dividing items": (_rows_not_dividing, ValueError),
           "3-D product": (_three_d, ValueError),
           "padding": (_padding, ValueError)}


@pytest.mark.parametrize("case", list(REFUSED))
def test_wrapper_refuses_before_any_launch(monkeypatch, case):
    calls = _stand_in(monkeypatch)
    edit, error = REFUSED[case]
    args = _operands()
    edit(args)
    before = counters()
    with pytest.raises(error):
        cb._launch(*args)
    assert calls == [] and counters() == before


#: The stand-in kernel's launches: (product's shape, parameter rows).
launched: list = []


def _rows_kernel(conv, bias, mean, var, weight, shift, eps, padding):
    """The kernel's function, computed by the plain version per parameter
    row (a stand-in for the card's launch)."""
    rows = bias.shape[0] if bias.ndim == 2 else 1
    launched.append((tuple(conv.shape), rows))
    parts = []
    for g, part in enumerate(conv.chunk(rows)):
        bn = types.SimpleNamespace(
            **{k: (t[g] if t.ndim == 2 else t) for k, t in (
                ("running_mean", mean), ("running_var", var),
                ("weight", weight), ("bias", shift))}, eps=eps)
        parts.append(cb.conv_block_plain(
            part, bias[g] if bias.ndim == 2 else bias, bn, padding))
    return torch.cat(parts)


def test_vmap_rule_folds_trials_into_one_launch(monkeypatch):
    """``vmap`` over four trials' products and parameters: one launch over
    the folded items with four parameter rows, each trial's output its own
    plain result."""
    launched.clear()
    monkeypatch.setattr(cb, "_launch", _rows_kernel)
    n, B, C, H, W = 4, 3, 8, 17, 34
    g = torch.Generator().manual_seed(3)
    conv = torch.randn((n, B, C, H, W), generator=g)
    bias, mean, shift = (torch.randn((n, C), generator=g) * 0.05
                         for _ in range(3))
    var, weight = (torch.rand((n, C), generator=g) + 0.5 for _ in range(2))

    def one(c, b, m, v, w, s):
        return cb._run(c, b, m, v, w, s, BN_KW["eps"], "SAME")

    got = torch.func.vmap(one)(conv, bias, mean, var, weight, shift)
    assert launched == [((n * B, C, H, W), n)]
    for i in range(n):
        bn = types.SimpleNamespace(running_mean=mean[i], running_var=var[i],
                                   weight=weight[i], bias=shift[i],
                                   eps=BN_KW["eps"])
        assert torch.equal(got[i], cb.conv_block_plain(conv[i], bias[i], bn,
                                                       "SAME"))


def test_multi_trial_eval_step_reaches_the_kernel_once_a_block(monkeypatch):
    """Jang-MTL's vmapped multi-trial evaluation step on the kernel's route
    (a card stood in for): each block launched once over the trials'
    items, the losses those of the chain (to float32 round-off: on the
    CPU the chain's convolution adds its bias inside the product)."""
    torch.manual_seed(0)
    net = JangCNN(mtl=True, n_mels=16, patch_size=12)
    trials = [{"loss_weights": w} for w in GRID_RANGES["loss_weights"][:3]]
    state = multitrial.stacked_state(
        [net] * len(trials), lambda ps: torch.optim.SGD(ps, lr=0.1),
        [0] * len(trials))
    hyper = multitrial.stack_hyperparams(trials, ("3C", "M", "R", "S"))
    step = multitrial.make_multi_eval_step(net, mtl=True)
    B = 5
    x = torch.randn((B, 2 * 257, 12, 1), generator=torch.Generator()
                    .manual_seed(4))
    cls = torch.arange(B) % 3
    labels = {"S": (cls == 1).float(), "M": (cls == 0).float(),
              "R": torch.stack([(cls != 1).float(), (cls != 0).float()], -1),
              "3C": torch.nn.functional.one_hot(cls, 3).float()}
    want = step(state, x, labels, hyper)["loss"]
    launched.clear()
    monkeypatch.setattr(cb, "_launch", _rows_kernel)
    monkeypatch.setattr(_nvcc, "on_card", lambda op, t: True)
    got = step(state, x, labels, hyper)["loss"]
    n = len(trials)
    assert launched == [((n * B, 32, 32, 12), n), ((n * B, 64, 16, 6), n),
                        ((n * B, 128, 8, 3), n)]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


# --- The kernel's source, built for the host ------------------------------

HOST_SHIM = Path(__file__).parent / "cuda_host"
_LAUNCH = re.compile(r"(\w+(?:<[^<>;]*>)?)<<<(.*?)>>>\((.*?)\);", re.S)


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """``csrc/conv_block.cu`` built with g++ against ``tests/cuda_host``,
    bound as ``ops/conv_block.py`` binds the card's library."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the kernel's source for the host")
    src = (_nvcc.CSRC / "conv_block.cu").read_text()
    host = _LAUNCH.sub(lambda m: f"host_launch({m.group(2)}, "
                       f"[&] {{ {m.group(1)}({m.group(3)}); }});", src)
    assert "<<<" not in host
    d = tmp_path_factory.mktemp("conv_block_host")
    (d / "conv_block.cpp").write_text(host)
    out = d / "libconv_block_host.so"
    subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off",
                    "-shared", "-fPIC", "-Wno-unknown-pragmas",
                    f"-I{HOST_SHIM}", "-o", str(out),
                    str(d / "conv_block.cpp")], check=True,
                   capture_output=True)
    mp = pytest.MonkeyPatch()
    mp.setattr(_nvcc, "build", lambda source, *a: out)
    mp.setattr(_nvcc, "_made_current",
               lambda device: contextlib.nullcontext())
    mp.setattr(_nvcc, "_stream", lambda device: 0)
    _nvcc.load.cache_clear()
    yield cb
    _nvcc.load.cache_clear()
    mp.undo()


def _per_item(t: torch.Tensor, B: int) -> torch.Tensor:
    """A ``(C,)`` or ``(G, C)`` parameter as a term of ``(B, C, H, W)``."""
    if t.ndim == 2:
        t = t.repeat_interleave(B // len(t), dim=0)
    return t.reshape(-1, t.shape[-1], 1, 1)


def _as_on_the_card(conv, bias, mean, var, weight, shift, eps, padding):
    """The chain as the kernel computes it: the bias added in conv's dtype,
    cuDNN's eval BatchNorm, ``fma(weight * (t - mean), 1 / std, shift)``
    with 1 / std as the host build takes it (``1 / sqrtf``; ``rsqrtf`` on
    the card), ReLU and the pool.  The fma is taken in float64 and rounded
    once more (a double rounding, off by an ulp in about 2^-28 of the
    values)."""
    B = len(conv)
    t = (conv + _per_item(bias, B)).float()
    inv = 1 / torch.sqrt(var + eps)
    prod = _per_item(weight, B) * (t - _per_item(mean, B))
    z = (prod.double() * _per_item(inv, B).double()
         + _per_item(shift, B).double()).float()
    return max_pool(torch.relu(z), (2, 2), (2, 2), padding)


def _host_operands(B, C, H, W, dtype, rows=1, offset=0):
    """A product (``offset`` elements into its buffer, so that its pointer
    is aligned to that many elements' bytes less than a pack), its bias
    and BatchNorm's parameters, one weight negative."""
    g = torch.Generator().manual_seed(B * 1000 + H * 10 + W)
    n = B * C * H * W
    buf = (torch.randn(n + offset, generator=g) * 2).to(dtype)
    conv = buf[offset:].view(B, C, H, W)
    shape = (rows, C) if rows > 1 else (C,)

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=g)
    weight = u(0.9, 1.1)
    weight[..., 1] *= -1
    return (conv, u(-0.05, 0.05).to(dtype), u(-0.05, 0.05), u(0.9, 1.1),
            weight, u(-0.05, 0.05), BN_KW["eps"])


#: (B, C, H, W, first element's offset): each load width the kernel takes
#: (16 bytes at W = 8 or 16 in bf16 and W = 12 in float32; 8 bytes at
#: W = 34; element by element at W = 17 or off a pack's alignment) and an
#: odd H (a pooled row alone in 'SAME', dropped in 'VALID').
HOST_SHAPES = [(2, 3, 8, 16, 0), (2, 3, 7, 12, 0), (2, 3, 6, 34, 0),
               (2, 3, 9, 17, 0), (2, 3, 6, 16, 1), (2, 3, 5, 16, 2),
               (1, 2, 3, 3, 0)]


@pytest.mark.parametrize("shape", HOST_SHAPES,
                         ids=["x".join(map(str, s)) for s in HOST_SHAPES])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bf16"])
def test_kernel_source_on_the_host(host_kernel, dtype, padding, shape):
    """The kernel bit for bit against the chain as the card computes it;
    the counters count the launch in its pooling mode."""
    *dims, offset = shape
    args = _host_operands(*dims, dtype, offset=offset)
    before = counters()
    got = cb._launch(*args, padding)
    want = _as_on_the_card(*args, padding)
    assert got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    key = f"conv_block.launches_by_pool.{padding.lower()}"
    assert counters()[key] - before.get(key, 0) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bf16"])
def test_kernel_source_takes_a_parameter_row_per_trial(host_kernel, dtype):
    """``(G, C)`` bias and BatchNorm parameters, one row for each B / G
    consecutive items: the kernel against the chain, each row's items
    their own."""
    args = _host_operands(6, 4, 7, 12, dtype, rows=3)
    got = cb._launch(*args, "SAME")
    want = _as_on_the_card(*args, "SAME")
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    conv, *params, eps = args
    for r in range(3):
        items = slice(2 * r, 2 * r + 2)
        row = _as_on_the_card(conv[items], *(p[r] for p in params), eps,
                              "SAME")
        assert torch.equal(got[items], row)

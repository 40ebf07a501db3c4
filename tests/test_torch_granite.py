"""Granite-Hybrid-MTL (``models/granite.py``), the SSD scan
(``ops/ssd_scan.py``, ``csrc/ssd_scan.cu``), the segmenter's 'stream' mode
and the benchmark's cell that uses them, on the CPU at small sizes.  The
model has no flax counterpart: it is held to the benchmark's plain
reference (``benchmark/reference/models/granite_hybrid_mtl.py``,
``benchmark/reference/segment_stream.py``), which imports nothing of the
port.  The scan kernel's source is built for the host with g++
(``tests/cuda_host_threads/``: a block's threads as threads that meet at
each barrier) and held to the plain version at the published head
shapes."""

from __future__ import annotations

import contextlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.flops import granite_hybrid_mtl as gflops
from benchmark.reference import layers as rlayers
from benchmark.reference import segment_stream as rstream
from benchmark.reference.models import granite_hybrid_mtl as rgranite
from benchmark.run import result
from sm_hpss_mtl_tpu_torch.cli import experiment as texp
from sm_hpss_mtl_tpu_torch.cli import segment as tcli
from sm_hpss_mtl_tpu_torch.data import audio as taudio
from sm_hpss_mtl_tpu_torch.infer import Classifier
from sm_hpss_mtl_tpu_torch.models.granite import (LAYER_TYPES,
                                                  GraniteHybridMTL)
from sm_hpss_mtl_tpu_torch.models.zoo import INPUT_KIND, MTL, get_model
from sm_hpss_mtl_tpu_torch.ops import _nvcc
from sm_hpss_mtl_tpu_torch.ops import ssd_scan as ss
from sm_hpss_mtl_tpu_torch.train.config import ExperimentConfig
from sm_hpss_mtl_tpu_torch.utils import profiling
from sm_hpss_mtl_tpu_torch.weights import save_state_npz

torch.set_num_threads(2)

CPU = torch.device("cpu")
CARD = {"name": "cpu", "power_limit_w": None}
#: Width 64, 4 layers (mamba, mamba, attention, mamba), 4 Mamba-2 heads
#: of 16 with states of 16, 4 query heads over 2 key heads, 8 bands.
SMALL = dict(hidden_size=64, layer_types=("mamba", "mamba", "attention",
                                          "mamba"),
             num_attention_heads=4, num_key_value_heads=2, mamba_n_heads=4,
             mamba_d_head=16, mamba_d_state=16, shared_intermediate_size=128)
N_MELS = 8
D = 2 * N_MELS
#: The reference's scan chunk here: short, so that its chunk-to-chunk
#: recurrence runs (the published 256 is the card's).
REF_CHUNK = 8
#: Float32 sums in another order (the scan's recurrence against the
#: reference's chunked einsums, the conv as shifted products against
#: conv1d, SDPA against explicit products) through 4 layers move the heads
#: by ~1e-7 of their O(1) values; 2e-5 is two orders above that and two
#: below a wrong step (a state not carried reads 1e-2 to 1e-1 here).
ATOL = 2e-5


def small_config(**over) -> dict:
    cfg = harness.read_json(harness.BENCH_DIR / "configs"
                            / "granite_hybrid_mtl.json")
    arch = dict(SMALL, layer_types=list(SMALL["layer_types"]))
    return dict(cfg, **arch, mamba_chunk_size=REF_CHUNK, in_dim=D,
                features=dict(cfg["features"], n_mels=N_MELS),
                program={"arch_kwargs": SMALL}) | over


@pytest.fixture(scope="module")
def small():
    """A small Granite-Hybrid-MTL with the benchmark's seeded weights (its
    reference's ``init_leaf`` for the scan's parameters), and them."""
    cfg = small_config()
    net = get_model("Granite_Hybrid_MTL", n_mels=N_MELS, **SMALL)
    W = harness.seeded_weights(net, 11, CPU, cfg)
    net.load_state_dict(W)
    return net.eval(), W, cfg


def _x(n: int, frames: int, seed: int = 0) -> torch.Tensor:
    return torch.randn(n, D, frames, generator=torch.Generator()
                       .manual_seed(seed))


def _stream(net, x: torch.Tensor, positions: int) -> dict:
    """``x`` through a fresh state in chunks of ``positions``."""
    state = net.new_state(len(x))
    outs: dict = {}
    with torch.no_grad():
        for s in range(0, x.shape[-1], 2 * positions):
            for k, v in net(x[..., s:s + 2 * positions], state).items():
                outs.setdefault(k, []).append(v)
    return {k: torch.cat(v, 1) for k, v in outs.items()}


def test_whole_pass_matches_the_reference(small):
    net, W, cfg = small
    x = _x(2, 2 * 61)
    with torch.no_grad():
        got = net(x, net.new_state(2))
        want = rgranite.forward(x, W, cfg, rlayers.Draws(None), train=False)
    assert list(got) == ["S", "M", "R", "3C"] == list(want)
    for head, units in (("S", 1), ("M", 1), ("R", 2), ("3C", 3)):
        assert got[head].shape == (2, 61, units)
        torch.testing.assert_close(got[head], want[head], rtol=0, atol=ATOL)
    assert got["S"][0].std() > 1e-3


def test_the_trunk_is_causal(small):
    net, W, cfg = small
    x = _x(1, 2 * 40, seed=1)
    y = x.clone()
    y[..., 51:] += 1.0             # frames from 51 on: position 25 and later
    with torch.no_grad():
        a = rgranite.forward(x, W, cfg, rlayers.Draws(None), train=False)
        b = rgranite.forward(y, W, cfg, rlayers.Draws(None), train=False)
    assert torch.equal(a["S"][:, :25], b["S"][:, :25])
    assert not torch.equal(a["S"][:, 25], b["S"][:, 25])


@pytest.mark.parametrize("positions", [2, 7, 256, 300])
def test_streamed_chunks_match_the_whole_pass(small, positions):
    net, _, _ = small
    x = _x(2, 2 * 620, seed=2)
    with torch.no_grad():
        whole = net(x, net.new_state(2))
    got = _stream(net, x, positions)
    for head in whole:
        torch.testing.assert_close(got[head], whole[head], rtol=0, atol=ATOL)


def test_slots_of_different_pasts_match_their_own_streams(small):
    net, _, _ = small
    x = _x(2, 2 * 90, seed=3)
    state = net.new_state(2)
    with torch.no_grad():
        first = net(x[..., :60], state)
        state.reset(1)                        # slot 1 starts again
        assert state.lengths == [30, 0]
        both = net(torch.stack([x[0, :, 60:120], x[1, :, :60]]), state)
        assert state.lengths == [60, 30]
        own0 = _stream(net, x[:1, :, :120], 30)
        own1 = _stream(net, x[1:, :, :60], 30)
    torch.testing.assert_close(torch.cat([first["S"][:1], both["S"][:1]], 1),
                               own0["S"], rtol=0, atol=ATOL)
    torch.testing.assert_close(both["S"][1:], own1["S"], rtol=0, atol=ATOL)


def test_a_reset_slot_is_a_fresh_stream(small):
    net, _, _ = small
    x = _x(1, 2 * 50, seed=4)
    state = net.new_state(1)
    with torch.no_grad():
        net(_x(1, 2 * 70, seed=5), state)
        kept = state.kv[0][0][0]
        state.reset(0)
        got = net(x, state)
        # The reset slot reuses its buffers: 50 positions fit in its 70.
        assert state.kv[0][0][0] is kept
        fresh = net(x, net.new_state(1))
    for head in got:
        assert torch.equal(got[head], fresh[head])


def test_kv_buffers_grow_as_a_stream_outruns_them(small):
    net, _, _ = small
    x = _x(1, 2 * 80, seed=6)
    state = net.new_state(1)
    outs, capacity = [], []
    with torch.no_grad():
        for s in range(0, 160, 40):
            outs.append(net(x[..., s:s + 40], state)["S"])
            capacity.append(state.kv[0][0][0].shape[1])
        whole = net(x, net.new_state(1))["S"]
    # Made at the first append, doubled when a chunk no longer fits.
    assert state.lengths == [80] and capacity == [20, 40, 80, 80]
    torch.testing.assert_close(torch.cat(outs, 1), whole, rtol=0, atol=ATOL)


def _scan_inputs(batch: int, L: int, H: int, P: int, N: int, seed: int,
                 pad: int = 0):
    """x, B, C as rows of one stride (``pad`` extra floats a row, as the
    mixer's conv output holds them), dt in Mamba-2's range, A in [-16, -1],
    D, and a start state."""
    g = torch.Generator().manual_seed(seed)
    rows = 0.5 * torch.randn(batch, L, H * P + 2 * N + pad, generator=g)
    x = rows[..., :H * P].view(batch, L, H, P)
    B, C = rows[..., H * P:H * P + N], rows[..., H * P + N:H * P + 2 * N]
    dt = torch.exp(np.log(1e-3) + np.log(100.0)
                   * torch.rand(batch, L, H, generator=g))
    A = -(1 + 15 * torch.rand(H, generator=g))
    Dv = 0.5 + torch.rand(H, generator=g)
    state = 0.3 * torch.randn(batch, H, P, N, generator=g)
    return x, dt, A, B, C, Dv, state


@pytest.mark.parametrize("start", [False, True], ids=["zeros", "carried"])
def test_reference_chunked_ssd_matches_the_recurrence(start):
    x, dt, A, B, C, Dv, state = _scan_inputs(2, 37, 3, 4, 5, seed=7)
    state = state if start else None
    y, final = rgranite.ssd(x * dt[..., None], dt * A, B, C, 8,
                            None if state is None else state.clone())
    want_y, want_s = ss.ssd_scan_plain(x.double(), dt.double(), A.double(),
                                       B.double(), C.double(),
                                       torch.zeros(3, dtype=torch.double),
                                       None if state is None
                                       else state.double())
    # A float32 cumulative sum of dt A (down to ~-60 over a chunk of 8)
    # leaves ~1e-6 of relative error in its decays.
    torch.testing.assert_close(y.double(), want_y, rtol=0, atol=1e-5)
    torch.testing.assert_close(final.double(), want_s, rtol=0, atol=1e-5)


def test_plain_scan_goes_on_from_a_start_state():
    x, dt, A, B, C, Dv, state = _scan_inputs(2, 40, 3, 4, 5, seed=8)
    y, s = ss.ssd_scan_plain(x, dt, A, B, C, Dv, state)
    y1, s1 = ss.ssd_scan_plain(x[:, :17], dt[:, :17], A, B[:, :17],
                               C[:, :17], Dv, state)
    y2, s2 = ss.ssd_scan_plain(x[:, 17:], dt[:, 17:], A, B[:, 17:],
                               C[:, 17:], Dv, s1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, rtol=0, atol=1e-6)
    torch.testing.assert_close(s2, s, rtol=0, atol=1e-6)
    # The start state's own contribution: exp(cumsum(dt A)) C . S.
    y0, _ = ss.ssd_scan_plain(x, dt, A, B, C, Dv, None)
    decay = torch.exp(torch.cumsum(dt * A, 1))            # (b, L, H)
    carried = decay[..., None] * torch.einsum("bln,bhpn->blhp", C, state)
    torch.testing.assert_close(y - y0, carried, rtol=0, atol=1e-5)
    # The route: CPU tensors take the plain version.
    torch.testing.assert_close(ss.ssd_scan(x, dt, A, B, C, Dv, state)[0], y,
                               rtol=0, atol=0)


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    x, dt, A, B, C, Dv, state = _scan_inputs(1, 9, 2, 64, 128, seed=9)
    assert ss._check(x, dt, A, B, C, Dv, state) == x.stride(1)
    small = _scan_inputs(1, 9, 2, 16, 16, seed=9)
    with pytest.raises(ValueError, match="heads of 64"):
        ss._check(*small)
    with pytest.raises(TypeError, match="float32"):
        ss._check(x.double(), dt, A, B, C, Dv, state)
    with pytest.raises(ValueError, match="rows of one stride"):
        ss._check(x, dt, A, B.contiguous(), C, Dv, state)
    with pytest.raises(ValueError, match="contiguous"):
        ss._check(x, dt, A, B, C, Dv,
                  state.transpose(-1, -2).contiguous().transpose(-1, -2))


# --- The kernel's source, built for the host -------------------------------

HOST_SHIM = Path(__file__).parent / "cuda_host_threads"
_LAUNCH = re.compile(r"(\w+(?:<[^<>;]*>)?)<<<(.*?)>>>\((.*?)\);", re.S)
_SHARED = "extern __shared__ float4 ssd_shared[];"


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """``csrc/ssd_scan.cu`` built with g++ against
    ``tests/cuda_host_threads``, bound as ``ops/ssd_scan.py`` binds the
    card's library."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the kernel's source for the host")
    src = (_nvcc.CSRC / "ssd_scan.cu").read_text()
    assert src.count(_SHARED) == 1
    host = _LAUNCH.sub(lambda m: f"host_launch({m.group(2)}, "
                       f"[&] {{ {m.group(1)}({m.group(3)}); }});", src)
    host = host.replace(_SHARED, "float4* ssd_shared = host_shared();")
    assert "<<<" not in host
    d = tmp_path_factory.mktemp("ssd_scan_host")
    (d / "ssd_scan.cpp").write_text(host)
    out = d / "libssd_scan_host.so"
    subprocess.run(["g++", "-std=c++20", "-O2", "-ffp-contract=off",
                    "-shared", "-fPIC", "-pthread", "-Wno-unknown-pragmas",
                    f"-I{HOST_SHIM}", "-o", str(out),
                    str(d / "ssd_scan.cpp")], check=True,
                   capture_output=True)
    mp = pytest.MonkeyPatch()
    mp.setattr(_nvcc, "build", lambda source, *a: out)
    mp.setattr(_nvcc, "_made_current",
               lambda device: contextlib.nullcontext())
    mp.setattr(_nvcc, "_stream", lambda device: 0)
    _nvcc.load.cache_clear()
    yield ss
    _nvcc.load.cache_clear()
    mp.undo()


@pytest.mark.parametrize("batch,L,start", [(1, 300, True), (2, 256, False),
                                           (2, 37, True)],
                         ids=["short_last_chunk", "whole_chunk", "one_short"])
def test_kernel_source_matches_the_recurrence(host_kernel, batch, L, start):
    x, dt, A, B, C, Dv, state = _scan_inputs(batch, L, 2, 64, 128,
                                             seed=L + batch, pad=3)
    state = state if start else None
    before = profiling.counters().get("ssd_scan.launches", 0)
    y, s = host_kernel._launch(x, dt, A, B, C, Dv, state)
    assert profiling.counters()["ssd_scan.launches"] == before + 1
    want_y, want_s = ss.ssd_scan_plain(
        *(t.double() for t in (x, dt, A, B, C, Dv)),
        None if state is None else state.double())
    # The kernel's decays are differences of a float32 cumulative sum (down
    # to ~-400 over a chunk): ~3e-5 of relative error in a decay, on
    # outputs of O(1) to O(10).
    scale = float(want_y.abs().max())
    torch.testing.assert_close(y.double(), want_y, rtol=0,
                               atol=2e-5 * scale)
    torch.testing.assert_close(s.double(), want_s, rtol=0,
                               atol=2e-5 * float(want_s.abs().max()))


# --- The registry, the widths and the counts --------------------------------


def test_published_widths_and_registry():
    with torch.device("meta"):
        net = get_model("Granite_Hybrid_MTL")
    trunk = sum(p.numel() for k, p in net.named_parameters()
                if k.startswith("layers."))
    assert trunk == 2_985_873_152                  # 36 x 76.2 M + 4 x 60.8 M
    assert [layer.kind for layer in net.layers] == list(LAYER_TYPES)
    assert [i for i, k in enumerate(LAYER_TYPES) if k == "attention"] == \
        [5, 15, 25, 35]
    m = net.layers[0].mamba
    assert m.in_proj.weight.shape == (4096 + 4352 + 64, 2048)
    assert m.conv1d.weight.shape == (4352, 1, 4) and m.A_log.shape == (64,)
    assert net.layers[5].self_attn.k_proj.weight.shape == (512, 2048)
    assert net.conv1.in_channels == 256 and net.context_frames == 3000
    assert MTL["Granite_Hybrid_MTL"] and \
        INPUT_KIND["Granite_Hybrid_MTL"] == "stream"
    with pytest.raises(ValueError, match="float32"):
        get_model("Granite_Hybrid_MTL", dtype=torch.bfloat16, **SMALL)


def test_flops_at_the_published_widths():
    cfg = harness.read_json(harness.BENCH_DIR / "configs"
                            / "granite_hybrid_mtl.json")
    assert gflops.forward_flops(cfg) * 1500 == pytest.approx(9.0e12,
                                                             rel=0.01)
    # 49.2 M x (past + 750) a chunk: 2.2 TFLOP at 45 000 carried positions.
    got = gflops.attention_flops(cfg, 1, 45_000 + 1500, 1500)
    assert got == pytest.approx(49.152e6 * (45_000 + 750), rel=1e-3)
    # The scan: chunks 5 x 256 + 220; two chunks of a kind add.
    assert gflops.scan_flops(cfg, 1500) == \
        5 * gflops.scan_flops(cfg, 256) + gflops.scan_flops(cfg, 220)


def test_the_trunks_products_match_the_flop_counter():
    from torch.utils.flop_counter import FlopCounterMode
    arch = dict(SMALL, layer_types=("mamba", "mamba"))
    net = get_model("Granite_Hybrid_MTL", n_mels=N_MELS, **arch).eval()
    cfg = small_config(layer_types=list(arch["layer_types"]))
    P = 24
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        net(torch.zeros(1, D, 2 * P), net.new_state(1))
    # The counter sees the stem's convolutions, the projections, the MLPs
    # and the heads; the depthwise conv runs as elementwise products here
    # (2 x 4352 x 4 a position at full width), the scan too.
    conv = 2 * (64 + 2 * 16) * 4
    assert fc.get_total_flops() == P * (gflops.forward_flops(cfg) - 2 * conv)


# --- The segmenter's 'stream' mode ------------------------------------------

CONTEXT = 40


@pytest.fixture(scope="module")
def short():
    """The small model with 40-frame chunks."""
    cfg = small_config()
    net = GraniteHybridMTL(D, **SMALL, context_frames=CONTEXT)
    W = harness.seeded_weights(net, 12, CPU, cfg)
    net.load_state_dict(W)
    return net.eval(), W, cfg


def _fv(T: int, seed: int) -> torch.Tensor:
    """A (D, T) dB featuregram with a floor row in each half."""
    g = torch.Generator().manual_seed(seed)
    fv = -40 + 15 * torch.randn(D, T, generator=g)
    fv[0] = fv[N_MELS] = -80.0
    return fv


def test_stream_slots_match_the_reference(short):
    net, W, cfg = short
    seg = tcli.segmenter("Granite_Hybrid_MTL", net)
    assert seg.input_kind == "stream" and seg.context_frames == CONTEXT
    lengths = [3 * CONTEXT + 7, CONTEXT - 5, 2 * CONTEXT, CONTEXT + 1]
    fvs = [_fv(T, seed) for seed, T in enumerate(lengths)]
    stream = seg.slots(2, CPU)
    todo = list(range(len(fvs)))
    done = {}
    before = profiling.counters()
    calls = 0
    while todo or len(stream.free()) < 2:
        for slot in stream.free():
            if todo:
                i = todo.pop(0)
                stream.assign(slot, i, fvs[i])
        out = stream.step("S", smooth_win=11)
        calls += 1
        for d in out["finished"]:
            done[d["key"]] = d
    after = profiling.counters()
    serve = {"context_frames": CONTEXT, "smooth_win": 11}
    for i, fv in enumerate(fvs):
        want = rstream.tracks(fv, W, cfg, serve)
        assert set(done[i]["tracks"]) == set(want) == {"S", "M", "R", "3C"}
        for head in want:
            assert done[i]["tracks"][head].shape == want[head].shape \
                == (len(fv[0]), want[head].shape[1])
            np.testing.assert_allclose(done[i]["tracks"][head], want[head],
                                       rtol=0, atol=ATOL)
        sm = rstream.smooth(want["S"][:, 0], 11, CPU)
        np.testing.assert_allclose(done[i]["smoothed"], sm, rtol=0,
                                   atol=ATOL)
        assert done[i]["labels"].shape == (len(fv[0]),)
    grew = {k: after.get(k, 0) - before.get(k, 0)
            for k in ("segment.stream_chunks", "segment.stream_positions",
                      "segment.padded_frames", "segment.state_resets")}
    chunks = sum(-(-T // CONTEXT) for T in lengths)
    assert grew == {"segment.stream_chunks": chunks,
                    "segment.stream_positions": sum(-(-T // 2)
                                                    for T in lengths),
                    "segment.padded_frames": chunks * CONTEXT - sum(lengths),
                    "segment.state_resets": len(lengths)}


def test_the_stream_reads_causally_chunk_by_chunk(short):
    """A broadcast's tracks so far are the reference's over the chunks fed,
    and the state carried: dropping it moves them."""
    net, W, cfg = short
    seg = tcli.segmenter("Granite_Hybrid_MTL", net)
    fv = _fv(4 * CONTEXT, 7)
    stream = seg.slots(1, CPU)
    stream.assign(0, "b", fv)
    serve = {"context_frames": CONTEXT, "smooth_win": 11}
    for chunks in (1, 2, 3):
        stream.step()
        want = rstream.tracks(fv, W, cfg, serve, chunks)
        np.testing.assert_allclose(stream.partial(0)["S"], want["S"],
                                   rtol=0, atol=ATOL)
    reset = rstream.tracks(fv, W, cfg, serve, 3, reset=True)
    assert np.abs(reset["S"] - want["S"]).max() > 100 * ATOL
    np.testing.assert_allclose(reset["S"][:CONTEXT], want["S"][:CONTEXT],
                               rtol=0, atol=ATOL)


def test_stream_spans_and_kv_counter(short):
    net, _, _ = short
    seg = tcli.segmenter("Granite_Hybrid_MTL", net)
    stream = seg.slots(2, CPU)
    stream.assign(0, "a", _fv(3 * CONTEXT, 1))
    stream.assign(1, "b", _fv(CONTEXT, 2))
    profiling.reset()
    before = profiling.counters().get("segment.kv_positions", 0)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        stream.step("S", 11)
        stream.step("S", 11)
    P = CONTEXT // 2
    # Call 1: both slots, P keys each; call 2: slot 0 alone, 2 P keys.
    assert profiling.counters()["segment.kv_positions"] - before == 4 * P
    by = {}
    for r in profiling.spans():
        by.setdefault(r.name, []).append(r.n)
    for name in ("segment.assemble", "segment.standardize",
                 "segment.model_call", "segment.to_host"):
        assert by[name] == [2, 1], name
    assert by["segment.smooth"] == [CONTEXT]
    # Per call an append per attention layer and slot, an idle slot's too
    # (it reads zeros), and in call 2 the idle slot's reset before it.
    assert len(by["segment.carry"]) == 2 + 1 + 2
    assert len({r.request for r in profiling.spans()}) == 2


def test_frame_probabilities_streams_one_slot(short):
    net, W, cfg = short
    seg = tcli.segmenter("Granite_Hybrid_MTL", net)
    fv = _fv(2 * CONTEXT + 13, 3)
    sm, labels, got = seg.segment(fv, smooth_win=11)
    want = rstream.tracks(fv, W, cfg, {"context_frames": CONTEXT})
    np.testing.assert_allclose(got["S"], want["S"], rtol=0, atol=ATOL)
    assert labels.shape == sm.shape == (len(fv[0]),)
    seg.standardize = "featuregram"
    with pytest.raises(ValueError, match="per chunk"):
        seg.segment(fv)


def test_cli_serves_the_model_and_training_refuses_it(tmp_path,
                                                      monkeypatch):
    tcli.check_model("Granite_Hybrid_MTL")
    net = GraniteHybridMTL(256, **SMALL, context_frames=CONTEXT)
    wav = str(tmp_path / "b.wav")
    taudio.write_wav(wav, 0.1 * np.random.default_rng(0).standard_normal(
        16000 * 2))
    w = str(tmp_path / "w.npz")
    save_state_npz(w, net.state_dict())
    monkeypatch.setattr(
        "sm_hpss_mtl_tpu_torch.models.zoo.get_model",
        lambda name, **kw: GraniteHybridMTL(256, **SMALL,
                                            context_frames=CONTEXT))
    prob, labels = tcli.main([wav, "--weights", w, "--model",
                              "Granite_Hybrid_MTL", "--device", "cpu",
                              "--smooth-win", "11"])
    assert prob.shape == labels.shape == (198,)
    with pytest.raises(ValueError, match="--chunk-frames does not apply"):
        tcli.main([wav, "--weights", w, "--model", "Granite_Hybrid_MTL",
                   "--device", "cpu", "--chunk-frames", "99"])
    cfg = ExperimentConfig(model="Granite_Hybrid_MTL",
                           data_root=str(tmp_path))
    with pytest.raises(ValueError, match="served .* not trained"):
        texp.run_fold(cfg, {}, 0, device="cpu")
    with pytest.raises(ValueError, match="30-s contexts"):
        Classifier.from_weights(w, model="Granite_Hybrid_MTL", device="cpu")


def test_other_models_build_without_the_granite_modules():
    """Building Jang-MTL and Lemaire-MTL, and loading what the benchmark's
    other kinds load, imports nothing of Granite-Hybrid-MTL or its scan."""
    code = ("import sys\n"
            "import sm_hpss_mtl_tpu_torch.cli.segment\n"
            "import sm_hpss_mtl_tpu_torch.eval.segment\n"
            "import sm_hpss_mtl_tpu_torch.cli.experiment\n"
            "from sm_hpss_mtl_tpu_torch.models.zoo import get_model\n"
            "get_model('Jang_et_al_MTL'); get_model('Lemaire_et_al_MTL')\n"
            "get_model('Whisper_MTL', d_model=32, encoder_layers=1,"
            " encoder_attention_heads=2, encoder_ffn_dim=64)\n"
            "bad = [m for m in ('sm_hpss_mtl_tpu_torch.models.granite',"
            " 'sm_hpss_mtl_tpu_torch.ops.ssd_scan') if m in sys.modules]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          cwd=str(Path(__file__).parents[1]))
    assert proc.returncode == 0, proc.stderr


# --- The benchmark's cell, at a small size on the CPU -------------------------

TINY_POOL = {"count": 2, "minutes": [0.05, 0.12], "segment_s": [1.0, 3.0],
             "bank": 2, "noise_floor": 0.01}
TINY_CHUNK = 200


def _stream_cell() -> harness.Cell:
    cell = harness.load_cell("granite_hybrid_mtl.segment_stream")
    arch = dict(SMALL, context_frames=TINY_CHUNK)
    cell.config = dict(cell.config, **dict(
        SMALL, layer_types=list(SMALL["layer_types"])),
        program={"arch_kwargs": arch})
    cell.mix = dict(cell.mix, pool=TINY_POOL, check_requests=3, streams=2,
                    context_frames=TINY_CHUNK)
    return cell


def test_new_cell_runs_and_checks():
    cell = _stream_cell()
    # A 2-s window: a checked broadcast has to end in it, which takes at
    # least two model calls (~0.1 s each here, several times that on a
    # loaded machine).
    run = harness.load_kind(cell).run(cell, 2 ** 31 + 11, 2.0, False, CPU,
                                      CARD)
    run.e2e["setup_s"] = 1.0
    line = result(run, harness.compare(run.readings, cell.limits), False)
    assert line["correct"], (line, run.faults)
    assert set(line["metrics"]) == {"audio_s_per_s", "setup_s"}
    assert set(line["checks"]) == set(cell.limits)
    c = run.counters
    assert c["stream_chunks"] == sum(k["stream_chunks"] for k in c["calls"])
    assert c["audio_s"] == pytest.approx(
        0.01 * sum(k["frames"] for k in c["calls"]))
    assert c["checked"] and any(k["ended"] for k in c["checked"])
    # Per call, each busy slot's carried and real positions: the real ones
    # are the program's counter, the padding the rest of the chunks.
    fed = [f for k in c["calls"] for f in k["fed"]]
    assert len(fed) == c["stream_chunks"]
    assert sum(n for _, n in fed) == c["stream_positions"]
    assert c["padded_frames"] == (TINY_CHUNK * c["stream_chunks"]
                                  - sum(k["frames"] for k in c["calls"]))
    # One request per broadcast featurized in the window.
    assert len(c["requests"]) == c["state_resets"]
    run.spans.traced = True
    per_layer = result(run, [], True)["metrics"]
    assert "mfu.segment_stream" in per_layer
    assert 0 <= per_layer["pad_share.segment_stream"]["value"] < 100
    # No trace: nothing that reads one.
    for m in ("ssd_roofline.segment_stream",
              "attention_roofline.segment_stream", "device_idle.segment"):
        assert m not in per_layer


def test_cell_seeds_the_weights_in_the_models_own_tensors(small):
    """The cell's weights are ``harness.seeded_weights``'s values, written
    into the model's tensors (no host copy) and returned as those."""
    _, W, cfg = small
    cell = _stream_cell()
    net = get_model("Granite_Hybrid_MTL", n_mels=N_MELS, **SMALL)
    got = harness.load_kind(cell).seeded_on_card(net, 11, CPU, cfg)
    state = net.state_dict()
    assert set(got) == {k for k, v in W.items() if v.is_floating_point()}
    for k, v in got.items():
        assert v.data_ptr() == state[k].data_ptr(), k
        assert torch.equal(v, W[k]), k


@pytest.mark.parametrize("head", ["S", "R"])
def test_stream_check_sees_a_wrong_answer(monkeypatch, head):
    """Every chunk's ``head`` output off by 1e-3: the check reads it in the
    checked broadcasts whether they ended in the window or not (how many
    calls a short window makes on the CPU varies with the machine)."""
    cell = _stream_cell()
    kind = harness.load_kind(cell)
    forward = GraniteHybridMTL.forward

    def off(self, x, state):
        out = forward(self, x, state)
        return dict(out, **{head: out[head] + 1e-3})
    monkeypatch.setattr(GraniteHybridMTL, "forward", off)
    run = kind.run(cell, 7, 0.3, False, CPU, CARD)
    assert run.readings["track_gap"] == pytest.approx(1e-3, rel=0.05)
    assert not all(c["ok"] for c in harness.compare(run.readings,
                                                    cell.limits))


def test_new_entries_are_declared():
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    name = "granite_hybrid_mtl.segment_stream"
    assert cells[name]["chips"] == 1
    configs = {c["name"]: c for c in bench["configs"]}
    assert configs["granite_hybrid_mtl"]["reduced"] == []
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for m in ("mfu.segment_stream", "ssd_roofline.segment_stream",
              "attention_roofline.segment_stream", "pad_share.segment_stream",
              "device_idle.segment", "dispatch_share.segment",
              "to_host_wait.segment", "frontend_roofline.segment",
              "read_rate.segment", "smooth_share.segment"):
        assert name in per_layer[m]["workloads"], m
        assert per_layer[m]["moves"] == "audio_s_per_s"
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert name in e2e["audio_s_per_s"]["workloads"]
    cell = harness.load_cell(name)
    assert {m["name"] for m in cell.end_to_end} == {"audio_s_per_s",
                                                    "setup_s"}
    # The catalog's numbers at the top level of the configuration.
    cfg = cell.config
    assert (cfg["hidden_size"], cfg["mamba_n_heads"], cfg["mamba_d_state"],
            cfg["num_key_value_heads"], len(cfg["layer_types"])) == \
        (2048, 64, 128, 8, 40)

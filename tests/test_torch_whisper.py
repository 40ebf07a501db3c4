"""Whisper-MTL (``models/whisper.py``), the segmenter's 'sequence' mode and
the benchmark's cell that uses them, on the CPU at small sizes.  The
model has no flax counterpart: it is held to the benchmark's plain
reference (``benchmark/reference/models/whisper_mtl.py``,
``benchmark/reference/segment_seq.py``), which imports nothing of the
port."""

from __future__ import annotations

import json
import math

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import harness
from benchmark.flops import whisper_mtl as wflops
from benchmark.reference import layers as rlayers
from benchmark.reference import segment_seq as rseq
from benchmark.reference.models import whisper_mtl as rwhisper
from benchmark.run import result
from sm_hpss_mtl_tpu_torch.cli import experiment as texp
from sm_hpss_mtl_tpu_torch.cli import mtl as tmtl
from sm_hpss_mtl_tpu_torch.cli import segment as tcli
from sm_hpss_mtl_tpu_torch.data import audio as taudio
from sm_hpss_mtl_tpu_torch.infer import Classifier
from sm_hpss_mtl_tpu_torch.models.lemaire import init_weights
from sm_hpss_mtl_tpu_torch.models.whisper import WhisperMTL, sinusoids
from sm_hpss_mtl_tpu_torch.models.zoo import (INPUT_KIND, MTL, get_model,
                                              load_model)
from sm_hpss_mtl_tpu_torch.train.config import ExperimentConfig
from sm_hpss_mtl_tpu_torch.utils import profiling
from sm_hpss_mtl_tpu_torch.weights import (load_state_npz, save_npz,
                                           save_state_npz, to_flax)

torch.set_num_threads(2)

CPU = torch.device("cpu")
CARD = {"name": "cpu", "power_limit_w": None}
#: 2 layers, width 64, 4 heads, FFN 256, 16 bands, a 200-frame context.
SMALL = dict(d_model=64, encoder_layers=2, encoder_attention_heads=4,
             encoder_ffn_dim=256, max_source_positions=100)
N_MELS = 16
CONTEXT = 2 * SMALL["max_source_positions"]


def small_config() -> dict:
    cfg = harness.read_json(harness.BENCH_DIR / "configs"
                            / "whisper_mtl.json")
    return dict(cfg, arch=dict(cfg["arch"], in_dim=2 * N_MELS, **SMALL),
                features=dict(cfg["features"], n_mels=N_MELS),
                program={"arch_kwargs": SMALL}, reference_batch=3)


@pytest.fixture(scope="module")
def small():
    """A small Whisper-MTL with the benchmark's seeded weights, and them."""
    cfg = small_config()
    net = get_model("Whisper_MTL", n_mels=N_MELS, **SMALL)
    W = harness.seeded_weights(net, 11, CPU, cfg)
    net.load_state_dict(W)
    return net.eval(), W, cfg


def test_model_matches_the_reference_at_every_position(small):
    net, W, cfg = small
    x = torch.randn(3, 2 * N_MELS, CONTEXT, generator=torch.Generator()
                    .manual_seed(0))
    with torch.no_grad():
        got = net(x)
        want = rwhisper.forward(x, W, cfg, rlayers.Draws(None), train=False)
    assert list(got) == ["S", "M", "R", "3C"] == list(want)
    for head, units in (("S", 1), ("M", 1), ("R", 2), ("3C", 3)):
        assert got[head].shape == (3, CONTEXT // 2, units)
        torch.testing.assert_close(got[head], want[head], rtol=0, atol=2e-5)
    # The positions differ: the trunk is no per-position constant.
    assert got["S"][0].std() > 1e-3


def test_sinusoids_follow_the_formula_and_stay_out_of_the_state():
    L, C = 1500, 1280
    table = sinusoids(L, C)
    inc = math.log(10000.0) / (C // 2 - 1)
    t = np.arange(L)[:, None] * np.exp(-inc * np.arange(C // 2))[None, :]
    want = np.concatenate([np.sin(t), np.cos(t)], axis=1)
    assert table.shape == (L, C) and table.dtype == torch.float32
    # float32 arguments up to 1500 keep ~1e-4 of their phase.
    np.testing.assert_allclose(table.numpy(), want, rtol=0, atol=3e-4)
    assert torch.equal(table, rwhisper.sinusoids(L, C, CPU))
    net = get_model("Whisper_MTL", n_mels=N_MELS, **SMALL)
    assert not [k for k in net.state_dict() if "position" in k]
    assert torch.equal(net.positions, sinusoids(100, 64))


def test_published_widths_and_registry():
    net = get_model("Whisper_MTL")
    assert sum(p.numel() for p in net.parameters()) == 635_605_975
    assert net.conv1.in_channels == 256 and net.context_frames == 3000
    assert net.layers[0].self_attn.k_proj.bias is None
    assert len(net.layers) == 32 and net.layers[0].fc1.out_features == 5120
    assert MTL["Whisper_MTL"] and INPUT_KIND["Whisper_MTL"] == "sequence"
    with pytest.raises(ValueError, match="float32"):
        get_model("Whisper_MTL", dtype=torch.bfloat16, **SMALL)


def test_forward_flops_match_the_flop_counter(small):
    _, W, cfg = small
    x = torch.zeros(1, 2 * N_MELS, CONTEXT)
    with FlopCounterMode(display=False) as fc:
        rwhisper.forward(x, W, cfg, rlayers.Draws(None), train=False)
    assert wflops.forward_flops(cfg) == fc.get_total_flops()
    full = harness.read_json(harness.BENCH_DIR / "configs"
                             / "whisper_mtl.json")
    assert wflops.forward_flops(full) == pytest.approx(2.277e12, rel=1e-3)
    assert wflops.attention_flops(full) / wflops.forward_flops(full) == \
        pytest.approx(0.162, abs=1e-3)


def _fv(T: int, seed: int = 0) -> torch.Tensor:
    """A (2 * N_MELS, T) dB featuregram with a floor row in each half."""
    g = torch.Generator().manual_seed(seed)
    fv = -40 + 15 * torch.randn(2 * N_MELS, T, generator=g)
    fv[0] = fv[N_MELS] = -80.0
    return fv


@pytest.mark.parametrize("T", [2 * CONTEXT, 2 * CONTEXT + 1, CONTEXT - 37],
                         ids=["whole", "one_frame_tail", "under_one"])
def test_sequence_segmenter_matches_the_reference(small, T):
    net, W, cfg = small
    seg = tcli.segmenter("Whisper_MTL", net)
    assert seg.input_kind == "sequence" and seg.context_frames == CONTEXT
    fv = _fv(T)
    before = profiling.counters()
    sm, labels, got = seg.segment(fv, smooth_win=11)
    after = profiling.counters()
    serve = {"context_frames": CONTEXT, "reference_batch": 2}
    want = rseq.tracks(fv, W, cfg, serve)
    assert set(got) == set(want) == {"S", "M", "R", "3C"}
    for head in want:
        assert got[head].shape == want[head].shape == (T, want[head].shape[1])
        np.testing.assert_allclose(got[head], want[head], rtol=0, atol=2e-5)
    # Frames 2p and 2p + 1 carry position p.
    np.testing.assert_array_equal(got["S"][0:T - T % 2:2],
                                  got["S"][1:T - T % 2 + 1:2])
    ref_sm = rseq.smooth(want["S"][:, 0], 11, CPU)
    np.testing.assert_allclose(sm, ref_sm, rtol=0, atol=2e-5)
    assert labels.shape == (T,)
    n_ctx = -(-T // CONTEXT)
    grew = {k: after.get(k, 0) - before.get(k, 0)
            for k in ("segment.contexts", "segment.padded_frames")}
    assert grew == {"segment.contexts": n_ctx,
                    "segment.padded_frames": n_ctx * CONTEXT - T}


def test_sequence_batches_do_not_move_the_tracks(small):
    net, _, _ = small
    fv = _fv(5 * CONTEXT + 3, seed=1)
    one = tcli.segmenter("Whisper_MTL", net)
    one.batch_windows = 1
    np.testing.assert_allclose(one.frame_probabilities(fv)["S"],
                               tcli.segmenter("Whisper_MTL", net)
                               .frame_probabilities(fv)["S"],
                               rtol=0, atol=2e-6)


def test_sequence_spans_count_contexts(small):
    net, _, _ = small
    seg = tcli.segmenter("Whisper_MTL", net)
    seg.batch_windows = 2
    profiling.reset()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        seg.segment(_fv(3 * CONTEXT + 5), smooth_win=11)
    recs = profiling.spans()
    by = {}
    for r in recs:
        by.setdefault(r.name, []).append(r.n)
    assert by["segment.assemble"] == [2, 2]
    assert by["segment.standardize"] == [2, 2]
    assert by["segment.model_call"] == [2, 2]
    assert by["segment.to_host"] == [2, 2]
    assert by["segment.smooth"] == [3 * CONTEXT + 5]
    assert len({r.request for r in recs}) == 1


def test_cli_serves_the_model_and_training_refuses_it(tmp_path, small):
    net, _, _ = small
    tcli.check_model("Whisper_MTL")
    assert "Whisper_MTL" in tcli.MODELS
    wav = str(tmp_path / "b.wav")
    taudio.write_wav(wav, 0.1 * np.random.default_rng(0).standard_normal(
        16000 * 3))
    w = str(tmp_path / "w.npz")
    save_state_npz(w, net.state_dict())
    for flag in ("--chunk-frames", "--patch-size"):
        with pytest.raises(ValueError, match=f"{flag} does not apply"):
            tcli.main([wav, "--weights", w, "--model", "Whisper_MTL",
                       "--device", "cpu", flag, "99"])
    cfg = ExperimentConfig(model="Whisper_MTL", data_root=str(tmp_path))
    with pytest.raises(ValueError, match="served .* not trained"):
        texp.run_fold(cfg, {}, 0, device="cpu")
    with pytest.raises(ValueError, match="served .* not trained"):
        tmtl.main(["--data", str(tmp_path), "--model", "Whisper_MTL",
                   "--device", "cpu"])
    with pytest.raises(ValueError, match="30-s contexts"):
        Classifier.from_weights(w, model="Whisper_MTL", device="cpu")


def test_weights_round_trip_through_load_model(tmp_path, small, monkeypatch):
    net, _, _ = small
    w = str(tmp_path / "w.npz")
    save_state_npz(w, net.state_dict())
    with np.load(w) as z:
        assert "layers.0.self_attn.q_proj.weight" in z.files
        assert z["conv1.weight"].shape == (64, 2 * N_MELS, 3)
    monkeypatch.setattr(
        "sm_hpss_mtl_tpu_torch.models.zoo.get_model",
        lambda name, **kw: WhisperMTL(2 * N_MELS, **SMALL))
    got = load_model(w, CPU, "Whisper_MTL")
    assert not got.training
    for k, v in net.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k
    x = torch.randn(1, 2 * N_MELS, CONTEXT)
    with torch.no_grad():
        torch.testing.assert_close(got(x)["S"], net(x)["S"], rtol=0, atol=0)


@pytest.mark.parametrize("layout", ["flax", "state_dict"])
def test_load_state_npz_tells_the_layouts_apart(tmp_path, layout):
    # The file's keys pick the layout: flax's "/"-joined ones (the JAX
    # zoo's weights), or a state_dict's own (a model with no flax tree).
    if layout == "flax":
        net = init_weights(get_model("Lemaire_et_al_MTL"),
                           torch.Generator().manual_seed(3))
        save_npz(str(tmp_path / "w.npz"), to_flax(net.state_dict()))
    else:
        net = get_model("Whisper_MTL", n_mels=N_MELS, **SMALL)
        save_state_npz(str(tmp_path / "w.npz"), net.state_dict())
    got = load_state_npz(str(tmp_path / "w.npz"))
    want = net.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v.cpu()), k


# ---------------------------------------------------------------------------
# The benchmark's cell, at a small size on the CPU

TINY_POOL = {"count": 2, "minutes": [0.3, 0.8], "segment_s": [1.0, 3.0],
             "bank": 2, "noise_floor": 0.01}
TINY_SEQ = dict(d_model=32, encoder_layers=1, encoder_attention_heads=2,
                encoder_ffn_dim=64)


def _seq_cell() -> harness.Cell:
    cell = harness.load_cell("whisper_mtl.segment_seq")
    cell.config = dict(cell.config,
                       arch=dict(cell.config["arch"], **TINY_SEQ),
                       program={"arch_kwargs": TINY_SEQ}, reference_batch=2)
    cell.mix = dict(cell.mix, pool=TINY_POOL, check_requests=2)
    return cell


@pytest.mark.parametrize("name", ["whisper_mtl.segment_seq"])
def test_new_cell_runs_and_checks(name):
    cell = _seq_cell()
    run = harness.load_kind(cell).run(cell, 2 ** 31 + 11, 0.5, False, CPU,
                                      CARD)
    run.e2e["setup_s"] = 1.0
    line = result(run, harness.compare(run.readings, cell.limits), False)
    assert line["correct"], line
    assert set(line["metrics"]) == {"audio_s_per_s", "setup_s"}
    assert set(line["checks"]) == set(cell.limits)
    run.spans.traced = True
    per_layer = result(run, [], True)["metrics"]
    c = run.counters
    assert c["contexts"] == sum(r["contexts"] for r in c["requests"])
    assert per_layer["pad_share.segment_seq"]["value"] == pytest.approx(
        100 * c["padded_frames"] / (3000 * c["contexts"]))
    assert "mfu.segment" in per_layer
    # No trace: nothing that reads one.
    for m in ("attention_roofline.segment_seq", "assemble_share.segment_seq",
              "device_idle.segment"):
        assert m not in per_layer


@pytest.mark.parametrize("head", ["S", "3C"])
def test_sequence_check_sees_a_wrong_answer(monkeypatch, head):
    cell = _seq_cell()
    kind = harness.load_kind(cell)
    request = kind.SequenceCell.request

    def off(self, path):
        out = request(self, path)
        out["tracks"][head] = out["tracks"][head] + 1e-3
        return out
    monkeypatch.setattr(kind.SequenceCell, "request", off)
    run = kind.run(cell, 7, 0.2, False, CPU, CARD)
    assert run.readings["track_gap"] == pytest.approx(1e-3, rel=0.05)
    assert not all(c["ok"] for c in harness.compare(run.readings,
                                                    cell.limits))


def test_new_entries_are_declared():
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    assert cells["whisper_mtl.segment_seq"]["chips"] == 1
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for m in ("attention_roofline.segment_seq", "pad_share.segment_seq",
              "assemble_share.segment_seq"):
        assert per_layer[m]["moves"] == "audio_s_per_s"
    for m in ("model_share.segment", "host_share.segment"):
        assert "whisper_mtl.segment_seq" in per_layer[m]["workloads"]
    for m in per_layer:
        assert (harness.BENCH_DIR / "metrics" / f"{m}.py").exists()
    for name in cells:
        cell = harness.load_cell(name)
        assert cell.per_layer and any(m["name"] != "setup_s"
                                      for m in cell.end_to_end)

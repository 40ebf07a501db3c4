"""The port's spans and counters (``sm_hpss_mtl_tpu_torch/utils/profiling``):
nothing is recorded while no profiler records; under ``torch.profiler``
each span is one of the profiler's events, on its clock; parents,
requests and raised exceptions; the spans of a train step and of a
segmentation; the store's bound; the counters under many threads."""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from sm_hpss_mtl_tpu_torch.data.featurize import FeatureConfig
from sm_hpss_mtl_tpu_torch.eval.segment import StreamingSegmenter
from sm_hpss_mtl_tpu_torch.models.zoo import get_model
from sm_hpss_mtl_tpu_torch.train import optimizers
from sm_hpss_mtl_tpu_torch.train.endtoend import (device_featurize_patches,
                                                  make_audio_train_step)
from sm_hpss_mtl_tpu_torch.train.state import TrainState
from sm_hpss_mtl_tpu_torch.utils import profiling

N_MELS, W, CLIPS = 16, 16, 3
#: How far a span's record may lie from its profiler event (the event is
#: taken inside the record's two clock reads).
CLOCK_US = 100


@pytest.fixture(autouse=True)
def empty_store():
    profiling.reset()
    yield
    profiling.reset()


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _train_step():
    """A narrow Lemaire-MTL audio step (the device pipeline's step, the
    plain front end on the CPU), its state, one batch of clips and their
    labels."""
    torch.manual_seed(0)
    net = get_model("Lemaire_et_al_MTL", n_mels=N_MELS, patch_size=W,
                    n_filters=8, nb_stacks=1, Nd=2)
    opt, _ = optimizers.for_model("Lemaire_et_al_MTL", net.parameters(),
                                  tr_steps=100)
    step = make_audio_train_step(
        net, opt, FeatureConfig(n_mels=N_MELS), patch_size=W, patch_shift=W,
        generator=torch.Generator().manual_seed(1), l2_reg=0.01,
        augment_noise=True)
    audio = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (CLIPS, (2 * W - 1) * 160 + 400)).astype(np.float32))
    cls = torch.arange(CLIPS) % 3
    labels = {"3C": torch.eye(3)[cls], "S": (cls == 1).float(),
              "M": (cls == 0).float(),
              "R": torch.stack([(cls != 1).float(), (cls != 0).float()], -1)}
    return step, TrainState(net, opt), audio, labels


class _Calls:
    """A model of two heads that counts its calls and their windows."""

    def __init__(self):
        self.windows = []

    def __call__(self, x):
        self.windows.append(len(x))
        m = x.mean(dim=(1, 2))
        return {"S": torch.sigmoid(m)[:, None],
                "M": torch.sigmoid(-m)[:, None]}


def _segmenter(**kw):
    model = _Calls()
    return model, StreamingSegmenter(predict_fn=model, patch_size=W,
                                     feat_name="LogMelHarmPercSpec", **kw)


def _featuregram(frames=200):
    return torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2 * N_MELS, frames)).astype(np.float32))


def test_nothing_is_recorded_while_no_profiler_records():
    step, state, audio, labels = _train_step()
    step(state, audio, labels)
    _, seg = _segmenter(chunk_frames=50, batch_windows=16)
    seg.segment(_featuregram(), smooth_win=5)
    with profiling.request():
        with profiling.span("outside", n=3) as s:
            s.n = 4
    assert profiling.spans() == [] and profiling.dropped() == 0
    # Off, a span and a request are one shared object: nothing is made.
    assert profiling.span("a") is profiling.span("b", n=1) \
        is profiling.request()


def test_spans_are_the_profilers_events_on_its_clock():
    names = [f"clock.{i}" for i in range(5)]
    with _profile() as prof:
        with profiling.span("warm_up"):
            pass
        for name in names:
            with profiling.span(name):
                time.sleep(0.002)
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append(e)
    records = {r.name: r for r in profiling.spans()}
    for name in names:
        (event,) = events[name]
        rec = records[name]
        start = event.start_ns()
        end = start + event.duration_ns()
        assert abs(rec.start_ns - start) < CLOCK_US * 1000, name
        assert abs(rec.end_ns - end) < CLOCK_US * 1000, name
        assert rec.end_ns - rec.start_ns >= 2_000_000
        assert rec.thread == threading.get_native_id()


def test_parents_requests_and_a_raised_exception():
    with _profile():
        with profiling.request():
            with profiling.span("outer"):
                with profiling.span("inner", n=2):
                    pass
            with profiling.request():            # keeps the outer id
                with profiling.span("sibling"):
                    pass
        with profiling.request():
            with pytest.raises(KeyError):
                with profiling.span("raises"):
                    raise KeyError("x")
        with profiling.span("alone"):
            pass
    rec = {r.name: r for r in profiling.spans()}
    assert [r.name for r in profiling.spans()] == [
        "inner", "outer", "sibling", "raises", "alone"]
    assert rec["inner"].parent == "outer" and rec["inner"].n == 2
    assert rec["outer"].parent is None and rec["sibling"].parent is None
    first = rec["outer"].request
    assert first is not None
    assert rec["inner"].request == rec["sibling"].request == first
    assert rec["raises"].request not in (None, first)
    assert rec["raises"].parent is None and rec["alone"].parent is None
    assert rec["alone"].request is None


def test_a_train_step_records_its_four_phases_in_one_request():
    step, state, audio, labels = _train_step()
    step(state, audio, labels)                    # built outside the trace
    with _profile():
        step(state, audio, labels)
    recs = profiling.spans()
    assert [r.name for r in recs] == ["train.featurize", "train.forward",
                                      "train.backward", "train.optimizer"]
    assert len({r.request for r in recs}) == 1 and recs[0].request
    rows = device_featurize_patches(audio, FeatureConfig(n_mels=N_MELS),
                                    patch_size=W, patch_shift=W).shape[0]
    assert recs[0].n == CLIPS and recs[1].n == rows
    assert all(a.end_ns <= b.start_ns for a, b in zip(recs, recs[1:]))
    assert all(r.parent is None for r in recs)


def test_a_segmentation_records_each_model_call_and_copy():
    model, seg = _segmenter(chunk_frames=50, batch_windows=16)
    fv = _featuregram()
    windows = fv.shape[1] - W + 1
    with _profile():
        seg.segment(fv, smooth_win=5)
    recs = profiling.spans()
    by = {}
    for r in recs:
        by.setdefault(r.name, []).append(r)
    assert len(model.windows) > 4                  # several calls a chunk
    for name in ("segment.model_call", "segment.to_host"):
        assert [r.n for r in by[name]] == model.windows, name
    assert sum(model.windows) == windows
    assert [r.n for r in by["segment.standardize"]] == [50, 50, 50, 35]
    assert [r.n for r in by["segment.smooth"]] == [windows]
    assert set(by) == {"segment.standardize", "segment.model_call",
                       "segment.to_host", "segment.smooth"}
    assert len({r.request for r in recs}) == 1 and recs[0].request


def test_cli_segment_groups_a_files_spans_in_one_request(tmp_path):
    from sm_hpss_mtl_tpu_torch import weights
    from sm_hpss_mtl_tpu_torch.cli import segment as cli
    from sm_hpss_mtl_tpu_torch.data.audio import write_wav
    torch.manual_seed(4)
    net = get_model("Lemaire_et_al_MTL", patch_size=68)
    npz = str(tmp_path / "w.npz")
    weights.save_npz(npz, weights.to_flax(net.state_dict()))
    wav = str(tmp_path / "b.wav")
    n = 2 * 16000
    write_wav(wav, 0.1 * np.random.default_rng(5).standard_normal(n))
    with _profile():
        cli.main([wav, "--weights", npz, "--device", "cpu",
                  "--smooth-win", "5"])
    recs = profiling.spans()
    names = [r.name for r in recs]
    assert names[:2] == ["audio.read", "segment.featurize"]
    assert names[2:] == ["segment.standardize", "segment.model_call",
                         "segment.to_host", "segment.smooth"]
    frames = 1 + (n - 400) // 160
    assert recs[0].n == n and recs[1].n == frames
    assert recs[-1].n == frames - 68 + 1
    assert len({r.request for r in recs}) == 1 and recs[0].request


def test_the_store_keeps_its_bound_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, "_store", profiling._Store(4))
    with _profile():
        for i in range(6):
            with profiling.span(f"s{i}", n=i):
                pass
    assert [r.n for r in profiling.spans()] == [2, 3, 4, 5]
    assert profiling.dropped() == 2
    profiling.reset()
    assert profiling.spans() == [] and profiling.dropped() == 0
    assert profiling.SPAN_CAPACITY == 65536


def test_counts_from_many_threads_are_not_lost():
    name, per_thread, threads = "test.tracing.count", 2000, 16
    before = profiling.counters().get(name, 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [
            profiling.count(name) for _ in range(per_thread)])
            for _ in range(threads)]
        for t in workers:
            t.start()
        for t in workers:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in workers)
    assert profiling.counters()[name] - before == per_thread * threads
    profiling.count(name, 5)
    assert profiling.counters()[name] - before == per_thread * threads + 5

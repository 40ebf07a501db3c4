"""The per-layer metrics that read the program's spans, over a synthetic
store and trace: each gives the value worked out by hand, leaves out
records from before the window, and reads None with no trace, no such
span, records dropped, or a program without the store."""

from __future__ import annotations

import pytest

from benchmark import harness
from benchmark.trace import TraceSummary
from sm_hpss_mtl_tpu_torch.utils import profiling

WINDOW_START = 1_790_000_000.25        # s, on the Unix epoch
TRACED_S = 2.0
MS = 1_000_000                         # ns
SR = 16000


def _at(offset_ms: float) -> int:
    return int(WINDOW_START * 1e9) + int(offset_ms * MS)


def _rec(name, start_ms, dur_ms, n=None):
    return profiling.SpanRecord(name, _at(start_ms), _at(start_ms + dur_ms),
                                None, 1, n, 1)


#: In the window: featurize 100 + 300 ms, forward 150 + 250, backward 400,
#: optimizer 50, stream 10 + 30; audio.read 40 s of audio in 40 ms,
#: smoothing 20 ms, model calls 60 ms, copies 500 ms.  Before it, one of
#: each that no reader may count.
RECORDS = [
    *(_rec(name, -5000, 1000, n=SR) for name in (
        "train.featurize", "train.forward", "train.backward",
        "train.optimizer", "stream.wait", "audio.read", "segment.smooth",
        "segment.model_call", "segment.to_host")),
    _rec("stream.wait", 1, 10), _rec("train.featurize", 11, 100, n=12),
    _rec("train.forward", 111, 150, n=36), _rec("train.backward", 261, 200),
    _rec("train.optimizer", 461, 50), _rec("stream.wait", 600, 30),
    _rec("train.featurize", 630, 300, n=12),
    _rec("train.forward", 930, 250, n=36), _rec("train.backward", 1180, 200),
    _rec("audio.read", 10, 10, n=10 * SR), _rec("audio.read", 30, 30,
                                                  n=30 * SR),
    _rec("segment.model_call", 100, 60, n=5000),
    _rec("segment.to_host", 160, 500, n=5000),
    _rec("segment.smooth", 700, 20, n=5000),
]
#: Device operations in the trace: 130 over two steps.
BY_NAME = {"frontend_kernel": [0.01, 2], "conv": [0.05, 100],
           "Memcpy HtoD": [0.001, 28]}

EXPECTED = {
    "ops_per_step.train": 130 / 2,
    "featurize_share.train": 100 * 0.4 / TRACED_S,
    "forward_share.train": 100 * 0.4 / TRACED_S,
    "backward_share.train": 100 * 0.4 / TRACED_S,
    "optimizer_share.train": 100 * 0.05 / TRACED_S,
    "stream_wait.train": 100 * 0.04 / TRACED_S,
    "read_rate.segment": 40 / 0.04,
    "smooth_share.segment": 100 * 0.02 / TRACED_S,
    "dispatch_share.segment": 100 * 0.06 / TRACED_S,
    "to_host_wait.segment": 100 * 0.5 / TRACED_S,
}


@pytest.fixture
def store(monkeypatch):
    fresh = profiling._Store(profiling.SPAN_CAPACITY)
    for r in RECORDS:
        fresh.add(r)
    monkeypatch.setattr(profiling, "_store", fresh)
    return fresh


def _cell(metric: str) -> harness.Cell:
    return harness.load_cell("lemaire_mtl.train" if metric.endswith(".train")
                             else "lemaire_mtl.segment")


def _run(metric: str, traced: bool = True) -> harness.Run:
    trace = TraceSummary(busy_s=0.1, window_s=TRACED_S, device_ops=[],
                         idle_gaps=[], by_name=dict(BY_NAME))
    return harness.Run(cell=_cell(metric), card={"name": "cpu"},
                       window_start=WINDOW_START,
                       trace=trace if traced else None)


def _read(metric: str, run: harness.Run):
    return harness.load_reader(run.cell, metric).read(run)


def test_every_reader_is_declared_for_its_cells():
    bench = harness.read_json(harness.ROOT / "BENCHMARK.json")
    declared = {m["name"]: m for m in bench["per_layer"]}
    for metric in EXPECTED:
        assert _cell(metric).name in declared[metric]["workloads"], metric
        assert (harness.BENCH_DIR / "metrics" / f"{metric}.py").exists()


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_a_reader_gives_the_hand_computed_value(metric, store):
    assert _read(metric, _run(metric)) == pytest.approx(EXPECTED[metric],
                                                        rel=1e-9)


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_a_reader_reads_none_where_it_has_nothing(metric, store,
                                                  monkeypatch):
    assert _read(metric, _run(metric, traced=False)) is None
    store.dropped = 1
    assert _read(metric, _run(metric)) is None
    store.dropped = 0
    store.records.clear()
    store.records.extend(r for r in RECORDS if r.start_ns < _at(0))
    assert _read(metric, _run(metric)) is None        # all before the window
    store.records.extend(RECORDS)
    # A program without the span store (the parent of the spans' change).
    monkeypatch.delattr(profiling, "spans")
    assert _read(metric, _run(metric)) is None

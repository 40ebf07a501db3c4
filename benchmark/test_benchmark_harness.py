"""The harness on the CPU: what it imports, that a cell is found by name
(a throwaway mix added as files alone), that its result line has the
contract's shape, and that the output check fails a run whose timed path
is broken underneath (the kinds' runs go on the CPU at a tiny size; the
look for a card is ``run.py``'s, which these tests skip)."""

from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import harness
from benchmark.kinds import segment as seg_kind
from benchmark.kinds import train as train_kind
from benchmark.run import result

BENCH = harness.BENCH_DIR
CPU = torch.device("cpu")
CARD = {"name": "cpu", "power_limit_w": None}
TINY_CORPUS = {"music": {"files": 6, "seconds": [3, 5]},
               "speech": {"files": 6, "seconds": [3, 5]}}
TINY_POOL = {"count": 2, "minutes": [0.05, 0.15], "segment_s": [1.0, 3.0],
             "bank": 2, "noise_floor": 0.01}


def _imports(path: Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_nothing_imports_jax_or_the_jax_package():
    files = [p for p in BENCH.rglob("*.py") if not p.name.startswith("test_")]
    for path in files:
        assert not _imports(path) & set(harness.FORBIDDEN), path
    for path in (BENCH / "reference").rglob("*.py"):
        assert not _imports(path) & {"sm_hpss_mtl_tpu_torch", "benchmark"}, \
            path
    # What the kinds load of the port pulls in none of it either.
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.run, benchmark.control, benchmark.readers\n"
            "from benchmark.kinds import train, segment\n" % str(BENCH.parent))
    for path in (BENCH / "kinds").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.startswith("sm_hpss_mtl_tpu_torch"):
                code += f"import {node.module}\n"
    code += ("from benchmark.harness import forbidden_modules\n"
             "assert not forbidden_modules(), forbidden_modules()\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_run_refuses_without_the_card(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path)
    for cwd in (BENCH.parent, tmp_path):
        proc = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload",
             "lemaire_mtl.train", "--seed", "1", "--seconds", "1",
             "--trace", "0"], cwd=cwd, capture_output=True, text=True,
            timeout=300)
        assert proc.returncode != 0 and proc.stdout == ""


def tiny(cell: harness.Cell) -> harness.Cell:
    cell.config = dict(cell.config, train_corpus=TINY_CORPUS)
    cell.mix = dict(cell.mix)
    if "pool" in cell.mix:
        cell.mix.update(pool=TINY_POOL, check_requests=2)
    return cell


def test_a_mix_added_as_files_runs(tmp_path):
    """A throwaway mix, found by name from files and entries alone."""
    for sub in ("configs", "limits", "metrics"):
        shutil.copytree(BENCH / sub, tmp_path / sub)
    mix = json.loads((BENCH / "mixes" / "segment.json").read_text())
    mix.update(pool=TINY_POOL, check_requests=2)
    (tmp_path / "mixes").mkdir()
    (tmp_path / "mixes" / "throwaway.json").write_text(json.dumps(mix))
    shutil.copy(BENCH / "limits" / "lemaire_mtl.segment.json",
                tmp_path / "limits" / "lemaire_mtl.throwaway.json")
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "lemaire_mtl.throwaway",
                               "config": "lemaire_mtl",
                               "traffic": "throwaway", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "lemaire_mtl.segment" in m.get("workloads", ()):
            m["workloads"].append("lemaire_mtl.throwaway")
    cell = harness.load_cell("lemaire_mtl.throwaway", bench, tmp_path)
    cell.config = dict(cell.config, train_corpus=TINY_CORPUS)
    run = harness.load_kind(cell).run(cell, 2 ** 31 + 11, 0.5, False, CPU,
                                        CARD)
    run.e2e["setup_s"] = 1.0
    line = result(run, harness.compare(run.readings, cell.limits), False)
    assert line["correct"], line
    assert set(line["metrics"]) == {"audio_s_per_s", "request_p95_ms",
                                    "setup_s"}
    assert list(line)[-1] == "checks" and line["attempted"] >= 1
    # The per-layer readers that need no trace read the same run.
    run.spans.traced = True
    per_layer = result(run, [], True)["metrics"]
    assert {"mfu.segment", "model_share.segment"} <= set(per_layer)
    assert "device_idle.segment" not in per_layer      # no trace: nothing


def _correct(run) -> bool:
    checks = harness.compare(run.readings, run.cell.limits)
    return all(c["ok"] for c in checks) and not run.faults and not run.failed


def _from_call(n: int, broken, intact):
    """A function that is ``intact`` for its first ``n`` calls and
    ``broken`` after them (a fault that shows only once the window has
    started, as a step captured after warm-up would)."""
    calls = [0]

    def f(*args, **kwargs):
        calls[0] += 1
        return (broken if calls[0] > n else intact)(*args, **kwargs)
    return f


@pytest.mark.parametrize("config", ["lemaire_mtl"])
@pytest.mark.parametrize("fault", [None, "unchanged", "half_batch",
                                   "unchanged_in_window",
                                   "stale_in_window"])
def test_train_check_fails_a_broken_step(fault, config, monkeypatch):
    import sm_hpss_mtl_tpu_torch.cli.experiment as experiment
    import sm_hpss_mtl_tpu_torch.train.state as state
    from sm_hpss_mtl_tpu_torch.train.optimizers import KerasSGD
    cell = tiny(harness.load_cell(f"{config}.train"))
    set_up = cell.mix["check_steps"] + cell.mix["warmup_steps"]
    if fault in ("unchanged", "unchanged_in_window"):
        n = 0 if fault == "unchanged" else set_up
        for opt in (KerasSGD, torch.optim.Adam):
            monkeypatch.setattr(opt, "step", _from_call(
                n, lambda self, closure=None: None, opt.step))
    elif fault == "half_batch":
        losses = state._losses

        def half(outputs, labels, mtl, weights):
            n = next(iter(labels.values())).shape[0] // 2
            return losses({k: v[:n] for k, v in outputs.items()},
                          {k: v[:n] for k, v in labels.items()}, mtl,
                          weights)
        monkeypatch.setattr(state, "_losses", half)
    elif fault == "stale_in_window":
        make = experiment.make_audio_train_step

        def stale_step(*args, **kwargs):
            """From the window on, each step trains on the batch of the
            step before it (an input buffer left unrefreshed)."""
            step, seen = make(*args, **kwargs), []

            def train_step(st, batch, labels):
                seen.append((batch, labels))
                if len(seen) > set_up:
                    batch, labels = seen[-2]
                return step(st, batch, labels)
            return train_step
        monkeypatch.setattr(experiment, "make_audio_train_step", stale_step)
    run = train_kind.run(cell, 2 ** 31 + 5, 0.2, False, CPU, CARD)
    assert _correct(run) == (fault is None), run.readings
    if fault is not None and fault.endswith("_in_window"):
        # The set-up steps were sound: only the window's check fails.
        assert all(c["ok"] for c in harness.compare(run.readings,
                                                    cell.limits)
                   if not c["name"].startswith("window_")), run.readings


@pytest.mark.parametrize("config", ["lemaire_mtl", "jang_mtl"])
@pytest.mark.parametrize("fault", [None, "altered", "half_batch", "stale"])
def test_segment_check_fails_a_broken_answer(fault, config, monkeypatch):
    import sm_hpss_mtl_tpu_torch.cli.segment as cli
    import sm_hpss_mtl_tpu_torch.eval.segment as evseg
    frame_probabilities = evseg.StreamingSegmenter.frame_probabilities
    featurize = cli._featurize_broadcast
    if fault == "altered":
        def altered(self, fv):
            tracks = frame_probabilities(self, fv)
            tracks["S"][len(tracks["S"]) // 2] += 0.01
            return tracks
        monkeypatch.setattr(evseg.StreamingSegmenter, "frame_probabilities",
                            altered)
    elif fault == "half_batch":
        def half(self, fv):
            predict = self.predict_fn

            def first_half(x):
                out = predict(x[:max(1, len(x) // 2)])
                return {k: torch.cat([v, v])[:len(x)] for k, v in out.items()}
            self.predict_fn = first_half
            try:
                return frame_probabilities(self, fv)
            finally:
                self.predict_fn = predict
        monkeypatch.setattr(evseg.StreamingSegmenter, "frame_probabilities",
                            half)
    elif fault == "stale":
        seen = []

        def stale(x, *args, **kwargs):
            """Each request answered with the features of the one
            before it."""
            seen.append(featurize(x, *args, **kwargs))
            return seen[-2] if len(seen) > 1 else seen[-1]
        monkeypatch.setattr(cli, "_featurize_broadcast", stale)
    cell = tiny(harness.load_cell(f"{config}.segment"))
    # A window long enough for two requests on the CPU.
    seconds = 5.0 if config == "jang_mtl" else 0.5
    run = seg_kind.run(cell, 2 ** 31 + 3, seconds, False, CPU, CARD)
    assert _correct(run) == (fault is None), (run.readings, run.faults)

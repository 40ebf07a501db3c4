"""The fold-at-scale tool of the port (``tools/scale_rehearsal_torch.py``)
and the corpus it builds, against the JAX package, on the CPU at tiny size.

The tiny corpus has 4 files per class: with 3, the genre-stratified folds
put every music file into fold 0's test set, and the JAX tool's fold 0
then has no music to train on either."""

import csv
import filecmp
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from sm_hpss_mtl_tpu.data import audio as jaudio
from sm_hpss_mtl_tpu.train import ExperimentConfig as JConfig
from sm_hpss_mtl_tpu_torch.data import audio as taudio
from sm_hpss_mtl_tpu_torch.data.folds import load_cv_folds
from sm_hpss_mtl_tpu_torch.train.config import ExperimentConfig as TConfig

REPO = Path(__file__).resolve().parents[1]
TOOL = REPO / "tools" / "scale_rehearsal_torch.py"
TINY = ["--device", "cpu", "--n-music", "4", "--n-speech", "4",
        "--dur-scale", "0.03"]
KEEP = ("music", "speech", "speech+music")


def _same_tree(a: Path, b: Path) -> None:
    names = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert names == sorted(p.relative_to(b) for p in b.rglob("*")
                           if p.is_file())
    for name in names:
        assert filecmp.cmp(a / name, b / name, shallow=False), name


@pytest.mark.parametrize("calls", [
    # The scale tool's two calls, at a tenth of their durations.
    ((3, (3.0, 9.0), 11, ("music",), False),
     (3, (6.0, 18.0), 12, ("speech",), False)),
    ((2, 1.0, 5, ("noise", "speech"), True),),
])
def test_make_toy_musan_only_writes_the_jax_bytes(tmp_path, calls):
    for n, dur, seed, only, noise in calls:
        for pkg, root in ((taudio, tmp_path / "port"),
                          (jaudio, tmp_path / "jax")):
            pkg.make_toy_musan(str(root), n_per_class=n, duration_s=dur,
                               seed=seed, only=only, with_noise=noise)
    _same_tree(tmp_path / "port", tmp_path / "jax")
    made = {p.name for p in (tmp_path / "port").iterdir()}
    wanted = {c for call in calls for c in call[3]} | {"annotations"}
    assert made == wanted


def _run_tool(*argv, **popen):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.Popen([sys.executable, str(TOOL), *argv], cwd=REPO,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, **popen)


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("scale")
    root, out = tmp / "corpus", tmp / "report.json"
    proc = _run_tool(*TINY, "--epochs", "2", "--pipelines", "device", "host",
                     "--root", str(root), "--out", str(out))
    log, _ = proc.communicate(timeout=240)
    assert proc.returncode == 0, log[-3000:]
    with open(out) as f:
        return root, json.load(f), log


def test_the_tool_writes_per_epoch_rows(tiny_run):
    root, report, log = tiny_run
    assert report["tool"] == "tools/scale_rehearsal_torch.py"
    assert set(report["pipelines"]) == {"device", "host"}
    for key, row in report["pipelines"].items():
        assert row["status"] == "finished"
        assert row["pipeline"] == key and row["model"] == "Lemaire_et_al_MTL"
        assert row["epochs_run"] == len(row["epochs"]) == 2
        assert [r["epoch"] for r in row["epochs"]] == [0.0, 1.0]
        assert row["epoch_train_s"] == [round(r["epoch_train_s"], 1)
                                        for r in row["epochs"]]
        with open(root / f"results_{key}" / "Lemaire_et_al_MTL"
                  / "LogMelHarmPercSpec" / "fold0_log.csv") as f:
            assert len(list(csv.DictReader(f))) == 2
        assert row["device"] == "cpu" and row["compute_dtype"] == "float32"
        assert row["k1_launches"] == 0      # the plain version on the CPU
        assert set(row["stages"]) == {"corpus", "folds", "fit", "test"}
        assert all(s["wall_s"] > 0 for s in row["stages"].values())
        assert row["warm_step_ms"] > 0 and 0 <= row["accuracy"] <= 1
    assert "[timer] fit: wall" in log


def test_the_tool_derives_the_jax_steps(tiny_run):
    root, report, _ = tiny_run
    cv = load_cv_folds(str(root / "cv_info"))
    hours = {k: v for k, v in cv["total_duration"].items() if k in KEEP}
    want = JConfig(batch_size=16, patch_size=68,
                   patch_shift=68).with_steps_from_durations(hours)
    for row in report["pipelines"].values():
        assert (row["tr_steps"], row["v_steps"], row["ts_steps"]) == (
            want.tr_steps, want.v_steps, want.ts_steps)
        assert row["corpus_hours"] == round(sum(hours.values()), 2)
    # At the reference's scale the steps are many: the same rule on the
    # tiny folds' proportions scaled to ~25 h.
    big = {k: v * 25 / sum(hours.values()) for k, v in hours.items()}
    got = TConfig().with_steps_from_durations(big)
    want = JConfig().with_steps_from_durations(big)
    assert got.tr_steps > 1000
    assert (got.tr_steps, got.v_steps, got.ts_steps) == (
        want.tr_steps, want.v_steps, want.ts_steps)


def test_the_tool_refuses_a_corpus_of_another_size(tiny_run, tmp_path):
    root, _, _ = tiny_run
    proc = _run_tool("--device", "cpu", "--n-music", "5", "--root",
                     str(root), "--out", str(tmp_path / "r.json"))
    log, _ = proc.communicate(timeout=120)
    assert proc.returncode != 0 and "holds a corpus made with" in log


def test_a_cut_run_keeps_its_finished_epochs(tiny_run, tmp_path):
    """The report holds each epoch as the fold log flushes it; a tool that
    is terminated marks the run cut and keeps them."""
    root, _, _ = tiny_run
    out = tmp_path / "cut.json"
    proc = _run_tool(*TINY, "--epochs", "200", "--pipelines", "device",
                     "--root", str(root), "--out", str(out), "--merge",
                     "--poll-s", "0.2", start_new_session=True)
    deadline = time.time() + 180
    row = {}
    while time.time() < deadline and proc.poll() is None:
        if out.exists():
            with open(out) as f:
                row = json.load(f)["pipelines"].get("device", {})
            if row.get("status") == "running" and row["epochs"]:
                break
        time.sleep(0.2)
    assert row.get("status") == "running", row
    proc.send_signal(signal.SIGTERM)
    proc.communicate(timeout=60)
    assert proc.returncode == 128 + signal.SIGTERM
    with open(out) as f:
        cut = json.load(f)["pipelines"]["device"]
    assert cut["status"] == "cut"
    assert len(cut["epochs"]) >= len(row["epochs"]) >= 1

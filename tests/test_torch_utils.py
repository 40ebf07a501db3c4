"""The port's timers (``sm_hpss_mtl_tpu_torch/utils``): ``stage_timer`` is
the JAX function, ``time_op`` keeps the JAX contract on the CPU, and
``device_trace`` writes a ``torch.profiler`` trace."""

import ast
import glob
import json
import os
from pathlib import Path

import pytest
import torch

from sm_hpss_mtl_tpu_torch import utils
from sm_hpss_mtl_tpu_torch.utils import device_trace, stage_timer, time_op

REPO = Path(__file__).resolve().parents[1]


def _function(path: Path, name: str) -> str:
    tree = ast.parse(path.read_text())
    (node,) = [n for n in tree.body
               if isinstance(n, ast.FunctionDef) and n.name == name]
    return ast.dump(node)


def test_stage_timer_is_the_jax_function():
    got = _function(REPO / "sm_hpss_mtl_tpu_torch" / "utils"
                    / "profiling.py", "stage_timer")
    want = _function(REPO / "sm_hpss_mtl_tpu" / "utils" / "profiling.py",
                     "stage_timer")
    assert got == want


def test_utils_export_the_jax_names():
    import sm_hpss_mtl_tpu.utils as jutils
    names = {"time_op", "device_trace", "stage_timer", "append_results",
             "dump_configuration", "dump_model_summary"}
    assert names <= set(vars(jutils)) and names <= set(vars(utils))


def test_stage_timer_fills_its_sink_and_prints(capsys):
    sink = {}
    with stage_timer("corpus", sink):
        sum(i * i for i in range(20000))
    with stage_timer("quiet", sink, verbose=False):
        pass
    rec = sink["corpus"]
    assert set(rec) == {"wall_s", "process_s"}
    assert rec["wall_s"] > 0 and rec["process_s"] >= 0
    assert set(sink) == {"corpus", "quiet"}
    out = capsys.readouterr().out
    assert out.startswith("[timer] corpus: wall ") and "quiet" not in out


def test_stage_timer_records_a_stage_that_raises():
    sink = {}
    with pytest.raises(KeyError):
        with stage_timer("failing", sink, verbose=False):
            raise KeyError("x")
    assert "failing" in sink


def _steps(n: int = 192):
    torch.manual_seed(0)
    m = torch.randn(n, n) / n ** 0.5

    def plain(c):
        return torch.tanh(c @ m)

    def heavy(c):
        for _ in range(10):
            c = torch.tanh(c @ m)
        return c
    return plain, heavy, torch.randn(n, n)


@pytest.mark.parametrize("stat", ["min", "median"])
def test_time_op_on_the_cpu_ranks_ten_times_the_work_above(stat):
    # One thread and products of ~1 ms each, so that the chains' difference
    # stands well above a loaded host's scheduling noise.
    plain, heavy, x = _steps(384)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        t_plain = time_op(plain, x, iters=(2, 8), repeats=5, stat=stat)
        t_heavy = time_op(heavy, x, iters=(2, 8), repeats=5, stat=stat)
    finally:
        torch.set_num_threads(threads)
    assert t_plain > 0 and t_heavy > 0
    assert t_heavy > 3 * t_plain


def test_time_op_takes_a_structured_carry_and_refuses_bad_input():
    plain, _, x = _steps()
    t = time_op(lambda c: {"a": plain(c["a"]), "b": c["b"] + 1},
                {"a": x, "b": torch.zeros(3, dtype=torch.int64)},
                iters=(1, 3), repeats=2)
    assert t > 0
    with pytest.raises(ValueError, match="stat"):
        time_op(plain, x, stat="mean")
    with pytest.raises(ValueError, match="no tensor"):
        time_op(lambda c: c, (1, 2))


def test_device_trace_writes_a_trace_on_the_cpu(tmp_path):
    plain, _, x = _steps()
    log_dir = str(tmp_path / "trace")
    with device_trace(log_dir) as prof:
        plain(x)
    files = glob.glob(os.path.join(log_dir, "trace.*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert any(e.key == "aten::mm" for e in prof.key_averages())
    with device_trace(log_dir):
        plain(x)
    assert len(glob.glob(os.path.join(log_dir, "trace.*.json"))) == 2

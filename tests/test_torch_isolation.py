"""The port runs without JAX: no module of ``sm_hpss_mtl_tpu_torch``
imports ``jax`` or the JAX package, and its entry points refuse to fall
back to the CPU when CUDA was asked for and is absent."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "sm_hpss_mtl_tpu_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_port_imports_neither_jax_nor_jax_package():
    mods = list(_modules())
    for new in ("cli.segment", "cli.hpss_resynth", "models.jang",
                "models.pool", "ops.mixing", "ops.hpss", "infer",
                "eval.tester", "data.featurize", "data.folds",
                "data.batcher", "ops.silence", "train.losses",
                "train.optimizers", "train.state", "train.checkpoint",
                "train.loop", "train.config", "train.endtoend",
                "data.prefetch", "data.audiostream", "utils.results",
                "cli.experiment", "cli.mtl", "models.layers",
                "models.cnn", "ops.stats", "data.stats", "cli.baseline",
                "cli.five_class", "cli.fuse_intermediate", "cli.fuse_late",
                "cli.make_folds", "eval.fusion", "cli.tune",
                "utils.bayesopt", "train.multitrial", "cli.featurize",
                "cli.tsne", "train.transfer", "data.balance",
                "data.codecs", "parallel", "parallel.mesh",
                "parallel.distributed", "parallel.halo",
                "parallel.frontend_shard", "parallel.dp", "native",
                "utils", "utils.benchmarking", "utils.profiling"):
        assert f"sm_hpss_mtl_tpu_torch.{new}" in mods, new
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'sklearn', "
        "'sm_hpss_mtl_tpu'))\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env={k: v for k, v in os.environ.items()
                        if k != "PYTHONPATH"})


def test_parallel_names_neither_jax_nor_the_jax_package():
    # parallel/ copies what it needs from the JAX package (process_file_shard)
    # and names it only as "the JAX package": no import, no module path.
    import re
    pattern = re.compile(r"import jax|sm_hpss_mtl_tpu\b")
    files = sorted((PKG / "parallel").glob("*.py"))
    assert len(files) == 6
    for path in files:
        for n, line in enumerate(path.read_text().splitlines(), 1):
            assert not pattern.search(line), f"{path.name}:{n}: {line}"


def test_new_tests_import_only_checked_modules():
    """The port's modules that the bf16, fold, codec and parallel tests
    import are among those the test above imports without JAX."""
    import ast
    mods = set(_modules())
    for name in ("test_torch_bf16.py", "test_torch_bf16_folds.py",
                 "test_torch_codecs.py", "test_torch_parallel.py",
                 "test_torch_distributed.py", "test_torch_native.py",
                 "test_torch_utils.py", "test_torch_scale.py",
                 "test_torch_modes.py"):
        tree = ast.parse((REPO / "tests" / name).read_text())
        used = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and (node.module or "") \
                    .startswith("sm_hpss_mtl_tpu_torch"):
                for alias in node.names:
                    full = f"{node.module}.{alias.name}"
                    used.add(full if full in mods else node.module)
        assert used and used <= mods, (name, sorted(used - mods))


def test_cli_without_device_cpu_raises_when_no_gpu(monkeypatch, tmp_path):
    from sm_hpss_mtl_tpu_torch.cli import segment as tcli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main([str(tmp_path / "missing.wav"), "--weights",
                   str(tmp_path / "missing.npz")])


def test_hpss_resynth_without_device_cpu_raises_when_no_gpu(monkeypatch,
                                                            tmp_path):
    from sm_hpss_mtl_tpu_torch.cli import hpss_resynth as tcli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main([str(tmp_path / "missing.wav")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.resynthesize(np.zeros(1600, np.float32))


def test_jang_cli_without_device_cpu_raises_when_no_gpu(monkeypatch,
                                                        tmp_path):
    from sm_hpss_mtl_tpu_torch.cli import segment as tcli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main([str(tmp_path / "missing.wav"), "--weights",
                   str(tmp_path / "missing.npz"), "--model",
                   "Jang_et_al_MTL"])


def test_classifier_and_featurizer_without_device_cpu_raise_when_no_gpu(
        monkeypatch, tmp_path):
    from sm_hpss_mtl_tpu_torch.data.featurize import FeatureConfig, Featurizer
    from sm_hpss_mtl_tpu_torch.infer import Classifier
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Featurizer(FeatureConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Classifier.from_weights(str(tmp_path / "missing.npz"))


def test_baseline_cli_without_device_cpu_raises_when_no_gpu(monkeypatch,
                                                            tmp_path):
    from sm_hpss_mtl_tpu_torch.cli import baseline as tcli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["--data", str(tmp_path), "--model", "Jang_et_al"])


@pytest.mark.parametrize("cli,argv", [
    ("five_class", []), ("fuse_intermediate", []),
    ("fuse_intermediate", ["--pipeline", "host"]),
    ("fuse_late", ["--ckpt-harm", "h", "--ckpt-perc", "p"])])
def test_lemaire_variant_clis_without_device_cpu_raise_when_no_gpu(
        monkeypatch, tmp_path, cli, argv):
    import importlib
    mod = importlib.import_module(f"sm_hpss_mtl_tpu_torch.cli.{cli}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(["--data", str(tmp_path), *argv])


@pytest.mark.parametrize("script", ["chip_smoke.py",
                                    "tools/bf16_step_bars.py",
                                    "tools/bf16_probe.py",
                                    "tools/multi_gpu_check.py",
                                    "tools/scale_rehearsal_torch.py",
                                    "tools/kernels_ab.py"])
def test_chip_scripts_import_neither_jax_nor_jax_package(script):
    # Both run on the GPU machine, which has no JAX: importing them (not
    # running them) must pull in neither jax nor the JAX package.
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('s', {script!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'sm_hpss_mtl_tpu'))\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env={k: v for k, v in os.environ.items()
                        if k != "PYTHONPATH"})

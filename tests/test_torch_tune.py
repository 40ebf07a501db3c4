"""``cli.tune`` in the port against the JAX CLI: every mode at the JAX
tests' arguments (``tests/test_segment_tune_tsne.py``,
``tests/test_multitrial.py``) with ``--device cpu``, the rows and the
``Performance_Tuning.csv`` header the JAX CLI writes, finite losses; the
grids' median pairs within the kernels' pairs; the refusals (no GPU,
several GPUs); the TCN's skip connections of the architecture space
against flax.  Models are Lemaire-MTL at the preset width on 16-frame
patches, one train and one val step per trial.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sm_hpss_mtl_tpu.cli import tune as jtune
from sm_hpss_mtl_tpu.models import get_model as jget_model
from sm_hpss_mtl_tpu_torch import weights
from sm_hpss_mtl_tpu_torch.cli import tune
from sm_hpss_mtl_tpu_torch.data.audio import make_toy_musan
from sm_hpss_mtl_tpu_torch.models.zoo import get_model
from sm_hpss_mtl_tpu_torch.ops.hpss import KERNEL_MEDIANS

torch.set_num_threads(2)

TINY = ["--epochs", "1", "--batch-size", "2", "--patch-size", "16",
        "--tr-steps", "1", "--v-steps", "1"]


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    return make_toy_musan(str(tmp_path_factory.mktemp("tune") / "corpus"),
                          n_per_class=6, duration_s=2.0)


def _header(out):
    with open(os.path.join(out, "Performance_Tuning.csv")) as f:
        return f.readline().rstrip("\n")


def _jax_header(monkeypatch, tmp_path, argv):
    """The header the JAX CLI writes for ``argv``, its trainings replaced
    by a fixed score (the header is the rows' keys)."""
    monkeypatch.setattr(jtune, "_score", lambda cfg, fold, tag: {
        "val_loss": 1.0, "accuracy": 0.5})
    out = str(tmp_path / "jax")
    jtune.main(["--data", str(tmp_path), "--output", out, *argv])
    return _header(out)


def test_tune_grid_tiny(toy, tmp_path, monkeypatch):
    out = str(tmp_path / "out")
    rows, best = tune.main(["--data", toy, "--output", out, "--mode", "grid",
                            "--param", "l_perc", *TINY, "--device", "cpu"])
    assert len(rows) == 5
    assert [r["l_perc"] for r in rows] == ["11", "21", "31", "41", "51"]
    assert np.isfinite(best["val_loss"]) and best in rows
    assert all(np.isfinite(r["val_loss"]) for r in rows)
    assert _header(out) == _jax_header(monkeypatch, tmp_path, [
        "--mode", "grid", "--param", "l_perc"]) \
        == "fold\tl_perc\tval_loss\taccuracy"


def test_tune_search_tiny(toy, tmp_path, monkeypatch):
    out = str(tmp_path / "out")
    rows, best = tune.main(["--data", toy, "--output", out, "--mode",
                            "search", "--space", "mtl-heads", "--trials", "2",
                            *TINY, "--device", "cpu"])
    assert len(rows) == 2
    assert {"head_layers", "head_width"} <= set(rows[0])
    assert all(np.isfinite(r["val_loss"]) for r in rows)
    # The JAX CLI's random search draws the same architectures.
    assert _header(out) == _jax_header(monkeypatch, tmp_path, [
        "--mode", "search", "--space", "mtl-heads", "--trials", "2"])
    with open(os.path.join(tmp_path / "jax", "Performance_Tuning.csv")) as f:
        jrows = f.read().splitlines()[1:]
    assert [r.split("\t")[2:4] for r in jrows] == [
        [str(r["head_layers"]), str(r["head_width"])] for r in rows]


def test_tune_search_bayes_tiny(toy, tmp_path):
    rows, best = tune.main(["--data", toy, "--output", str(tmp_path),
                            "--mode", "search", "--space", "mtl-heads",
                            "--algo", "bayes", "--trials", "3", *TINY,
                            "--device", "cpu"])
    assert len(rows) == 3
    assert {"head_layers", "head_width"} <= set(rows[0])
    # distinct configurations (the optimizer dedups its asks)
    assert len({(r["head_layers"], r["head_width"]) for r in rows}) == 3
    assert np.isfinite(best["val_loss"])


def test_tune_search_arch_trains_skip_connections(toy, tmp_path):
    # The architecture space names every TCN knob, skip connections among
    # them; seed 0 draws a trial with them on.
    rows, _ = tune.main(["--data", toy, "--output", str(tmp_path), "--mode",
                         "search", "--space", "arch", "--trials", "2",
                         *TINY, "--device", "cpu"])
    assert {"kernel_size", "Nd", "nb_stacks", "n_filters",
            "use_skip_connections"} <= set(rows[0])
    assert any(r["use_skip_connections"] for r in rows)
    assert all(np.isfinite(r["val_loss"]) for r in rows)


def test_tune_cli_vmapped_grid(toy, tmp_path):
    # The JAX package's test of the same name: --vmap trains the whole
    # loss-weight grid as one program; --mode seeds trains seed replicates.
    common = ["--data", toy, "--output", str(tmp_path / "out"),
              "--epochs", "1", "--tr-steps", "2", "--v-steps", "1",
              "--batch-size", "2", "--patch-size", "16", "--device", "cpu"]
    rows, best = tune.main(["--mode", "grid", "--param", "loss_weights",
                            "--vmap"] + common)
    assert len(rows) == 4
    assert all(np.isfinite(r["val_loss"]) for r in rows)
    assert best in rows
    # The JAX CLI's rows: trial, the trial's settings, the scores.
    assert _header(str(tmp_path / "out")) == (
        "fold\ttrial\tloss_weights\tval_loss\taccuracy\tbest_epoch")
    rows, best = tune.main(["--mode", "seeds", "--trials", "2"] + common)
    assert len(rows) == 2
    # Different seeds -> different initializations -> different losses.
    assert rows[0]["val_loss"] != rows[1]["val_loss"]
    with pytest.raises(SystemExit):
        tune.main(["--mode", "grid", "--param", "l_harm", "--vmap"] + common)


def test_tune_grids_stay_within_the_kernel_pairs(monkeypatch, tmp_path):
    # Each width of the l_harm and l_perc grids runs at a median pair the
    # kernels K1 to K4 are built for.
    seen = []

    def score(cfg, fold, tag, device):
        seen.append((cfg.l_harm, cfg.l_perc))
        return {"val_loss": 1.0, "accuracy": 0.5}

    monkeypatch.setattr(tune, "_score", score)
    for param in ("l_harm", "l_perc"):
        tune.main(["--data", str(tmp_path), "--output", str(tmp_path / param),
                   "--mode", "grid", "--param", param, "--device", "cpu"])
    assert len(seen) == 10 and set(seen) <= set(KERNEL_MEDIANS)
    assert set(KERNEL_MEDIANS) - set(seen) == {(11, 5)}


def test_tune_without_device_cpu_raises_when_no_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tune.main(["--data", str(tmp_path), "--mode", "grid", "--param",
                   "l_harm"])


def _cpu_mesh(n):
    from sm_hpss_mtl_tpu_torch.parallel import make_mesh
    return lambda devices=None: make_mesh(devices=[torch.device("cpu")] * n)


def test_tune_shard_trials_raises(toy, tmp_path, monkeypatch):
    # Over a mesh of 2 devices, 3 seed replicates do not shard: the JAX
    # package's message.
    monkeypatch.setattr(tune, "make_mesh", _cpu_mesh(2))
    with pytest.raises(ValueError, match="3 trials do not shard over 2"):
        tune.main(["--data", toy, "--output", str(tmp_path), "--mode",
                   "seeds", "--trials", "3", "--vmap", "--shard-trials",
                   *TINY, "--device", "cpu"])


def test_tune_shard_trials_writes_the_tuning_csv(toy, tmp_path,
                                                 monkeypatch):
    # --shard-trials with --device cpu: a mesh of the one CPU, the JAX CLI's
    # columns; over 4 devices (a mesh of the CPU four times) each trains
    # one replicate, and every row equals the unsharded run's.
    argv = ["--data", toy, "--mode", "seeds", "--trials", "4", "--vmap",
            *TINY, "--device", "cpu"]
    out = str(tmp_path / "one")
    one, best = tune.main(argv + ["--output", out, "--shard-trials"])
    assert len(one) == 4 and best in one
    assert _header(out) == (
        "fold\ttrial\tseed\tval_loss\taccuracy\tbest_epoch")
    plain, _ = tune.main(argv + ["--output", str(tmp_path / "plain")])
    monkeypatch.setattr(tune, "make_mesh", _cpu_mesh(4))
    four, _ = tune.main(argv + ["--output", str(tmp_path / "four"),
                                "--shard-trials"])
    for rows in (one, four):
        assert [r["seed"] for r in rows] == ["0", "1", "2", "3"]
        np.testing.assert_allclose([r["val_loss"] for r in rows],
                                   [r["val_loss"] for r in plain], rtol=1e-5)


def test_skip_connections_match_jax():
    # The TCN with use_skip_connections sums every block's skip branch.
    kw = dict(n_filters=8, nb_stacks=2, Nd=2, kernel_size=5,
              use_skip_connections=True)
    spec = jget_model("Lemaire_et_al_MTL", n_mels=16, **kw)
    x = np.random.default_rng(4).standard_normal((3, 16, 32)).astype(
        np.float32)
    v = spec.module.init({"params": jax.random.PRNGKey(0),
                          "dropout": jax.random.PRNGKey(1)},
                         jnp.asarray(x), train=False)
    net = get_model("Lemaire_et_al_MTL", n_mels=16, patch_size=16, **kw)
    net.load_state_dict(weights.from_flax(
        jax.tree_util.tree_map(np.asarray, dict(v))))
    net.eval()
    want = spec.module.apply(v, jnp.asarray(x), train=False)
    got = net(torch.from_numpy(x))
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), atol=1e-5,
                                   err_msg=k)
    net.tcn.use_skip_connections = False
    assert not torch.allclose(net(torch.from_numpy(x))["R"], got["R"])

"""Data parallelism and process wiring of the port
(``sm_hpss_mtl_tpu_torch/parallel/dp.py``, ``distributed.py``) against the
port's single-process step and the JAX package's.

Two worker processes join a gloo group through a file under ``tmp_path``
(no port is bound) and each runs one data-parallel step on its half of the
batch; every worker has a timeout of 120 s, so a hung rendezvous fails.
Dropout is off, as in the JAX package's DP test: each process draws its own
masks.  Bars: against the port's single step on the whole batch, loss rtol
2e-5, parameters rtol 2e-4 / atol 2e-5 (``tests/test_parallel.py``'s bars
for JAX's DP step), BatchNorm running statistics 1e-6 absolute; against
JAX's ``make_dp_train_step`` on 8 virtual devices, ``test_torch_train``'s
patch-step bars (parameters rtol 1e-4 / atol 1e-6, statistics 1e-5 of each
tensor's largest value).
"""

import os
import subprocess
import sys
from pathlib import Path

import flax.linen as fnn
import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from sm_hpss_mtl_tpu.models import get_model as jget_model
from sm_hpss_mtl_tpu.parallel import distributed as jdist
from sm_hpss_mtl_tpu.parallel import make_dp_train_step as j_dp_step
from sm_hpss_mtl_tpu.parallel import make_mesh as j_make_mesh
from sm_hpss_mtl_tpu.parallel import shard_batch as j_shard_batch
from sm_hpss_mtl_tpu.train import optimizers as joptim
from sm_hpss_mtl_tpu.train import state as jstate
from sm_hpss_mtl_tpu_torch import parallel as tpar
from sm_hpss_mtl_tpu_torch import weights
from sm_hpss_mtl_tpu_torch.data.featurize import FeatureConfig
from sm_hpss_mtl_tpu_torch.models import layers
from sm_hpss_mtl_tpu_torch.models.zoo import get_model
from sm_hpss_mtl_tpu_torch.parallel import distributed as tdist
from sm_hpss_mtl_tpu_torch.train import endtoend as tendtoend
from sm_hpss_mtl_tpu_torch.train import optimizers as toptim
from sm_hpss_mtl_tpu_torch.train import state as tstate

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
NARROW = dict(n_filters=8, nb_stacks=1, Nd=2)
N_MELS, W = 16, 16
ROWS = 24                  # divides over 2 processes and 8 JAX devices
CLIPS = 6                  # audio clips, two patches each
TIMEOUT_S = 120


class _NoDropout(fnn.Module):
    rate: float = 0.0
    deterministic: bool | None = None

    @fnn.compact
    def __call__(self, x, deterministic=None, rng=None):
        return x


def _labels(n):
    cls = np.repeat(np.arange(3), n // 3)
    r = np.stack([(cls != 1) * 1.0, (cls != 0) * 1.0], -1).astype(np.float32)
    r[cls == 2, 0] = 10 ** (-5 / 10)
    return {"S": (cls == 1).astype(np.float32),
            "M": (cls == 0).astype(np.float32), "R": r,
            "3C": np.eye(3, dtype=np.float32)[cls]}


def _net():
    net = get_model("Lemaire_et_al_MTL", n_mels=N_MELS, patch_size=W,
                    dropout_rate=0.0, **NARROW)
    for m in net.modules():
        if isinstance(m, layers.Dropout):
            m.rate = 0.0
    return net


def _t(tree):
    if isinstance(tree, dict):
        return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


def _opt(net):
    return toptim.for_model("Lemaire_et_al_MTL", net.parameters(),
                            tr_steps=100000)[0]


def _audio_cfg():
    return FeatureConfig(n_mels=N_MELS)


_WORKER = """\
import sys
import torch
import torch.distributed as dist

from sm_hpss_mtl_tpu_torch import parallel as tpar
from sm_hpss_mtl_tpu_torch.data.featurize import FeatureConfig
from sm_hpss_mtl_tpu_torch.models import layers
from sm_hpss_mtl_tpu_torch.models.zoo import get_model
from sm_hpss_mtl_tpu_torch.train import endtoend, optimizers, state

torch.set_num_threads(1)
rank, world, rdv, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4], sys.argv[5])
dist.init_process_group("gloo", init_method="file://" + rdv,
                        rank=rank, world_size=world)
x = torch.full((3,), float(rank + 1))
dist.all_reduce(x)
assert x.tolist() == [3.0] * 3, x
assert tpar.per_process_seed(7) == 7 + 100_003 * rank
assert tpar.process_file_shard({{"m": list("abcd")}}) == {{
    "m": list("abcd")[rank::2]}}

data = torch.load(inp)
results = {{}}
for kind, l2 in (("patch", 0.0), ("audio", 0.01)):
    net = get_model("Lemaire_et_al_MTL", n_mels={n_mels}, patch_size={w},
                    dropout_rate=0.0, **{narrow!r})
    for m in net.modules():
        if isinstance(m, layers.Dropout):
            m.rate = 0.0
    # Rank 1 starts from other weights: the step broadcasts rank 0's.
    net.load_state_dict(data["state"] if rank == 0 else
                        {{k: v + 1 if v.is_floating_point() else v
                          for k, v in data["state"].items()}})
    opt = optimizers.for_model("Lemaire_et_al_MTL", net.parameters(),
                               tr_steps=100000)[0]
    featurize = (endtoend.audio_featurizer(FeatureConfig(n_mels={n_mels}),
                                           patch_size={w}, patch_shift={w})
                 if kind == "audio" else None)
    step = tpar.make_dp_train_step(
        net, opt, mtl=True, l2_reg=l2, featurize=featurize,
        generator=torch.Generator().manual_seed(tpar.per_process_seed(0)))
    x, labels = tpar.shard_batch((data[kind], data[kind + "_labels"]))
    metrics = step(state.TrainState(net, opt), x, labels)
    results[kind] = {{"metrics": {{k: float(v) for k, v in metrics.items()}},
                     "state": net.state_dict()}}
# Shards of unequal size are refused in every process (the audio step:
# rank 0 passes 2 clips, rank 1 4), not left to hang or to average wrongly.
x, labels = data["audio"], data["audio_labels"]
n = 2 * (rank + 1)
try:
    step(state.TrainState(net, opt), x[:n], {{k: v[:n] for k, v in
                                             labels.items()}})
    results["unequal"] = "passed"
except ValueError as e:
    results["unequal"] = str(e)
if rank == 0:
    torch.save(results, out)
dist.barrier()
dist.destroy_process_group()
print("worker", rank, "ok")
"""


def _spawn(tmp_path, inp, world=2) -> dict:
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.format(n_mels=N_MELS, w=W, narrow=NARROW))
    out = tmp_path / "out.pt"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world),
         str(tmp_path / "rendezvous"), str(inp), str(out)], cwd=REPO,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, (so, se)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {r} rc={p.returncode}\n{so}\n{se}"
        assert f"worker {r} ok" in so
    return torch.load(out)


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory, monkeypatch_module):
    """One Lemaire-MTL state (flax init, moved into the port), a batch of
    patches and one of audio, and the world-2 DP step's results on each."""
    monkeypatch_module.setattr(fnn, "Dropout", _NoDropout)
    tmp = tmp_path_factory.mktemp("dp")
    spec = jget_model("Lemaire_et_al_MTL", n_mels=N_MELS, dropout_rate=0.0,
                      **NARROW)
    v = spec.module.init({"params": jax.random.PRNGKey(0),
                          "dropout": jax.random.PRNGKey(1)},
                         jnp.zeros((2, W, 2 * N_MELS)), train=False)
    v = jax.tree_util.tree_map(np.asarray, dict(v))
    rng = np.random.default_rng(5)
    data = {"state": _state_of(v),
            "patch": _t(rng.standard_normal((ROWS, W, 2 * N_MELS)).astype(
                np.float32)),
            "patch_labels": _t(_labels(ROWS)),
            "audio": _t(rng.standard_normal(
                (CLIPS, (2 * W - 1) * 160 + 400)).astype(np.float32)),
            "audio_labels": _t(_labels(CLIPS))}
    torch.save(data, tmp / "in.pt")
    return {"module": spec.module, "flax": v, "data": data,
            "dp": _spawn(tmp, tmp / "in.pt")}


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _state_of(v):
    net = _net()
    net.load_state_dict(weights.from_flax(v))
    return net.state_dict()


def _single(data, kind):
    net = _net()
    net.load_state_dict(data["state"])
    opt = _opt(net)
    kw = dict(mtl=True, generator=torch.Generator())
    step = (tendtoend.make_audio_train_step(net, opt, _audio_cfg(),
                                            patch_size=W, patch_shift=W,
                                            l2_reg=0.01, **kw)
            if kind == "audio" else tstate.make_train_step(net, opt, **kw))
    m = step(tstate.TrainState(net, opt), data[kind], data[kind + "_labels"])
    return {k: float(v) for k, v in m.items()}, net.state_dict()


def _same_as_single(dp, metrics, state):
    assert set(dp["metrics"]) == set(metrics)
    np.testing.assert_allclose(dp["metrics"]["loss"], metrics["loss"],
                               rtol=2e-5)
    for k, w in state.items():
        got = dp["state"][k]
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got.numpy(), w.numpy(), atol=1e-6,
                                       err_msg=k)
        elif w.is_floating_point():
            np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=2e-4,
                                       atol=2e-5, err_msg=k)
        else:
            assert torch.equal(got, w), k


def test_dp_step_equals_the_single_step_on_the_whole_batch(dp_run):
    metrics, state = _single(dp_run["data"], "patch")
    _same_as_single(dp_run["dp"]["patch"], metrics, state)


def test_audio_dp_step_equals_the_single_audio_step(dp_run):
    # The device featurizer (K1's plain version here) runs in each process
    # on its own clips.
    metrics, state = _single(dp_run["data"], "audio")
    _same_as_single(dp_run["dp"]["audio"], metrics, state)


def test_dp_step_matches_jax_dp_on_eight_devices(dp_run):
    data, v = dp_run["data"], dp_run["flax"]
    jopt, _ = joptim.for_model("Lemaire_et_al_MTL", tr_steps=100000)
    js = jstate.TrainState(params=v["params"], batch_stats=v["batch_stats"],
                           opt_state=jopt.init(v["params"]),
                           step=jnp.zeros((), jnp.int32))
    mesh = j_make_mesh()
    assert mesh.shape["data"] == 8
    step = j_dp_step(dp_run["module"], jopt, mesh, mtl=True)
    xb, lb = j_shard_batch(
        (jnp.asarray(data["patch"].numpy()),
         {k: jnp.asarray(a.numpy()) for k, a in
          data["patch_labels"].items()}), mesh)
    js, jm = step(js, xb, lb, jax.random.PRNGKey(0))
    dp = dp_run["dp"]["patch"]
    np.testing.assert_allclose(dp["metrics"]["loss"], float(jm["loss"]),
                               rtol=1e-5)
    net = _net()
    net.load_state_dict(dp["state"])
    tree = weights.to_flax(net.state_dict())
    got_p = weights._flatten(tree["params"])
    for path, w in weights._flatten(jax.tree_util.tree_map(
            np.asarray, js.params)).items():
        np.testing.assert_allclose(got_p[path], w, rtol=1e-4, atol=1e-6,
                                   err_msg="/".join(path))
    got_s = weights._flatten(tree["batch_stats"])
    for path, w in weights._flatten(jax.tree_util.tree_map(
            np.asarray, js.batch_stats)).items():
        np.testing.assert_allclose(got_s[path], w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg="/".join(path))


def test_batchnorm_over_a_group_of_one_is_the_local_batchnorm(tmp_path):
    # World size 1: the group's global batch is the local one, so the
    # group path (two reductions, the normalisation by hand) equals torch's
    # batch_norm, output and gradients and running statistics.
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((6, 5, 7)).astype(np.float32))
    a, b = layers.BatchNorm1d(5), layers.BatchNorm1d(5)
    with torch.no_grad():
        a.weight.uniform_(0.5, 1.5)
        a.bias.uniform_(-0.5, 0.5)
    b.load_state_dict(a.state_dict())
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        layers.use_process_group(b)
        outs = []
        for m in (a, b):
            xi = x.clone().requires_grad_(True)
            y = m.train()(xi)
            (y * torch.arange(7.0)).sum().backward()
            outs.append((y.detach(), xi.grad, m.weight.grad))
    finally:
        dist.destroy_process_group()
    for u, w in zip(*outs):
        np.testing.assert_allclose(u.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5)
    for k in ("running_mean", "running_var"):
        np.testing.assert_allclose(getattr(b, k).numpy(),
                                   getattr(a, k).numpy(), atol=1e-7)


def test_dp_step_refuses_shards_of_unequal_size(dp_run):
    assert "equal size" in dp_run["dp"]["unequal"]


def test_make_dp_train_step_needs_a_process_group():
    net = _net()
    with pytest.raises(RuntimeError, match="process group"):
        tpar.make_dp_train_step(net, _opt(net), mtl=True,
                                generator=torch.Generator())


def test_shard_batch_takes_a_rank_rows():
    x = torch.arange(12.0).reshape(6, 2)
    tree = (x, {"S": torch.arange(6.0)})
    got = tpar.shard_batch(tree, rank=1, world=3)
    assert torch.equal(got[0], x[2:4])
    assert torch.equal(got[1]["S"], torch.tensor([2.0, 3.0]))
    with pytest.raises(ValueError, match="does not shard"):
        tpar.shard_batch(x, rank=0, world=4)
    assert tpar.replicate({"a": x}, "cpu")["a"].device.type == "cpu"


# --- process wiring -----------------------------------------------------------

def test_initialize_noop_without_env(monkeypatch):
    monkeypatch.delenv("SMHPSS_DISTRIBUTED", raising=False)
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    assert tpar.initialize_from_env() is False
    assert not dist.is_initialized()


@pytest.mark.parametrize("env,want", [
    ({"SMHPSS_DISTRIBUTED": "1"}, dict(init_method="env://")),
    ({"JAX_COORDINATOR_ADDRESS": "localhost:1234", "JAX_NUM_PROCESSES": "3",
      "JAX_PROCESS_ID": "2", "SMHPSS_DISTRIBUTED": "1"},
     dict(init_method="tcp://localhost:1234", world_size=3, rank=2)),
])
def test_initialize_reads_the_jax_triggers_in_order(monkeypatch, env, want):
    # The coordinator address wins over SMHPSS_DISTRIBUTED, as in JAX; the
    # backend is gloo without a GPU.
    for k in ("SMHPSS_DISTRIBUTED", "JAX_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    for k, val in env.items():
        monkeypatch.setenv(k, val)
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: calls.append(kw))
    monkeypatch.setattr(dist, "get_world_size", lambda: 3)
    assert tpar.initialize_from_env() is True
    assert calls == [dict(backend="gloo", **want)]
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    assert tpar.initialize_from_env() is True and len(calls) == 1


def test_per_process_seed_identity_single_process():
    assert tpar.per_process_seed(42) == 42


FILES = {"music": [f"mu{i}" for i in range(10)],
         "speech": [f"sp{i}" for i in range(7)],
         "noise": ["no0"]}


@pytest.mark.parametrize("count", [1, 2, 3, 4])
def test_process_file_shard_is_the_jax_function(count):
    for idx in range(count):
        got = tpar.process_file_shard(FILES, process_index=idx,
                                      process_count=count)
        assert got == jdist.process_file_shard(FILES, process_index=idx,
                                               process_count=count)
    assert tpar.process_file_shard(FILES) is FILES


def test_run_fold_shards_by_the_process_rank(monkeypatch):
    # What run_fold reads under two processes: rank 1's half of each class
    # and a seed 100 003 away.
    monkeypatch.setattr(tdist, "rank", lambda: 1)
    monkeypatch.setattr(tdist, "world_size", lambda: 2)
    assert tdist.per_process_seed(7) == 7 + 100_003
    assert tdist.process_file_shard(FILES) == jdist.process_file_shard(
        FILES, process_index=1, process_count=2)

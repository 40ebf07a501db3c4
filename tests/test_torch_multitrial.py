"""Multi-trial training in the port (``train/multitrial.py``) against the
JAX package's vmapped trials and against the port's own single-trial step.

Tolerances: against JAX, per-trial losses rtol 1e-5 and the updated
parameters and statistics at ``test_torch_train``'s patch-step bars
(parameters rtol 1e-4, atol 1e-6; statistics rtol 1e-5 of each tensor's
largest value), float32 summation order apart; against the port's single
step, 1e-6 absolute (the same arithmetic, batched by ``torch.func.vmap``).
The model is the narrow Lemaire-MTL of ``test_torch_train``.
"""

import copy

import flax.linen as fnn
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sm_hpss_mtl_tpu.models import get_model as jget_model
from sm_hpss_mtl_tpu.train import multitrial as jmulti
from sm_hpss_mtl_tpu.train import optimizers as joptim
from sm_hpss_mtl_tpu_torch import weights
from sm_hpss_mtl_tpu_torch.models import layers
from sm_hpss_mtl_tpu_torch.models.lemaire import init_weights
from sm_hpss_mtl_tpu_torch.models.zoo import get_model
from sm_hpss_mtl_tpu_torch.train import losses as tlosses
from sm_hpss_mtl_tpu_torch.train import multitrial as tmulti
from sm_hpss_mtl_tpu_torch.train import optimizers as toptim
from sm_hpss_mtl_tpu_torch.train import state as tstate

torch.set_num_threads(2)

NARROW = dict(n_filters=8, nb_stacks=1, Nd=2)
N_MELS, W, BS = 16, 16, 2
HEADS = ("S", "M", "R", "3C")
TRIALS = [
    {"loss_weights": {"S": 0.2, "M": 0.2, "R": 0.2, "3C": 0.4}},
    {"loss_weights": {"S": 0.5, "M": 0.1, "R": 0.3, "3C": 0.1},
     "lr_scale": 0.5},
]


class _NoDropout(fnn.Module):
    rate: float = 0.0
    deterministic: bool | None = None

    @fnn.compact
    def __call__(self, x, deterministic=None, rng=None):
        return x


@pytest.fixture
def jax_dropout_off(monkeypatch):
    monkeypatch.setattr(fnn, "Dropout", _NoDropout)


def _batch(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    cls = np.repeat(np.arange(3), BS)
    r = np.stack([(cls != 1) * 1.0, (cls != 0) * 1.0], -1).astype(np.float32)
    r[cls == 2, 0] = 10 ** (-5 / 10)
    labels = {"S": (cls == 1).astype(np.float32),
              "M": (cls == 0).astype(np.float32), "R": r,
              "3C": np.eye(3, dtype=np.float32)[cls]}
    x = (scale * rng.standard_normal((3 * BS, W, 2 * N_MELS))).astype(
        np.float32)
    return x, labels


def _net(dropout_rate=0.0):
    """The narrow model; with rate 0 every dropout is off, the heads' fixed
    0.4 too (as the JAX side's ``jax_dropout_off``)."""
    net = get_model("Lemaire_et_al_MTL", n_mels=N_MELS, patch_size=W,
                    dropout_rate=dropout_rate, **NARROW)
    if not dropout_rate:
        for m in net.modules():
            if isinstance(m, layers.Dropout):
                m.rate = 0.0
    return net


def _lemaire_sgd(params, trial_axis=True, init_lr=0.002):
    return toptim.lemaire_optimizer(params, 50, init_lr=init_lr,
                                    trial_axis=trial_axis)[0]


def _t(labels):
    return {k: torch.from_numpy(v) for k, v in labels.items()}


@pytest.mark.parametrize("steps", [1, 2])
def test_multi_step_matches_jax(jax_dropout_off, steps):
    # Two trials (their own loss weights, lr scales 1 and 0.5) from the JAX
    # package's stacked init, carried across with weights.from_flax, on a
    # batch large enough that Lemaire's clipnorm clips.
    spec = jget_model("Lemaire_et_al_MTL", n_mels=N_MELS, dropout_rate=0.0,
                      **NARROW)
    x, labels = _batch(3, scale=4.0)
    jopt, _ = joptim.for_model("Lemaire_et_al_MTL", tr_steps=50)
    stacked = jmulti.init_trials(spec.module, jopt, jnp.asarray(x),
                                 seeds=[0, 1])
    nets = []
    for i in range(2):
        net = _net()
        net.load_state_dict(weights.from_flax({
            "params": jmulti.unstack_trial(stacked.params, i),
            "batch_stats": jmulti.unstack_trial(stacked.batch_stats, i)}))
        nets.append(net)
    jstep = jmulti.make_multi_train_step(spec.module, jopt, mtl=True,
                                         l2_reg=0.01)
    jhyper = jmulti.stack_hyperparams(TRIALS, HEADS)
    jl = {k: jnp.asarray(v) for k, v in labels.items()}
    for t in range(steps):
        stacked, jm = jstep(stacked, jnp.asarray(x), jl,
                            jax.random.split(jax.random.PRNGKey(t), 2),
                            jhyper)

    state = tmulti.stacked_state(nets, _lemaire_sgd, [0, 1])
    step = tmulti.make_multi_train_step(nets[0], mtl=True, l2_reg=0.01)
    hyper = tmulti.stack_hyperparams(TRIALS, HEADS)
    for _ in range(steps):
        tm = step(state, torch.from_numpy(x), _t(labels), hyper)
    assert state.step == steps
    for k in jm:
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   rtol=1e-5, err_msg=k)
    # The batch is large enough that Lemaire's clipnorm (1) clips.
    probe = copy.deepcopy(nets[0]).train()
    total, _ = tlosses.mtl_loss(probe(torch.from_numpy(x)), _t(labels))
    total.backward()
    assert max(float(p.grad.norm()) for p in probe.parameters()) > 1
    for i in range(2):
        got = weights.to_flax(tmulti.unstack_trial(state, i))
        want_p = weights._flatten(jmulti.unstack_trial(stacked.params, i))
        got_p = weights._flatten(got["params"])
        assert set(got_p) == set(want_p)
        for path, w in want_p.items():
            np.testing.assert_allclose(got_p[path], w, rtol=1e-4, atol=1e-6,
                                       err_msg="/".join(path))
        want_s = weights._flatten(jmulti.unstack_trial(stacked.batch_stats,
                                                       i))
        got_s = weights._flatten(got["batch_stats"])
        for path, w in want_s.items():
            np.testing.assert_allclose(got_s[path], w, rtol=1e-5,
                                       atol=1e-5 * np.abs(w).max(),
                                       err_msg="/".join(path))


def test_multi_step_is_each_trials_single_step():
    # Dropout and the noise augmentation on, l2, per-trial loss weights and
    # an lr scale: trial i of the multi-trial step equals the single-trial
    # step of its seed's weights and generator (the scaled trial against an
    # optimizer at 0.5x the lr), parameters and BatchNorm statistics.
    net = _net(dropout_rate=0.2)
    x, labels = _batch(5)
    seeds = [3, 4]
    state = tmulti.init_trials(net, seeds, _lemaire_sgd)
    step = tmulti.make_multi_train_step(net, mtl=True, augment_noise=True,
                                        l2_reg=0.01)
    hyper = tmulti.stack_hyperparams(TRIALS, HEADS)
    for _ in range(3):
        m = step(state, torch.from_numpy(x), _t(labels), hyper)
    for i, (trial, seed) in enumerate(zip(TRIALS, seeds)):
        single = copy.deepcopy(net)
        init_weights(single, torch.Generator().manual_seed(seed))
        start = copy.deepcopy(single.state_dict())
        opt = _lemaire_sgd(single.parameters(), trial_axis=False,
                           init_lr=0.002 * trial.get("lr_scale", 1.0))
        s1 = tstate.make_train_step(
            single, opt, mtl=True, l2_reg=0.01, augment_noise=True,
            loss_weights=trial["loss_weights"],
            generator=torch.Generator().manual_seed(seed))
        ts = tstate.TrainState(single, opt)
        for _ in range(3):
            m1 = s1(ts, torch.from_numpy(x), _t(labels))
        np.testing.assert_allclose(float(m["loss"][i]), float(m1["loss"]),
                                   rtol=1e-6)
        got = tmulti.unstack_trial(state, i)
        for k, v in single.state_dict().items():
            torch.testing.assert_close(got[k], v, rtol=0, atol=1e-6,
                                       msg=k)
        moved = [k for k in ("heads.S_block.bn.running_mean",
                             "heads.S_block.bn.running_var")
                 if not torch.equal(got[k], start[k])]
        assert len(moved) == 2


def test_trials_draw_from_their_own_seeds_generators():
    # Same seed, same masks (two identical trials stay identical); another
    # seed draws other masks.
    net = _net(dropout_rate=0.3)
    x, labels = _batch(6)
    state = tmulti.init_trials(net, [1, 1, 2], _lemaire_sgd)
    step = tmulti.make_multi_train_step(net, mtl=True)
    m = step(state, torch.from_numpy(x), _t(labels),
             tmulti.stack_hyperparams([{}, {}, {}], None))
    assert float(m["loss"][0]) == float(m["loss"][1])
    a, b = tmulti.unstack_trial(state, 0), tmulti.unstack_trial(state, 1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = tmulti.unstack_trial(state, 2)
    assert float(m["loss"][2]) != float(m["loss"][0])
    assert not all(torch.equal(a[k], c[k]) for k in a)
    assert all(d.feed is None for d in net.modules()
               if isinstance(d, layers.Dropout))


def test_clipnorm_takes_each_trials_norm():
    # Keras clipnorm per tensor: over a (trial, ...) stack each trial's
    # slice is clipped by its own norm, not the stack's.
    g = torch.stack([torch.full((3, 4), 0.1), torch.full((3, 4), 2.0)])
    want = [g[0].clone(), g[1] / g[1].norm()]
    toptim.clip_by_per_tensor_norm([g], 1.0, trial_axis=True)
    torch.testing.assert_close(g[0], want[0], rtol=0, atol=0)
    torch.testing.assert_close(g[1], want[1], rtol=1e-6, atol=0)
    whole = torch.stack([torch.full((3, 4), 0.1), torch.full((3, 4), 2.0)])
    toptim.clip_by_per_tensor_norm([whole], 1.0)
    assert not torch.allclose(whole[0], want[0])


def test_lr_scale_is_exact_lr_rescaling():
    # The JAX package's test of the same name: lr_scale 0.5 through the
    # multi-trial step equals an optimizer built at half the lr (SGD with
    # momentum, clipnorm and decay), over five steps.
    net = _net()
    x, labels = _batch(7)
    state = tmulti.init_trials(net, [3], _lemaire_sgd)
    step = tmulti.make_multi_train_step(net, mtl=True)
    hyper = tmulti.stack_hyperparams([{"lr_scale": 0.5}], HEADS)
    half = tmulti.init_trials(
        net, [3], lambda ps: _lemaire_sgd(ps, init_lr=0.001))
    for _ in range(5):
        step(state, torch.from_numpy(x), _t(labels), hyper)
        step(half, torch.from_numpy(x), _t(labels),
             tmulti.stack_hyperparams([{}], HEADS))
    a, b = tmulti.unstack_trial(state, 0), tmulti.unstack_trial(half, 0)
    assert max(float((a[k] - b[k]).abs().max()) for k in a
               if a[k].is_floating_point()) < 1e-6


def test_lr_scale_exact_for_adam():
    # The JAX package's test of the same name: Adam's update is linear in
    # the lr, so scaling the final update by 0.1 at lr 1e-3 equals lr 1e-4
    # (one step, Doukhan-MTL's Adam).
    net = get_model("Doukhan_et_al_MTL", in_dim=40, patch_size=68)
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((3, 40, 68, 1)).astype(
        np.float32))
    cls = np.arange(3)
    labels = {"S": torch.tensor((cls == 1) * 1.0, dtype=torch.float32),
              "M": torch.tensor((cls == 0) * 1.0, dtype=torch.float32),
              "R": torch.rand(3, 2, generator=torch.Generator().manual_seed(
                  0)), "3C": torch.eye(3)}

    def run(lr, scale):
        state = tmulti.init_trials(
            net, [0], lambda ps: toptim.adam_optimizer(ps, lr)[0])
        step = tmulti.make_multi_train_step(net, mtl=True)
        step(state, x, labels,
             tmulti.stack_hyperparams([{"lr_scale": scale}], HEADS))
        return tmulti.unstack_trial(state, 0)

    a, b = run(1e-3, 0.1), run(1e-4, 1.0)
    assert max(float((a[k] - b[k]).abs().max()) for k in a
               if a[k].is_floating_point()) < 1e-6


def test_fit_multi_early_stop_and_best_restore():
    # The JAX package's test of the same name: per-trial bests, history
    # rows of per-trial arrays, the stacked state kept, each trial's best
    # weights restored.
    net = _net(dropout_rate=0.1)
    x, labels = _batch(9)

    def stream():
        while True:
            yield torch.from_numpy(x), _t(labels)

    trials = [{"loss_weights": {"3C": 1.0}}, {"seed": 9}]
    res = tmulti.fit_multi(net, _lemaire_sgd, stream(), stream(), mtl=True,
                           trials=trials, heads=HEADS, epochs=4,
                           steps_per_epoch=2, val_steps=1, patience=2,
                           verbose=False)
    assert res.n_trials == 2
    assert np.isfinite(res.best_val_loss).all()
    assert (res.best_epoch >= 0).all()
    assert res.best_accuracy.shape == (2,)
    assert next(iter(res.state.params.values())).shape[0] == 2
    assert res.history[0]["val_loss"].shape == (2,)
    # The restored weights give each trial its best val loss.
    ev = tmulti.make_multi_eval_step(net, mtl=True)
    got = ev(res.state, torch.from_numpy(x), _t(labels),
             tmulti.stack_hyperparams(trials, HEADS))["loss"].numpy()
    np.testing.assert_allclose(got, res.best_val_loss, rtol=1e-5)


def test_trials_over_several_gpus_raise():
    # Trials shard over the mesh's data devices only evenly, with the JAX
    # package's message.
    from sm_hpss_mtl_tpu_torch.parallel import make_mesh
    mesh = make_mesh(n_data=2, devices=[torch.device("cpu")] * 2)
    with pytest.raises(ValueError, match="3 trials do not shard over 2"):
        tmulti.fit_multi(_net(), _lemaire_sgd, iter(()), iter(()),
                         mtl=True, trials=[{}] * 3, heads=None, epochs=1,
                         steps_per_epoch=1, val_steps=1, mesh=mesh)


def test_trial_sharding_matches_unsharded():
    # The JAX package's test of the same name, on 4 CPU devices: each
    # trains its trial on its own copy of the batch, and every trial ends
    # as in the unsharded run (dropout and augmentation on).
    from sm_hpss_mtl_tpu_torch.parallel import make_mesh
    x, labels = _batch(11)

    def stream():
        while True:
            yield torch.from_numpy(x), _t(labels)

    trials = [{"seed": s} for s in range(3)] + [
        {"seed": 3, "lr_scale": 0.5,
         "loss_weights": {"S": 0.5, "M": 0.1, "R": 0.3, "3C": 0.1}}]
    kw = dict(mtl=True, trials=trials, heads=HEADS, epochs=2,
              steps_per_epoch=2, val_steps=1, augment_noise=True,
              verbose=False)
    net = _net(dropout_rate=0.1)
    mesh = make_mesh(n_data=4, devices=[torch.device("cpu")] * 4)
    sharded = tmulti.fit_multi(net, _lemaire_sgd, stream(), stream(),
                               mesh=mesh, **kw)
    plain = tmulti.fit_multi(net, _lemaire_sgd, stream(), stream(), **kw)
    np.testing.assert_allclose(sharded.best_val_loss, plain.best_val_loss,
                               rtol=1e-5)
    for a, b in zip(sharded.history, plain.history):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
    # The trial axis really is cut: one state of one trial per device.
    assert len(sharded.shards) == 4
    assert all(next(iter(st.params.values())).shape[0] == 1
               for st in sharded.shards)
    for i in range(4):
        got = tmulti.unstack_trial(sharded.state, i)
        for k, w in tmulti.unstack_trial(plain.state, i).items():
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), atol=1e-6,
                                       err_msg=f"trial {i} {k}")

"""Training in the port against the JAX package: the losses, the optimizers,
the BatchNorm running statistics, dropout's generator, one train and eval
step from transferred parameters (patch batches and raw audio), the raw-
audio crop batcher and the balanced patch batcher, the device patches, the
prefetcher and the checkpoints.

Tolerances: losses rtol 1e-6; optimizer trajectories rtol 1e-6, atol 1e-7
(float32 on both sides, one rounding per operation apart); BatchNorm
statistics rtol 1e-6; one train step: loss rtol 1e-5, parameters atol
1e-6 and rtol 1e-4, statistics rtol 1e-5 of each tensor's largest value
(float32 summation order through the model and its backward pass); patches atol 1e-4 (as
``tests/test_endtoend.py`` holds the JAX host and device paths); crops and
labels bit for bit.  The model is a narrow Lemaire-MTL: 8 filters, 1
stack, dilations (1, 2), 16 mel bands, 16-frame patches, 2 per class.
"""

import contextlib
import os

import flax.linen as fnn
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sm_hpss_mtl_tpu import native
from sm_hpss_mtl_tpu.data import audiostream as jstream
from sm_hpss_mtl_tpu.data import batcher as jbatcher
from sm_hpss_mtl_tpu.data import featurize as jfeat
from sm_hpss_mtl_tpu.data import folds as jfolds
from sm_hpss_mtl_tpu.models import cnn as jcnn
from sm_hpss_mtl_tpu.models import get_model as jget_model
from sm_hpss_mtl_tpu.models.heads import BN_KW as JBN_KW
from sm_hpss_mtl_tpu.ops import patches as jpatches
from sm_hpss_mtl_tpu.ops import stats as jopstats
from sm_hpss_mtl_tpu.train import endtoend as jendtoend
from sm_hpss_mtl_tpu.train import losses as jlosses
from sm_hpss_mtl_tpu.train import optimizers as joptim
from sm_hpss_mtl_tpu.train import state as jstate
from sm_hpss_mtl_tpu_torch import weights
from sm_hpss_mtl_tpu_torch.data import audio as taudio
from sm_hpss_mtl_tpu_torch.data import audiostream as tstream
from sm_hpss_mtl_tpu_torch.data import batcher as tbatcher
from sm_hpss_mtl_tpu_torch.data import featurize as tfeat
from sm_hpss_mtl_tpu_torch.data import prefetch as tprefetch
from sm_hpss_mtl_tpu_torch.data import stats as tstats
from sm_hpss_mtl_tpu_torch.models import layers
from sm_hpss_mtl_tpu_torch.models.heads import BN_KW, HeadBlock
from sm_hpss_mtl_tpu_torch.models.zoo import get_model
from sm_hpss_mtl_tpu_torch.ops import featuregram as tfg
from sm_hpss_mtl_tpu_torch.ops import patches as tpatches
from sm_hpss_mtl_tpu_torch.ops import stats as topstats
from sm_hpss_mtl_tpu_torch.train import checkpoint as tckpt
from sm_hpss_mtl_tpu_torch.train import endtoend as tendtoend
from sm_hpss_mtl_tpu_torch.train import losses as tlosses
from sm_hpss_mtl_tpu_torch.train import optimizers as toptim
from sm_hpss_mtl_tpu_torch.train import state as tstate

torch.set_num_threads(2)

NARROW = dict(n_filters=8, nb_stacks=1, Nd=2)
N_MELS, W, BS = 16, 16, 2


class _NoDropout(fnn.Module):
    """flax's ``nn.Dropout`` as the identity (the JAX heads fix their rate
    at 0.4 and ``get_model`` does not expose it)."""
    rate: float = 0.0
    deterministic: bool | None = None

    @fnn.compact
    def __call__(self, x, deterministic=None, rng=None):
        return x


@pytest.fixture
def jax_dropout_off(monkeypatch):
    monkeypatch.setattr(fnn, "Dropout", _NoDropout)


@pytest.fixture
def jax_standardize_fixed(monkeypatch):
    """The JAX device pipeline's standardization with constant rows centred
    to 0, jit-traceable (``test_torch_segment`` explains the JAX helper's
    fault); patched here, not edited."""
    def fixed(FV):
        out = jpatches.standardize_rows(FV)
        const = jnp.max(FV, axis=-1, keepdims=True) == jnp.min(
            FV, axis=-1, keepdims=True)
        return jnp.where(const, 0.0, out)

    monkeypatch.setattr(jendtoend, "standardize_rows", fixed)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# --- losses ------------------------------------------------------------------

def _loss_inputs(seed):
    rng = np.random.default_rng(seed)
    p = rng.uniform(0, 1, (8, 1)).astype(np.float32)
    p[0, 0], p[1, 0] = 0.0, 1.0                  # the 1e-7 clip edges
    y = (rng.uniform(size=8) > 0.5).astype(np.float32)
    c = rng.dirichlet(np.ones(3), 8).astype(np.float32)
    c[0] = [1.0, 0.0, 0.0]
    onehot = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    r = rng.standard_normal((8, 2)).astype(np.float32)
    rt = rng.uniform(0, 1, (8, 2)).astype(np.float32)
    return p, y, c, onehot, r, rt


@pytest.mark.parametrize("name", ["binary_crossentropy", "hinge",
                                  "categorical_crossentropy",
                                  "mean_squared_error", "mtl_loss"])
def test_losses_match_jax(name):
    p, y, c, onehot, r, rt = _loss_inputs(1)
    if name in ("binary_crossentropy", "hinge"):
        args = (p, y)
    elif name == "categorical_crossentropy":
        args = (c, onehot)
    elif name == "mean_squared_error":
        args = (r, rt)
    if name != "mtl_loss":
        got = getattr(tlosses, name)(*map(_t, args))
        want = getattr(jlosses, name)(*map(jnp.asarray, args))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
        return
    outputs = {"S": p, "M": p[::-1].copy(), "R": r, "3C": c}
    labels = {"S": y, "M": y[::-1].copy(), "R": rt, "3C": onehot}
    for weights_, types in ((None, None),
                            ({"S": 0.5, "R": 2.0}, {"M": "hinge"})):
        got, got_heads = tlosses.mtl_loss(
            {k: _t(v) for k, v in outputs.items()},
            {k: _t(v) for k, v in labels.items()}, weights_, types)
        want, want_heads = jlosses.mtl_loss(
            {k: jnp.asarray(v) for k, v in outputs.items()},
            {k: jnp.asarray(v) for k, v in labels.items()}, weights_, types)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
        assert set(got_heads) == set(want_heads) == {"S", "M", "R", "3C"}
        for k in want_heads:
            np.testing.assert_allclose(got_heads[k].numpy(),
                                       np.asarray(want_heads[k]), rtol=1e-6)


# --- optimizers --------------------------------------------------------------

def _param_set(seed):
    """A conv kernel, a dense kernel, a bias and a BatchNorm scale."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((8, 4, 3), (16, 5), (16,), (8,))]


def _run_torch(make, params, grads):
    ps = [torch.nn.Parameter(_t(p).clone()) for p in params]
    opt, sched = make(ps)
    out = []
    for gs in grads:
        for p, g in zip(ps, gs):
            p.grad = _t(g).clone()
        opt.step()
        out.append([p.detach().numpy().copy() for p in ps])
    return out, sched


def _run_optax(opt, params, grads):
    import optax
    ps = [jnp.asarray(p) for p in params]
    state = opt.init(ps)
    out = []
    for gs in grads:
        upd, state = opt.update([jnp.asarray(g) for g in gs], state, ps)
        ps = optax.apply_updates(ps, upd)
        out.append([np.asarray(p) for p in ps])
    return out


@pytest.mark.parametrize("family", ["Lemaire_et_al_MTL", "Doukhan_et_al",
                                    "Papakostas_et_al", "Jang_et_al_MTL"])
def test_optimizers_match_optax(family):
    params = _param_set(2)
    rng = np.random.default_rng(3)
    # Scales 0.05 .. 5: some tensors are clipped to norm 1, some are not.
    grads = [[(rng.standard_normal(p.shape) * rng.choice([0.05, 5.0])
               ).astype(np.float32) for p in params] for _ in range(5)]
    # tr_steps 2: the Lemaire lr decays over 6 steps, 0.1x within the run.
    got, sched = _run_torch(
        lambda ps: toptim.for_model(family, ps, tr_steps=2), params, grads)
    jopt, jsched = joptim.for_model(family, tr_steps=2)
    want = _run_optax(jopt, params, grads)
    for step, (g, w) in enumerate(zip(got, want)):
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7,
                                       err_msg=f"{family} step {step}")
        np.testing.assert_allclose(sched(step), float(jsched(step)),
                                   rtol=1e-6)


def test_per_tensor_clip_is_not_the_global_norm():
    g = [torch.full((4,), 2.0), torch.full((9,), 0.1), torch.zeros(3)]
    toptim.clip_by_per_tensor_norm(g, 1.0)
    torch.testing.assert_close(g[0], torch.full((4,), 0.5))   # norm 4 -> 1
    torch.testing.assert_close(g[1], torch.full((9,), 0.1))   # kept
    assert torch.equal(g[2], torch.zeros(3))                  # 1e-12 floor


# --- BatchNorm and dropout ---------------------------------------------------

def _flax_bn_update(x):
    bn = fnn.BatchNorm(use_running_average=False, **JBN_KW)
    v = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    y, mut = bn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    return np.asarray(y), jax.tree_util.tree_map(np.asarray,
                                                 mut["batch_stats"])


@pytest.mark.parametrize("kind", ["1d", "2d"])
def test_batchnorm_running_stats_match_flax(kind):
    rng = np.random.default_rng(4)
    if kind == "1d":           # a head's BatchNorm at the full batch of 48
        x = (2.0 * rng.standard_normal((48, 16)) + 0.5).astype(np.float32)
        bn, xt = layers.BatchNorm1d(16, **BN_KW), _t(x)
    else:                      # a Jang conv block's, NHWC in flax
        x = (2.0 * rng.standard_normal((4, 6, 5, 8)) + 0.5).astype(
            np.float32)
        bn, xt = layers.BatchNorm2d(8, **BN_KW), _t(x).permute(0, 3, 1, 2)
    want_y, want = _flax_bn_update(x)
    y = bn.train()(xt)
    if kind == "2d":
        y = y.permute(0, 2, 3, 1)
    np.testing.assert_allclose(y.detach().numpy(), want_y, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), want["mean"],
                               rtol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), want["var"],
                               rtol=1e-6)
    # Eval mode is torch's own, on the updated statistics.
    ref = torch.nn.BatchNorm1d(16, **BN_KW) if kind == "1d" else \
        torch.nn.BatchNorm2d(8, **BN_KW)
    ref.load_state_dict(bn.state_dict())
    torch.testing.assert_close(bn.eval()(xt), ref.eval()(xt))


def test_torch_batchnorm_update_is_off_by_the_unbiased_factor():
    """torch's own BatchNorm moves its running variance towards the
    unbiased batch variance: after one train-mode forward at batch 48 it
    is more than 1e-4 off flax's, which the ported heads must match."""
    x = (2.0 * np.random.default_rng(5).standard_normal((48, 16))
         ).astype(np.float32)
    _, want = _flax_bn_update(x)
    head = HeadBlock(16, 16)
    head.dense.weight.data = torch.eye(16)
    head.dense.bias.data.zero_()
    torch_bn = torch.nn.BatchNorm1d(16, **BN_KW)
    for bn in (head.bn, torch_bn):
        bn.train()(_t(x))
    rel = lambda v: np.abs(v.numpy() / want["var"] - 1).max()  # noqa: E731
    assert rel(torch_bn.running_var) > 1e-4
    assert rel(head.bn.running_var) < 1e-6
    for name in ("Lemaire_et_al_MTL", "Jang_et_al_MTL"):
        net = get_model(name, n_mels=24)
        bns = [m for m in net.modules()
               if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
        assert bns and all(isinstance(m, (layers.BatchNorm1d,
                                          layers.BatchNorm2d)) for m in bns)


def test_dropout_draws_only_from_its_generator():
    net = get_model("Lemaire_et_al_MTL", n_mels=N_MELS, patch_size=W,
                    **NARROW)
    drops = [m for m in net.modules() if isinstance(m, layers.Dropout)]
    assert len(drops) == 2 + 3          # a TCN block per dilation, 3 heads
    x = torch.randn(6, W, 2 * N_MELS)
    with pytest.raises(RuntimeError, match="generator"):
        net.train()(x)
    outs = []
    for _ in range(2):
        layers.use_generator(net, torch.Generator().manual_seed(9))
        torch.manual_seed(len(outs))     # the global RNG plays no part
        outs.append(net.train()(x)["S"])
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


# --- one train and eval step against JAX ------------------------------------

def _batch(seed, n_rows):
    rng = np.random.default_rng(seed)
    cls = np.repeat(np.arange(3), n_rows // 3)
    onehot = np.eye(3, dtype=np.float32)[cls]
    r = np.stack([(cls != 1) * 1.0, (cls != 0) * 1.0], -1).astype(
        np.float32)
    r[cls == 2, 0] = 10 ** (-5 / 10)
    labels = {"S": (cls == 1).astype(np.float32),
              "M": (cls == 0).astype(np.float32), "R": r, "3C": onehot}
    return rng, labels


def _models(seed):
    """The narrow JAX Lemaire-MTL with its variables, and the port's with
    the same weights; dropout off on both sides (the TCN's rate 0, the
    heads' as the identity)."""
    spec = jget_model("Lemaire_et_al_MTL", n_mels=N_MELS, dropout_rate=0.0,
                      **NARROW)
    v = spec.module.init({"params": jax.random.PRNGKey(seed),
                          "dropout": jax.random.PRNGKey(seed + 1)},
                         jnp.zeros((2, W, 2 * N_MELS)), train=False)
    net = get_model("Lemaire_et_al_MTL", n_mels=N_MELS, patch_size=W,
                    dropout_rate=0.0, **NARROW)
    net.load_state_dict(weights.from_flax(
        jax.tree_util.tree_map(np.asarray, dict(v))))
    for m in net.modules():
        if isinstance(m, layers.Dropout):
            m.rate = 0.0
    return spec.module, v, net


def _same_state(net, jstate_, rtol_stats=1e-5):
    tree = weights.to_flax(net.state_dict())
    want_p = jax.tree_util.tree_map(np.asarray, jstate_.params)
    want_s = jax.tree_util.tree_map(np.asarray, jstate_.batch_stats)
    got_p = weights._flatten(tree["params"])
    for path, w in weights._flatten(want_p).items():
        np.testing.assert_allclose(got_p[path], w, rtol=1e-4, atol=1e-6,
                                   err_msg="/".join(path))
    got_s = weights._flatten(tree["batch_stats"])
    for path, w in weights._flatten(want_s).items():
        # rtol on the tensor's scale: a running mean moves by 1% of a batch
        # mean, whose elements near 0 carry the batch's absolute rounding.
        np.testing.assert_allclose(got_s[path], w, rtol=rtol_stats,
                                   atol=rtol_stats * np.abs(w).max(),
                                   err_msg="/".join(path))
    assert set(got_p) == set(weights._flatten(want_p))


def _same_metrics(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)


def test_train_and_eval_step_match_jax(jax_dropout_off):
    module, v, net = _models(0)
    rng, labels = _batch(6, 3 * BS)
    x = rng.standard_normal((3 * BS, W, 2 * N_MELS)).astype(np.float32)
    jopt, _ = joptim.for_model("Lemaire_et_al_MTL", tr_steps=100000)
    js = jstate.TrainState(params=v["params"], batch_stats=v["batch_stats"],
                           opt_state=jopt.init(v["params"]),
                           step=jnp.zeros((), jnp.int32))
    jstep = jstate.make_train_step(module, jopt, mtl=True, l2_reg=0.01)
    js, jm = jstep(js, jnp.asarray(x), {k: jnp.asarray(a) for k, a in
                                        labels.items()},
                   jax.random.PRNGKey(2))

    opt, _ = toptim.for_model("Lemaire_et_al_MTL", net.parameters(),
                              tr_steps=100000)
    ts = tstate.TrainState(net, opt)
    step = tstate.make_train_step(net, opt, mtl=True, l2_reg=0.01,
                                  generator=torch.Generator().manual_seed(0))
    tl = {k: _t(a) for k, a in labels.items()}
    tm = step(ts, _t(x), tl)
    assert ts.step == 1
    _same_metrics(tm, jm)
    _same_state(net, js)

    jm = jstate.make_eval_step(module, mtl=True)(
        js, jnp.asarray(x), {k: jnp.asarray(a) for k, a in labels.items()})
    _same_metrics(tstate.make_eval_step(net, mtl=True)(ts, _t(x), tl), jm)
    want = module.apply({"params": js.params,
                         "batch_stats": js.batch_stats}, jnp.asarray(x))
    got = tstate.make_predict(net)(ts, _t(x))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, err_msg=k)


def test_l2_kernels_are_the_jax_regularized_leaves():
    for name, kw in (("Lemaire_et_al_MTL", dict(n_mels=N_MELS, **NARROW)),
                     ("Jang_et_al_MTL", dict(n_mels=24))):
        net = get_model(name, **kw)
        chosen = {id(p) for p in tstate.l2_kernels(net)}
        names = {n for n, p in net.named_parameters() if id(p) in chosen}
        # The JAX rule on the flax tree of the same weights.
        tree = weights._flatten(weights.to_flax(net.state_dict())["params"])
        want = {path for path in tree if path[-1] == "kernel" and any(
            "heads" in q or "melCl" in q for q in path)}
        assert len(names) == len(want) > 0
        assert sum(tree[p].size for p in want) == sum(
            p.numel() for p in tstate.l2_kernels(net))
        assert not any(n.endswith("bn.weight") for n in names)


def test_train_step_is_a_function_of_its_seed():
    nets, init = [], None
    for _ in range(2):
        net = get_model("Lemaire_et_al_MTL", n_mels=N_MELS, patch_size=W,
                        **NARROW)
        init = init or {k: v.clone() for k, v in net.state_dict().items()}
        net.load_state_dict(init)
        opt, _ = toptim.for_model("Lemaire_et_al_MTL", net.parameters(),
                                  tr_steps=10)
        step = tstate.make_train_step(
            net, opt, mtl=True, augment_noise=True,
            generator=torch.Generator().manual_seed(4))
        rng, labels = _batch(7, 3 * BS)
        x = _t(rng.standard_normal((3 * BS, W, 2 * N_MELS)).astype(
            np.float32))
        torch.manual_seed(len(nets))
        for _ in range(2):
            step(tstate.TrainState(net, opt), x,
                 {k: _t(a) for k, a in labels.items()})
        nets.append(net)
    for (k, a), b in zip(nets[0].state_dict().items(),
                         nets[1].state_dict().values()):
        assert torch.equal(a, b), k


# --- the device pipeline -----------------------------------------------------

def _audio(seed, B, n=16000):
    return np.random.default_rng(seed).standard_normal((B, n)).astype(
        np.float32)


@pytest.mark.parametrize("max_patches", [None, 1])
def test_device_featurize_patches_match_jax(jax_standardize_fixed,
                                            max_patches):
    audio = _audio(8, 3)
    kw = dict(patch_size=W, patch_shift=W, max_patches=max_patches)
    got = tendtoend.device_featurize_patches(
        _t(audio), tfeat.FeatureConfig(n_mels=N_MELS), **kw)
    want = jendtoend.device_featurize_patches(
        jnp.asarray(audio), jfeat.FeatureConfig(n_mels=N_MELS,
                                                dft_precision="highest"),
        use_pallas=False, **kw)
    assert got.shape == want.shape
    assert got.shape[1:] == (W, 2 * N_MELS)
    assert got.shape[0] == 3 * (max_patches or 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


def test_audio_train_and_eval_step_match_jax(jax_dropout_off,
                                             jax_standardize_fixed):
    module, v, net = _models(3)
    B = 3 * BS
    audio = _audio(9, B, n=(2 * W - 1) * 160 + 400)   # two patches a clip
    _, labels = _batch(0, B)
    kw = dict(patch_size=W, patch_shift=W, mtl=True)
    jcfg = jfeat.FeatureConfig(n_mels=N_MELS, dft_precision="highest")
    jopt, _ = joptim.for_model("Lemaire_et_al_MTL", tr_steps=100000)
    js = jstate.TrainState(params=v["params"], batch_stats=v["batch_stats"],
                           opt_state=jopt.init(v["params"]),
                           step=jnp.zeros((), jnp.int32))
    jl = {k: jnp.asarray(a) for k, a in labels.items()}
    js, jm = jendtoend.make_audio_train_step(
        module, jopt, jcfg, l2_reg=0.01, use_pallas=False, **kw)(
        js, jnp.asarray(audio), jl, jax.random.PRNGKey(0))

    cfg = tfeat.FeatureConfig(n_mels=N_MELS)
    opt, _ = toptim.for_model("Lemaire_et_al_MTL", net.parameters(),
                              tr_steps=100000)
    ts = tstate.TrainState(net, opt)
    tl = {k: _t(a) for k, a in labels.items()}
    tm = tendtoend.make_audio_train_step(
        net, opt, cfg, l2_reg=0.01, generator=torch.Generator(), **kw)(
        ts, _t(audio), tl)
    _same_metrics(tm, jm)
    _same_state(net, js)
    jm = jendtoend.make_audio_eval_step(module, jcfg, use_pallas=False,
                                        **kw)(js, jnp.asarray(audio), jl)
    _same_metrics(tendtoend.make_audio_eval_step(net, cfg, **kw)(
        ts, _t(audio), tl), jm)


# --- the image-family models and single-task steps --------------------------

#: One step of each model family against JAX: (model, input rows, patch
#: width, zoo kwargs).  Heights are cut from the presets' (402, 240, 21
#: rows at 68 frames) to keep the CPU run short.
STEP_CASES = [("Papakostas_et_al_MTL", 48, 48, {}),
              ("Doukhan_et_al_MTL", 40, 68, {"n_mels": 20}),
              ("Papakostas_et_al", 48, 48, {})]


@pytest.fixture
def jax_float64(monkeypatch):
    """The JAX step in float64, for the image models' step tests.

    Their four to six BatchNorms in series at batch 6 amplify float32
    rounding to ~1e-5 of the outputs: the port's own float32 run against
    its float64 run differs by up to 1.5e-5 on Doukhan-MTL's R head and
    1.1e-5 on Papakostas-MTL's (tools/cnn_step_precision.py), where the
    step's bars stand, so no two float32 programs meet them.  In float64
    the two packages agree to ~1e-12 and a fault of semantics still moves
    them by 1e-3 or more.
    The JAX LRN casts to float32 inside; here it keeps its input's dtype
    (the same formula, patched, not edited)."""
    def lrn(x, depth_radius=5, bias=1.0, alpha=1e-4, beta=0.75):
        i = jnp.arange(x.shape[-1])
        band = (jnp.abs(i[:, None] - i[None, :]) <= depth_radius)
        summed = jnp.einsum("...c,cd->...d", x * x, band.astype(x.dtype),
                            precision=jax.lax.Precision.HIGHEST)
        return x / (bias + alpha * summed) ** beta

    monkeypatch.setattr(jcnn, "local_response_normalization", lrn)
    with jax.enable_x64(True):
        yield


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, dtype=np.float64), tree)


def _image_models(name, rows, width, kw, seed):
    """The flax model with its variables in float64 (dropout off through
    the fixture), and the port's in float64 with the same weights and
    dropout rate 0."""
    module = jget_model(name, **kw).module
    v = jax.jit(lambda k: module.init({"params": k, "dropout": k + 1},
                                      jnp.zeros((1, rows, width, 1)),
                                      train=False))(jax.random.PRNGKey(seed))
    v = _f64(dict(v))
    net = get_model(name, in_dim=rows, patch_size=width, **kw)
    net.load_state_dict(weights.from_flax(v))
    for m in net.modules():
        if isinstance(m, layers.Dropout):
            m.rate = 0.0
    return module, v, net.double()


def _optimizers(name, net):
    """The model's optimizer on both sides, but plain SGD (Papakostas's)
    for the Adam models: Adam's first update is lr * g / (|g| + eps), which
    turns the rounding noise of a gradient that is 0 in exact arithmetic
    (a conv bias before a BatchNorm) into updates of ~lr whose sign is
    noise.  Adam itself is held to optax in test_optimizers_match_optax."""
    family = name if name.startswith("Papakostas") else "Papakostas_et_al"
    jopt, _ = joptim.for_model(family, tr_steps=1)
    opt, _ = toptim.for_model(family, net.parameters(), tr_steps=1)
    return jopt, opt


def _jax_state(v, jopt):
    return jstate.TrainState(params=v["params"],
                             batch_stats=v["batch_stats"],
                             opt_state=jopt.init(v["params"]),
                             step=jnp.zeros((), jnp.int32))


@pytest.mark.parametrize("name,rows,width,kw", STEP_CASES,
                         ids=[c[0] for c in STEP_CASES])
def test_image_model_train_step_matches_jax(jax_dropout_off, jax_float64,
                                            name, rows, width, kw):
    module, v, net = _image_models(name, rows, width, kw, 4)
    mtl = name.endswith("_MTL")
    rng, labels = _batch(12, 3 * BS)
    labels = _f64(labels if mtl else labels["3C"])
    x = rng.standard_normal((3 * BS, rows, width, 1))
    jopt, opt = _optimizers(name, net)
    jl = jax.tree_util.tree_map(jnp.asarray, labels)
    l2 = 0.01 if mtl else 0.0           # the runner's rule, as in JAX
    # Doukhan's JAX step runs eagerly: jitted on XLA:CPU, its gradient of
    # c4's conv bias, which feeds a train-mode BatchNorm and so is 0 in
    # exact arithmetic (the loss moves by float32 noise under a finite
    # difference), comes out 0.29 against 3e-7 eagerly and in the port,
    # and the error runs back through c1-c3 (tools/cnn_step_precision.py,
    # ROADMAP §3).
    jit = contextlib.nullcontext() if name.startswith("Papakostas") else \
        jax.disable_jit()
    with jit:
        js, jm = jstate.make_train_step(module, jopt, mtl=mtl, l2_reg=l2)(
            _jax_state(v, jopt), jnp.asarray(x), jl, jax.random.PRNGKey(2))
    ts = tstate.TrainState(net, opt)
    tl = {k: _t(a) for k, a in labels.items()} if mtl else _t(labels)
    tm = tstate.make_train_step(net, opt, mtl=mtl, l2_reg=l2,
                                generator=torch.Generator())(ts, _t(x), tl)
    assert ("3C_accuracy" in tm) == mtl and ("accuracy" in tm) != mtl
    _same_metrics(tm, jm)
    _same_state(net, js)
    jm = jstate.make_eval_step(module, mtl=mtl)(js, jnp.asarray(x), jl)
    _same_metrics(tstate.make_eval_step(net, mtl=mtl)(ts, _t(x), tl), jm)


def test_jang_mtl_audio_step_matches_jax(jax_dropout_off,
                                         jax_standardize_fixed,
                                         monkeypatch):
    """Jang-MTL's device-pipeline step: LogHarmPercSpec at n_fft 512 (K2's
    features on the card), row standardization per HPSS component, the
    patches into the image model, the labels tiled, and the l2 of the heads
    and the mel-scale kernels; 24 mel bands, 16-frame patches.  Both steps
    take the same featuregram (the port's plain float32 one, in float64,
    see ``jax_float64``); that the featuregrams agree is
    ``test_device_patches_scaled_and_skewness_match_jax[jang]``'s."""
    B = 3 * BS
    audio = _audio(10, B, n=(2 * W - 1) * 160 + 400)
    fv = tfg.featuregram(_t(audio), feat_name="LogHarmPercSpec",
                         n_fft=512)                        # (B, 514, T)

    def features(y, *, feat_name, n_fft, **kw):
        assert (y.shape, feat_name, n_fft) == (audio.shape,
                                               "LogHarmPercSpec", 512)
        return fv

    monkeypatch.setattr(tendtoend.fg, "featuregram", features)
    monkeypatch.setattr(jendtoend.fg, "featuregram",
                        lambda y, use_pallas=None, **kw: jnp.asarray(
                            features(y, **kw).numpy()))
    module = jget_model("Jang_et_al_MTL", n_mels=24).module
    v = jax.jit(lambda k: module.init({"params": k, "dropout": k + 1},
                                      jnp.zeros((1, 514, W, 1)),
                                      train=False))(jax.random.PRNGKey(5))
    v = jax.tree_util.tree_map(np.asarray, dict(v))
    net = get_model("Jang_et_al_MTL", n_mels=24, patch_size=W)
    net.load_state_dict(weights.from_flax(v))
    for m in net.modules():
        if isinstance(m, layers.Dropout):
            m.rate = 0.0
    _, labels = _batch(0, B)
    kw = dict(patch_size=W, patch_shift=W, mtl=True, input_kind="image")
    feat = dict(feat_name="LogHarmPercSpec", n_fft=512)
    jcfg = jfeat.FeatureConfig(dft_precision="highest", **feat)
    jopt, opt = _optimizers("Jang_et_al_MTL", net)
    jl = {k: jnp.asarray(a) for k, a in labels.items()}
    # Eagerly, as Doukhan's (test_image_model_train_step_matches_jax):
    # jitted, the gradient of b3's conv bias (0 in exact arithmetic) is
    # 0.20 against 1.5e-7 eagerly (tools/cnn_step_precision.py), and the
    # first block's BatchNorm shift ends 9e-4 off the port's.
    with jax.disable_jit():
        js, jm = jendtoend.make_audio_train_step(
            module, jopt, jcfg, l2_reg=0.01, use_pallas=False, **kw)(
            _jax_state(v, jopt), jnp.asarray(audio), jl,
            jax.random.PRNGKey(0))
    cfg = tfeat.FeatureConfig(**feat)
    ts = tstate.TrainState(net, opt)
    tl = {k: _t(a) for k, a in labels.items()}
    tm = tendtoend.make_audio_train_step(
        net, opt, cfg, l2_reg=0.01, generator=torch.Generator(), **kw)(
        ts, _t(audio), tl)
    regularized = {id(p) for p in tstate.l2_kernels(net)}
    assert {n for n, p in net.named_parameters() if id(p) in regularized
            and "melCl" in n} == {"melCl_H.kernel", "melCl_P.kernel"}
    _same_metrics(tm, jm)
    _same_state(net, js)
    jm = jendtoend.make_audio_eval_step(module, jcfg, use_pallas=False,
                                        **kw)(js, jnp.asarray(audio), jl)
    _same_metrics(tendtoend.make_audio_eval_step(net, cfg, **kw)(
        ts, _t(audio), tl), jm)


@pytest.mark.parametrize("option", ["fold_stats", "Row", "Col", "jang"])
def test_device_patches_scaled_and_skewness_match_jax(jax_standardize_fixed,
                                                      option):
    """Frame-level scaling, skewness vectors, and Jang-MTL's image patches
    of LogHarmPercSpec at n_fft 512 (an 11120-sample crop frames to 67
    frames at n_fft 512, whose 68-frame patch takes the tiling rule)."""
    audio = _audio(13, 3, n=11120 if option == "jang" else 16000)
    D = 2 * N_MELS
    rng = np.random.default_rng(14)
    stats = ((rng.standard_normal(D) * 10 - 30).astype(np.float32),
             rng.uniform(5, 15, D).astype(np.float32))
    feat = dict(n_mels=N_MELS)
    kw = dict(patch_size=W, patch_shift=W, max_patches=2)
    if option == "jang":
        feat = dict(feat_name="LogHarmPercSpec", n_fft=512)
        kw = dict(patch_size=68, patch_shift=68, max_patches=1,
                  input_kind="image")
    elif option == "fold_stats":
        kw["fold_stats"] = stats
    else:
        kw["skewness_vector"] = option
    got = tendtoend.device_featurize_patches(
        _t(audio), tfeat.FeatureConfig(**feat), **kw)
    want = jendtoend.device_featurize_patches(
        jnp.asarray(audio), jfeat.FeatureConfig(dft_precision="highest",
                                                **feat),
        use_pallas=False, **kw)
    shape = {"Row": (6, 1, D), "Col": (6, W, 1), "fold_stats": (6, W, D),
             "jang": (3, 514, 68, 1)}[option]
    assert got.shape == want.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    if option == "jang":
        assert tstream.crop_samples(1, 68, tfeat.FeatureConfig(**feat)) == \
            11120
        # 67 frames, tiled to 68: the first frame again at the end.
        fv = tendtoend.fg.featuregram(_t(audio), feat_name="LogHarmPercSpec",
                                      n_fft=512)
        assert fv.shape[-1] == 67
        torch.testing.assert_close(got[:, :, 67, 0], got[:, :, 0, 0])
    # The statistics may also be tensors on the audio's device.
    if option == "fold_stats":
        kw["fold_stats"] = tuple(torch.from_numpy(a) for a in stats)
        torch.testing.assert_close(tendtoend.device_featurize_patches(
            _t(audio), tfeat.FeatureConfig(**feat), **kw), got,
            rtol=0, atol=0)


@pytest.mark.parametrize("name,kw", [
    ("Papakostas_et_al_MTL", dict(in_dim=48, patch_size=48)),
    ("Doukhan_et_al_MTL", dict(n_mels=20)),
    ("Papakostas_et_al", dict(in_dim=48, patch_size=48)),
    ("Jang_et_al", {})])
def test_l2_kernels_of_the_image_models(name, kw):
    """The l2 set of the JAX rule (``kernel`` leaves under ``heads`` or
    ``melCl``): the MTL CNNs' head kernels only, none in the single-task
    CNNs, Jang's mel-scale kernel (which the runner's single-task rule
    then leaves unregularized, l2 being 0 there)."""
    net = get_model(name, **kw)
    chosen = {id(p) for p in tstate.l2_kernels(net)}
    names = {n for n, p in net.named_parameters() if id(p) in chosen}
    tree = weights._flatten(weights.to_flax(net.state_dict())["params"])
    want = {path for path in tree if path[-1] == "kernel" and any(
        "heads" in q or "melCl" in q for q in path)}
    assert len(names) == len(want)
    assert {n.replace(".weight", ".kernel").replace(".", "/")
            for n in names} == {"/".join(p) for p in want}
    if name.endswith("_MTL"):
        assert len(names) == 7 and all(n.startswith("heads.") for n in names)
    else:
        assert names == ({"melCl.kernel"} if name == "Jang_et_al" else set())


def test_broadcast_labels_take_a_single_task_array():
    """A single-task model's labels are one ``(B, C)`` array, which JAX
    tiles like a dict's leaves."""
    onehot = torch.eye(3)[[0, 2, 1, 1]]
    got = tendtoend._broadcast_labels(onehot, 3)
    want = jendtoend._broadcast_labels(jnp.asarray(onehot.numpy()), 3)
    assert got.shape == (12, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_broadcast_labels_keep_the_patch_order():
    labels = {"3C": torch.eye(3), "S": torch.tensor([0.0, 1.0, 0.0])}
    got = tendtoend._broadcast_labels(labels, 2)
    torch.testing.assert_close(got["3C"], torch.cat([torch.eye(3)] * 2))
    want = jendtoend._broadcast_labels({k: jnp.asarray(v.numpy())
                                        for k, v in labels.items()}, 2)
    for k in labels:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("T,size,shift", [(5, 16, 16), (16, 16, 16),
                                          (69, 68, 68), (150, 16, 4),
                                          (301, 68, 68)])
def test_extract_patches_matches_the_host_version(T, size, shift):
    fv = np.random.default_rng(T).standard_normal((2, 6, T)).astype(
        np.float32)
    got = tpatches.extract_patches(_t(fv), patch_size=size,
                                   patch_shift=shift)
    for b in range(2):
        np.testing.assert_array_equal(
            got[:, b].numpy(), jpatches.extract_patches_np(fv[b], size,
                                                           shift))


# --- batchers ----------------------------------------------------------------

def _noise_floor(root, seed, level=1e-2):
    """White noise at -40 dB of the unit peak on every wav (the toy
    synthesizers leave bins where two float32 DFTs differ by 0.02 dB;
    ``test_torch_eval`` explains)."""
    rng = np.random.default_rng(seed)
    for cls in sorted(os.listdir(root)):
        d = os.path.join(root, cls)
        if cls == "annotations" or not os.path.isdir(d):
            continue
        for name in sorted(os.listdir(d)):
            x, _ = taudio.read_wav(os.path.join(d, name))
            taudio.write_wav(os.path.join(d, name),
                             x + level * rng.standard_normal(len(x)))


@pytest.fixture(scope="module")
def toy5(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("toy5"))
    taudio.make_toy_musan(root, n_per_class=6, duration_s=1.5,
                          with_noise=True, seed=2)
    _noise_floor(root, 3)
    cv = jfolds.create_cv_folds(root, with_noise=True, seed=0)
    return root, cv


@pytest.mark.parametrize("n_classes", [3, 5])
def test_audio_crop_batcher_matches_jax(toy5, n_classes):
    root, cv = toy5
    names = ["music", "speech", "speech+music", "noise",
             "speech+noise"][:n_classes]
    files, _ = jfolds.get_train_test_files(cv, 0, class_names=names)
    kw = dict(clips_per_class=2, n_patches_per_clip=2, patch_size=W,
              patch_shift=W, seed=5)
    got = tstream.AudioCropBatcher(tstream.AudioCache(), root, files,
                                   tfeat.FeatureConfig(), **kw)
    want = jstream.AudioCropBatcher(jstream.AudioCache(), root, files,
                                    jfeat.FeatureConfig(), **kw)
    assert got.L == want.L == tstream.crop_samples(2, W,
                                                   tfeat.FeatureConfig())
    for _ in range(5):
        (ga, gl), (wa, wl) = next(got), next(want)
        np.testing.assert_array_equal(ga, wa)
        assert set(gl) == set(wl)
        for k in wl:
            np.testing.assert_array_equal(gl[k], wl[k])


def test_balanced_batcher_matches_jax(toy5):
    root, cv = toy5
    assert native.available()           # the JAX batcher's host kernels
    files, _ = jfolds.get_train_test_files(cv, 1)
    kw = dict(batch_size=BS, patch_size=W, patch_shift=W,
              augment_noise=False, seed=7)
    got = tbatcher.BalancedBatcher(
        tfeat.Featurizer(tfeat.FeatureConfig(n_mels=N_MELS), device="cpu"),
        root, files, tbatcher.BatcherConfig(**kw))
    want = jbatcher.BalancedBatcher(
        jfeat.Featurizer(jfeat.FeatureConfig(n_mels=N_MELS),
                         use_pallas=False),
        root, files, jbatcher.BatcherConfig(**kw))
    for _ in range(5):
        (gx, gl), (wx, wl) = next(got), next(want)
        assert gx.shape == wx.shape == (3 * BS, W, 2 * N_MELS)
        np.testing.assert_allclose(gx, wx, rtol=0, atol=1e-4)
        for k in wl:
            np.testing.assert_array_equal(gl[k], wl[k])
    assert got.cache_stats == want.cache_stats
    # The dual batches (intermediate fusion, ported) are the same batches'
    # two halves (held to JAX by test_torch_lemaire_variants).
    single = tbatcher.BalancedBatcher(
        tfeat.Featurizer(tfeat.FeatureConfig(n_mels=N_MELS), device="cpu"),
        root, files, tbatcher.BatcherConfig(**kw))
    dual = tbatcher.BalancedBatcher(
        tfeat.Featurizer(tfeat.FeatureConfig(n_mels=N_MELS), device="cpu"),
        root, files, tbatcher.BatcherConfig(dual_tower=True, **kw))
    (sx, sl), (dx, dl) = next(single), next(dual)
    np.testing.assert_array_equal(np.concatenate(
        [dx["harm_input"], dx["perc_input"]], axis=-1), sx)
    for k in sl:
        np.testing.assert_array_equal(dl[k], sl[k])


@pytest.mark.parametrize("option", ["Row", "Col", "fold_stats"])
def test_balanced_batcher_skewness_and_scaling_match_jax(toy5, option):
    """Frame-level scaling by fold statistics in place of the per-file
    standardization, compared directly; skewness-vector batches as the
    skewness of the batcher's own patches, in both packages, whose patches
    agree.  (The skewness of a 16-frame row is ill-conditioned where the
    row barely moves within the window: the two packages' patches, 1e-5
    apart, then give skewness vectors up to 1.3e-4 apart; the statistic
    itself is held in ``test_torch_stats``, at the same atol 1e-5 as
    here.)  The fold statistics are the corpus's (``data.stats``)."""
    root, cv = toy5
    files, _ = jfolds.get_train_test_files(cv, 1)    # as the test above
    D = 2 * N_MELS
    scaled = option == "fold_stats"
    fold_stats = tstats.get_data_stats(
        tfeat.Featurizer(tfeat.FeatureConfig(n_mels=N_MELS), device="cpu"),
        root, files) if scaled else None

    def batchers(skew):
        kw = dict(batch_size=BS, patch_size=W, patch_shift=W,
                  augment_noise=False, seed=7, skewness_vector=skew,
                  frame_level_scaling=scaled)
        return (tbatcher.BalancedBatcher(
                    tfeat.Featurizer(tfeat.FeatureConfig(n_mels=N_MELS),
                                     device="cpu"),
                    root, files, tbatcher.BatcherConfig(**kw),
                    fold_stats=fold_stats),
                jbatcher.BalancedBatcher(
                    jfeat.Featurizer(jfeat.FeatureConfig(n_mels=N_MELS),
                                     use_pallas=False),
                    root, files, jbatcher.BatcherConfig(**kw),
                    fold_stats=fold_stats))

    got, want = batchers(None)
    if not scaled:
        got_s, want_s = batchers(option)
        axis = 1 if option == "Row" else 0
    for _ in range(3):
        (gx, gl), (wx, wl) = next(got), next(want)
        assert gx.shape == wx.shape == (3 * BS, W, D)
        np.testing.assert_allclose(gx, wx, rtol=0, atol=1e-4)
        for k in wl:
            np.testing.assert_array_equal(gl[k], wl[k])
        if scaled:
            continue
        (gs, gsl), (ws, wsl) = next(got_s), next(want_s)
        shape = (1, D) if option == "Row" else (W, 1)
        assert gs.shape == ws.shape == (3 * BS,) + shape
        # Each package's skewness batch is the skewness of its own patches
        # (the batches hold them time-major, (N, W, D)).
        skew_of = {"torch": topstats.patch_statistics(torch.from_numpy(
                       np.ascontiguousarray(np.swapaxes(gx, 1, 2))),
                       axis=axis),
                   "jax": np.asarray(jopstats.patch_statistics(
                       np.ascontiguousarray(np.swapaxes(wx, 1, 2)),
                       axis=axis))}
        np.testing.assert_allclose(gs.reshape(3 * BS, -1),
                                   np.asarray(skew_of["torch"]), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(ws.reshape(3 * BS, -1), skew_of["jax"],
                                   rtol=0, atol=1e-5)
        for k in wl:
            np.testing.assert_array_equal(gsl[k], wl[k])
            np.testing.assert_array_equal(wsl[k], wl[k])


# --- prefetcher and checkpoints ----------------------------------------------

def test_prefetcher_hands_batches_through_and_raises_worker_errors():
    def stream(n, fail=False):
        for i in range(n):
            yield np.full((2, 3), i, np.float32), {"3C": np.eye(3)[i % 3]}
        if fail:
            raise ValueError("corpus file vanished")

    pf = tprefetch.DevicePrefetcher(stream(4), "cpu")
    got = list(pf)
    assert [int(x[0, 0]) for x, _ in got] == [0, 1, 2, 3]
    assert all(isinstance(x, torch.Tensor) and isinstance(y["3C"],
                                                           torch.Tensor)
               for x, y in got)
    pf = tprefetch.DevicePrefetcher(stream(2, fail=True), "cpu")
    assert int(next(pf)[0][0, 0]) == 0
    with pytest.raises(ValueError, match="vanished"):
        next(pf), next(pf)
    # close() ends workers blocked on a full queue.
    pf = tprefetch.DevicePrefetcher([stream(10 ** 6), stream(10 ** 6)],
                                    "cpu", buffer_size=1)
    next(pf)
    pf.close()
    for t in pf.threads:
        t.join(timeout=5)
        assert not t.is_alive()


def test_checkpoint_round_trip(tmp_path):
    net = get_model("Lemaire_et_al_MTL", n_mels=N_MELS, patch_size=W,
                    **NARROW)
    opt, _ = toptim.for_model("Lemaire_et_al_MTL", net.parameters(), 10)
    st = tstate.TrainState(net, opt)
    step = tstate.make_train_step(net, opt, mtl=True,
                                  generator=torch.Generator().manual_seed(1))
    rng, labels = _batch(2, 3 * BS)
    for _ in range(2):
        step(st, _t(rng.standard_normal((3 * BS, W, 2 * N_MELS)).astype(
            np.float32)), {k: _t(a) for k, a in labels.items()})
    ck = str(tmp_path / "ck")
    assert not tckpt.checkpoint_exists(ck)
    tckpt.save_checkpoint(ck, st, {"epoch": 3, "val_loss": 1.5})
    tckpt.update_metadata(ck, {"completed": True})
    assert tckpt.checkpoint_exists(ck)

    net2 = get_model("Lemaire_et_al_MTL", n_mels=N_MELS, patch_size=W,
                     **NARROW)
    opt2, _ = toptim.for_model("Lemaire_et_al_MTL", net2.parameters(), 10)
    st2, meta = tckpt.restore_checkpoint(ck, tstate.TrainState(net2, opt2))
    assert meta == {"epoch": 3, "val_loss": 1.5, "completed": True}
    assert st2.step == 2
    for (k, a), b in zip(net.state_dict().items(),
                         net2.state_dict().values()):
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(a, b), k
    for p, q in zip(net.parameters(), net2.parameters()):
        assert torch.equal(opt.state[p]["momentum_buffer"],
                           opt2.state[q]["momentum_buffer"])
        assert int(opt2.state[q]["step"]) == 2
    # The model file is a serving weights file.
    tree = weights.load_npz(os.path.join(ck, "state", "model.npz"))
    assert tree["params"]["heads"]["S_out"]["kernel"].shape == (16, 1)

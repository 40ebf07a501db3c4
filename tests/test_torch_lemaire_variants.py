"""The paper's Lemaire variants in the port against the JAX package:
Cascaded-MTL, the 5-class MTL with the noise head, and the intermediate-
fusion twin towers.

Each model in eval mode against flax with transferred weights (every head,
atol 1e-5); the weights' round trip (exact); one train and eval step on
patches (loss rtol 1e-5, parameters atol 1e-6 and rtol 1e-4, statistics
rtol 1e-5, as ``tests/test_torch_train.py``); the fusion model's device
step through the plain K1 (patches atol 1e-4); the l2 set; the dict
augmentation; the dual batcher; and ``cli.segment`` serving Cascaded-MTL.
Narrow models: 8 filters, 1 stack, dilations (1, 2) (the fusion model's
towers keep the TCN's 8 dilations, as the JAX zoo builds them), 16 mel
bands, 16-frame patches, 2 per class.
"""

import os

import flax.linen as fnn
import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax
import jax.numpy as jnp

from sm_hpss_mtl_tpu.cli import segment as jcli
from sm_hpss_mtl_tpu.data import batcher as jbatcher
from sm_hpss_mtl_tpu.data import featurize as jfeat
from sm_hpss_mtl_tpu.data import folds as jfolds
from sm_hpss_mtl_tpu.eval import segment as jseg
from sm_hpss_mtl_tpu.models import get_model as jget_model
from sm_hpss_mtl_tpu.ops import patches as jpatches
from sm_hpss_mtl_tpu.train import endtoend as jendtoend
from sm_hpss_mtl_tpu.train import optimizers as joptim
from sm_hpss_mtl_tpu.train import state as jstate
from sm_hpss_mtl_tpu_torch import weights
from sm_hpss_mtl_tpu_torch.cli import segment as tcli
from sm_hpss_mtl_tpu_torch.data import audio as taudio
from sm_hpss_mtl_tpu_torch.data import batcher as tbatcher
from sm_hpss_mtl_tpu_torch.data import featurize as tfeat
from sm_hpss_mtl_tpu_torch.models import layers
from sm_hpss_mtl_tpu_torch.models.zoo import INPUT_KIND, MTL, get_model
from sm_hpss_mtl_tpu_torch.train import endtoend as tendtoend
from sm_hpss_mtl_tpu_torch.train import optimizers as toptim
from sm_hpss_mtl_tpu_torch.train import state as tstate

torch.set_num_threads(2)

NARROW = dict(n_filters=8, nb_stacks=1, Nd=2)
N_MELS, W, BS = 16, 16, 2
CASCADED, FIVE, IF = ("Lemaire_et_al_Cascaded_MTL",
                      "Lemaire_et_al_MTL_5class", "Lemaire_et_al_MTL_IF")
NAMES = (CASCADED, FIVE, IF)


class _NoDropout(fnn.Module):
    """flax's ``nn.Dropout`` as the identity (the JAX heads fix their rate
    at 0.4)."""
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
    to 0 (``test_torch_segment`` explains the JAX helper's fault)."""
    def fixed(FV):
        out = jpatches.standardize_rows(FV)
        const = jnp.max(FV, axis=-1, keepdims=True) == jnp.min(
            FV, axis=-1, keepdims=True)
        return jnp.where(const, 0.0, out)

    monkeypatch.setattr(jendtoend, "standardize_rows", fixed)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _rows(name):
    """Feature rows of the model's preset at ``N_MELS`` bands: Cascaded-MTL
    takes ``LogMelHarmSpec``, the others ``LogMelHarmPercSpec``."""
    return N_MELS if name == CASCADED else 2 * N_MELS


def _inputs(name, x):
    """``(B, W, rows)`` patches as the model's input: the fusion model's
    dict of the two halves."""
    if name == IF:
        return {"harm_input": x[..., :N_MELS], "perc_input": x[..., N_MELS:]}
    return x


def _labels(name):
    """Batch labels of ``BS`` rows per class (5 classes for the 5-class
    model), from the port's label rule (held to JAX's by
    ``test_torch_train``)."""
    n = 5 if name == FIVE else 3
    dbs = [np.full(BS, np.nan)] * 2 + [np.array([5.0, -3.0])]
    if n == 5:
        dbs += [np.full(BS, np.nan), np.array([2.0, -1.0])]
    return tbatcher.mtl_labels(BS, dbs)


def _perturbed(v, seed):
    """Non-trivial BatchNorm statistics, biases and scales."""
    rng = np.random.default_rng(seed)

    def perturb(path, x):
        name = path[-1].key
        if name == "mean":
            return rng.standard_normal(x.shape).astype(np.float32) * 0.3
        if name == "var":
            return rng.uniform(0.5, 2.0, x.shape).astype(np.float32)
        if name in ("bias", "scale"):
            return x + rng.standard_normal(x.shape).astype(np.float32) * 0.1
        return x

    return {k: jax.tree_util.tree_map_with_path(perturb, dict(v[k]))
            for k in ("params", "batch_stats")}


def _models(name, seed, dropout=True, perturb=False):
    """The narrow flax model with its variables and the port's with the
    same weights; ``dropout=False`` turns the TCN's dropout off on both
    sides (the heads' with ``jax_dropout_off``)."""
    kw = {} if dropout else {"dropout_rate": 0.0}
    module = jget_model(name, n_mels=N_MELS, **kw, **NARROW).module
    sample = _inputs(name, jnp.zeros((2, W, _rows(name))))
    v = module.init({"params": jax.random.PRNGKey(seed),
                     "dropout": jax.random.PRNGKey(seed + 1)}, sample,
                    train=False)
    v = jax.tree_util.tree_map(np.asarray, dict(v))
    if perturb:
        v = _perturbed(v, seed)
    net = get_model(name, n_mels=N_MELS, patch_size=W, **kw, **NARROW)
    net.load_state_dict(weights.from_flax(v))
    if not dropout:
        for m in net.modules():
            if isinstance(m, layers.Dropout):
                m.rate = 0.0
    return module, v, net


def test_zoo_specs_match_jax():
    for name in NAMES:
        want = jget_model(name, n_mels=N_MELS)
        assert (INPUT_KIND[name], MTL[name]) == (want.input_kind, want.mtl)
    assert INPUT_KIND[IF] == "dual"
    # Full width: the preset geometry, 5 classes forced, twin 120-band
    # towers fused over 2 x 68 x 32 features.
    assert get_model(CASCADED).tcn.initial_conv.in_channels == 120
    five = get_model(FIVE, n_classes=3)
    assert five.heads.C_out.out_features == 5
    assert five.heads.R_out.out_features == 3
    fused = get_model(IF)
    assert fused.tcn_H.initial_conv.in_channels == 120
    assert fused.fusion_bn.num_features == 2 * 68 * 32
    assert len(fused.tcn_P.block_names) == 3 * 8


@pytest.mark.parametrize("name", NAMES)
def test_heads_match_flax_in_eval_mode(name):
    module, v, net = _models(name, 0, perturb=True)
    x = np.random.default_rng(1).standard_normal(
        (4, W, _rows(name))).astype(np.float32)
    want = module.apply(v, _inputs(name, jnp.asarray(x)), train=False)
    with torch.no_grad():
        got = net.eval()(_inputs(name, _t(x)))
    assert list(got) == list(want)          # the JAX order of the heads
    heads = {FIVE: ["S", "M", "N", "R", "3C"],
             CASCADED: ["R", "S", "M", "3C"]}.get(name, ["S", "M", "R", "3C"])
    assert list(got) == heads
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5, err_msg=k)


def test_five_class_heads_stack_head_layers():
    """``head_layers`` blocks per head, named ``S_block``, ``S_block_l1``."""
    kw = dict(head_layers=2, head_width=8, **NARROW)
    module = jget_model(FIVE, n_mels=N_MELS, **kw).module
    v = module.init({"params": jax.random.PRNGKey(3),
                     "dropout": jax.random.PRNGKey(4)},
                    jnp.zeros((2, W, 2 * N_MELS)), train=False)
    v = _perturbed(jax.tree_util.tree_map(np.asarray, dict(v)), 5)
    assert "N_block_l1" in v["params"]["heads"]
    net = get_model(FIVE, n_mels=N_MELS, patch_size=W, **kw)
    net.load_state_dict(weights.from_flax(v))
    x = np.random.default_rng(2).standard_normal((3, W, 2 * N_MELS)).astype(
        np.float32)
    want = module.apply(v, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = net.eval()(_t(x))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", NAMES)
def test_weights_round_trip_is_exact(name, tmp_path):
    _, v, net = _models(name, 2, perturb=True)
    flat = weights._flatten(v)
    new = {IF: [("params", "tcn_H", "initial_conv", "kernel"),
                ("params", "tcn_P", "stack0_dilation128", "conv_1x1",
                 "kernel"),
                ("params", "fusion_bn", "scale"),
                ("batch_stats", "fusion_bn", "var")],
           CASCADED: [("params", "heads", "S_cat_bn", "scale"),
                      ("batch_stats", "heads", "M_cat_bn", "mean")],
           FIVE: [("params", "heads", "N_block", "dense", "kernel"),
                  ("params", "heads", "N_out", "kernel")]}[name]
    for path in new:
        assert path in flat, path
    if name == FIVE:
        assert flat[("params", "heads", "R_out", "kernel")].shape == (16, 3)
    path = str(tmp_path / "w.npz")
    weights.save_npz(path, v)
    back = weights._flatten(weights.to_flax(weights.from_flax(
        weights.load_npz(path))))
    assert set(back) == set(flat)
    for k, a in flat.items():
        np.testing.assert_array_equal(back[k], a, err_msg="/".join(k))
        assert back[k].shape == a.shape
    # torch -> flax -> torch is the identity too.
    again = weights.from_flax(weights.to_flax(net.state_dict()))
    for k, t in net.state_dict().items():
        torch.testing.assert_close(again[k], t, rtol=0, atol=0,
                                   check_dtype=False)


def _same_state(net, js, rtol_stats=1e-5):
    """Parameters at atol 1e-6 and rtol 1e-4; BatchNorm statistics at
    ``rtol_stats`` of each tensor's largest value, where a running mean's
    scale is at least its update's, 0.01 (the momentum's share) of its
    feature's spread: a BatchNorm after a normalised input (the fusion
    model's heads after ``fusion_bn``) has a batch mean that is 0 in exact
    arithmetic, so its running mean is float32 rounding, ~1e-9."""
    tree = weights.to_flax(net.state_dict())
    got_p = weights._flatten(tree["params"])
    want_p = weights._flatten(jax.tree_util.tree_map(np.asarray, js.params))
    assert set(got_p) == set(want_p)
    for path, w in want_p.items():
        np.testing.assert_allclose(got_p[path], w, rtol=1e-4, atol=1e-6,
                                   err_msg="/".join(path))
    got_s = weights._flatten(tree["batch_stats"])
    want_s = weights._flatten(jax.tree_util.tree_map(np.asarray,
                                                     js.batch_stats))
    for path, w in want_s.items():
        scale = np.abs(w).max()
        if path[-1] == "mean":
            spread = np.sqrt(want_s[path[:-1] + ("var",)].max())
            scale = max(scale, 0.01 * spread)
        np.testing.assert_allclose(got_s[path], w, rtol=rtol_stats,
                                   atol=rtol_stats * scale,
                                   err_msg="/".join(path))


def _same_metrics(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)


def _states(name, module, v, net):
    jopt, _ = joptim.for_model(name, tr_steps=100000)
    js = jstate.TrainState(params=v["params"], batch_stats=v["batch_stats"],
                           opt_state=jopt.init(v["params"]),
                           step=jnp.zeros((), jnp.int32))
    opt, _ = toptim.for_model(name, net.parameters(), tr_steps=100000)
    return jopt, js, opt, tstate.TrainState(net, opt)


@pytest.mark.parametrize("name", NAMES)
def test_patch_train_and_eval_step_match_jax(jax_dropout_off, name):
    module, v, net = _models(name, 0, dropout=False)
    labels = _labels(name)
    n = len(labels["3C"])
    x = np.random.default_rng(6).standard_normal((n, W, _rows(name))).astype(
        np.float32)
    jopt, js, opt, ts = _states(name, module, v, net)
    jl = {k: jnp.asarray(a) for k, a in labels.items()}
    js, jm = jstate.make_train_step(module, jopt, mtl=True, l2_reg=0.01)(
        js, _inputs(name, jnp.asarray(x)), jl, jax.random.PRNGKey(2))
    tl = {k: _t(a) for k, a in labels.items()}
    tm = tstate.make_train_step(net, opt, mtl=True, l2_reg=0.01,
                                generator=torch.Generator().manual_seed(0))(
        ts, _inputs(name, _t(x)), tl)
    assert ("N_loss" in tm) == (name == FIVE)
    _same_metrics(tm, jm)
    _same_state(net, js)
    jm = jstate.make_eval_step(module, mtl=True)(
        js, _inputs(name, jnp.asarray(x)), jl)
    _same_metrics(tstate.make_eval_step(net, mtl=True)(
        ts, _inputs(name, _t(x)), tl), jm)
    want = module.apply({"params": js.params, "batch_stats": js.batch_stats},
                        _inputs(name, jnp.asarray(x)))
    got = tstate.make_predict(net)(ts, _inputs(name, _t(x)))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5, err_msg=k)


def _audio(seed, B, n):
    return np.random.default_rng(seed).standard_normal((B, n)).astype(
        np.float32)


def test_fusion_audio_step_matches_jax(jax_dropout_off,
                                       jax_standardize_fixed, monkeypatch):
    """The fusion model's device-pipeline step: K1's features (its plain
    version here), standardized per HPSS component, cut into patches and
    split into the twin inputs ('dual'), the labels tiled.  The patches of
    each side's own featuregram agree to atol 1e-4 in float32.  The steps
    then take one featuregram (the port's, in float64) and run in float64:
    in float32
    the standardizations differ by ~1e-5 and the towers' eight dilated
    blocks turn that into tower updates 0.5% apart (more than the step's
    rtol 1e-4), while in float64 the two packages agree to ~1e-12 and a
    fault of semantics still moves them by 1e-3 or more (the image models'
    steps in ``test_torch_train`` are held so too)."""
    module, v, net = _models(IF, 3, dropout=False)
    B = 3 * BS
    audio = _audio(9, B, 2 * W * 160 + 400)    # 2W + 1 frames: two patches
    labels = _labels(IF)
    cfg = tfeat.FeatureConfig(n_mels=N_MELS)
    jcfg = jfeat.FeatureConfig(n_mels=N_MELS, dft_precision="highest")
    kw = dict(patch_size=W, patch_shift=W, input_kind="dual")
    got = tendtoend.device_featurize_patches(_t(audio), cfg, **kw)
    want = jendtoend.device_featurize_patches(jnp.asarray(audio), jcfg,
                                              use_pallas=False, **kw)
    assert set(got) == set(want) == {"harm_input", "perc_input"}
    for k in want:
        assert got[k].shape == want[k].shape == (2 * B, W, N_MELS)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-4, err_msg=k)
    audio = audio.astype(np.float64)
    fv = tendtoend.fg.featuregram(_t(audio), feat_name=cfg.feat_name,
                                  n_mels=N_MELS).double()
    monkeypatch.setattr(tendtoend.fg, "featuregram", lambda y, **kw: fv)
    monkeypatch.setattr(jendtoend.fg, "featuregram",
                        lambda y, use_pallas=None, **kw: jnp.asarray(
                            fv.numpy()))
    net.double()
    tl = {k: _t(a.astype(np.float64)) for k, a in labels.items()}
    with jax.enable_x64(True):
        v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)
        jopt, js, opt, ts = _states(IF, module, v, net)
        jl = {k: jnp.asarray(a.astype(np.float64)) for k, a in labels.items()}
        js, jm = jendtoend.make_audio_train_step(
            module, jopt, jcfg, l2_reg=0.01, use_pallas=False, mtl=True,
            **kw)(js, jnp.asarray(audio), jl, jax.random.PRNGKey(0))
        tm = tendtoend.make_audio_train_step(
            net, opt, cfg, l2_reg=0.01, generator=torch.Generator(),
            mtl=True, **kw)(ts, _t(audio), tl)
        _same_metrics(tm, jm)
        _same_state(net, js)
        jm = jendtoend.make_audio_eval_step(module, jcfg, use_pallas=False,
                                            mtl=True, **kw)(
            js, jnp.asarray(audio), jl)
        _same_metrics(tendtoend.make_audio_eval_step(
            net, cfg, mtl=True, **kw)(ts, _t(audio), tl), jm)


@pytest.mark.parametrize("name", NAMES)
def test_l2_kernels_are_the_jax_set(name):
    """The JAX rule (``kernel`` leaves whose path holds ``heads``) on the
    flax tree: the heads' dense kernels, not the BatchNorm scales
    (``S_cat_bn``, ``fusion_bn``) and nothing of the towers."""
    _, v, net = _models(name, 1)
    chosen = {id(p) for p in tstate.l2_kernels(net)}
    names = {n for n, p in net.named_parameters() if id(p) in chosen}
    want = {"/".join(path) for path in weights._flatten(v["params"])
            if path[-1] == "kernel" and any("heads" in q for q in path)}
    assert {n.replace(".weight", ".kernel").replace(".", "/")
            for n in names} == want
    assert len(names) == {FIVE: 9}.get(name, 7)
    assert all(n.startswith("heads.") and "_bn" not in n for n in names)


def test_augment_takes_one_scale_for_both_inputs():
    """A dict batch: one scale drawn for the step, then each input's own
    noise, in sorted key order (the JAX ``_augment``'s structure)."""
    shape = (64, 16, 8)
    batch = {"perc_input": torch.zeros(shape), "harm_input": torch.ones(shape)}
    got = tstate.augment(batch, torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(3)
    i = torch.randint(len(tstate.NOISE_SCALES), (), generator=g)
    scale = tstate.NOISE_SCALES[int(i)]
    assert list(got) == ["harm_input", "perc_input"]
    for k in got:
        want = batch[k] + torch.tensor(scale) * torch.randn(shape,
                                                            generator=g)
        torch.testing.assert_close(got[k], want, rtol=0, atol=0)
    assert not torch.equal(got["harm_input"] - 1, got["perc_input"])
    # The JAX augmentation has one scale per step too: the two inputs'
    # noise has the same spread, as the port's does, for every seed.
    for seed in range(6):
        j = jstate._augment({k: jnp.zeros(shape) for k in batch},
                            jax.random.PRNGKey(seed))
        t = tstate.augment({k: torch.zeros(shape) for k in batch},
                           torch.Generator().manual_seed(seed))
        for out in (j, t):
            ratio = float(np.std(np.asarray(out["harm_input"]))
                          / np.std(np.asarray(out["perc_input"])))
            assert abs(ratio - 1) < 0.05, ratio


def _noise_floor(root, seed, level=1e-2):
    """White noise at -40 dB of the unit peak on every wav (the toy
    synthesizers leave bins where two float32 DFTs differ)."""
    rng = np.random.default_rng(seed)
    for cls in sorted(os.listdir(root)):
        d = os.path.join(root, cls)
        if cls == "annotations" or not os.path.isdir(d):
            continue
        for name in sorted(os.listdir(d)):
            x, _ = taudio.read_wav(os.path.join(d, name))
            taudio.write_wav(os.path.join(d, name),
                             x + level * rng.standard_normal(len(x)))


def test_dual_balanced_batcher_matches_jax(tmp_path):
    """The corpus and bar of ``test_torch_train``'s batcher test: patches
    at atol 1e-4, labels bit for bit."""
    root = str(tmp_path)
    taudio.make_toy_musan(root, n_per_class=6, duration_s=1.5,
                          with_noise=True, seed=2)
    _noise_floor(root, 3)
    files, _ = jfolds.get_train_test_files(
        jfolds.create_cv_folds(root, with_noise=True, seed=0), 1)
    kw = dict(batch_size=BS, patch_size=W, patch_shift=W,
              augment_noise=False, dual_tower=True, seed=7)
    got = tbatcher.BalancedBatcher(
        tfeat.Featurizer(tfeat.FeatureConfig(n_mels=N_MELS), device="cpu"),
        root, files, tbatcher.BatcherConfig(**kw))
    want = jbatcher.BalancedBatcher(
        jfeat.Featurizer(jfeat.FeatureConfig(n_mels=N_MELS),
                         use_pallas=False),
        root, files, jbatcher.BatcherConfig(**kw))
    for _ in range(4):
        (gx, gl), (wx, wl) = next(got), next(want)
        assert set(gx) == set(wx) == {"harm_input", "perc_input"}
        for k in wx:
            assert gx[k].shape == wx[k].shape == (3 * BS, W, N_MELS)
            np.testing.assert_allclose(gx[k], wx[k], rtol=0, atol=1e-4)
        for k in wl:
            np.testing.assert_array_equal(gl[k], wl[k])


@pytest.fixture
def jax_constant_rows_fixed(monkeypatch):
    """The JAX segmenter's standardization with constant rows centred to 0
    (``test_torch_segment`` explains)."""
    def fixed(FV):
        FV = np.asarray(FV)
        out = np.array(jpatches.standardize_rows(FV))
        out[FV.max(axis=-1) == FV.min(axis=-1)] = 0.0
        return out

    monkeypatch.setattr(jseg, "standardize_rows", fixed)


def _broadcast(seconds, seed):
    """Tones, clicks and a speech-like burst, as 16 kHz float32."""
    rng = np.random.default_rng(seed)
    n = int(16000 * seconds)
    t = np.arange(n) / 16000
    x = 0.3 * np.sin(2 * np.pi * 220 * t) * (t < seconds / 2)
    burst = np.sin(2 * np.pi * 140 * t) * (np.sin(2 * np.pi * 4 * t) > 0)
    x = x + 0.3 * burst * (t >= seconds / 2) + 0.02 * rng.standard_normal(n)
    for k in range(0, n - 40, 3200):
        x[k:k + 40] += 0.8 * np.hanning(40)
    return x.astype(np.float32)


def serve_both(tmp_path, name, rows, seed, head):
    """``cli.segment`` of ``name`` at full width on a 1.4 s broadcast, by
    the JAX CLI (orbax checkpoint) and the port's (npz of the same
    weights) on the CPU; the tracks of both."""
    from sm_hpss_mtl_tpu.train import TrainState, for_model
    from sm_hpss_mtl_tpu.train.checkpoint import save_checkpoint

    wav = str(tmp_path / "b.wav")
    wavfile.write(wav, 16000, (_broadcast(1.4, seed) * 32767).astype(
        np.int16))
    spec = jget_model(name, n_mels=120)
    opt, _ = for_model(name, tr_steps=1)
    state = TrainState.create(spec.module, opt, jnp.zeros((2, 68, rows)),
                              jax.random.PRNGKey(seed))
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, state)
    npz = str(tmp_path / "w.npz")
    weights.save_npz(npz, jax.tree_util.tree_map(
        np.asarray, {"params": state.params,
                     "batch_stats": state.batch_stats}))
    common = [wav, "--model", name, "--head", head, "--chunk-frames", "32",
              "--smooth-win", "11"]
    jprob, jlab = jcli.main(common + ["--ckpt", ckpt,
                                      "--out", str(tmp_path / "j.npz")])
    tprob, tlab = tcli.main(common + ["--weights", npz, "--device", "cpu",
                                      "--out", str(tmp_path / "t.npz")])
    with np.load(tmp_path / "j.npz") as j, np.load(tmp_path / "t.npz") as t:
        return (jprob, jlab, dict(j)), (tprob, tlab, dict(t))


def test_cli_segment_cascaded_matches_jax_cli(tmp_path,
                                              jax_constant_rows_fixed):
    # LogMelHarmSpec: K1's harmonic half on the card, 120 rows.  1.4 s:
    # 138 frames, the bucketed whole-signal path on both sides.
    (jprob, jlab, j), (tprob, tlab, t) = serve_both(tmp_path, CASCADED, 120,
                                                    5, "S")
    assert tprob.shape == jprob.shape == (138 - 67,)
    np.testing.assert_allclose(tprob, jprob, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tlab, jlab)
    # The same bound as test_torch_segment: the unbounded R head moves by
    # up to ~3e-5 with the features' float32 summation order.
    assert set(t) == set(j)
    for k in ("track_S", "track_M", "track_R", "track_3C"):
        assert t[k].shape == j[k].shape
        np.testing.assert_allclose(t[k], j[k], rtol=0, atol=1e-4)


def test_cli_mtl_cascaded_writes_the_jax_columns(tmp_path, monkeypatch):
    """A fold of Cascaded-MTL through ``cli.mtl`` on the CPU (host
    pipeline) writes the JAX CLI's files and columns (the RNGs differ, so
    values are not compared); the CLIs narrowed through their
    ``config_from_args``."""
    import csv
    import dataclasses

    from sm_hpss_mtl_tpu.cli import mtl as jmtl
    from sm_hpss_mtl_tpu_torch.cli import mtl as tmtl

    root = str(tmp_path / "toy")
    taudio.make_toy_musan(root, n_per_class=6, duration_s=1.5, seed=3)

    def narrow(config_from_args):
        return lambda args: dataclasses.replace(
            config_from_args(args), arch_kwargs=dict(NARROW),
            n_mels_override=N_MELS)

    argv = ["--data", root, "--model", CASCADED, "--epochs", "1",
            "--batch-size", "2", "--patch-size", "16", "--patch-shift", "16",
            "--tr-steps", "2", "--v-steps", "1", "--folds", "0",
            "--no-augment"]
    monkeypatch.setattr(jmtl, "config_from_args",
                        narrow(jmtl.config_from_args))
    want = jmtl.main(argv + ["--output", str(tmp_path / "j"),
                             "--dft-precision", "highest"])[0]
    monkeypatch.setattr(tmtl, "config_from_args",
                        narrow(tmtl.config_from_args))
    got = tmtl.main(argv + ["--output", str(tmp_path / "t"), "--device",
                            "cpu"])[0]
    assert got["pipeline"] == "host"
    assert os.path.relpath(got["op_dir"], str(tmp_path / "t")) == \
        os.path.relpath(want["op_dir"], str(tmp_path / "j")) == \
        os.path.join(CASCADED, "LogMelHarmSpec")
    assert set(got["row"]) == set(want["row"])
    assert got["test"]["ConfMat"].shape == (3, 3)
    for name, delim in (("Performance.csv", "\t"), ("fold0_log.csv", ",")):
        heads = []
        for out in (got, want):
            with open(os.path.join(out["op_dir"], name)) as f:
                heads.append(next(csv.reader(f, delimiter=delim)))
        assert heads[0] == heads[1], name
    ckpt = weights.load_npz(os.path.join(got["op_dir"], "fold0_ckpt",
                                         "state", "model.npz"))
    assert "S_cat_bn" in ckpt["params"]["heads"]

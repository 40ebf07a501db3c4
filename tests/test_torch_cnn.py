"""Doukhan's and Papakostas's CNNs, the LRN, and Lemaire's single-task TCN
in the port against the flax models.

Flax parameters from ``init`` (BatchNorm statistics, scales and biases
perturbed, so that no layer is the identity) go through
``weights.from_flax`` into the torch module; every output must agree in
eval mode to atol 1e-5.  Both sides compute in float32: the difference is
summation order (the JAX LRN's band sum runs at matmul precision HIGH,
5e-6 of HIGHEST).  The inputs are cut in height and width (Doukhan-MTL at
40 rows, Papakostas at 48 x 48, whose last pool leaves 2 x 2 positions, so
the NHWC flatten order shows), which sizes the first dense layer as flax
infers it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sm_hpss_mtl_tpu.models import cnn as jcnn
from sm_hpss_mtl_tpu.models import get_model as jget_model
from sm_hpss_mtl_tpu_torch import weights
from sm_hpss_mtl_tpu_torch.models import cnn as tcnn
from sm_hpss_mtl_tpu_torch.models import layers
from sm_hpss_mtl_tpu_torch.models.lemaire import init_weights
from sm_hpss_mtl_tpu_torch.models.zoo import (INPUT_KIND, MTL, get_model,
                                              get_spec)

torch.set_num_threads(2)

ATOL = 1e-5


def _apply(module, v, x):
    """Eval-mode flax outputs, as one XLA program (eager flax compiles op
    by op, several times slower here)."""
    return jax.jit(lambda v, x: module.apply(v, x, train=False))(
        v, jnp.asarray(x))


def _perturbed(module, x, seed):
    v = jax.jit(lambda k: module.init({"params": k, "dropout": k + 1},
                                      jnp.asarray(x[:1]), train=False))(
        jax.random.PRNGKey(seed))
    v = jax.tree_util.tree_map(np.asarray, dict(v))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        name = path[-1].key
        if name == "mean":
            return rng.standard_normal(a.shape).astype(np.float32) * 0.3
        if name == "var":
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        if name in ("bias", "scale"):
            return a + rng.standard_normal(a.shape).astype(np.float32) * 0.1
        return a

    return {k: jax.tree_util.tree_map_with_path(perturb, dict(v[k]))
            for k in v}


@pytest.mark.parametrize("shape,scale", [((2, 9, 5, 96), 1.0),
                                         ((1, 3, 4, 7), 30.0),
                                         ((2, 2, 2, 384), 0.1)])
def test_lrn_matches_jax(shape, scale):
    x = (np.random.default_rng(len(shape) + shape[-1]).standard_normal(shape)
         * scale).astype(np.float32)
    want = np.asarray(jcnn.local_response_normalization(jnp.asarray(x)))
    got = tcnn.local_response_normalization(
        torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # TF's definition, with 11 channels around each (fewer at the ends).
    C = shape[-1]
    band = np.abs(np.arange(C)[:, None] - np.arange(C)[None]) <= 5
    ref = x / (1.0 + 1e-4 * (x.astype(np.float64) ** 2) @ band) ** 0.75
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


CASES = [("Papakostas_et_al_MTL", (2, 48, 48, 1)),
         ("Papakostas_et_al", (2, 48, 48, 1)),
         ("Doukhan_et_al_MTL", (2, 40, 68, 1)),
         ("Doukhan_et_al", (2, 21, 68, 1))]


@pytest.mark.parametrize("name,shape", CASES)
def test_cnn_matches_flax(name, shape):
    x = np.random.default_rng(shape[1]).standard_normal(shape).astype(
        np.float32)
    module = jget_model(name).module
    v = _perturbed(module, x, 3)
    want = _apply(module, v, x)
    spec = get_spec(name, in_dim=shape[1], patch_size=shape[2])
    assert (spec.input_kind, spec.mtl) == ("image", name.endswith("_MTL"))
    model = spec.module
    model.load_state_dict(weights.from_flax(v))
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
        got3 = model(torch.from_numpy(x[..., 0]))     # (B, rows, W) too
    if not spec.mtl:
        got, got3, want = {"3C": got}, {"3C": got3}, {"3C": want}
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=ATOL, err_msg=k)
        torch.testing.assert_close(got3[k], got[k], rtol=0, atol=0)


def test_lemaire_single_task_matches_flax():
    narrow = dict(n_filters=8, nb_stacks=1, Nd=2)
    x = np.random.default_rng(5).standard_normal((3, 16, 24)).astype(
        np.float32)
    module = jget_model("Lemaire_et_al", n_mels=24, **narrow).module
    v = _perturbed(module, x, 6)
    want = np.asarray(_apply(module, v, x))
    spec = get_spec("Lemaire_et_al", in_dim=24, patch_size=16, **narrow)
    assert (spec.input_kind, spec.mtl) == ("time_mel", False)
    spec.module.load_state_dict(weights.from_flax(v))
    with torch.no_grad():
        got = spec.module.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # The preset's geometry: LogMelSpec, 120 rows.
    assert get_model("Lemaire_et_al").tcn.initial_conv.in_channels == 120


def test_zoo_holds_the_jax_specs():
    from sm_hpss_mtl_tpu.models.zoo import MODEL_NAMES
    # Every model of the JAX zoo, and the port's own sequence and stream
    # models.
    served = {n for n, kind in INPUT_KIND.items()
              if kind in ("sequence", "stream")}
    assert set(MTL) == set(MODEL_NAMES) | served
    for name in MODEL_NAMES:
        kw = {"n_mels": 20} if name == "Doukhan_et_al_MTL" else {}
        want = jget_model(name, **kw)
        assert (INPUT_KIND[name], MTL[name]) == (want.input_kind, want.mtl)
    # The full-width first dense layers of the presets.
    assert get_model("Papakostas_et_al_MTL").fc1.dense.in_features == 13312
    assert get_model("Papakostas_et_al").fc1.dense.in_features == 6 * 2 * 512
    assert get_model("Doukhan_et_al_MTL").fc1.dense.in_features == 55 * 256
    assert get_model("Doukhan_et_al").fc1.dense.in_features == 256
    with pytest.raises(ValueError, match="too small"):
        get_model("Doukhan_et_al", patch_size=16)


def test_cnn_layers_train_like_flax():
    """Every BatchNorm keeps flax's biased update and every dropout draws
    from the step's generator; Papakostas's layers draw normal(0.01)
    kernels with bias 0.1, the rest glorot-uniform with bias 0."""
    for name in ("Papakostas_et_al_MTL", "Doukhan_et_al_MTL"):
        net = get_model(name, in_dim=48, patch_size=68)
        for m in net.modules():
            assert not isinstance(m, torch.nn.Dropout)
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                assert isinstance(m, (layers.BatchNorm1d, layers.BatchNorm2d))
        assert sum(isinstance(m, layers.Dropout) for m in net.modules()) == (
            2 + 3 if name.startswith("Papakostas") else 4 + 3)
    net = init_weights(get_model("Papakostas_et_al", in_dim=48,
                                 patch_size=48),
                       torch.Generator().manual_seed(0))
    for layer in (net.c1, net.c2, net.c3, net.fc1.dense, net.out):
        assert abs(float(layer.weight.std()) - 0.01) < 2e-3
        assert torch.all(layer.bias == 0.1)
    assert torch.all(net.fc1.bn.weight == 1) and torch.all(
        net.fc1.bn.bias == 0)
    net = init_weights(get_model("Doukhan_et_al_MTL", in_dim=40),
                       torch.Generator().manual_seed(0))
    w = net.c2.conv.weight
    limit = (6 / (w.shape[1] * 9 + w.shape[0] * 9)) ** 0.5
    assert float(w.abs().max()) <= limit and float(w.abs().max()) > 0.9 * limit
    assert torch.all(net.c2.conv.bias == 0)
    assert torch.all(net.heads.C_out.bias == 0)


@pytest.mark.parametrize("name,shape", CASES[::2])
def test_cnn_weights_round_trip(tmp_path, name, shape):
    x = np.zeros(shape, np.float32)
    v = _perturbed(jget_model(name).module, x, 7)
    path = str(tmp_path / "w.npz")
    weights.save_npz(path, v)
    sd = weights.from_flax(weights.load_npz(path))
    model = get_model(name, in_dim=shape[1], patch_size=shape[2])
    model.load_state_dict(sd)            # every key, every shape
    if name.startswith("Papakostas"):
        assert sd["c1.weight"].shape == (96, 1, 5, 5)    # (out, in, kh, kw)
        assert sd["fc1.dense.weight"].shape == (4096, 2 * 2 * 512)
    else:
        assert sd["c1.conv.weight"].shape == (64, 1, 4, 5)
        assert sd["fc1.bn.running_var"].shape == (512,)
    back = weights._flatten(weights.to_flax(model.state_dict()))
    flat = weights._flatten(v)
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=str(k))

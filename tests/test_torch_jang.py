"""Jang's mel-scale CNN in the port against the flax model, and the SAME
max pooling it needs.

Flax parameters from ``init`` (BatchNorm statistics, scales, biases and
the mel-scale kernels perturbed, so that no layer is the identity) go
through ``weights.from_flax`` into the torch module; every head must agree
in eval mode to atol 1e-5.  Both sides compute in float32: the difference
is summation order in the banded mel layer (F=257 rows x 5 taps), three
3x3 convolutions and the dense stack, ~1e-7 on outputs of order 1.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sm_hpss_mtl_tpu.models import get_model as jget_model
from sm_hpss_mtl_tpu.models import jang as jjang
from sm_hpss_mtl_tpu.models import pool as jpool
from sm_hpss_mtl_tpu_torch import weights
from sm_hpss_mtl_tpu_torch.models import jang as tjang
from sm_hpss_mtl_tpu_torch.models import pool as tpool
from sm_hpss_mtl_tpu_torch.models.lemaire import init_weights
from sm_hpss_mtl_tpu_torch.models.zoo import INPUT_KIND, get_model

torch.set_num_threads(2)

ATOL = 1e-5


@pytest.mark.parametrize("shape,window,strides,padding", [
    ((2, 17, 17, 3), (2, 2), (2, 2), "SAME"),    # 17 -> 9, -inf on the right
    ((2, 16, 17, 3), (2, 2), (2, 2), "VALID"),
    ((2, 9, 13, 2), (3, 3), (2, 2), "SAME"),     # overlapping (Papakostas)
    ((2, 9, 13, 2), (3, 3), (2, 2), "VALID"),
    ((1, 7, 24, 1), (1, 12), (1, 12), "SAME"),
    ((1, 1, 5, 2), (2, 2), (2, 2), "SAME"),      # H=1: pad below only
])
def test_max_pool_matches_jax(shape, window, strides, padding):
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(jpool.max_pool(jnp.asarray(x), window, strides,
                                      padding))
    got = tpool.max_pool(torch.from_numpy(x).permute(0, 3, 1, 2), window,
                         strides, padding).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).all()


def test_max_pool_same_pads_high_side():
    x = torch.arange(17.0).reshape(1, 1, 1, 17)
    out = tpool.max_pool(x, (1, 2), (1, 2), "SAME")
    assert out.shape[-1] == 9
    assert out[0, 0, 0, -1] == 16.0        # the last window is [16, -inf]
    with pytest.raises(ValueError, match="padding"):
        tpool.max_pool(x, (2, 2), (2, 2), "FULL")


def _perturbed_variables(name, n_mels, x, seed):
    kw = {"n_mels": n_mels} if name == "Jang_et_al_MTL" else {}
    spec = jget_model(name, **kw)
    v = spec.module.init({"params": jax.random.PRNGKey(seed),
                          "dropout": jax.random.PRNGKey(seed + 1)},
                         jnp.asarray(x[:1]), train=False)
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        name = path[-1].key
        if name == "mean":
            return rng.standard_normal(a.shape).astype(np.float32) * 0.3
        if name == "var":
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        if name in ("bias", "scale"):
            return a + rng.standard_normal(a.shape).astype(np.float32) * 0.1
        if str(path[-2].key).startswith("melCl"):
            noise = rng.standard_normal(a.shape).astype(np.float32)
            return a * (1.0 + 0.2 * noise)
        return a

    v = {k: jax.tree_util.tree_map_with_path(perturb, dict(v[k]))
         for k in ("params", "batch_stats")}
    return spec.module, v


@pytest.fixture(scope="module")
def jang_mtl_24():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 514, 68, 1)).astype(np.float32)
    module, v = _perturbed_variables("Jang_et_al_MTL", 24, x, 0)
    return module, v, x


def test_jang_mtl_matches_flax(jang_mtl_24):
    module, v, x = jang_mtl_24
    want = module.apply(v, jnp.asarray(x), train=False)
    model = get_model("Jang_et_al_MTL", n_mels=24)
    model.load_state_dict(weights.from_flax(v))
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
        got3 = model(torch.from_numpy(x[..., 0]))    # (B, F, T) input too
    assert set(got) == set(want) == {"S", "M", "R", "3C"}
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=ATOL, err_msg=k)
        torch.testing.assert_close(got3[k], got[k], rtol=0, atol=0)


def test_jang_single_task_matches_flax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 257, 68, 1)).astype(np.float32)
    module, v = _perturbed_variables("Jang_et_al", 64, x, 3)
    want = np.asarray(module.apply(v, jnp.asarray(x), train=False))
    model = get_model("Jang_et_al")
    model.load_state_dict(weights.from_flax(v))
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert INPUT_KIND["Jang_et_al"] == INPUT_KIND["Jang_et_al_MTL"] == "image"


def test_mel_scale_layer_matches_flax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 257, 11)).astype(np.float32)
    layer = jjang.MelScaleLayer(n_mels=16, t_dim=4)    # even t_dim
    v = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))
    kernel = np.asarray(v["params"]["kernel"])
    kernel = kernel * (1 + 0.3 * rng.standard_normal(kernel.shape)
                       ).astype(np.float32)
    want = np.asarray(layer.apply({"params": {"kernel": kernel}},
                                  jnp.asarray(x)))          # (B, M, T, C)
    t = tjang.MelScaleLayer(n_mels=16, t_dim=4)
    np.testing.assert_array_equal(t.kernel.detach().numpy(),
                                  np.asarray(v["params"]["kernel"]))
    with torch.no_grad():
        t.kernel.copy_(torch.from_numpy(kernel))
        got = t(torch.from_numpy(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # Off-band weights never act: the mask multiplies them in forward.
    M, mask = tjang.mel_band_weights(16000, 512, 16)
    np.testing.assert_array_equal(
        M, np.asarray(jjang.mel_band_weights(16000, 512, 16)[0]))
    with torch.no_grad():
        t.kernel.add_(torch.from_numpy(1.0 - mask)[:, :, None, None] * 1e3)
        np.testing.assert_allclose(
            t(torch.from_numpy(x)).permute(0, 2, 3, 1).numpy(), want,
            rtol=0, atol=ATOL)


def test_jang_weights_round_trip(jang_mtl_24, tmp_path):
    _, v, _ = jang_mtl_24
    path = str(tmp_path / "jang.npz")
    weights.save_npz(path, v)
    with np.load(path) as z:
        assert z["params/melCl_H/kernel"].shape == (24, 257, 5, 3)
        assert z["params/b1/conv/kernel"].shape == (3, 3, 3, 32)
        assert "params/fc1_bn/scale" in z.files
        assert "batch_stats/fc2_bn/var" in z.files
    sd = weights.from_flax(weights.load_npz(path))
    assert sd["melCl_P.kernel"].shape == (24, 257, 5, 3)    # layout kept
    assert sd["b2.conv.weight"].shape == (64, 32, 3, 3)     # (out, in, kh, kw)
    assert sd["fc1.weight"].shape == (2048, 6 * 9 * 128)
    back = weights.to_flax(sd)
    flat_v, flat_b = weights._flatten(v), weights._flatten(back)
    assert set(flat_b) == set(flat_v)
    for k in flat_v:
        np.testing.assert_array_equal(flat_b[k], flat_v[k], err_msg=str(k))
    # torch -> flax -> torch is the identity on a seeded port init.
    model = init_weights(get_model("Jang_et_al_MTL", n_mels=24),
                         torch.Generator().manual_seed(5))
    tree = weights.to_flax(model.state_dict())
    assert tree["params"]["fc1_bn"]["scale"].shape == (2048,)
    assert "kernel" not in tree["params"]["fc2_bn"]
    again = weights.from_flax(tree)
    assert set(again) == set(model.state_dict())
    for k, t in model.state_dict().items():
        torch.testing.assert_close(again[k], t, rtol=0, atol=0,
                                   check_dtype=False)


def test_from_flax_maps_kernels_by_module():
    # A 4-D kernel is a Conv2D kernel unless it belongs to a mel-scale
    # layer; a BatchNorm is recognised by its statistics, not its name.
    k4 = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)
    tree = {"params": {"conv": {"kernel": k4},
                       "melCl": {"kernel": k4},
                       "fc_bn": {"scale": np.ones(3, np.float32),
                                 "bias": np.zeros(3, np.float32)}},
            "batch_stats": {"fc_bn": {"mean": np.zeros(3, np.float32),
                                      "var": np.ones(3, np.float32)}}}
    sd = weights.from_flax(tree)
    np.testing.assert_array_equal(sd["conv.weight"].numpy(),
                                  k4.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["melCl.kernel"].numpy(), k4)
    back = weights.to_flax(sd)
    np.testing.assert_array_equal(back["params"]["conv"]["kernel"], k4)
    np.testing.assert_array_equal(back["params"]["melCl"]["kernel"], k4)
    assert set(back["params"]["fc_bn"]) == {"scale", "bias"}


def test_jang_mtl_preset_width_forward_matches_flax():
    # The served width: 120 mel bands, 34,560 inputs to fc1.
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 514, 68, 1)).astype(np.float32)
    module, v = _perturbed_variables("Jang_et_al_MTL", 120, x, 9)
    want = module.apply(v, jnp.asarray(x), train=False)
    model = get_model("Jang_et_al_MTL")
    model.load_state_dict(weights.from_flax(v))
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert model.fc1.in_features == 30 * 9 * 128
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=ATOL, err_msg=k)

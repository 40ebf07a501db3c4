"""Lemaire-MTL port at full width against the flax model.

Flax parameters from ``init`` (with non-trivial BatchNorm statistics) go
through ``weights.from_flax`` into the torch module; all four heads must
agree in eval mode to atol 1e-5 (float32 on both sides; the difference is
summation order in 25 convolution layers and the 2176-wide heads).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sm_hpss_mtl_tpu.models import get_model as jget_model
from sm_hpss_mtl_tpu_torch import weights
from sm_hpss_mtl_tpu_torch.models import tcn as ttcn
from sm_hpss_mtl_tpu_torch.models.lemaire import init_weights
from sm_hpss_mtl_tpu_torch.models.zoo import get_model

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def flax_variables():
    spec = jget_model("Lemaire_et_al_MTL", n_mels=120)
    v = spec.module.init({"params": jax.random.PRNGKey(0),
                          "dropout": jax.random.PRNGKey(1)},
                         jnp.zeros((2, 68, 240)), train=False)
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.default_rng(0)

    def perturb(path, x):
        name = path[-1].key
        if name == "mean":
            return rng.standard_normal(x.shape).astype(np.float32) * 0.3
        if name == "var":
            return rng.uniform(0.5, 2.0, x.shape).astype(np.float32)
        if name in ("bias", "scale"):
            return x + rng.standard_normal(x.shape).astype(np.float32) * 0.1
        return x

    v = {k: jax.tree_util.tree_map_with_path(perturb, dict(v[k]))
         for k in ("params", "batch_stats")}
    return spec.module, v


def test_full_width_heads_match_flax(flax_variables):
    module, v = flax_variables
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 68, 240)).astype(np.float32)
    want = module.apply(v, jnp.asarray(x), train=False)
    model = get_model("Lemaire_et_al_MTL")
    model.load_state_dict(weights.from_flax(v))
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert set(got) == set(want) == {"S", "M", "R", "3C"}
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5, err_msg=k)


def test_weights_npz_round_trip(flax_variables, tmp_path):
    _, v = flax_variables
    path = str(tmp_path / "w.npz")
    weights.save_npz(path, v)
    with np.load(path) as z:
        assert "params/tcn/initial_conv/kernel" in z.files
        assert "batch_stats/heads/S_block/bn/mean" in z.files
    back = weights.load_npz(path)
    sd = weights.from_flax(back)
    ref = weights.from_flax(v)
    assert set(sd) == set(ref)
    for k in ref:
        torch.testing.assert_close(sd[k], ref[k], rtol=0, atol=0)
    # torch -> flax -> torch is the identity on a seeded port init.
    model = init_weights(get_model("Lemaire_et_al_MTL"),
                         torch.Generator().manual_seed(3))
    tree = weights.to_flax(model.state_dict())
    assert tree["params"]["tcn"]["initial_conv"]["kernel"].shape == (3, 240, 32)
    again = weights.from_flax(tree)
    for k, t in model.state_dict().items():
        torch.testing.assert_close(again[k], t, rtol=0, atol=0,
                                   check_dtype=False)


def test_spatial_dropout_drops_whole_channels():
    drop = ttcn.SpatialDropout1D(0.5)
    x = torch.ones(8, 32, 20)
    with pytest.raises(RuntimeError, match="generator"):
        drop.train()(x)                          # never torch's global RNG
    drop.generator = torch.Generator().manual_seed(0)
    y = drop.train()(x)
    per_channel = y.amax(dim=-1) - y.amin(dim=-1)
    assert torch.all(per_channel == 0)           # one value across time
    assert set(torch.unique(y).tolist()) <= {0.0, 2.0}
    assert torch.equal(drop.eval()(x), x)
    norm = ttcn.channel_normalization(torch.tensor([[[2.0], [-4.0]]]))
    torch.testing.assert_close(norm, torch.tensor([[[2.0], [-4.0]]])
                               / (4.0 + 1e-5))

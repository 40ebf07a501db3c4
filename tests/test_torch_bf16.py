"""bf16 compute in the port against flax's ``dtype=jnp.bfloat16``.

flax's rule, which the port mirrors layer by layer (``models/layers.py``):
a dense or convolution layer given ``dtype=bf16`` casts its input, kernel
and bias to bf16 and returns bf16; a layer without a dtype (every
BatchNorm, the output layers) promotes bf16 input and float32 parameters to
float32.  The parameters stay float32 on both sides.

Every model family is built narrow (Lemaire: 8 filters, 1 stack, Nd 3, 24
rows of 16 frames; the CNNs at the sizes of ``test_torch_cnn``; Jang-MTL at
24 mel bands) from one set of flax variables (BatchNorm statistics, scales
and biases perturbed) and fed one seeded numpy batch.

The JAX programs run eagerly (``jax.disable_jit``): each operator then
rounds its bf16 output, where flax's dtypes put the roundings.  Jitted,
XLA:CPU keeps float32 between the operators it fuses (excess precision), so
its bf16 program rounds fewer times than flax's dtypes say; and the jitted
Doukhan and Jang steps also miscompute a gradient on XLA:CPU (ROADMAP §3).

The bars, each derived from what JAX itself measures:

- outputs, per head, eval mode: ``d_ref`` is the JAX bf16 model's max |Δ|
  from the JAX float32 model (same variables, same input).  The port's bf16
  output lies within ``d_ref`` of JAX's bf16 output, and within ``2 d_ref``
  of the port's float32 output.  Doukhan-MTL is held to ``2 d_ref`` against
  JAX's bf16 too: its four conv blocks and four dense layers each re-round
  to bf16 after a float32 BatchNorm, so a bf16 rounding that flips with the
  summation order of one convolution spreads through the rest, and JAX's
  own jitted and eager bf16 programs lie farther apart than ``d_ref``
  (asserted below, so that the bar tightens if that ever stops being so);
- one train step, dropout off, the same batch (Lemaire-MTL and Jang-MTL):
  the loss within JAX's own bf16-vs-float32 loss difference; each
  parameter's update within ``R`` of its norm, ``R`` the largest relative
  bf16-vs-float32 update difference of the JAX step over the parameters
  that do not feed a BatchNorm; a bias that feeds a BatchNorm has a
  gradient of 0 in exact arithmetic, so its update is rounding noise on
  every side and is held to at most twice JAX's bf16 one plus 1e-2 of the
  lr per element.
"""

import flax.linen as fnn
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sm_hpss_mtl_tpu.models import get_model as jget_model
from sm_hpss_mtl_tpu.train import optimizers as joptim
from sm_hpss_mtl_tpu.train import state as jstate
from sm_hpss_mtl_tpu_torch import weights
from sm_hpss_mtl_tpu_torch.models import layers
from sm_hpss_mtl_tpu_torch.models.zoo import get_model
from sm_hpss_mtl_tpu_torch.train import optimizers as toptim
from sm_hpss_mtl_tpu_torch.train import state as tstate

torch.set_num_threads(2)

BF16 = torch.bfloat16
NARROW = dict(n_filters=8, nb_stacks=1, Nd=3)
ROWS, W, B = 24, 16, 6
IF = "Lemaire_et_al_MTL_IF"

#: name -> (JAX get_model kwargs, port get_model kwargs, input shape).
FAMILIES = {
    "Lemaire_et_al_MTL": (dict(n_mels=ROWS // 2, **NARROW),
                          dict(in_dim=ROWS, patch_size=W, **NARROW),
                          (B, W, ROWS)),
    "Lemaire_et_al_Cascaded_MTL": (dict(n_mels=ROWS // 2, **NARROW),
                                   dict(in_dim=ROWS, patch_size=W, **NARROW),
                                   (B, W, ROWS)),
    "Lemaire_et_al_MTL_5class": (dict(n_mels=ROWS // 2, **NARROW),
                                 dict(in_dim=ROWS, patch_size=W, **NARROW),
                                 (B, W, ROWS)),
    IF: (dict(n_filters=8, nb_stacks=1),
         dict(in_dim=ROWS, patch_size=W, n_filters=8, nb_stacks=1),
         (B, W, ROWS)),
    "Lemaire_et_al": (dict(n_mels=ROWS // 2, **NARROW),
                      dict(in_dim=ROWS, patch_size=W, **NARROW),
                      (B, W, ROWS)),
    "Jang_et_al_MTL": (dict(n_mels=ROWS), dict(n_mels=ROWS, patch_size=W),
                       (B, 514, W, 1)),
    "Doukhan_et_al_MTL": (dict(n_mels=20), dict(in_dim=40, patch_size=68),
                          (B, 40, 68, 1)),
    "Papakostas_et_al_MTL": ({}, dict(in_dim=48, patch_size=48),
                             (B, 48, 48, 1)),
}
#: The families whose bf16 layers re-round after float32 BatchNorms deep
#: enough that JAX's own two bf16 programs differ by more than d_ref.
DEEP_BN_CHAIN = ("Doukhan_et_al_MTL",)


def _input(name, seed):
    shape = FAMILIES[name][2]
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if name == IF:
        return {"harm_input": x[..., :ROWS // 2],
                "perc_input": x[..., ROWS // 2:]}
    return x


def _jnp(x):
    return jax.tree_util.tree_map(jnp.asarray, x)


def _t(x):
    if isinstance(x, dict):
        return {k: _t(v) for k, v in x.items()}
    return torch.from_numpy(np.array(x))


def _perturbed_variables(module, x, seed):
    """flax variables from ``init``, BatchNorm statistics, scales and biases
    perturbed, so that no layer is the identity."""
    v = jax.jit(lambda k: module.init({"params": k, "dropout": k + 1},
                                      jax.tree_util.tree_map(
                                          lambda a: a[:1], x), train=False))(
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


def _models(name, seed=3):
    jkw, tkw, _ = FAMILIES[name]
    x = _input(name, seed)
    j32 = jget_model(name, **jkw).module
    j16 = jget_model(name, dtype=jnp.bfloat16, **jkw).module
    v = _perturbed_variables(j32, _jnp(x), seed)
    nets = {}
    for dt in (None, BF16):
        net = get_model(name, dtype=dt, **tkw)
        net.load_state_dict(weights.from_flax(v))
        nets[dt] = net.eval()
    return x, v, j32, j16, nets


def _heads(out):
    return out if isinstance(out, dict) else {"out": out}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _dtypes(out):
    """The dtypes of a module's output: a tensor, a tuple or a dict."""
    if isinstance(out, dict):
        return tuple(_dtypes(out[k]) for k in sorted(out))
    if isinstance(out, (tuple, list)):
        return tuple(_dtypes(o) for o in out)
    return str(out.dtype).replace("torch.", "")


@pytest.mark.parametrize("name", list(FAMILIES))
def test_bf16_module_dtypes_and_outputs_match_flax(name):
    x, v, j32, j16, nets = _models(name)
    with jax.disable_jit():
        want, st = j16.apply(v, _jnp(x), train=False,
                             capture_intermediates=True,
                             mutable=["intermediates"])
        want32 = j32.apply(v, _jnp(x), train=False)
    # Each module's first call's output.
    flax_map = {".".join(p[:-1]): _dtypes(o[0])
                for p, o in _flat(st["intermediates"]) if p[-1] == "__call__"}
    port_map = {}
    net = nets[BF16]
    hooks = [m.register_forward_hook(
        lambda m, i, o, n=n: port_map.__setitem__(n, _dtypes(o)))
        for n, m in net.named_modules() if n]
    try:
        with torch.no_grad():
            got = net(_t(x))
            got32 = nets[None](_t(x))
    finally:
        for h in hooks:
            h.remove()
    # Every module holding parameters (the modules weights.py maps) has a
    # flax counterpart of the same name, and the same output dtypes.
    mapped = {n for n, m in net.named_modules()
              if n and any(True for _ in m.parameters(recurse=False))}
    assert mapped <= set(flax_map), sorted(mapped - set(flax_map))
    shared = set(port_map) & set(flax_map)
    assert mapped <= shared
    bad = {n: (port_map[n], flax_map[n]) for n in shared
           if port_map[n] != flax_map[n]}
    assert not bad, bad
    assert "bfloat16" in str(flax_map.values())

    want, want32 = _heads(want), _heads(want32)
    got, got32 = _heads(got), _heads(got32)
    assert set(got) == set(want)
    eager_vs_jit = {}
    if name in DEEP_BN_CHAIN:
        jit16 = _heads(jax.jit(lambda v, x: j16.apply(v, x, train=False))(
            v, _jnp(x)))
    for k in want:
        assert got[k].dtype == torch.float32, k       # outputs reach f32
        w16, w32 = np.asarray(want[k]), np.asarray(want32[k])
        d_ref = float(np.abs(w16 - w32).max())
        assert d_ref > 0, k
        bar = 2 * d_ref if name in DEEP_BN_CHAIN else d_ref
        d = float(np.abs(got[k].numpy() - w16).max())
        assert d <= bar, f"{k}: port bf16 vs JAX bf16 {d:.3e} over {bar:.3e}"
        d_own = float(np.abs(got[k].numpy() - got32[k].numpy()).max())
        assert d_own <= 2 * d_ref, (
            f"{k}: port bf16 vs port f32 {d_own:.3e} over {2 * d_ref:.3e}")
        if name in DEEP_BN_CHAIN:
            eager_vs_jit[k] = float(np.abs(np.asarray(jit16[k]) - w16).max()
                                    ) / d_ref
    if name in DEEP_BN_CHAIN:
        assert max(eager_vs_jit.values()) > 1.0, eager_vs_jit


# --- one train step ----------------------------------------------------------

class _NoDropout(fnn.Module):
    """flax's ``nn.Dropout`` as the identity (the JAX heads fix their rate
    at 0.4 and ``get_model`` does not expose it)."""
    rate: float = 0.0
    deterministic: bool | None = None

    @fnn.compact
    def __call__(self, x, deterministic=None, rng=None):
        return x


def _labels(n_rows):
    cls = np.repeat(np.arange(3), n_rows // 3)
    r = np.stack([(cls != 1) * 1.0, (cls != 0) * 1.0], -1).astype(np.float32)
    r[cls == 2, 0] = 10 ** (-5 / 10)
    return {"S": (cls == 1).astype(np.float32),
            "M": (cls == 0).astype(np.float32), "R": r,
            "3C": np.eye(3, dtype=np.float32)[cls]}


def _bn_fed_biases(net) -> set[str]:
    """The biases of the layers that feed a BatchNorm (``X.conv``/``X.dense``
    before ``X.bn``, Jang's ``fc1`` before ``fc1_bn``)."""
    names, out = set(net.state_dict()), set()
    for path, mod in net.named_modules():
        if not isinstance(mod, torch.nn.modules.batchnorm._BatchNorm):
            continue
        base, _, leaf = path.rpartition(".")
        feeds = ([f"{base}.conv", f"{base}.dense"] if leaf == "bn"
                 else [path[:-len("_bn")]] if path.endswith("_bn") else [])
        out |= {f"{f.lstrip('.')}.bias" for f in feeds} & names
    return out


STEP_CASES = ("Lemaire_et_al_MTL", "Jang_et_al_MTL")


@pytest.mark.parametrize("name", STEP_CASES)
def test_bf16_train_step_matches_jax(monkeypatch, name):
    monkeypatch.setattr(fnn, "Dropout", _NoDropout)
    jkw, tkw, shape = FAMILIES[name]
    jkw = {**jkw, **({"dropout_rate": 0.0} if name.startswith("Lemaire")
                     else {})}
    x = _input(name, 8)
    labels = _labels(shape[0])
    # Plain SGD (Papakostas's) for Jang's Adam, as test_torch_train's image
    # steps: Adam's first update turns the noise of a zero gradient into
    # +-lr.
    family = name if name.startswith("Lemaire") else "Papakostas_et_al"
    jopt, _ = joptim.for_model(family, tr_steps=100000)
    v = _perturbed_variables(jget_model(name, **jkw).module, _jnp(x), 5)
    lr = None
    jax_after, jax_loss = {}, {}
    with jax.disable_jit():
        for dt in (None, jnp.bfloat16):
            module = jget_model(name, dtype=dt, **jkw).module
            js = jstate.TrainState(params=v["params"],
                                   batch_stats=v["batch_stats"],
                                   opt_state=jopt.init(v["params"]),
                                   step=jnp.zeros((), jnp.int32))
            js, jm = jstate.make_train_step(module, jopt, mtl=True,
                                            l2_reg=0.01)(
                js, _jnp(x), _jnp(labels), jax.random.PRNGKey(2))
            jax_loss[dt] = float(jm["loss"])
            jax_after[dt] = weights._flatten(jax.tree_util.tree_map(
                np.asarray, {"params": js.params}))

    net = get_model(name, dtype=BF16, **tkw)
    net.load_state_dict(weights.from_flax(v))
    for m in net.modules():
        if isinstance(m, layers.Dropout):
            m.rate = 0.0
    opt, sched = toptim.for_model(family, net.parameters(), tr_steps=100000)
    lr = float(sched(0))
    tm = tstate.make_train_step(net, opt, mtl=True, l2_reg=0.01,
                                generator=torch.Generator())(
        tstate.TrainState(net, opt), _t(x), _t(labels))
    assert all(p.dtype == torch.float32 for p in net.parameters())

    loss_bar = abs(jax_loss[jnp.bfloat16] - jax_loss[None])
    d_loss = abs(float(tm["loss"]) - jax_loss[jnp.bfloat16])
    assert d_loss <= loss_bar, (d_loss, loss_bar)

    before = weights._flatten({"params": v["params"]})
    got = weights._flatten(weights.to_flax(net.state_dict()))
    to_port = {path: _port_key(path) for path in before}
    noise = _bn_fed_biases(net)
    spreads, rels, bad = {}, {}, []
    for path, b in before.items():
        u16 = jax_after[jnp.bfloat16][path].astype(np.float64) - b
        u32 = jax_after[None][path].astype(np.float64) - b
        if to_port[path] not in noise:
            spreads[path] = np.linalg.norm(u16 - u32) / np.linalg.norm(u32)
    R = max(spreads.values())
    for path, b in before.items():
        u16 = jax_after[jnp.bfloat16][path].astype(np.float64) - b
        up = got[path].astype(np.float64) - b
        if to_port[path] in noise:
            bar = 2 * np.linalg.norm(u16) + 1e-2 * lr * np.sqrt(b.size)
            if np.linalg.norm(up) > bar:
                bad.append(f"{to_port[path]} (feeds a BatchNorm): update "
                           f"{np.linalg.norm(up):.3e} over {bar:.3e}")
            continue
        rels[path] = np.linalg.norm(up - u16) / np.linalg.norm(u16)
        if rels[path] > R:
            bad.append(f"{to_port[path]}: {rels[path]:.3e} of its norm, over "
                       f"{R:.3e}")
    assert not bad, bad
    assert len(rels) >= 8


def _port_key(path: tuple) -> str:
    """The state_dict key of a flax ``("params", ..., leaf)`` path."""
    *mod, leaf = path[1:]
    if leaf == "scale" or (leaf == "kernel" and not mod[-1].startswith(
            "melCl")):
        leaf = "weight"
    return ".".join(mod + [leaf])

"""The reference, the counts and the traffic against the port at small
sizes on the CPU (the tests may import both; the reference imports
nothing of the port)."""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import harness
from benchmark.flops import jang_mtl as jang_flops
from benchmark.flops import lemaire_mtl as lemaire_flops
from benchmark.reference import frontend as rf
from benchmark.reference import layers
from benchmark.reference import models as rm
from benchmark.reference import optimizers as ro
from benchmark.reference import train as rt
from benchmark.traffic import generate
from sm_hpss_mtl_tpu_torch.models.layers import use_generator
from sm_hpss_mtl_tpu_torch.models.zoo import get_model
from sm_hpss_mtl_tpu_torch.ops import featuregram as fg
from sm_hpss_mtl_tpu_torch.ops import reference as port_ref
from sm_hpss_mtl_tpu_torch.ops.patches import standardize_rows
from sm_hpss_mtl_tpu_torch.train.config import ExperimentConfig
from sm_hpss_mtl_tpu_torch.train.endtoend import device_featurize_patches
from sm_hpss_mtl_tpu_torch.train.optimizers import for_model

CONFIGS = ("lemaire_mtl", "jang_mtl")


def config(name: str) -> dict:
    return harness.read_json(harness.BENCH_DIR / "configs" / f"{name}.json")


def audio(seed: int, n: int, rows: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    x = [generate.normalize(generate.synth_speech(rng, n)
                            + 0.5 * generate.synth_music(rng, n))
         for _ in range(rows)]
    return torch.as_tensor(np.stack(x).astype(np.float32))


def test_mel_bank_is_the_ports():
    for sr, n_fft in ((22050, 400), (16000, 512)):
        np.testing.assert_allclose(rf.mel_filterbank(sr, n_fft, 120),
                                   port_ref.mel_filterbank(sr, n_fft, 120),
                                   rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("name", CONFIGS)
def test_features_match_the_port(name):
    cfg = config(name)
    f = cfg["features"]
    y = audio(1, 16000 * 3, 2)
    want = fg.featuregram(y, feat_name=f["feat_name"], n_fft=f["n_fft"],
                          win_length=f["win_length"],
                          hop_length=f["hop_length"],
                          n_mels=f["n_mels"] or 120, l_harm=f["l_harm"],
                          l_perc=f["l_perc"])
    got = rf.featuregram(y, f)
    assert got.shape == want.shape
    # Both float32: the dB maps agree to rounding.
    assert (got - want).abs().max() < 1e-3
    # Against float64 the port's float32 reads its rounding, no more.
    exact = rf.featuregram(y.double(), f).float()
    assert (want - exact).abs().mean() < 1e-3


@pytest.mark.parametrize("n", [272, 7909, 10067])
def test_a_constant_row_standardizes_to_zero(n):
    """A row of one repeated value (the dB floor of an empty mel band) is
    centred to 0, as scikit-learn and the port centre it; a float64 mean
    an ulp off the value must not turn it into +-1.  A row with a real
    spread keeps unit variance."""
    fv = torch.full((3, n), -76.53105926513672)
    fv[1, n // 2] += 1e-3
    fv[2] = torch.linspace(-80.0, -20.0, n)
    # The mean an ulp off, as a device's reduction may leave it.
    x = fv.double()
    assert float(((x[0] - x[0].mean() * (1 + 2 ** -52)) ** 2).mean()) > 0
    got = rf.standardize_rows(fv)
    assert got[0].abs().max() < 1e-6
    for r in (1, 2):
        assert abs(float(got[r].double().std(unbiased=False)) - 1) < 1e-3
    torch.testing.assert_close(got[0::2], standardize_rows(fv)[0::2],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", CONFIGS)
def test_patches_match_the_port(name):
    cfg = config(name)
    mix = harness.read_json(harness.BENCH_DIR / "mixes" / "train.json")
    y = audio(2, 43760, 3)
    fc = ExperimentConfig(model=cfg["model"]).feature_config()
    want = device_featurize_patches(
        y, fc, patch_size=68, patch_shift=68,
        input_kind=cfg["input_kind"], max_patches=mix["clip_patches"])
    got = rt.patches(y, cfg, mix)
    assert got.shape == want.shape
    assert (got - want).abs().max() < 0.05
    assert (got - want).abs().mean() < 1e-4


def _model(name: str, seed: int):
    cfg = config(name)
    net = get_model(cfg["model"], patch_size=68)
    W = harness.seeded_weights(net, seed, torch.device("cpu"), cfg)
    net.load_state_dict(W)
    shape = ((4, 68, 240) if cfg["input_kind"] == "time_mel"
             else (4, 514, 68, 1))
    return cfg, net, W, torch.randn(shape, generator=torch.Generator()
                                    .manual_seed(seed))


@pytest.mark.parametrize("name", CONFIGS)
def test_models_match_the_port(name):
    cfg, net, W, x = _model(name, 3)
    with torch.no_grad():
        net.eval()
        want = net(x)
        got = rm.forward(x, W, cfg, layers.Draws(None), train=False)
        for h in want:
            torch.testing.assert_close(got[h], want[h], rtol=1e-4,
                                       atol=1e-5)
        g1 = torch.Generator().manual_seed(9)
        g2 = torch.Generator().manual_seed(9)
        use_generator(net, g1)
        net.train()
        want = net(x)
        got = rm.forward(x, W, cfg, layers.Draws(g2), train=True)
        for h in want:
            torch.testing.assert_close(got[h], want[h], rtol=1e-4,
                                       atol=1e-5)


def _optimizer_steps(name: str, seed: int, steps: int):
    cfg = config(name)
    gen = torch.Generator().manual_seed(seed)
    p0 = {f"p{i}": torch.randn(s, generator=gen)
          for i, s in enumerate([(5, 3), (7,), (2, 2, 2)])}
    grads = [{k: torch.randn(v.shape, generator=gen) * 2 for k, v in
              p0.items()} for _ in range(steps)]
    ports = [torch.nn.Parameter(v.clone()) for v in p0.values()]
    opt, _ = for_model(cfg["model"], ports,
                       tr_steps=cfg["optimizer"].get("decay_tr_steps", 1))
    return cfg, p0, grads, ports, opt


def _port_state(cfg: dict, opt, ports, names) -> dict:
    """The port's optimizer state in the reference's terms, read where
    the configuration's ``program_state`` says the port keeps it."""
    keys = cfg["optimizer"]["program_state"]
    st = [opt.state[p] for p in ports]
    return {"t": int(st[0][keys["step"]]),
            "m": {k: s[keys["m"]].clone() for k, s in zip(names, st)},
            "v": {k: (s[keys["v"]].clone() if keys["v"] else None)
                  for k, s in zip(names, st)}}


@pytest.mark.parametrize("name", CONFIGS)
def test_optimizers_match_the_port(name):
    cfg, p0, grads, ports, opt = _optimizer_steps(name, 4, 3)
    mine = {k: v.clone() for k, v in p0.items()}
    ref = ro.optimizer(cfg["optimizer"], mine)
    for g in grads:
        for p, k in zip(ports, p0):
            p.grad = g[k].clone()
        opt.step()
        ref.update(mine, g)
    for p, k in zip(ports, p0):
        torch.testing.assert_close(mine[k], p.detach(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", CONFIGS)
def test_optimizer_goes_on_from_the_ports_state(name):
    """From the port's state after two updates, the reference's third
    update is the port's, and the gradient read back from the first
    moments before and after it is the one the update took."""
    cfg, p0, grads, ports, opt = _optimizer_steps(name, 6, 3)
    for g in grads[:2]:
        for p, k in zip(ports, p0):
            p.grad = g[k].clone()
        opt.step()
    start = _port_state(cfg, opt, ports, p0)
    mine = {k: p.detach().clone() for k, p in zip(p0, ports)}
    ref = ro.optimizer(cfg["optimizer"], mine, start)
    for p, k in zip(ports, p0):
        p.grad = grads[2][k].clone()
    opt.step()
    ref.update(mine, grads[2])
    after = _port_state(cfg, opt, ports, p0)
    kind = ro.kind(cfg["optimizer"])
    for p, k in zip(ports, p0):
        torch.testing.assert_close(mine[k], p.detach(), rtol=1e-6, atol=1e-7)
        g = kind.gradient(cfg["optimizer"], start["m"][k].double(),
                          after["m"][k].double(), start["t"])
        torch.testing.assert_close(g.float(), ref.seen(grads[2][k]),
                                   rtol=1e-4, atol=1e-6)
    assert after["t"] == start["t"] + 1 == 3


def test_flops_match_the_flop_counter():
    for name, mod in (("lemaire_mtl", lemaire_flops),
                      ("jang_mtl", jang_flops)):
        cfg, net, _, x = _model(name, 5)
        net.eval()
        with FlopCounterMode(display=False) as counter, torch.no_grad():
            net(x[:1])
        assert mod.forward_flops(cfg) == counter.get_total_flops(), name


def _digest(root: str) -> str:
    h = hashlib.sha256()
    for dirpath, _, files in sorted(os.walk(root)):
        for f in sorted(files):
            with open(os.path.join(dirpath, f), "rb") as fh:
                h.update(f.encode() + fh.read())
    return h.hexdigest()


def test_traffic_is_a_function_of_the_seed(tmp_path):
    corpus = {"music": {"files": 3, "seconds": [1, 2]},
              "speech": {"files": 2, "seconds": [1, 2]}}
    pool = {"count": 3, "minutes": [0.02, 0.05], "segment_s": [0.5, 1.5],
            "bank": 2, "noise_floor": 0.01}
    digests = {}
    for tag, seed in (("a", 2 ** 31 + 7), ("b", 2 ** 31 + 7), ("c", 12)):
        generate.make_corpus(str(tmp_path / tag / "corpus"), seed, corpus)
        generate.make_pool(str(tmp_path / tag / "pool"), seed, pool)
        digests[tag] = _digest(str(tmp_path / tag))
    assert digests["a"] == digests["b"]
    assert digests["a"] != digests["c"]
    # Every seed serves the same lengths, in its own order.
    assert generate.pool_seconds(pool) == sorted(generate.pool_seconds(pool))
    first = [next(o) for o in [generate.request_order(1, 8)] for _ in range(8)]
    assert sorted(first) == list(range(8))


def test_mixes_and_configs_are_data():
    for sub in ("mixes", "configs", "limits"):
        for f in (harness.BENCH_DIR / sub).iterdir():
            json.loads(f.read_text())

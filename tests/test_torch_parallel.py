"""Multi-device runs of the port (``sm_hpss_mtl_tpu_torch/parallel``) against
the JAX package's ``parallel`` on its 8 virtual CPU devices (conftest).

The port's meshes here are ``[cpu] * 8``: a device may repeat, as
``chip_smoke.py`` runs ``[cuda:0] * n`` on one card.  Tolerances:

- ``hpss_time_sharded`` against JAX's and against the port's unsharded
  ``hpss_plain``: 1e-6 absolute (the same medians on the same values);
- the halo-mode front end (K1's and K2's plain versions) and the sharded
  front end against the Pallas kernel in interpret mode at
  ``dft_precision='highest'``: rtol 2e-4, atol 2e-5 (``test_torch_frontend``'s
  bar); against the port's unsharded plain version: 1e-6 absolute;
- ``featuregram_time_sharded`` against JAX ``featuregram(use_pallas=False)``
  at JAX's own bars (``tests/test_parallel.py``): rtol 1e-4, atol 1e-4 on
  log-mel, 0.05 dB at full resolution.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

from sm_hpss_mtl_tpu.ops import featuregram as jfg
from sm_hpss_mtl_tpu.ops import frontend_pallas as fp
from sm_hpss_mtl_tpu.ops import mel as jmel
from sm_hpss_mtl_tpu.parallel import hpss_time_sharded as j_hts
from sm_hpss_mtl_tpu.parallel import make_mesh as j_make_mesh
from sm_hpss_mtl_tpu.parallel import stft_hpss_mel_time_sharded as j_sts
from sm_hpss_mtl_tpu_torch import parallel as tpar
from sm_hpss_mtl_tpu_torch.cli import segment as tseg
from sm_hpss_mtl_tpu_torch.ops import frontend as tfe
from sm_hpss_mtl_tpu_torch.ops import hpss as thpss
from sm_hpss_mtl_tpu_torch.ops.featuregram import featuregram
from sm_hpss_mtl_tpu_torch.train.config import MODEL_PRESETS

torch.set_num_threads(2)

CPU = torch.device("cpu")
TOL = dict(rtol=2e-4, atol=2e-5)


def _time_mesh(n=8):
    return tpar.make_mesh(n_data=1, n_time=n, devices=[CPU] * n)


def _jtime_mesh(n=8):
    return JMesh(np.array(jax.devices()[:n]).reshape(n), ("time",))


def _mel(n_mels, n_fft=400):
    return np.array(jmel.mel_filterbank(22050, n_fft, n_mels))


# --- meshes -------------------------------------------------------------------

def test_mesh_shapes_as_jax():
    cpus = [CPU] * 8
    for kw in ({}, dict(n_data=4, n_time=2), dict(n_time=2, n_model=2)):
        got = tpar.make_mesh(devices=cpus, **kw).shape
        assert got == dict(j_make_mesh(**kw).shape), kw
    mesh = tpar.make_mesh(devices=cpus)
    assert mesh.shape == {"data": 8, "time": 1, "model": 1}
    assert mesh.along("data") == cpus
    one = tpar.Mesh([CPU] * 4, ("time",))
    assert one.shape == {"time": 4} and one.along("time") == [CPU] * 4


def test_make_mesh_never_builds_a_cpu_mesh_by_itself(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        tpar.make_mesh()
    with pytest.raises(ValueError, match="needs 16 devices"):
        tpar.make_mesh(n_data=16, devices=[CPU] * 8)


def test_cuda_mesh_refuses_cpu_tensors():
    # Device objects need no GPU: the refusal happens before any copy.
    mesh = tpar.make_mesh(n_data=1, n_time=2,
                          devices=[torch.device("cuda", 0)] * 2)
    x = torch.zeros(1, 8000)
    with pytest.raises(ValueError, match="takes cuda tensors"):
        tpar.stft_hpss_mel_time_sharded(x, None, mesh, l_harm=5, l_perc=5)
    with pytest.raises(ValueError, match="one type"):
        tpar.Mesh([CPU, torch.device("cuda", 0)], ("time",))


def test_shardings_cut_as_jax_specs():
    mesh = tpar.make_mesh(n_data=4, n_time=2, devices=[CPU] * 8)
    x = torch.arange(8 * 3 * 6.0).reshape(8, 3, 6)
    batch = tpar.batch_sharding(mesh).shards(x)
    assert len(batch) == 8 and batch[0].shape == (2, 3, 6)
    assert torch.equal(batch[2], x[2:4]) and torch.equal(batch[3], x[2:4])
    time = tpar.time_sharding(mesh).shards(x)
    assert torch.equal(time[0], x[..., :3]) and torch.equal(time[1],
                                                            x[..., 3:])
    assert all(torch.equal(t, x) for t in tpar.replicated(mesh).shards(x))
    model = tpar.model_sharding(mesh, axis=1, ndim=2)
    assert model.spec == (None, "model")
    w = torch.ones(4, 4)
    assert all(torch.equal(t, w) for t in model.shards(w))
    with pytest.raises(ValueError, match="does not shard"):
        tpar.batch_sharding(mesh).shards(torch.zeros(6, 2))


# --- time-sharded HPSS ------------------------------------------------------

def test_hpss_time_sharded_matches_jax_and_unsharded(rng):
    S = np.abs(rng.standard_normal((2, 31, 8 * 40))).astype(np.float32)
    H, P = tpar.hpss_time_sharded(torch.from_numpy(S), _time_mesh())
    JH, JP = j_hts(jnp.asarray(S), j_make_mesh(n_data=1, n_time=8))
    H0, P0 = thpss.hpss_plain(torch.from_numpy(S))
    for got, jw, pw in ((H, JH, H0), (P, JP, P0)):
        np.testing.assert_allclose(got.numpy(), np.asarray(jw), atol=1e-6)
        np.testing.assert_allclose(got.numpy(), pw.numpy(), atol=1e-6)


def test_hpss_time_sharded_guards(rng):
    mesh = _time_mesh()
    S = torch.from_numpy(np.abs(rng.standard_normal((1, 8, 100))).astype(
        np.float32))
    with pytest.raises(ValueError, match="not divisible"):
        tpar.hpss_time_sharded(S, mesh)
    small = torch.rand(1, 8, 8 * 8)
    with pytest.raises(ValueError, match="halo"):
        tpar.hpss_time_sharded(small, mesh)


# --- K1 and K2 in halo mode -------------------------------------------------

def _shard_audio(y, j, n, T_local, ht, hop=160, n_fft=400):
    """Shard ``j`` of ``n`` of whole-signal audio with its halos, as the
    sharded front end hands it to the kernel (zeros past either end)."""
    a = (j * T_local - ht) * hop
    b = ((j + 1) * T_local + ht - 1) * hop + n_fft
    seg = np.zeros((y.shape[0], b - a), np.float32)
    lo, hi = max(a, 0), min(b, y.shape[1])
    seg[:, lo - a:hi - a] = y[:, lo:hi]
    return seg


@pytest.mark.parametrize("mel", [True, False], ids=["K1", "K2"])
@pytest.mark.parametrize("flags", [(1, 0), (0, 0), (0, 1), (1, 1)])
def test_halo_mode_plain_matches_pallas_and_whole_signal(rng, mel, flags):
    # One shard of a 4-way cut at l_harm 21: the JAX kernel's halo mode in
    # interpret mode, and the whole-signal plain run over the same frames.
    n, T_local, ht = 4, 24, 10
    j = {(1, 0): 0, (0, 0): 1, (0, 1): 3, (1, 1): 0}[flags]
    nn = 1 if flags == (1, 1) else n
    y = rng.standard_normal((2, 400 + (nn * T_local - 1) * 160)).astype(
        np.float32)
    seg = _shard_audio(y, j, nn, T_local, ht)
    M = _mel(24) if mel else None
    kw = dict(n_fft=400, win_length=400, hop_length=160, l_harm=21,
              l_perc=11, power=2.0)
    th, tp = (tfe.stft_hpss_mel_plain(torch.from_numpy(seg),
                                      torch.from_numpy(M),
                                      halo_in_audio=True, edge_flags=flags,
                                      **kw) if mel else
              tfe.stft_hpss_plain(torch.from_numpy(seg), halo_in_audio=True,
                                  edge_flags=flags, **kw))
    jh, jp = fp._frontend_pallas(
        jnp.asarray(seg), jnp.asarray(M).T if mel else None, tile_t=24,
        dft_precision="highest", halo_in_audio=True,
        edge_flags=jnp.asarray([flags], jnp.int32), interpret=True, **kw)
    whole = (tfe.stft_hpss_mel_plain(torch.from_numpy(y), torch.from_numpy(M),
                                     **kw) if mel else
             tfe.stft_hpss_plain(torch.from_numpy(y), **kw))
    cut = slice(j * T_local, (j + 1) * T_local)
    for got, jw, w in ((th, jh, whole[0]), (tp, jp, whole[1])):
        assert got.shape[-1] == T_local
        np.testing.assert_allclose(got.numpy(), np.asarray(jw), **TOL)
        np.testing.assert_allclose(got.numpy(), w[..., cut].numpy(),
                                   atol=1e-6)


@pytest.mark.parametrize("flags", [(1, 0), (0, 0), (0, 1)])
def test_halo_mode_plain_at_the_widest_tuner_pair(rng, flags):
    # l_harm 51 (ht 25) at its smallest legal block, 50 frames a shard.
    n, T_local, ht = 3, 50, 25
    j = {(1, 0): 0, (0, 0): 1, (0, 1): 2}[flags]
    y = rng.standard_normal((1, 400 + (n * T_local - 1) * 160)).astype(
        np.float32)
    seg = _shard_audio(y, j, n, T_local, ht)
    kw = dict(n_fft=400, win_length=400, hop_length=160, l_harm=51,
              l_perc=11)
    M = torch.from_numpy(_mel(16))
    got = tfe.stft_hpss_mel_plain(torch.from_numpy(seg), M,
                                  halo_in_audio=True, edge_flags=flags, **kw)
    whole = tfe.stft_hpss_mel_plain(torch.from_numpy(y), M, **kw)
    for g, w in zip(got, whole):
        np.testing.assert_allclose(
            g.numpy(), w[..., j * T_local:(j + 1) * T_local].numpy(),
            atol=1e-6)


def test_halo_mode_arguments_are_checked():
    y = torch.zeros(1, 400 + 99 * 160)
    M = torch.zeros(8, 201)
    with pytest.raises(ValueError, match="need halo_in_audio"):
        tfe.stft_hpss_mel_plain(y, M, edge_flags=(0, 1))
    with pytest.raises(ValueError, match="two of 0 and 1"):
        tfe.stft_hpss_plain(y, halo_in_audio=True, edge_flags=(2, 0))
    with pytest.raises(ValueError, match="more than 20 frames"):
        tfe.stft_hpss_plain(y[:, :400 + 19 * 160], halo_in_audio=True)


def test_halo_mode_counts_in_the_kernel_counters(monkeypatch):
    # The CUDA route of a halo-mode call goes to launch (never to the
    # short-clip branch), which counts in the existing counters.
    seen = []
    monkeypatch.setattr(tfe, "launch", lambda y, M, **kw: seen.append(kw))
    y = torch.zeros(1, 400 + 24 * 160)
    tfe._dispatch(y, None, n_fft=400, win_length=400, hop_length=160,
                  l_harm=21, l_perc=11, halo_in_audio=True,
                  edge_flags=(0, 1))
    assert seen == [dict(n_fft=400, win_length=400, hop_length=160,
                         l_harm=21, l_perc=11, power=2.0,
                         dft_precision="highest", halo_in_audio=True,
                         edge_flags=(0, 1))]


# --- the time-sharded front end ----------------------------------------------

@pytest.mark.parametrize("mel", [True, False], ids=["K1", "K2"])
def test_frontend_time_sharded_matches_jax_and_unsharded(rng, mel):
    T = 192                                # 8 shards x 24 frames
    y = rng.standard_normal((2, 400 + (T - 1) * 160)).astype(np.float32)
    M = _mel(24) if mel else None
    Hs, Ps = tpar.stft_hpss_mel_time_sharded(
        torch.from_numpy(y), None if M is None else torch.from_numpy(M),
        _time_mesh())
    JH, JP = j_sts(jnp.asarray(y), M, _jtime_mesh(), tile_t=24,
                   dft_precision="highest", interpret=True)
    Hu, Pu = (tfe.stft_hpss_mel_plain(torch.from_numpy(y),
                                      torch.from_numpy(M)) if mel
              else tfe.stft_hpss_plain(torch.from_numpy(y)))
    for got, jw, w in ((Hs, JH, Hu), (Ps, JP, Pu)):
        np.testing.assert_allclose(got.numpy(), np.asarray(jw), **TOL)
        np.testing.assert_allclose(got.numpy(), w.numpy(), atol=1e-6)


def test_frontend_time_sharded_validations():
    M = torch.from_numpy(_mel(8))
    mesh = _time_mesh()
    y = torch.zeros(1, 400 + 97 * 160)     # T=98, not divisible by 8
    with pytest.raises(ValueError, match="not divisible"):
        tpar.stft_hpss_mel_time_sharded(y, M, mesh)
    y = torch.zeros(1, 400 + 95 * 160)     # T=96 -> T_local=12 < 2*ht
    with pytest.raises(ValueError, match="smaller than"):
        tpar.stft_hpss_mel_time_sharded(y, M, mesh)
    y = torch.zeros(1, 400 + 399 * 160)    # T=400 -> 50 a shard at l 51
    tpar.stft_hpss_mel_time_sharded(y, M, mesh, l_harm=51)
    y = torch.zeros(1, 400 + 391 * 160)    # T=392 -> 49 a shard
    with pytest.raises(ValueError, match="smaller than"):
        tpar.stft_hpss_mel_time_sharded(y, M, mesh, l_harm=51)


def test_featuregram_time_sharded_matches_featuregram(rng):
    # T=205 is not divisible by 8: the pad and the tail splice.
    T = 205
    y = rng.standard_normal((400 + (T - 1) * 160,)).astype(np.float32)
    got = tpar.featuregram_time_sharded(torch.from_numpy(y), _time_mesh(),
                                        feat_name="LogMelHarmPercSpec",
                                        n_mels=24)
    want = jfg.featuregram(jnp.asarray(y), feat_name="LogMelHarmPercSpec",
                           n_mels=24, use_pallas=False)
    assert tuple(got.shape) == want.shape == (48, T)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    with pytest.raises(ValueError, match="HPSS featName"):
        tpar.featuregram_time_sharded(torch.from_numpy(y), _time_mesh(),
                                      feat_name="LogSpec")


def test_featuregram_time_sharded_fullres(rng):
    T = 203
    y = rng.standard_normal((400 + (T - 1) * 160,)).astype(np.float32)
    got = tpar.featuregram_time_sharded(torch.from_numpy(y), _time_mesh(),
                                        feat_name="LogHarmPercSpec")
    want = jfg.featuregram(jnp.asarray(y), feat_name="LogHarmPercSpec",
                           use_pallas=False)
    assert tuple(got.shape) == want.shape == (402, T)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=0.05)


def test_featuregram_time_sharded_tail_splice_takes_the_dispatcher(
        rng, monkeypatch):
    # The splice goes through ops.frontend's dispatcher (K1 on the card),
    # never a plain version called by name.
    calls = []
    real = tfe.stft_hpss_mel
    monkeypatch.setattr(tfe, "stft_hpss_mel", lambda *a, **kw: (
        calls.append(kw.get("halo_in_audio", False)), real(*a, **kw))[1])
    T = 205
    y = torch.from_numpy(rng.standard_normal(400 + (T - 1) * 160).astype(
        np.float32))
    tpar.featuregram_time_sharded(y, _time_mesh(), n_mels=24)
    assert calls == [True] * 8 + [False]


# --- cli.segment's multi-device branch -----------------------------------------

def test_segment_shards_the_features_over_several_devices(rng, monkeypatch):
    import sm_hpss_mtl_tpu.cli.segment as jseg
    preset = MODEL_PRESETS["Lemaire_et_al_MTL"]
    x = (0.1 * rng.standard_normal(400 + 199 * 160)).astype(np.float32)
    # The whole-signal featuregram (one device pads short files to a length
    # bucket first, so it is held here to what the slabbed path computes).
    one = featuregram(torch.from_numpy(x), feat_name=preset["feat_name"],
                      n_fft=preset["n_fft"], n_mels=preset["n_mels"])
    calls = []
    real = tseg.featuregram_time_sharded
    monkeypatch.setattr(tseg, "featuregram_time_sharded", lambda *a, **k: (
        calls.append(a[1].shape), real(*a, **k))[1])
    many = tseg._featurize_broadcast(x, preset, CPU, devices=[CPU] * 8)
    assert calls == [{"time": 8}]
    assert many.shape == one.shape == (240, 200)
    np.testing.assert_allclose(many.numpy(), one.numpy(), atol=1e-3)
    # The JAX CLI shards over its 8 virtual devices (bf16x3 DFT there).
    want = jseg._featurize_broadcast(x, preset)
    np.testing.assert_allclose(many.numpy(), want, atol=0.05)
    # Under 20 frames a device, and on the CPU by default, it does not.
    calls.clear()
    tseg._featurize_broadcast(x[:400 + 150 * 160], preset, CPU,
                              devices=[CPU] * 8)
    tseg._featurize_broadcast(x, preset, CPU)
    assert calls == []

"""Serving path of the port against the JAX package: the streaming
segmenter, the ``cli.segment`` entry point end to end, and the metrics."""

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax
import jax.numpy as jnp

from sm_hpss_mtl_tpu.cli import segment as jcli
from sm_hpss_mtl_tpu.eval import metrics as jmetrics
from sm_hpss_mtl_tpu.eval import segment as jseg
from sm_hpss_mtl_tpu.ops import featuregram as jfg
from sm_hpss_mtl_tpu_torch.cli import segment as tcli
from sm_hpss_mtl_tpu_torch.eval import metrics as tmetrics
from sm_hpss_mtl_tpu_torch.eval import segment as tseg
from sm_hpss_mtl_tpu_torch.ops import featuregram as tfg
from sm_hpss_mtl_tpu_torch import weights

torch.set_num_threads(1)


@pytest.fixture
def jax_constant_rows_fixed(monkeypatch):
    """The JAX segmenter's standardization with constant rows centred to 0.

    The serving features always hold rows pinned at the dB floor (the
    empty low filters of the sr=22050 mel bank).  The JAX helper tests
    the float32 std against 0, which misses them, and turns them into
    +-1 noise that depends on summation order; the port centres them as
    sklearn does (``test_torch_dsp``).  The JAX side is patched here, not
    edited, so that both are held to the same rule."""
    from sm_hpss_mtl_tpu.ops.patches import standardize_rows

    def fixed(FV):
        FV = np.asarray(FV)
        out = np.array(standardize_rows(FV))
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


def test_segmenter_matches_jax_plain_loop(jax_constant_rows_fixed):
    x = _broadcast(2.0, 0)
    fv = np.asarray(jfg.featuregram(jnp.asarray(x),
                                    feat_name="LogMelHarmPercSpec", n_mels=40))
    W, chunk = 16, 50                 # 183 windows: chunks 50,50,50,33

    def jpredict(b):                  # (B, W, D)
        s = 3.0 * jnp.mean(b[:, :, :8], axis=(1, 2))
        return {"S": jax.nn.sigmoid(s)[:, None],
                "M": jax.nn.sigmoid(jnp.mean(b[:, :, 40:48], axis=(1, 2))
                                    * 3.0)[:, None]}

    def tpredict(b):
        s = 3.0 * b[:, :, :8].mean(dim=(1, 2))
        return {"S": torch.sigmoid(s)[:, None],
                "M": torch.sigmoid(b[:, :, 40:48].mean(dim=(1, 2))
                                   * 3.0)[:, None]}

    want = jseg.StreamingSegmenter(predict_fn=jpredict, patch_size=W,
                                   chunk_frames=chunk)
    got = tseg.StreamingSegmenter(predict_fn=tpredict, patch_size=W,
                                  chunk_frames=chunk)
    for head in ("S", "M"):
        sm0, lab0, tr0 = want.segment(fv, head=head, smooth_win=9)
        sm1, lab1, tr1 = got.segment(torch.tensor(fv), head=head,
                                     smooth_win=9)
        assert tr1[head].shape == tr0[head].shape == (fv.shape[1] - W + 1, 1)
        np.testing.assert_allclose(tr1[head], tr0[head], rtol=0, atol=1e-5)
        np.testing.assert_allclose(sm1, sm0, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(lab1, lab0)
        assert 0 < lab1.sum() < len(lab1)


def test_cli_segment_matches_jax_cli(tmp_path, jax_constant_rows_fixed):
    from sm_hpss_mtl_tpu.models import get_model
    from sm_hpss_mtl_tpu.train import TrainState, for_model
    from sm_hpss_mtl_tpu.train.checkpoint import save_checkpoint

    # 1.4 s: 138 frames, below the JAX CLI's multi-device and slab
    # thresholds, so both take the bucketed whole-signal path.
    wav = str(tmp_path / "b.wav")
    wavfile.write(wav, 16000,
                  (_broadcast(1.4, 1) * 32767).astype(np.int16))
    annot = tmp_path / "a.csv"
    annot.write_text("tmin,dur,label\n0.0,0.7,0\n0.7,0.7,1\n")

    spec = get_model("Lemaire_et_al_MTL", n_mels=120)
    opt, _ = for_model("Lemaire_et_al_MTL", tr_steps=1)
    state = TrainState.create(spec.module, opt, jnp.zeros((2, 68, 240)),
                              jax.random.PRNGKey(4))
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, state)
    npz = str(tmp_path / "w.npz")
    weights.save_npz(npz, jax.tree_util.tree_map(
        np.asarray, {"params": state.params,
                     "batch_stats": state.batch_stats}))

    common = [wav, "--head", "M", "--chunk-frames", "32", "--smooth-win",
              "11", "--annot", str(annot)]
    jprob, jlab = jcli.main(common + ["--ckpt", ckpt,
                                      "--out", str(tmp_path / "j.npz")])
    tprob, tlab = tcli.main(common + ["--weights", npz, "--device", "cpu",
                                      "--out", str(tmp_path / "t.npz")])
    assert tprob.shape == jprob.shape == (138 - 67,)
    np.testing.assert_allclose(tprob, jprob, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tlab, jlab)
    # The featuregrams differ by up to ~2e-3 dB (float32 summation order),
    # which moves the unbounded R head (values ~2) by up to ~3e-5.
    with np.load(tmp_path / "j.npz") as j, np.load(tmp_path / "t.npz") as t:
        for k in ("track_S", "track_M", "track_R", "track_3C"):
            np.testing.assert_allclose(t[k], j[k], rtol=0, atol=1e-4)


def test_cli_featurize_long_broadcast_takes_slabs(monkeypatch):
    monkeypatch.setattr(tcli, "SLAB_THRESHOLD_FRAMES", 64)
    seen = {}
    orig = tcli.featuregram_slabbed

    def spy(y, **kw):
        seen["slabbed"] = True
        return orig(y, slab_frames=64, **kw)

    monkeypatch.setattr(tcli, "featuregram_slabbed", spy)
    x = _broadcast(2.0, 2)
    preset = {"feat_name": "LogMelHarmPercSpec", "n_fft": 400, "n_mels": 24}
    got = tcli._featurize_broadcast(x, preset, torch.device("cpu"))
    assert seen.get("slabbed")
    want = np.asarray(jfg.featuregram_slabbed(x, slab_frames=64, **preset))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("labels", [[0, 1], [0, 1, 2]])
def test_get_performance_matches_sklearn(labels):
    rng = np.random.default_rng(len(labels))
    truth = rng.integers(0, 2, 300)
    pred = rng.integers(0, len(labels), 300)
    want = jmetrics.get_performance(pred, truth, labels)
    got = tmetrics.get_performance(pred, truth, labels)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert tmetrics.accuracy(got[0]) == jmetrics.accuracy(want[0])


def test_interval_markers_match_jax(tmp_path):
    path = tmp_path / "a.csv"
    path.write_text("tmin,dur,label\n0,10,1\n10,5,0\n15,12.5,1\n")
    rows = tseg.read_interval_csv(str(path))
    assert rows == jseg.read_interval_csv(str(path))
    np.testing.assert_array_equal(
        tseg.interval_annotations_to_markers(rows, 97),
        jseg.interval_annotations_to_markers(rows, 97))


def _jax_checkpoint(tmp_path, name, sample_shape, seed):
    """A JAX train state for ``name`` saved as the JAX CLI's checkpoint
    and as the port's npz."""
    from sm_hpss_mtl_tpu.models import get_model
    from sm_hpss_mtl_tpu.train import TrainState, for_model
    from sm_hpss_mtl_tpu.train.checkpoint import save_checkpoint

    spec = get_model(name, n_mels=120)
    opt, _ = for_model(name, tr_steps=1)
    state = TrainState.create(spec.module, opt, jnp.zeros(sample_shape),
                              jax.random.PRNGKey(seed))
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, state)
    npz = str(tmp_path / "w.npz")
    weights.save_npz(npz, jax.tree_util.tree_map(
        np.asarray, {"params": state.params,
                     "batch_stats": state.batch_stats}))
    return ckpt, npz


def test_cli_segment_jang_mtl_matches_jax_cli(tmp_path,
                                              jax_constant_rows_fixed,
                                              monkeypatch):
    # Jang-MTL: LogHarmPercSpec at n_fft 512 (514 rows), 'image' windows.
    # 1.4 s: 137 frames at n_fft 512, 70 windows, chunks of 32 in model
    # calls of at most 20 windows.
    wav = str(tmp_path / "b.wav")
    wavfile.write(wav, 16000,
                  (_broadcast(1.4, 3) * 32767).astype(np.int16))
    ckpt, npz = _jax_checkpoint(tmp_path, "Jang_et_al_MTL",
                                (2, 514, 68, 1), 6)
    monkeypatch.setattr(tcli, "IMAGE_BATCH_WINDOWS", 20)
    common = [wav, "--model", "Jang_et_al_MTL", "--head", "S",
              "--chunk-frames", "32", "--smooth-win", "11"]
    jprob, jlab = jcli.main(common + ["--ckpt", ckpt,
                                      "--out", str(tmp_path / "j.npz")])
    tprob, tlab = tcli.main(common + ["--weights", npz, "--device", "cpu",
                                      "--out", str(tmp_path / "t.npz")])
    assert tprob.shape == jprob.shape == (137 - 67,)
    np.testing.assert_allclose(tprob, jprob, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tlab, jlab)
    with np.load(tmp_path / "j.npz") as j, np.load(tmp_path / "t.npz") as t:
        for k in ("track_S", "track_M", "track_R", "track_3C"):
            assert t[k].shape == j[k].shape
            np.testing.assert_allclose(t[k], j[k], rtol=0, atol=1e-4)


def test_jang_featurize_slabbed_matches_whole_and_jax(monkeypatch):
    # The slabbed full-resolution featurizer (K2's serving path on the
    # GPU): every frame equals the whole-signal featuregram's, and the
    # JAX slabbed featurizer's.
    monkeypatch.setattr(tcli, "SLAB_THRESHOLD_FRAMES", 64)
    orig = tcli.featuregram_slabbed
    monkeypatch.setattr(tcli, "featuregram_slabbed",
                        lambda y, **kw: orig(y, slab_frames=64, **kw))
    x = _broadcast(2.5, 4)                         # 247 frames at n_fft 512
    preset = tcli.MODEL_PRESETS["Jang_et_al_MTL"]
    got = tcli._featurize_broadcast(x, preset, torch.device("cpu"))
    assert got.shape == (514, 247)
    whole = tfg.featuregram(torch.from_numpy(x), feat_name="LogHarmPercSpec",
                            n_fft=512).numpy()
    np.testing.assert_allclose(got.numpy(), whole, rtol=0, atol=1e-3)
    want = np.asarray(jfg.featuregram_slabbed(
        x, slab_frames=64, feat_name="LogHarmPercSpec", n_fft=512))
    # At full resolution a few bins differ by up to ~2.5 mdB between any
    # two float32 programs (a last-ulp DFT difference flips a close pair
    # inside the harmonic median); the JAX package allows its own slabbed
    # and whole programs 5 mdB for it (tests/test_dsp_parity.py).
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-3)


def test_segmenter_image_windows_match_jax(jax_constant_rows_fixed):
    x = _broadcast(1.2, 5)
    fv = np.asarray(jfg.featuregram(jnp.asarray(x),
                                    feat_name="LogHarmPercSpec", n_fft=512))
    W, chunk = 12, 40

    def jpredict(b):                  # (B, D, W, 1)
        return 0.5 + 0.1 * jnp.tanh(b[:, 3:9, :, 0].mean(axis=(1, 2)))[:, None]

    def tpredict(b):
        assert b.shape[1:] == (514, W, 1) and b.shape[0] <= 7
        return 0.5 + 0.1 * torch.tanh(b[:, 3:9, :, 0].mean(dim=(1, 2)))[:, None]

    want = jseg.StreamingSegmenter(predict_fn=jpredict, patch_size=W,
                                   chunk_frames=chunk, input_kind="image",
                                   feat_name="LogHarmPercSpec")
    got = tseg.StreamingSegmenter(predict_fn=tpredict, patch_size=W,
                                  chunk_frames=chunk, input_kind="image",
                                  feat_name="LogHarmPercSpec",
                                  batch_windows=7)
    t0 = want.frame_probabilities(fv)
    t1 = got.frame_probabilities(torch.tensor(fv))
    assert set(t1) == set(t0) == {"3C"}
    assert t1["3C"].shape == (fv.shape[1] - W + 1, 1)
    np.testing.assert_allclose(t1["3C"], t0["3C"], rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="input_kind"):
        tseg.StreamingSegmenter(predict_fn=tpredict, patch_size=W,
                                input_kind="dual").frame_probabilities(
                                    torch.tensor(fv))


@pytest.mark.parametrize("model,item", [("Lemaire_et_al_Cascaded_MTL", 7),
                                        ("Lemaire_et_al_MTL_5class", 7),
                                        ("Lemaire_et_al_MTL_IF", 7)])
def test_cli_segment_names_the_queue_of_other_models(tmp_path, model, item):
    # ROADMAP §1 item ``item`` ported Lemaire's variants: Cascaded-MTL and
    # the 5-class model are served (the CLI goes on to read the wav), the
    # fusion model is refused as the JAX CLI fails on it
    # (test_torch_fusion); none is left waiting.
    argv = [str(tmp_path / "b.wav"), "--weights", str(tmp_path / "w.npz"),
            "--model", model, "--device", "cpu"]
    if model == "Lemaire_et_al_MTL_IF":
        with pytest.raises(ValueError, match="harm_input"):
            tcli.main(argv)
    else:
        assert model in tcli.MODELS
        with pytest.raises(FileNotFoundError):
            tcli.main(argv)


@pytest.mark.parametrize("model", ["Jang_et_al", "Papakostas_et_al",
                                   "Doukhan_et_al", "Lemaire_et_al"])
def test_cli_segment_refuses_single_task_models(tmp_path, model):
    with pytest.raises(ValueError, match="no S or M head"):
        tcli.main([str(tmp_path / "b.wav"), "--weights",
                   str(tmp_path / "w.npz"), "--model", model,
                   "--device", "cpu"])


@pytest.mark.parametrize("model,rows,patch", [
    ("Papakostas_et_al_MTL", 402, 16), ("Doukhan_et_al_MTL", 240, 68)])
def test_cli_segment_cnn_mtl_matches_jax_cli(tmp_path,
                                             jax_constant_rows_fixed,
                                             monkeypatch, model, rows, patch):
    # Papakostas-MTL: HarmPercSpec at n_fft 400 (402 rows, K2 on the card);
    # Doukhan-MTL: MelHarmPercSpec (240 rows, K1).  1.4 s: 138 frames,
    # chunks of 32 windows in model calls of at most 20.
    wav = str(tmp_path / "b.wav")
    wavfile.write(wav, 16000,
                  (_broadcast(1.4, 7) * 32767).astype(np.int16))
    ckpt, npz = _jax_checkpoint(tmp_path, model, (2, rows, patch, 1), 8)
    monkeypatch.setattr(tcli, "IMAGE_BATCH_WINDOWS", 20)
    common = [wav, "--model", model, "--head", "M", "--patch-size",
              str(patch), "--chunk-frames", "32", "--smooth-win", "11"]
    jprob, jlab = jcli.main(common + ["--ckpt", ckpt,
                                      "--out", str(tmp_path / "j.npz")])
    tprob, tlab = tcli.main(common + ["--weights", npz, "--device", "cpu",
                                      "--out", str(tmp_path / "t.npz")])
    assert tprob.shape == jprob.shape == (138 - patch + 1,)
    np.testing.assert_allclose(tprob, jprob, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tlab, jlab)
    with np.load(tmp_path / "j.npz") as j, np.load(tmp_path / "t.npz") as t:
        for k in ("track_S", "track_M", "track_R", "track_3C"):
            assert t[k].shape == j[k].shape
            np.testing.assert_allclose(t[k], j[k], rtol=0, atol=1e-4)


@pytest.mark.parametrize("seed,n,win,n_labels", [(0, 200, 11, 3),
                                                 (1, 500, 50, 2),
                                                 (2, 31, 31, 4),
                                                 (3, 64, 7, 5)])
def test_mode_filtering_matches_jax(seed, n, win, n_labels):
    """The port's ``mode_filtering`` equals the JAX one and the reference
    loop (an even window widens by one; a track no longer than the window
    keeps its labels)."""
    x = np.random.default_rng(seed).integers(0, n_labels, n)
    got = tseg.mode_filtering(x.copy(), win)
    np.testing.assert_array_equal(got, jseg.mode_filtering(x.copy(), win))
    want = x.copy()
    half = (win | 1) // 2
    for i in range(half, len(x) - half):
        u, c = np.unique(x[i - half:i + half], return_counts=True)
        want[i] = u[np.argmax(c)]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("standardize", [True, "chunk", "featuregram",
                                         False, "none"])
def test_segmenter_scopes_match_jax(jax_constant_rows_fixed, standardize):
    """The three standardization scopes of the JAX segmenter on the same
    features: per chunk (the default), over the whole featuregram, and
    none (the reference's DAFx streaming path)."""
    x = _broadcast(2.0, 6)
    fv = np.asarray(jfg.featuregram(jnp.asarray(x),
                                    feat_name="LogMelHarmPercSpec", n_mels=40))
    W, chunk = 16, 50

    def jpredict(b):
        return {"S": jax.nn.sigmoid(0.05 * jnp.mean(b[:, :, :8], axis=(1, 2))
                                    + 0.3 * jnp.mean(b[:, :, 40:44],
                                                     axis=(1, 2)))[:, None]}

    def tpredict(b):
        return {"S": torch.sigmoid(0.05 * b[:, :, :8].mean(dim=(1, 2))
                                   + 0.3 * b[:, :, 40:44].mean(dim=(1, 2))
                                   )[:, None]}

    kw = dict(patch_size=W, chunk_frames=chunk, standardize=standardize)
    want = jseg.StreamingSegmenter(predict_fn=jpredict, **kw)
    got = tseg.StreamingSegmenter(predict_fn=tpredict, **kw)
    t0 = want.frame_probabilities(fv)["S"]
    t1 = got.frame_probabilities(torch.tensor(fv))["S"]
    assert t1.shape == t0.shape == (fv.shape[1] - W + 1, 1)
    np.testing.assert_allclose(t1, t0, rtol=0, atol=1e-5)
    # The scopes differ from one another on these features.
    other = "none" if got._scope() != "none" else "chunk"
    t2 = tseg.StreamingSegmenter(predict_fn=tpredict, patch_size=W,
                                 chunk_frames=chunk, standardize=other
                                 ).frame_probabilities(torch.tensor(fv))["S"]
    assert np.abs(t2 - t1).max() > 1e-2
    with pytest.raises(ValueError, match="standardize"):
        tseg.StreamingSegmenter(predict_fn=tpredict, patch_size=W,
                                standardize="file").frame_probabilities(
                                    torch.tensor(fv))


def test_cli_segment_ckpt_matches_jax_cli(tmp_path, jax_constant_rows_fixed):
    """``--ckpt`` serves the port's fold checkpoint (``state/model.npz``,
    as ``cli.mtl`` writes it) as the JAX CLI serves its own, and as
    ``--weights`` serves the same parameters; the JAX package's orbax
    checkpoint is refused with a message that says so, and exactly one of
    ``--ckpt`` and ``--weights`` is taken."""
    from sm_hpss_mtl_tpu_torch.models.zoo import load_model
    from sm_hpss_mtl_tpu_torch.train.checkpoint import save_checkpoint
    from sm_hpss_mtl_tpu_torch.train.optimizers import for_model
    from sm_hpss_mtl_tpu_torch.train.state import TrainState

    wav = str(tmp_path / "b.wav")
    wavfile.write(wav, 16000,
                  (_broadcast(1.4, 7) * 32767).astype(np.int16))
    jckpt, npz = _jax_checkpoint(tmp_path, "Lemaire_et_al_MTL",
                                 (2, 68, 240), 8)
    net = load_model(npz, torch.device("cpu"), "Lemaire_et_al_MTL")
    opt, _ = for_model("Lemaire_et_al_MTL", net.parameters(), tr_steps=1)
    ckpt = str(tmp_path / "fold0_ckpt")
    save_checkpoint(ckpt, TrainState(net, opt), {"epoch": 0})

    common = [wav, "--head", "S", "--chunk-frames", "32", "--smooth-win",
              "11"]
    out = {}
    jprob, jlab = jcli.main(common + ["--ckpt", jckpt,
                                      "--out", str(tmp_path / "j.npz")])
    for tag, src in (("ckpt", ["--ckpt", ckpt]), ("weights",
                                                  ["--weights", npz])):
        out[tag] = tcli.main(common + src + [
            "--device", "cpu", "--out", str(tmp_path / f"{tag}.npz")])
    np.testing.assert_array_equal(out["ckpt"][0], out["weights"][0])
    np.testing.assert_allclose(out["ckpt"][0], jprob, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(out["ckpt"][1], jlab)
    with np.load(tmp_path / "j.npz") as j, \
            np.load(tmp_path / "ckpt.npz") as c, \
            np.load(tmp_path / "weights.npz") as w:
        for k in ("track_S", "track_M", "track_R", "track_3C"):
            np.testing.assert_array_equal(c[k], w[k])
            np.testing.assert_allclose(c[k], j[k], rtol=0, atol=1e-4)

    with pytest.raises(ValueError, match="orbax"):
        tcli.main([wav, "--ckpt", jckpt, "--device", "cpu"])
    with pytest.raises(FileNotFoundError):
        tcli.main([wav, "--ckpt", str(tmp_path / "none"), "--device", "cpu"])
    for argv in ([wav, "--device", "cpu"],
                 [wav, "--ckpt", ckpt, "--weights", npz, "--device", "cpu"]):
        with pytest.raises(SystemExit):
            tcli.main(argv)

"""bf16 compute through the runner: every zoo model trains, evaluates and
checkpoints one toy fold with ``ExperimentConfig(compute_dtype='bfloat16')``
(the device pipeline, K1/K2's plain versions inside the step on the CPU),
and ``cli.mtl --bf16`` writes a fold that ``cli.segment --ckpt`` serves.

What is held: the model computes in bf16 where flax's dtype rule says
(``test_torch_bf16``), its parameters and checkpoint stay float32, the
validation loss and the test predictions are finite float32, and the
served tracks of the checkpoint equal those of the same parameters given
as ``--weights``.
"""

import os

import numpy as np
import pytest
import torch

from sm_hpss_mtl_tpu_torch.cli import experiment as texp
from sm_hpss_mtl_tpu_torch.cli import mtl as tmtl
from sm_hpss_mtl_tpu_torch.cli import segment as tcli
from sm_hpss_mtl_tpu_torch.data import audio as taudio
from sm_hpss_mtl_tpu_torch.models.layers import Conv1d, Conv2d, Linear
from sm_hpss_mtl_tpu_torch.models.zoo import INPUT_KIND, MTL
from sm_hpss_mtl_tpu_torch.train import config as tconfig
from sm_hpss_mtl_tpu_torch.weights import load_npz

torch.set_num_threads(2)

NARROW = dict(n_filters=8, nb_stacks=1, Nd=2)
FOLD = dict(epochs=1, batch_size=2, patch_size=16, patch_shift=16,
            tr_steps=1, v_steps=1, augment_noise=False, seed=0)
#: Per-model settings beside FOLD: the narrow Lemaire trunks, Jang's 24
#: mel bands, Doukhan's 68-frame patches (its pools need them) and the
#: 5-class folds.
SETTINGS = {
    "Lemaire_et_al": dict(n_mels_override=16, arch_kwargs=NARROW),
    "Lemaire_et_al_MTL": dict(n_mels_override=16, arch_kwargs=NARROW),
    "Lemaire_et_al_Cascaded_MTL": dict(n_mels_override=16,
                                       arch_kwargs=NARROW),
    "Lemaire_et_al_MTL_5class": dict(n_mels_override=16, n_classes=5,
                                     arch_kwargs=NARROW),
    "Lemaire_et_al_MTL_IF": dict(n_mels_override=16,
                                 arch_kwargs=dict(n_filters=8, nb_stacks=1)),
    "Jang_et_al": {},
    "Jang_et_al_MTL": dict(n_mels_override=24),
    "Doukhan_et_al": dict(patch_size=68, patch_shift=68),
    "Doukhan_et_al_MTL": dict(n_mels_override=20, patch_size=68,
                              patch_shift=68),
    "Papakostas_et_al": {},
    "Papakostas_et_al_MTL": {},
}


@pytest.fixture(scope="module")
def toy_root(tmp_path_factory):
    return taudio.make_toy_musan(str(tmp_path_factory.mktemp("toy_bf16")),
                                 n_per_class=9, duration_s=2.0,
                                 with_noise=True)


def test_every_zoo_model_has_a_setting():
    # Every model that trains; a sequence or stream model refuses a fold
    # (tests/test_torch_whisper.py, tests/test_torch_granite.py).
    assert set(SETTINGS) == {m for m in MTL
                             if INPUT_KIND[m] not in ("sequence", "stream")}


@pytest.mark.parametrize("model", sorted(SETTINGS))
def test_bf16_fold_trains_evaluates_and_checkpoints(toy_root, tmp_path,
                                                    monkeypatch, model):
    built = {}
    spec_of = texp.model_spec

    def spy(config):
        built["spec"] = spec = spec_of(config)
        return spec

    monkeypatch.setattr(texp, "model_spec", spy)
    cfg = tconfig.ExperimentConfig(model=model, data_root=toy_root,
                                   output_dir=str(tmp_path),
                                   pipeline="device",
                                   compute_dtype="bfloat16",
                                   **{**FOLD, **SETTINGS[model]})
    out = texp.run_experiment(cfg, folds=[0], verbose=False,
                              device="cpu")[0]
    net = built["spec"].module
    layers = [m for m in net.modules()
              if isinstance(m, (Conv1d, Conv2d, Linear))]
    assert any(m.compute_dtype == torch.bfloat16 for m in layers)
    assert all(p.dtype == torch.float32 for p in net.parameters())
    assert np.isfinite(out["row"]["val_loss"])
    assert np.isfinite(out["fit"].history[0]["loss"])
    n = cfg.n_classes
    assert out["test"]["ConfMat"].shape == (n, n)
    ckpt = os.path.join(out["op_dir"], "fold0_ckpt", "state", "model.npz")
    flat = load_npz(ckpt)
    leaves = []

    def walk(tree):
        for v in tree.values():
            walk(v) if isinstance(v, dict) else leaves.append(v)
    walk(flat)
    assert leaves and all(a.dtype == np.float32 for a in leaves)
    # The model's outputs reach the tester's metrics as float32.
    tester, seen = out["tester"], []
    predict = tester.predict_fn

    def spy_predict(x):
        y = predict(x)
        seen.extend(y.values() if isinstance(y, dict) else [y])
        return y

    tester.predict_fn = spy_predict
    music = os.path.join(toy_root, "music", out["test_files"]["music"][0])
    pred, _ = tester.predict_file("music", "", music)
    assert seen and all(v.dtype == torch.float32 for v in seen)
    assert pred.dtype == np.float32 and np.isfinite(pred).all()


def test_cli_mtl_bf16_fold_serves_through_cli_segment_ckpt(toy_root,
                                                           tmp_path):
    """``cli.mtl --bf16`` trains one fold at full width and writes its
    checkpoint and results; ``cli.segment --ckpt`` serves that checkpoint
    (in float32, as the JAX CLI serves) with the tracks ``--weights`` gives
    on the same parameters."""
    res = str(tmp_path / "res")
    out = tmtl.main(["--data", toy_root, "--output", res, "--device", "cpu",
                     "--bf16", "--epochs", "1", "--batch-size", "2",
                     "--patch-size", "68", "--patch-shift", "68",
                     "--tr-steps", "1", "--v-steps", "1", "--folds", "0",
                     "--no-augment"])[0]
    op_dir = out["op_dir"]
    for name in ("Performance.csv", "Configuration.csv", "fold0_log.csv"):
        assert os.path.exists(os.path.join(op_dir, name)), name
    with open(os.path.join(op_dir, "Configuration.csv")) as f:
        assert 'compute_dtype\t"bfloat16"' in f.read()
    ckpt = os.path.join(op_dir, "fold0_ckpt")
    wav = str(tmp_path / "b.wav")
    taudio.write_wav(wav, 0.3 * np.sin(2 * np.pi * 220 * np.arange(22400)
                                       / 16000))
    common = [wav, "--device", "cpu", "--chunk-frames", "32",
              "--smooth-win", "11"]
    got = tcli.main(common + ["--ckpt", ckpt, "--out",
                              str(tmp_path / "c.npz")])
    want = tcli.main(common + ["--weights", os.path.join(
        ckpt, "state", "model.npz"), "--out", str(tmp_path / "w.npz")])
    np.testing.assert_array_equal(got[0], want[0])
    with np.load(tmp_path / "c.npz") as c, np.load(tmp_path / "w.npz") as w:
        assert set(c.files) == set(w.files)
        for k in c.files:
            assert c[k].dtype != np.float16
            np.testing.assert_array_equal(c[k], w[k])
            assert np.isfinite(c[k]).all()

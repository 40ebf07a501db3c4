"""The "user hands us a wav" entry point: weights -> classify audio files
(counterpart of ``sm_hpss_mtl_tpu/infer.py``).

    from sm_hpss_mtl_tpu_torch.infer import Classifier
    clf = Classifier.from_weights("W.npz", model="Lemaire_et_al_MTL")
    out = clf.classify_file("clip.wav")
    out["class_name"], out["probabilities"], out["heads"]

The JAX package restores an orbax training state; the port reads the
``.npz`` of ``sm_hpss_mtl_tpu_torch.weights``, as ``cli.segment --weights``
does.  Runs on CUDA unless ``device="cpu"`` is given.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .data.featurize import FeatureConfig, Featurizer
from .device import resolve_device
from .eval.tester import FileWiseTester
from .models.zoo import INPUT_KIND, load_model
from .train.config import MODEL_PRESETS

CLASS_NAMES = ("music", "speech", "speech_music", "noise", "speech_noise")


@dataclass
class Classifier:
    tester: FileWiseTester

    @classmethod
    def from_weights(cls, weights: str, *, model: str = "Lemaire_et_al_MTL",
                     device: str | torch.device = "cuda") -> "Classifier":
        """A classifier for ``model`` (3 classes; 5 for
        ``Lemaire_et_al_MTL_5class``) with weights from a ``.npz``
        (flax keys), on 68-frame patches at shift 68, featurizing with the
        model's preset, bucketed, on ``device``.  The intermediate-fusion
        model is refused, as the JAX ``Classifier`` fails on it (its
        template state is built from one array)."""
        if INPUT_KIND[model] == "dual":
            raise ValueError(f"model {model!r} takes two inputs; the "
                             "Classifier feeds one featuregram's patches")
        device = resolve_device(device)
        preset = MODEL_PRESETS[model]
        feat_cfg = FeatureConfig(feat_name=preset["feat_name"],
                                 n_fft=preset["n_fft"],
                                 n_mels=preset["n_mels"])
        tester = FileWiseTester(
            featurizer=Featurizer(feat_cfg, device=device),
            predict_fn=load_model(weights, device, model), folder="",
            feat_name=feat_cfg.feat_name, input_kind=INPUT_KIND[model])
        return cls(tester=tester)

    def _summarize(self, pred: np.ndarray, heads) -> dict:
        probs = pred.mean(axis=0)
        label = int(np.argmax(probs))
        out = {"label": label,
               "class_name": CLASS_NAMES[label],
               "probabilities": probs,
               "patch_labels": np.argmax(pred, axis=1)}
        if isinstance(heads, dict):
            out["heads"] = {k: np.asarray(v).mean(axis=0)
                            for k, v in heads.items()}
        return out

    def classify_file(self, wav_path: str) -> dict:
        """Classify one audio file (featurized as the generic 'muspeak'
        class)."""
        pred, heads = self.tester.predict_file("muspeak", sp_path=wav_path)
        return self._summarize(pred, heads)

    def classify_pair(self, speech_path: str, music_path: str,
                      smr_db: float) -> dict:
        """Classify a speech+music mixture rendered at ``smr_db``."""
        pred, heads = self.tester.predict_file("speech_music", speech_path,
                                               music_path, smr_db)
        return self._summarize(pred, heads)

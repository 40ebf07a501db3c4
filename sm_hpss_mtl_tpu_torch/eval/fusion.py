"""Late fusion: the α-blend of two trained models' class posteriors
(counterpart of ``sm_hpss_mtl_tpu/eval/fusion.py``).

A harmonic-feature model and a percussive-feature model are evaluated
file-wise, each through its own ``FileWiseTester``, and their 3C
posteriors combined as ``pred = α·pred_H + (1-α)·pred_P`` (α = 0.5 by
default) over the shorter of the two patch counts before the argmax.
Music files go to the testers as ``mu_path``, every other single file as
``sp_path``, as in the JAX tester of late fusion.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from .metrics import get_performance
from .tester import FileWiseTester


@dataclass
class LateFusionTester:
    tester_h: FileWiseTester   # harmonic-feature model
    tester_p: FileWiseTester   # percussive-feature model
    alpha: float = 0.5

    def _blend(self, classname, sp="", mu="", db=None):
        pred_h, _ = self.tester_h.predict_file(classname, sp, mu, db)
        pred_p, _ = self.tester_p.predict_file(classname, sp, mu, db)
        n = min(len(pred_h), len(pred_p))
        return self.alpha * pred_h[:n] + (1 - self.alpha) * pred_p[:n]

    def test_model(self, test_files: dict, target_db=None):
        """Fused file-wise test of music, speech and the speech+music pairs
        (each at its annotated SMR, or remixed at ``target_db``, which skips
        the single files)."""
        preds, labels, gts = [], [], []
        folder = self.tester_h.folder
        if target_db is None:
            for classname, label in (("music", 0), ("speech", 1)):
                for fl in test_files.get(classname, []):
                    path = os.path.join(folder, classname, fl)
                    if not os.path.exists(path):
                        continue
                    sp, mu = ("", path) if classname == "music" else (path, "")
                    pred = self._blend(classname, sp, mu, None)
                    preds.append(pred)
                    labels.append(np.argmax(pred, axis=1))
                    gts.append(np.full(len(pred), label))
        for pair in test_files.get("speech+music", []):
            sp = os.path.join(folder, "speech", pair["speech"])
            mu = os.path.join(folder, "music", pair["music"])
            if not (os.path.exists(sp) and os.path.exists(mu)):
                continue
            db = pair["SMR"] if target_db is None else target_db
            pred = self._blend("speech_music", sp, mu, db)
            preds.append(pred)
            labels.append(np.argmax(pred, axis=1))
            gts.append(np.full(len(pred), 2))

        pred_labels = np.concatenate(labels)
        ground = np.concatenate(gts)
        conf, p, r, f = get_performance(pred_labels, ground,
                                        list(range(preds[0].shape[1])))
        return {"ConfMat": conf, "precision": p, "recall": r, "fscore": f,
                "PtdLabels": pred_labels, "GroundTruth": ground,
                "Predictions": np.concatenate(preds)}

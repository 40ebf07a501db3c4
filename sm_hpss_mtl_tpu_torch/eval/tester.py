"""File-wise model evaluation and the SMR sweep (counterpart of
``sm_hpss_mtl_tpu/eval/tester.py``).

The reference's test protocol: every test file is featurized (no cache
writes), standardized per row, cut into patches with the reference's test
shift of 68 frames, predicted patch-wise and scored by the argmax of the
3C head; the SMR sweep re-mixes every speech+music pair at each target
level.  Patches of one file go to the model in one call on the
featurizer's device ('image' models in calls of at most
``models.zoo.IMAGE_BATCH_WINDOWS`` patches).  The JAX tester pads each call to a
power of two for XLA's compile cache; in eval mode every patch's output
is independent of the others in its call, so the port does not pad.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..data.batcher import scale_frames, split_dual
from ..data.featurize import Featurizer
from ..models.zoo import IMAGE_BATCH_WINDOWS
from ..ops.patches import extract_patches_np, standardize_rows
from ..ops.stats import skewness_vectors
from .metrics import get_performance


@dataclass
class FileWiseTester:
    featurizer: Featurizer
    #: model call: a tensor of patches on the featurizer's device (a dict of
    #: two with ``dual_tower``) -> a dict of head outputs, or one ``(B, C)``
    #: tensor of class probabilities
    predict_fn: Callable[[torch.Tensor], object]
    folder: str
    feat_name: str
    input_kind: str = "time_mel"
    patch_size: int = 68
    test_patch_shift: int = 68
    frame_level_scaling: bool = False
    fold_stats: tuple | None = None
    skewness_vector: str | None = None
    #: feed the model ``{"harm_input", "perc_input"}``, the two halves of
    #: each patch's features (the intermediate-fusion model)
    dual_tower: bool = False

    def __post_init__(self):
        if self.input_kind not in ("time_mel", "image"):
            raise ValueError(f"unknown input_kind {self.input_kind!r}")

    def file_patches(self, classname: str, sp_path: str = "",
                     mu_path: str = "", target_db=None) -> np.ndarray:
        """One item's test patches: ``(N, patch_size, D)`` for 'time_mel',
        ``(N, D, patch_size, 1)`` for 'image', float32 on the host; with
        ``skewness_vector`` each patch's skewness per row ('Row') or column
        ('Col') in its place, as the batchers do."""
        fv = self.featurizer.featuregram(classname, sp_path, mu_path,
                                         target_db, save_feat=False)
        if self.frame_level_scaling and self.fold_stats is not None:
            fv = scale_frames(fv, *self.fold_stats)
        dual = "HarmPerc" in self.feat_name
        parts = ([fv[:fv.shape[0] // 2], fv[fv.shape[0] // 2:]]
                 if dual else [fv])
        out = []
        for part in parts:
            if not self.frame_level_scaling:
                part = standardize_rows(torch.from_numpy(
                    np.ascontiguousarray(part, np.float32))).numpy()
            out.append(extract_patches_np(part, self.patch_size,
                                          self.test_patch_shift))
        patches = np.concatenate(out, axis=1) if dual else out[0]
        if self.skewness_vector:
            patches = skewness_vectors(torch.from_numpy(np.ascontiguousarray(
                patches, np.float32)), self.skewness_vector).numpy()
        if self.input_kind == "time_mel":
            patches = np.transpose(patches, (0, 2, 1))
        else:
            patches = patches[..., None]
        return np.ascontiguousarray(patches, dtype=np.float32)

    def predict_file(self, classname: str, sp_path: str = "",
                     mu_path: str = "", target_db=None):
        """``(pred, out)``: the 3C probabilities ``(N, C)`` and every head's
        output, as host arrays (``out`` is the dict of heads, or ``pred``
        itself for a single-output model)."""
        patches = torch.from_numpy(self.file_patches(classname, sp_path,
                                                     mu_path, target_db))
        patches = patches.to(self.featurizer.device)
        n = patches.shape[0]
        step = IMAGE_BATCH_WINDOWS if self.input_kind == "image" else n
        with torch.inference_mode():
            outs = [self.predict_fn(split_dual(patches[b0:b0 + step],
                                               self.input_kind)
                                    if self.dual_tower
                                    else patches[b0:b0 + step])
                    for b0 in range(0, n, step)]

        def host(vs):
            return np.concatenate([v.float().cpu().numpy() for v in vs])

        if isinstance(outs[0], dict):
            out = {k: host([o[k] for o in outs]) for k in outs[0]}
            return out["3C"], out
        pred = host(outs)
        return pred, pred

    # ------------------------------------------------------------------
    def test_model(self, test_files: dict, target_db=None,
                   verbose: bool = False):
        """Full test pass.  ``target_db=None`` uses each pair's annotated
        SMR; otherwise every pair is remixed at ``target_db``."""
        preds, labels, gts = [], [], []

        singles = [("music", 0), ("speech", 1)]
        if "speech+noise" in test_files:
            singles.append(("noise", 3))
        if target_db is None:
            for classname, label in singles:
                for fl in test_files.get(classname, []):
                    path = os.path.join(self.folder, classname, fl)
                    if not os.path.exists(path):
                        continue
                    sp, mu = (("", path) if classname != "speech"
                              else (path, ""))
                    pred, _ = self.predict_file(classname, sp, mu, None)
                    preds.append(pred)
                    labels.append(np.argmax(pred, axis=1))
                    gts.append(np.full(len(pred), label))
                    if verbose:
                        acc = np.mean(labels[-1] == label)
                        print(f"{classname} {fl}: {len(pred)} patches "
                              f"acc={acc:.3f}", flush=True)

        pair_specs = [("speech+music", "speech_music", "music", "music", 2)]
        if "speech+noise" in test_files:
            pair_specs.append(("speech+noise", "speech_noise", "noise",
                               "noise", 4))
        for key, classname, pdir, pkey, label in pair_specs:
            for pair in test_files.get(key, []):
                sp = os.path.join(self.folder, "speech", pair["speech"])
                mu = os.path.join(self.folder, pdir, pair[pkey])
                if not (os.path.exists(sp) and os.path.exists(mu)):
                    continue
                db = pair["SMR"] if target_db is None else target_db
                pred, _ = self.predict_file(classname, sp, mu, db)
                preds.append(pred)
                labels.append(np.argmax(pred, axis=1))
                gts.append(np.full(len(pred), label))

        pred_labels = np.concatenate(labels)
        ground = np.concatenate(gts)
        n_classes = preds[0].shape[1]
        conf, precision, recall, fscore = get_performance(
            pred_labels, ground, list(range(n_classes)))
        return {"ConfMat": conf, "precision": precision, "recall": recall,
                "fscore": fscore, "PtdLabels": pred_labels,
                "Predictions": np.concatenate(preds), "GroundTruth": ground}

    def smr_sweep(self, test_files: dict, levels=(-5, 0, 5, 10, 15, 20)):
        """Per-SMR results and pooled 'All' metrics."""
        results = {}
        all_labels, all_gts = [], []
        for db in levels:
            res = self.test_model({"speech+music":
                                   test_files.get("speech+music", [])},
                                  target_db=db)
            results[db] = res
            all_labels.append(res["PtdLabels"])
            all_gts.append(res["GroundTruth"])
        conf, p, r, f = get_performance(np.concatenate(all_labels),
                                        np.concatenate(all_gts),
                                        list(range(3)))
        results["All"] = {"ConfMat": conf, "precision": p, "recall": r,
                          "fscore": f}
        return results

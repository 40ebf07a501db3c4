"""Late-fusion driver: the α-blend of two trained MTL models (counterpart of
``sm_hpss_mtl_tpu/cli/fuse_late.py``, the same flags, plus ``--device``).
Restores a harmonic-feature model and a percussive-feature model from the
port's fold checkpoints (trained by ``cli.mtl --feat-name LogMelHarmSpec``
and ``--feat-name LogMelPercSpec``), tests fold ``--fold`` of
``<data>/cv_info`` with their 3C posteriors blended at ``--alpha``, and
appends the row to ``<output>/Late_Fusion/<model>/Performance.csv``.

    python -m sm_hpss_mtl_tpu_torch.cli.fuse_late --data /path/to/musan \\
        --ckpt-harm H/fold0_ckpt --ckpt-perc P/fold0_ckpt [--device cpu]

A checkpoint is the directory ``train.checkpoint`` writes
(``state/model.npz``, flax keys).  Runs on CUDA unless ``--device cpu`` is
given; without a GPU it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import torch

from ..data.featurize import Featurizer
from ..data.folds import get_train_test_files, load_cv_folds
from ..device import resolve_device
from ..eval.fusion import LateFusionTester
from ..eval.metrics import accuracy
from ..eval.tester import FileWiseTester
from ..models.zoo import get_spec
from ..train.checkpoint import restore_checkpoint
from ..train.config import ExperimentConfig
from ..train.optimizers import for_model
from ..train.state import TrainState, make_predict
from ..utils.results import append_results


def _load_tester(config: ExperimentConfig, model_name: str, feat_name: str,
                 ckpt_dir: str, device: torch.device) -> FileWiseTester:
    """A tester of ``model_name`` on ``feat_name`` features with the weights
    of the checkpoint at ``ckpt_dir``, on ``device``."""
    feat_cfg = dataclasses.replace(config.feature_config(),
                                   feat_name=feat_name)
    # flax sizes the model from the features; the port builds it so.
    spec = get_spec(model_name, n_classes=config.n_classes,
                    dropout_rate=config.dropout_rate,
                    patch_size=config.patch_size, in_dim=feat_cfg.dim)
    model = spec.module.to(device)
    opt, _ = for_model(model_name, model.parameters(), tr_steps=1)
    state, _ = restore_checkpoint(ckpt_dir, TrainState(model, opt))
    predict = make_predict(model)
    return FileWiseTester(
        featurizer=Featurizer(feat_cfg, device=device),
        predict_fn=lambda x: predict(state, x),
        folder=config.data_root, feat_name=feat_name,
        input_kind=config.input_kind, patch_size=config.patch_size,
        test_patch_shift=config.test_patch_shift)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", required=True)
    p.add_argument("--ckpt-harm", required=True)
    p.add_argument("--ckpt-perc", required=True)
    p.add_argument("--model", default="Lemaire_et_al_MTL")
    p.add_argument("--feat-harm", default="LogMelHarmSpec")
    p.add_argument("--feat-perc", default="LogMelPercSpec")
    p.add_argument("--alpha", type=float, default=0.5)
    p.add_argument("--fold", type=int, default=0)
    p.add_argument("--patch-size", type=int, default=68)
    p.add_argument("--output", default="./results")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    config = ExperimentConfig(model=args.model, data_root=args.data,
                              output_dir=args.output,
                              patch_size=args.patch_size)
    cv = load_cv_folds(os.path.join(args.data, "cv_info"))
    _, test_files = get_train_test_files(cv, args.fold)

    fuser = LateFusionTester(
        tester_h=_load_tester(config, args.model, args.feat_harm,
                              args.ckpt_harm, device),
        tester_p=_load_tester(config, args.model, args.feat_perc,
                              args.ckpt_perc, device),
        alpha=args.alpha)
    res = fuser.test_model(test_files)
    row = {"alpha": args.alpha, "accuracy": accuracy(res["ConfMat"])}
    for i, cls in enumerate(["mu", "sp", "spmu"][:res["ConfMat"].shape[0]]):
        row[f"F1_{cls}"] = res["fscore"][i]
    op_dir = os.path.join(args.output, "Late_Fusion", args.model)
    append_results(op_dir, args.fold, row)
    print(row)
    return res


if __name__ == "__main__":
    main()

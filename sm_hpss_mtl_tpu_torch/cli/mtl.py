"""The paper's proposed work: train and test an MTL model on HPSS features
(counterpart of ``sm_hpss_mtl_tpu/cli/mtl.py``, the same flags, plus
``--device``).  ``--model``: ``Lemaire_et_al_MTL`` (default),
``Lemaire_et_al_Cascaded_MTL``, ``Jang_et_al_MTL``,
``Papakostas_et_al_MTL``, ``Doukhan_et_al_MTL``, or a single-task model
(``cli.baseline``'s); the 5-class and intermediate-fusion models have
drivers of their own (``cli.five_class``, ``cli.fuse_intermediate``),
which take these flags.

    python -m sm_hpss_mtl_tpu_torch.cli.mtl --data /path/to/musan \\
        --epochs 50 --folds 0 1 2 [--model Jang_et_al_MTL] [--smr-sweep] \\
        [--frame-level-scaling] [--skewness-vector Row] [--bf16] \\
        [--device cpu]

Runs on CUDA unless ``--device cpu`` is given; without a GPU it raises.
"""

from __future__ import annotations

import argparse

from ..train.config import ExperimentConfig
from .experiment import run_experiment


def build_parser(default_model: str = "Lemaire_et_al_MTL"):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", required=True, help="MUSAN-layout corpus root")
    p.add_argument("--model", default=default_model)
    p.add_argument("--features", default="", help="feature cache dir")
    p.add_argument("--output", default="./results")
    p.add_argument("--folds", type=int, nargs="*", default=None)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--patch-size", type=int, default=68)
    p.add_argument("--patch-shift", type=int, default=68)
    p.add_argument("--n-classes", type=int, default=3)
    p.add_argument("--tr-steps", type=int, default=0,
                   help="override derived steps/epoch (0 = derive)")
    p.add_argument("--v-steps", type=int, default=0)
    p.add_argument("--lr-schedule-steps", type=int, default=0,
                   help="decay horizon for the Lemaire SGD schedule; set "
                        "when overriding --tr-steps to a small value")
    p.add_argument("--no-augment", action="store_true")
    p.add_argument("--smr-sweep", action="store_true")
    p.add_argument("--loss-weights", default=None,
                   help="e.g. 'S:0.5,M:0.5,R:0.5,3C:1.0'")
    p.add_argument("--skewness-vector", choices=["Row", "Col"], default=None,
                   help="feed each patch's skewness per row or column "
                        "(Lemaire models)")
    p.add_argument("--frame-level-scaling", action="store_true",
                   help="scale frames by the fold's corpus statistics "
                        "instead of standardizing rows per file")
    p.add_argument("--bf16", action="store_true",
                   help="mixed-precision compute: bf16 activations and "
                        "products, float32 parameters, BatchNorm statistics "
                        "and loss (flax's dtype rule)")
    p.add_argument("--pipeline", choices=["auto", "host", "device"],
                   default="auto",
                   help="'device' featurizes inside the train step (the "
                        "host streams raw-audio crops); 'host' batches "
                        "patches of whole-file features; 'auto' (default) "
                        "is device on CUDA, host on the CPU")
    p.add_argument("--clip-patches", type=int, default=0,
                   help="device pipeline: patches per sampled clip crop; "
                        "0 (default) adapts to corpus size")
    p.add_argument("--feat-name", default=None,
                   help="override the model preset's featName")
    p.add_argument("--min-crop-s", type=float, default=0.0,
                   help="device pipeline: minimum crop seconds for "
                        "crop-local standardization context")
    p.add_argument("--dft-precision", choices=["bf16x3", "highest"],
                   default="highest",
                   help="fused-frontend DFT precision: 'highest' (the "
                        "port's default, split TF32) or 'bf16x3' (the JAX "
                        "package's default)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p


def config_from_args(args) -> ExperimentConfig:
    lw = None
    if args.loss_weights:
        lw = {k: float(v) for k, v in
              (item.split(":") for item in args.loss_weights.split(","))}
    return ExperimentConfig(
        model=args.model, data_root=args.data, feature_dir=args.features,
        output_dir=args.output, epochs=args.epochs,
        batch_size=args.batch_size, n_classes=args.n_classes,
        patch_size=args.patch_size, patch_shift=args.patch_shift,
        tr_steps=args.tr_steps, v_steps=args.v_steps,
        lr_schedule_steps=args.lr_schedule_steps,
        augment_noise=not args.no_augment, loss_weights=lw,
        pipeline=args.pipeline, clip_patches=args.clip_patches,
        min_crop_s=args.min_crop_s, dft_precision=args.dft_precision,
        feat_name_override=args.feat_name,
        skewness_vector=args.skewness_vector,
        frame_level_scaling=args.frame_level_scaling,
        compute_dtype="bfloat16" if args.bf16 else "float32", seed=args.seed)


def main(argv=None):
    args = build_parser().parse_args(argv)
    results = run_experiment(config_from_args(args), folds=args.folds,
                             smr_sweep=args.smr_sweep, device=args.device)
    for out in results:
        print(f"fold result: {out['row']}")
    return results


if __name__ == "__main__":
    main()

"""5-class driver: music / speech / speech+music / noise / speech+noise
(counterpart of ``sm_hpss_mtl_tpu/cli/five_class.py``, the flags of
``cli.mtl``).  The Lemaire-MTL model with the noise head and the 3-unit
SMNR regression, trained on the folds with the noise class and the
speech+noise pairs (``<data>/cv_info_5_class``, made on first use, or by
``cli.make_folds --with-noise --output <data>/cv_info_5_class``).

    python -m sm_hpss_mtl_tpu_torch.cli.five_class --data /path/to/musan \\
        [--device cpu]

Runs on CUDA unless ``--device cpu`` is given; without a GPU it raises.
"""

from __future__ import annotations

from .experiment import run_experiment
from .mtl import build_parser, config_from_args


def main(argv=None):
    parser = build_parser(default_model="Lemaire_et_al_MTL_5class")
    parser.set_defaults(n_classes=5)
    args = parser.parse_args(argv)
    args.n_classes = 5
    results = run_experiment(config_from_args(args), folds=args.folds,
                             smr_sweep=args.smr_sweep, device=args.device)
    for out in results:
        print(f"fold result: {out['row']}")
    return results


if __name__ == "__main__":
    main()

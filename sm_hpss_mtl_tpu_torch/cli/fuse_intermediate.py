"""Intermediate-fusion driver: twin harmonic and percussive TCN towers
(counterpart of ``sm_hpss_mtl_tpu/cli/fuse_intermediate.py``, the flags of
``cli.mtl``).  The Lemaire-MTL model with a tower per HPSS component,
fused by concatenation before the heads, fed ``{'harm_input',
'perc_input'}`` batches by either pipeline.

    python -m sm_hpss_mtl_tpu_torch.cli.fuse_intermediate \\
        --data /path/to/musan [--pipeline host|device] [--device cpu]

Runs on CUDA unless ``--device cpu`` is given; without a GPU it raises.
"""

from __future__ import annotations

from .experiment import run_experiment
from .mtl import build_parser, config_from_args


def main(argv=None):
    parser = build_parser(default_model="Lemaire_et_al_MTL_IF")
    args = parser.parse_args(argv)
    results = run_experiment(config_from_args(args), folds=args.folds,
                             smr_sweep=args.smr_sweep, device=args.device)
    for out in results:
        print(f"fold result: {out['row']}")
    return results


if __name__ == "__main__":
    main()

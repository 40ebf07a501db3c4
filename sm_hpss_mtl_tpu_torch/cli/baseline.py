"""Baselines: the single-task models on 2- or 3-class MUSAN (counterpart
of ``sm_hpss_mtl_tpu/cli/baseline.py``, the same flags as ``cli.mtl``).
``--model``: ``Lemaire_et_al`` (default), ``Jang_et_al``,
``Papakostas_et_al`` or ``Doukhan_et_al``.

    python -m sm_hpss_mtl_tpu_torch.cli.baseline --data /path/to/musan \\
        --model Jang_et_al --epochs 50 [--device cpu]

Runs on CUDA unless ``--device cpu`` is given; without a GPU it raises.
"""

from __future__ import annotations

from .experiment import run_experiment
from .mtl import build_parser, config_from_args


def main(argv=None):
    args = build_parser(default_model="Lemaire_et_al").parse_args(argv)
    results = run_experiment(config_from_args(args), folds=args.folds,
                             smr_sweep=args.smr_sweep, device=args.device)
    for out in results:
        print(f"fold result: {out['row']}")
    return results


if __name__ == "__main__":
    main()

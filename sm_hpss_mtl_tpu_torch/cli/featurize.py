"""Bulk feature-cache prewarming (counterpart of
``sm_hpss_mtl_tpu/cli/featurize.py``, the same flags, plus ``--device``).

Builds the featuregram cache of a whole corpus up front with batched
featurization (``Featurizer.precompute``: files grouped by length bucket,
up to ``--batch-size`` a launch, on CUDA through K1 or K2), instead of
the lazy per-file computation of a training run's first epoch.  The cache
is ``<features>/<model>/<featName>``, where ``cli.mtl --features`` reads
it.

    python -m sm_hpss_mtl_tpu_torch.cli.featurize --data D --features CACHE \\
        [--model Lemaire_et_al_MTL] [--n-classes 3] [--batch-size 16] \\
        [--device cpu]

Runs on CUDA unless ``--device cpu`` is given; without a GPU it raises.
"""

from __future__ import annotations

import argparse
import os

from ..data.featurize import Featurizer
from ..data.folds import create_cv_folds, load_cv_folds
from ..train.config import ExperimentConfig
from .experiment import class_names_for


def corpus_items(data: str, cv: dict, n_classes: int) -> list[tuple]:
    """Every item of every fold as ``Featurizer.featuregram``'s
    (classname, sp_path, mu_path, target_db) arguments."""
    items = []
    for cls in class_names_for(n_classes):
        for k in range(cv["CV_folds"]):
            for item in cv[cls][f"fold{k}"]:
                if isinstance(item, dict):
                    partner = "music" if "music" in item else "noise"
                    items.append((
                        "speech_music" if partner == "music"
                        else "speech_noise",
                        os.path.join(data, "speech", item["speech"]),
                        os.path.join(data, partner, item[partner]),
                        item["SMR"]))
                elif cls == "speech":
                    items.append(("speech", os.path.join(data, "speech",
                                                         item), "", None))
                else:
                    items.append((cls, "", os.path.join(data, cls, item),
                                  None))
    return items


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", required=True)
    p.add_argument("--features", required=True)
    p.add_argument("--model", default="Lemaire_et_al_MTL")
    p.add_argument("--n-classes", type=int, default=3)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    config = ExperimentConfig(model=args.model, data_root=args.data,
                              n_classes=args.n_classes)
    feat_cfg = config.feature_config()
    cache = os.path.join(args.features, args.model, feat_cfg.feat_name)
    fz = Featurizer(feat_cfg, cache_dir=cache, device=args.device)

    with_noise = args.n_classes == 5
    cv_path = os.path.join(args.data,
                           "cv_info_5_class" if with_noise else "cv_info")
    if os.path.exists(os.path.join(cv_path, "cv_file_list.pkl")):
        cv = load_cv_folds(cv_path)
    else:
        cv = create_cv_folds(args.data, with_noise=with_noise)
    items = corpus_items(args.data, cv, args.n_classes)
    done = fz.precompute(items, batch_size=args.batch_size, verbose=True)
    print(f"computed {done} new featuregrams "
          f"({len(items) - done} already cached) -> {cache}")
    return done


if __name__ == "__main__":
    main()

"""Optional dataset balancing (counterpart of
``sm_hpss_mtl_tpu/data/balance.py``; the reference's
``misc.preprocess_data``, ``lib/misc.py:42-54``).

The reference rebalances flattened feature matrices with imblearn's
SMOTEENN.  As in the JAX package, ``balance_data`` uses it when it is
importable and otherwise oversamples the minority classes to parity from
a seeded numpy generator (neither machine of this port has imblearn, so
that is the rule they run).  The balanced streaming batcher makes this
path rarely needed: it serves the reference's array-level workflows.
"""

from __future__ import annotations

import numpy as np


def balance_data(train_data: np.ndarray, train_label: np.ndarray,
                 seed: int = 0):
    """Return class-balanced (data, labels)."""
    try:
        from imblearn.combine import SMOTEENN  # optional dependency
        smote_enn = SMOTEENN(sampling_strategy=1.0)
        return smote_enn.fit_resample(train_data, train_label)
    except ImportError:
        pass
    rng = np.random.default_rng(seed)
    labels = np.asarray(train_label).ravel()
    classes, counts = np.unique(labels, return_counts=True)
    target = counts.max()
    idx_parts = []
    for cls, cnt in zip(classes, counts):
        idx = np.nonzero(labels == cls)[0]
        if cnt < target:
            extra = rng.choice(idx, target - cnt, replace=True)
            idx = np.concatenate([idx, extra])
        idx_parts.append(idx)
    order = rng.permutation(np.concatenate(idx_parts))
    return train_data[order], labels[order]

"""Classification metrics matching ``misc.getPerformance`` of the
reference, in numpy (counterpart of ``sm_hpss_mtl_tpu/eval/metrics.py``,
which calls scikit-learn): confusion matrix and per-class precision,
recall and F1 rounded to 4 places, 0 where a denominator is 0."""

from __future__ import annotations

import numpy as np


def get_performance(pred_labels, ground_truth, labels):
    truth = np.asarray(ground_truth).ravel()
    pred = np.asarray(pred_labels).ravel()
    conf = np.array([[np.sum((truth == t) & (pred == p)) for p in labels]
                     for t in labels], dtype=np.int64)
    tp = np.diag(conf).astype(np.float64)
    pred_pos = conf.sum(axis=0).astype(np.float64)
    true_pos = conf.sum(axis=1).astype(np.float64)

    def ratio(num, den):
        return np.divide(num, den, out=np.zeros_like(num), where=den > 0)

    precision = ratio(tp, pred_pos)
    recall = ratio(tp, true_pos)
    fscore = ratio(2 * tp, pred_pos + true_pos)
    return (conf, np.round(precision, 4), np.round(recall, 4),
            np.round(fscore, 4))


def accuracy(conf: np.ndarray) -> float:
    return float(np.round(np.sum(np.diag(conf)) / max(np.sum(conf), 1), 4))

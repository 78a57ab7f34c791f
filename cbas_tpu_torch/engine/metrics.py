"""Scientific metrics: classification reports and confusion matrices.

A numpy copy of ``cbas_tpu/engine/metrics.py``, which wraps scikit-learn.
The card's machine has no scikit-learn, and training reports every epoch, so
the port computes the same report itself: ``classification_report(...,
output_dict=True, zero_division=0, labels=range(C))`` and ``confusion_matrix``
with the same keys, values and averages (a test holds it equal to
scikit-learn's, zero-division classes included).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


class PerformanceReport:
    """Per-epoch train/val report pair (as ``cbas_tpu.engine.metrics``)."""

    def __init__(
        self,
        train_report: dict,
        train_cm: np.ndarray,
        val_report: dict,
        val_cm: np.ndarray,
    ):
        self.train_report = train_report
        self.train_cm = train_cm
        self.val_report = val_report
        self.val_cm = val_cm


def _divide(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """num / den, 0 where den is 0 (scikit-learn's ``zero_division=0``)."""
    num = np.asarray(num, np.float64)
    den = np.asarray(den, np.float64)
    return np.divide(num, den, out=np.zeros_like(num), where=den != 0)


def _scores(tp, pred, true):
    precision = _divide(tp, pred)
    recall = _divide(tp, true)
    f1 = _divide(2 * tp, true + pred)
    return precision, recall, f1


def report_and_cm(
    y_true: Sequence[int], y_pred: Sequence[int], behaviors: Sequence[str]
) -> tuple[dict, np.ndarray]:
    """(report dict, confusion matrix) over labels ``0..len(behaviors)-1``."""
    y_true = np.asarray(y_true, np.int64)
    y_pred = np.asarray(y_pred, np.int64)
    C = len(behaviors)
    cm = np.zeros((C, C), np.int64)
    keep = (y_true >= 0) & (y_true < C) & (y_pred >= 0) & (y_pred < C)
    np.add.at(cm, (y_true[keep], y_pred[keep]), 1)

    tp = np.diag(cm)
    true = np.array([(y_true == c).sum() for c in range(C)], np.int64)
    pred = np.array([(y_pred == c).sum() for c in range(C)], np.int64)
    precision, recall, f1 = _scores(tp, pred, true)
    support = int(true.sum())

    rep: dict = {}
    for c, name in enumerate(behaviors):
        rep[name] = {
            "precision": float(precision[c]), "recall": float(recall[c]),
            "f1-score": float(f1[c]), "support": float(true[c]),
        }
    # scikit-learn names the micro average "accuracy" when the labels cover
    # every class present, and keeps only its precision.
    micro = _scores(tp.sum(), pred.sum(), true.sum())
    present = set(np.unique(np.concatenate([y_true, y_pred])).tolist())
    if present <= set(range(C)):
        rep["accuracy"] = float(micro[0])
    else:
        rep["micro avg"] = dict(zip(
            ("precision", "recall", "f1-score", "support"),
            [float(v) for v in micro] + [float(support)],
        ))
    weights = true if true.sum() > 0 else None
    for name, w in (("macro avg", None), ("weighted avg", weights)):
        rep[name] = {
            "precision": float(np.average(precision, weights=w)),
            "recall": float(np.average(recall, weights=w)),
            "f1-score": float(np.average(f1, weights=w)),
            "support": float(support),
        }
    return rep, cm


def f1_of(report: dict, target: str) -> float:
    return float(report.get(target, {}).get("f1-score", -1.0))

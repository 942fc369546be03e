"""Classification metrics (host-side numpy; no sklearn dependency on the hot
path); the port's copy of ``kstar_tpu/train/metrics.py``. Matches the reference's evaluation definitions: macro-F1 over the
argmax/thresholded predictions, ROC-AUC on the disruption probability
p = softmax(logits)[:, 0] (reference src/evaluate.py:56-87)."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def softmax_np(logits: np.ndarray) -> np.ndarray:
    z = logits - logits.max(axis=-1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=-1, keepdims=True)


def confusion_matrix(labels: np.ndarray, preds: np.ndarray, n_classes: int = 2) -> np.ndarray:
    cm = np.zeros((n_classes, n_classes), dtype=np.int64)
    np.add.at(cm, (labels.astype(int), preds.astype(int)), 1)
    return cm


def f1_per_class(cm: np.ndarray) -> np.ndarray:
    tp = np.diag(cm).astype(np.float64)
    fp = cm.sum(axis=0) - tp
    fn = cm.sum(axis=1) - tp
    denom = 2 * tp + fp + fn
    return np.where(denom > 0, 2 * tp / np.maximum(denom, 1), 0.0)


def macro_f1(labels: np.ndarray, preds: np.ndarray, n_classes: int = 2) -> float:
    """Macro-averaged F1 (sklearn f1_score(average='macro') semantics)."""
    cm = confusion_matrix(labels, preds, n_classes)
    return float(f1_per_class(cm).mean())


def accuracy(labels: np.ndarray, preds: np.ndarray) -> float:
    return float((labels == preds).mean()) if len(labels) else 0.0


def roc_curve(y_true: np.ndarray, score: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """ROC for the positive class (y_true == 1 means positive here; callers
    pass y_true = (label == 0) with score = p_disrupt)."""
    order = np.argsort(-score, kind="stable")
    y = y_true[order].astype(np.float64)
    s = score[order]
    tps = np.cumsum(y)
    fps = np.cumsum(1 - y)
    # keep threshold boundaries only
    distinct = np.r_[np.where(np.diff(s))[0], len(s) - 1]
    tps, fps = tps[distinct], fps[distinct]
    P = max(y.sum(), 1e-12)
    N = max(len(y) - y.sum(), 1e-12)
    tpr = np.r_[0.0, tps / P]
    fpr = np.r_[0.0, fps / N]
    thr = np.r_[np.inf, s[distinct]]
    return fpr, tpr, thr


def roc_auc(y_true: np.ndarray, score: np.ndarray) -> float:
    if len(np.unique(y_true)) < 2:
        return float("nan")
    fpr, tpr, _ = roc_curve(y_true, score)
    return float(np.trapezoid(tpr, fpr))


def precision_recall_curve(y_true: np.ndarray, score: np.ndarray):
    order = np.argsort(-score, kind="stable")
    y = y_true[order].astype(np.float64)
    tps = np.cumsum(y)
    fps = np.cumsum(1 - y)
    precision = tps / np.maximum(tps + fps, 1e-12)
    recall = tps / max(y.sum(), 1e-12)
    return np.r_[1.0, precision], np.r_[0.0, recall]


def threshold_predict(probs_disrupt: np.ndarray, threshold: float = 0.5) -> np.ndarray:
    """Reference prediction rule (src/evaluate.py:56-57): predict
    disruptive (0) iff p_disrupt > threshold, else normal (1)."""
    return np.where(probs_disrupt > threshold, 0, 1)


def classification_report(labels: np.ndarray, preds: np.ndarray,
                          n_classes: int = 2) -> Dict[str, Dict[str, float]]:
    """Per-class precision/recall/F1/support (sklearn-style dict)."""
    cm = confusion_matrix(labels, preds, n_classes)
    tp = np.diag(cm).astype(np.float64)
    fp = cm.sum(axis=0) - tp
    fn = cm.sum(axis=1) - tp
    prec = tp / np.maximum(tp + fp, 1e-12)
    rec = tp / np.maximum(tp + fn, 1e-12)
    f1 = f1_per_class(cm)
    names = {0: "disruption", 1: "normal"}
    rep = {}
    for c in range(n_classes):
        rep[names.get(c, str(c))] = {
            "precision": float(prec[c]), "recall": float(rec[c]),
            "f1-score": float(f1[c]), "support": int(cm[c].sum()),
        }
    rep["macro avg"] = {
        "precision": float(prec.mean()), "recall": float(rec.mean()),
        "f1-score": float(f1.mean()), "support": int(cm.sum()),
    }
    rep["accuracy"] = float(tp.sum() / max(cm.sum(), 1))
    return rep

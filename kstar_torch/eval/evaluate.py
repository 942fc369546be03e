"""Test-set evaluation with threshold-based prediction and reports.

Port of ``kstar_tpu/eval/evaluate.py`` (rebuild of reference
src/evaluate.py): disruption probability is ``softmax(logits)[:, 0]``; a
sample is predicted *normal* unless p_disrupt > threshold (reference :56-57,
:76); metrics are macro-F1, ROC-AUC, the confusion matrix and a
sklearn-style classification report, rendered as text. The 2x2 matplotlib
figure (``evaluation_figure``) and ``evaluate_detail`` come with the viz
port (ROADMAP.md Queue 1 item 15).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..losses import ldam_margins
from ..train import metrics as M


def evaluate_probs(
    probs: np.ndarray,      # (N, 2) softmax probabilities
    labels: np.ndarray,     # (N,) 0=disrupt / 1=normal
    threshold: float = 0.5,
) -> Dict:
    """Compute the reference metric set from collected eval probabilities."""
    probs = np.nan_to_num(probs)
    p_disrupt = probs[:, 0]
    preds = M.threshold_predict(p_disrupt, threshold)

    cm = M.confusion_matrix(labels, preds)
    f1 = M.macro_f1(labels, preds)
    acc = M.accuracy(labels, preds)
    # positive class for ROC = disruptive (label 0)
    y_true = (labels == 0).astype(int)
    auc = M.roc_auc(y_true, p_disrupt)
    report = M.classification_report(labels, preds)
    fpr, tpr, _ = M.roc_curve(y_true, p_disrupt)
    prec, rec = M.precision_recall_curve(y_true, p_disrupt)

    return {
        "threshold": threshold,
        "macro_f1": f1,
        "accuracy": acc,
        "roc_auc": auc,
        "confusion": cm,
        "report": report,
        "roc": (fpr, tpr),
        "pr": (prec, rec),
        "p_disrupt": p_disrupt,
        "preds": preds,
        "labels": labels,
    }


def evaluate(model, dataset, loss_cfg, batch_size: int = 128,
             threshold: float = 0.5, save_txt: Optional[str] = None,
             put=None, pre_fn=None) -> Dict:
    """Full test loop (reference evaluate, src/evaluate.py:11-137) on the
    model's device. ``put`` moves raw batches to the device (default: as
    they are) and ``pre_fn`` preprocesses them there (e.g. the eval half of
    ``data.augment.make_pre_fns`` for uint8 video)."""
    from ..train.loop import make_eval_step, run_eval_epoch

    device = next(model.parameters()).device
    eval_step = make_eval_step(loss_cfg, pre_fn=pre_fn)
    counts = dataset.class_counts()
    w = torch.ones(len(counts), device=device)
    m = torch.as_tensor(ldam_margins(counts, loss_cfg.ldam_max_m)).to(device)

    loss, _, _, (probs, labels) = run_eval_epoch(
        eval_step, model, dataset, batch_size, w, m, put=put, collect_probs=True)

    results = evaluate_probs(probs, labels, threshold)
    results["test_loss"] = loss

    if save_txt:
        os.makedirs(os.path.dirname(os.path.abspath(save_txt)), exist_ok=True)
        with open(save_txt, "w") as f:
            f.write(format_report(results))
    return results


def format_report(results: Dict) -> str:
    rep = results["report"]
    lines = [
        f"threshold : {results['threshold']:.2f}",
        f"macro F1  : {results['macro_f1']:.4f}",
        f"accuracy  : {results['accuracy']:.4f}",
        f"ROC-AUC   : {results['roc_auc']:.4f}",
        "",
        f"{'class':<12}{'precision':>10}{'recall':>10}{'f1':>10}{'support':>10}",
    ]
    for name in ("disruption", "normal", "macro avg"):
        r = rep[name]
        lines.append(f"{name:<12}{r['precision']:>10.4f}{r['recall']:>10.4f}"
                     f"{r['f1-score']:>10.4f}{r['support']:>10d}")
    cm = results["confusion"]
    lines += ["", "confusion matrix (rows=true, cols=pred; 0=disrupt,1=normal):",
              str(cm)]
    return "\n".join(lines)

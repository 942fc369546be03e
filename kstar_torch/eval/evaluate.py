"""Test-set evaluation with threshold-based prediction, reports and figures.

Port of ``kstar_tpu/eval/evaluate.py`` (rebuild of reference
src/evaluate.py): disruption probability is ``softmax(logits)[:, 0]``; a
sample is predicted *normal* unless p_disrupt > threshold (reference :56-57,
:76); metrics are macro-F1, ROC-AUC, the confusion matrix and a
sklearn-style classification report, rendered as text and as one 2x2
matplotlib figure (reference :89-122); ``evaluate_detail`` dumps one row
per sample of named splits.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

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
             put=None, pre_fn=None, model_type: str = "single",
             save_fig: Optional[str] = None, mesh=None) -> Dict:
    """Full test loop (reference evaluate, src/evaluate.py:11-137) on the
    model's device. ``put`` moves raw batches to the device (default: as
    they are) and ``pre_fn`` preprocesses them there (e.g. the eval half of
    ``data.augment.make_pre_fns`` for uint8 video). ``model_type`` as in
    ``train.loop.make_eval_step`` (a ``"multi-GB"`` model is scored on its
    multi logits, with zero blending weights as JAX's). ``save_fig`` writes
    ``evaluation_figure``. ``mesh``: data-parallel (``put`` defaults to this
    rank's rows); every rank returns the results, rank 0 alone writes."""
    from ..train.loop import make_eval_step, run_eval_epoch

    device = next(model.parameters()).device
    eval_step = make_eval_step(loss_cfg, pre_fn=pre_fn, model_type=model_type, mesh=mesh)
    counts = dataset.class_counts()
    w = torch.ones(len(counts), device=device)
    m = torch.as_tensor(ldam_margins(counts, loss_cfg.ldam_max_m)).to(device)

    loss, _, _, (probs, labels) = run_eval_epoch(
        eval_step, model, dataset, batch_size, w, m, put=put, collect_probs=True,
        gb_w=torch.zeros(3, device=device), mesh=mesh)

    results = evaluate_probs(probs, labels, threshold)
    results["test_loss"] = loss
    if mesh is not None and not mesh.is_main:
        return results

    if save_txt:
        os.makedirs(os.path.dirname(os.path.abspath(save_txt)), exist_ok=True)
        with open(save_txt, "w") as f:
            f.write(format_report(results))
    if save_fig:
        fig = evaluation_figure(results)
        os.makedirs(os.path.dirname(os.path.abspath(save_fig)), exist_ok=True)
        fig.savefig(save_fig)
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


def evaluation_figure(results: Dict):
    """2x2 figure: confusion heatmap, ROC, PR, report table
    (reference src/evaluate.py:89-122 / evaluate_tensorboard :140-240)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 2, figsize=(12, 10))

    cm = results["confusion"]
    ax = axes[0][0]
    ax.imshow(cm, cmap="Blues")
    for i in range(2):
        for j in range(2):
            ax.text(j, i, str(cm[i, j]), ha="center", va="center",
                    color="white" if cm[i, j] > cm.max() / 2 else "black")
    ax.set_xticks([0, 1], ["disrupt", "normal"])
    ax.set_yticks([0, 1], ["disrupt", "normal"])
    ax.set_xlabel("predicted"); ax.set_ylabel("true")
    ax.set_title(f"confusion (F1={results['macro_f1']:.3f})")

    fpr, tpr = results["roc"]
    ax = axes[0][1]
    ax.plot(fpr, tpr)
    ax.plot([0, 1], [0, 1], "k--", lw=0.5)
    ax.set_xlabel("FPR"); ax.set_ylabel("TPR")
    ax.set_title(f"ROC (AUC={results['roc_auc']:.3f})")

    prec, rec = results["pr"]
    ax = axes[1][0]
    ax.plot(rec, prec)
    ax.set_xlabel("recall"); ax.set_ylabel("precision")
    ax.set_title("precision-recall")

    ax = axes[1][1]
    ax.axis("off")
    ax.text(0.0, 0.5, format_report(results), family="monospace", fontsize=8,
            va="center")
    fig.tight_layout()
    return fig


def evaluate_detail(model, datasets: Dict[str, Tuple], loss_cfg,
                    batch_size: int = 128, threshold: float = 0.5,
                    model_type: str = "single", save_csv: Optional[str] = None,
                    put=None, pre_fn=None):
    """Per-sample dump over named splits with shot numbers -> rows
    (task, label, shot, pred, tag) for per-shot error analysis
    (reference evaluate_detail, src/evaluate.py:242-350)."""
    import pandas as pd

    rows = []
    for task, ds in datasets.items():
        res = evaluate(model, ds, loss_cfg, batch_size, threshold, put=put,
                       pre_fn=pre_fn, model_type=model_type)
        shots = getattr(ds, "shot_ids", np.zeros(len(ds), np.int64))
        for label, shot, pred in zip(res["labels"], shots, res["preds"]):
            tag = "correct" if label == pred else ("missing" if label == 0 else "false alarm")
            rows.append({"task": task, "label": int(label), "shot": int(shot),
                         "pred": int(pred), "tag": tag})
    df = pd.DataFrame(rows)
    if save_csv:
        os.makedirs(os.path.dirname(os.path.abspath(save_csv)), exist_ok=True)
        df.to_csv(save_csv, index=False)
    return df

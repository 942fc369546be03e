"""Permutation feature importance for 0D models.

Port of ``kstar_tpu/eval/feature_importance.py`` (rebuild of reference
src/feature_importance.py): for each input feature, shuffle that column of
the dataset's table, re-evaluate, and report
``FI = |loss_permuted - loss_orig| / loss_orig`` (reference :96-113). The
permutations are drawn with numpy from ``seed``, column after column, as
the JAX function draws them, so both packages shuffle the same rows;
``plot_feature_importance`` draws the bar plot.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..config import Schema
from ..losses import ldam_margins


def compute_permute_feature_importance(
    model, dataset, loss_cfg,
    batch_size: int = 256,
    seed: int = 42,
    save_fig: Optional[str] = None,
) -> Dict[str, float]:
    """Returns {feature_name: importance} over ``dataset`` (a TSDataset),
    evaluated on the model's device."""
    from ..train.loop import make_eval_step, run_eval_epoch

    device = next(model.parameters()).device
    eval_step = make_eval_step(loss_cfg)
    counts = dataset.class_counts()
    w = torch.ones(len(counts), device=device)
    m = torch.as_tensor(ldam_margins(counts, loss_cfg.ldam_max_m)).to(device)

    def run() -> float:
        return run_eval_epoch(eval_step, model, dataset, batch_size, w, m)[0]

    loss_orig = run()
    rng = np.random.default_rng(seed)
    data = dataset.table.data
    results: Dict[str, float] = {}
    for j, col in enumerate(dataset.cols):
        original = data[:, j].copy()
        try:
            data[:, j] = original[rng.permutation(len(original))]
            loss_perm = run()
        finally:
            # the table is shared state: restore the column even on an error
            data[:, j] = original
        results[col] = abs(loss_perm - loss_orig) / max(abs(loss_orig), 1e-12)

    if save_fig:
        plot_feature_importance(results, save_fig)
    return results


def plot_feature_importance(importance: Dict[str, float], save_path: str) -> None:
    """Horizontal bar plot with display names (reference :115-134)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    names = [Schema.FEATURE_MAP.get(k, k.lstrip("\\")) for k in importance]
    vals = list(importance.values())
    order = np.argsort(vals)
    fig, ax = plt.subplots(figsize=(8, 0.4 * len(names) + 2))
    ax.barh([names[i] for i in order], [vals[i] for i in order])
    ax.set_xlabel("feature importance |dLoss|/Loss")
    ax.set_title("permutation feature importance")
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
    fig.savefig(save_path)
    plt.close(fig)

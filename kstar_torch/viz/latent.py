"""Latent-space visualization (port of ``kstar_tpu/viz/latent.py``, a
rebuild of reference src/visualization/visualize_latent_space.py): collect
``encode`` latents over a dataset on the model's device, project to 2/3D
with PCA or t-SNE, scatter colored by class; the multimodal variant plots
fusion/video/0D panels side by side."""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch


def collect_latents(model, dataset, batch_size: int = 128,
                    multimodal: bool = False,
                    put=None) -> Tuple[np.ndarray, np.ndarray, Optional[Dict]]:
    """Run ``encode`` over the dataset on the model's device. Returns
    (latents, labels, extras); for multimodal models extras = {'video': ...,
    '0D': ...}.

    ``put``: a (batch, labels) -> (device batch, labels) eval preprocessor
    (``data.DevicePreprocessor(train=False)``: crop + mean-subtract +
    dtype). REQUIRED for raw-uint8 video datasets — encoding unpreprocessed
    pixels yields out-of-distribution latents; 0D datasets are already
    scaled and may omit it."""
    from ..data.loader import eval_batches, to_device

    device = next(model.parameters()).device
    model.eval()
    hs, labels, h_vis_all, h_ts_all = [], [], [], []
    with torch.no_grad():
        for idx, mask in eval_batches(len(dataset), batch_size):
            batch, y = dataset.batch(idx)
            if put is not None:
                batch, y = put((batch, y))
            else:
                batch = to_device(batch, device)
            if multimodal:
                vid = batch["video"] if put is not None else batch["video"].float()
                h, h_vis, h_ts = model.encode(vid, batch["0D"])
                h_vis_all.append(h_vis.float().cpu().numpy()[mask])
                h_ts_all.append(h_ts.float().cpu().numpy()[mask])
            else:
                h = model.encode(batch if put is not None else batch.float())
            hs.append(h.float().cpu().numpy()[mask])
            labels.append(np.asarray(y.cpu() if isinstance(y, torch.Tensor) else y)[mask])

    extras = None
    if multimodal:
        extras = {"video": np.concatenate(h_vis_all), "0D": np.concatenate(h_ts_all)}
    return np.concatenate(hs), np.concatenate(labels), extras


def project(latents: np.ndarray, method: str = "pca", dim: int = 2,
            seed: int = 42) -> np.ndarray:
    """PCA (incremental-equivalent) or t-SNE projection."""
    if method == "tsne":
        from sklearn.manifold import TSNE

        return TSNE(n_components=dim, random_state=seed,
                    init="pca", perplexity=min(30, max(len(latents) // 4, 2))
                    ).fit_transform(latents)
    from sklearn.decomposition import PCA

    return PCA(n_components=dim, random_state=seed).fit_transform(latents)


def _scatter(ax, z, labels, title, dim):
    colors = np.where(labels == 0, "crimson", "royalblue")
    if dim == 3:
        ax.scatter(z[:, 0], z[:, 1], z[:, 2], c=colors, s=4, alpha=0.6)
    else:
        ax.scatter(z[:, 0], z[:, 1], c=colors, s=4, alpha=0.6)
    ax.set_title(title, fontsize=9)


def visualize_latent_space(model, dataset, method: str = "pca",
                           dim: int = 2, batch_size: int = 128,
                           save_path: Optional[str] = None, put=None):
    """2D/3D latent scatter (reference visualize_2D/3D_latent_space :12-57)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    h, labels, _ = collect_latents(model, dataset, batch_size, put=put)
    z = project(h, method, dim)
    fig = plt.figure(figsize=(6, 5))
    ax = fig.add_subplot(111, projection="3d" if dim == 3 else None)
    _scatter(ax, z, labels, f"latent ({method}, {dim}D) red=disrupt", dim)
    fig.tight_layout()
    if save_path:
        os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
        fig.savefig(save_path)
    return fig


def visualize_latent_space_multi(model, dataset, method: str = "pca",
                                 dim: int = 2, batch_size: int = 64,
                                 save_path: Optional[str] = None, put=None):
    """Fusion/video/0D panel scatter (reference
    visualize_2D_latent_space_multi :59-148)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    h, labels, extras = collect_latents(model, dataset, batch_size,
                                        multimodal=True, put=put)
    fig = plt.figure(figsize=(15, 5))
    for i, (name, lat) in enumerate([("fusion", h), ("video", extras["video"]),
                                     ("0D", extras["0D"])]):
        z = project(lat, method, dim)
        ax = fig.add_subplot(1, 3, i + 1, projection="3d" if dim == 3 else None)
        _scatter(ax, z, labels, f"{name} latent", dim)
    fig.tight_layout()
    if save_path:
        os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
        fig.savefig(save_path)
    return fig

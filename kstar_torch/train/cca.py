"""Deep CCA training for multimodal encoder alignment (port of
``kstar_tpu/train/cca.py``, a rebuild of reference src/CCA.py).

The fusion model's ``encode`` gives the two modality latents, and the
negative total canonical correlation between them (``losses.cca_loss``) is
minimised by its own loop (reference train_cca :178-222), to pre-align the
video and 0D latent spaces before fusion fine-tuning. ``encode`` runs in
evaluation mode, so there is no dropout, no input noise and no BatchNorm
statistics update; a non-finite loss zeroes the gradients, and the update
(optimizer moments, count, AdamW's decay) is applied all the same, as the
JAX step does.

On a mesh the CCA loss stays the global batch's: its covariances run over
the batch axis, so both encodings are all-gathered over the data group
(differentiably: each rank's backward keeps its rows) before ``cca_loss``,
every rank computes the same loss, and the gradients are summed over the
group.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..data.loader import epoch_batches
from ..losses import cca_loss
from ..parallel.comm import all_reduce_, gather_rows
from .loop import default_puts
from .state import TrainState


def make_cca_step(out_dim: int, use_all_singular_values: bool = False, mesh=None):
    """step(state, batch) -> (state, loss) for a fusion model exposing
    ``encode``: maximises the canonical correlation between the latents
    (on a ``mesh``, of the global batch)."""

    def step(state: TrainState, batch):
        for p in state.params:
            p.grad = None
        _, h_vis, h_ts = state.model.encode(batch["video"], batch["0D"])
        if mesh is not None:
            d, i = mesh.shape["data"], mesh.data_index
            h_vis = gather_rows(h_vis, mesh.data_group, i, d)
            h_ts = gather_rows(h_ts, mesh.data_group, i, d)
        loss = cca_loss(h_vis, h_ts, out_dim, use_all_singular_values)
        loss.backward()
        loss = loss.detach()
        with torch.no_grad():
            grads = state.flat_grads()
            if mesh is not None:
                all_reduce_(grads, mesh.data_group)
            grads = torch.where(torch.isfinite(loss), grads, torch.zeros_like(grads))
        state.apply_gradients(torch.ones((), dtype=torch.bool, device=state.device), None,
                              grads)
        return state, loss

    return step


def train_cca(state: TrainState, train_ds, batch_size: int = 32, n_epochs: int = 8,
              out_dim: int = 16, seed: int = 42, put=None,
              mesh=None) -> Tuple[TrainState, list]:
    """CCA pre-training loop (reference train_cca, src/CCA.py:178-222):
    returns the state and the mean loss of each epoch. ``put`` moves a host
    (batch, labels) pair to the device (e.g. ``DevicePreprocessor``, which
    also crops and normalises the video); default: a plain upload to the
    state's device, on a ``mesh`` of this rank's rows."""
    put = put or default_puts(state.device, mesh)[0]
    step = make_cca_step(out_dim, mesh=mesh)
    rng = np.random.default_rng(seed)
    losses = []
    for _ in range(n_epochs):
        total, n = 0.0, 0
        for idx in epoch_batches(len(train_ds), batch_size, rng):
            batch, _ = train_ds.batch(idx)
            batch, _ = put((batch, np.zeros(len(idx))))
            state, loss = step(state, batch)
            total += float(loss)
            n += 1
        losses.append(total / max(n, 1))
    return state, losses

"""Sub-batch BatchNorm and the multigrid long-cycle helpers.

Port of ``kstar_tpu/models/subbn.py`` (rebuild of the reference's
SubBatchNorm3d, src/models/resnet.py:11-61, and
``update_bn_splits_long_cycle``, :267-273). In training the batch
statistics are computed over ``num_splits`` interleaved sub-batches: sample
``a * s + g`` belongs to split ``g``, which ``reshape(n // s, s, ...)``
gives (``torch.chunk`` would give contiguous splits instead). Each split
keeps its own running statistics by torch's BatchNorm rule, and
``aggregate_batch_stats`` folds them into the one (mean, var) pair that
evaluation normalises with, by the law of total variance.

The module's buffers carry flax's ``batch_stats`` names through
``weights.state_dict_from_flax``: ``split_mean``/``split_var`` (s, C) as
they are, ``mean``/``var`` as ``running_mean``/``running_var``. Every
update writes into the buffers in place (``copy_``), because
``TrainState`` rebinds them as views of its flat statistics buffer, which
the NaN guard restores.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import torch
from torch import nn

from ..parallel.comm import current_mesh, data_size, reduce_data


class SubBatchNorm(nn.Module):
    """Channels-last SubBatchNorm (reference SubBatchNorm3d semantics).

    Train: each of the ``num_splits`` interleaved sub-batches is normalised
    with its own biased batch statistics, mean((x - mu)^2); the per-split
    running statistics move by ``(1 - m) * old + m * new`` with m = 0.1 and
    the UNBIASED variance, count = (n / s) * prod(spatial). Eval: the
    aggregated ``running_mean``/``running_var`` normalise. f32 arithmetic;
    the output is cast back to the input's dtype.

    In a data-parallel step the splits are those of the global batch: with
    contiguous rank slices whose size ``num_splits`` divides, local row j is
    global row ``rank * n + j``, in split j mod s as on one device, so the
    per-split sums (of x, then of the squared deviations) are summed over
    the data group, differentiably."""

    def __init__(self, features: int, num_splits: int = 1, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.num_splits, self.momentum, self.eps = num_splits, momentum, eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("split_mean", torch.zeros(num_splits, features))
        self.register_buffer("split_var", torch.ones(num_splits, features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        xf = x.float()
        if train:
            n, c, s = xf.shape[0], xf.shape[-1], self.num_splits
            if n % s:
                raise ValueError(
                    f"batch {n} not divisible by num_splits {s}" if current_mesh() is None
                    else f"this rank's batch {n} (the global batch over the data axis) "
                         f"is not divisible by num_splits {s}")
            spatial = tuple(xf.shape[1:-1])
            # (n, *spatial, c) -> (n // s, s, *spatial, c): index g of the
            # second axis holds samples g, s + g, 2s + g, ...
            xg = xf.reshape((n // s, s) + spatial + (c,))
            red = (0,) + tuple(range(2, 2 + len(spatial)))
            if current_mesh() is None:
                mean = xg.mean(red, keepdim=True)
                var = torch.square(xg - mean).mean(red, keepdim=True)
            else:
                per_split = n // s * math.prod(spatial) * data_size()
                mean = reduce_data(xg.sum(red, keepdim=True) / per_split)
                var = reduce_data(torch.square(xg - mean).sum(red, keepdim=True) / per_split)
            out = ((xg - mean) / torch.sqrt(var + self.eps)).reshape(xf.shape)
            with torch.no_grad():
                count = (n // s) * math.prod(spatial) * data_size()
                unbiased = var.reshape(s, c) * (count / max(count - 1, 1))
                m = self.momentum
                self.split_mean.copy_((1.0 - m) * self.split_mean + m * mean.reshape(s, c))
                self.split_var.copy_((1.0 - m) * self.split_var + m * unbiased)
        else:
            out = (xf - self.running_mean) / torch.sqrt(self.running_var + self.eps)
        out = out * self.weight + self.bias
        return out.to(x.dtype)

    @torch.no_grad()
    def aggregate_stats(self) -> None:
        """Fold the split statistics into ``running_mean``/``running_var``
        (reference ``aggregate_stats``), in place."""
        mean, var = _aggregate(self.split_mean, self.split_var)
        self.running_mean.copy_(mean)
        self.running_var.copy_(var)

    @torch.no_grad()
    def reset_splits(self, new_splits: int) -> None:
        """Fresh split statistics at ``new_splits`` (zeros/ones), keeping the
        affine parameters and the aggregated statistics. The buffers change
        shape, so a ``TrainState`` holding them re-flattens
        (``TrainState.reset_bn_splits``)."""
        c = self.split_mean.shape[-1]
        dev = self.split_mean.device
        self.num_splits = new_splits
        self.split_mean = torch.zeros(new_splits, c, device=dev)
        self.split_var = torch.ones(new_splits, c, device=dev)


def _aggregate(split_mean: torch.Tensor, split_var: torch.Tensor):
    """mean = split means averaged; var = split variances averaged + the
    variance of the split means (no Bessel correction, as the reference's
    ``_get_aggregated_mean_std``). The split axis is -2."""
    mean = split_mean.mean(-2)
    var = split_var.mean(-2) + torch.square(split_mean - mean.unsqueeze(-2)).mean(-2)
    return mean, var


def aggregate_batch_stats(model: nn.Module) -> nn.Module:
    """Aggregate every SubBatchNorm of ``model`` in place (the tree-level
    form of JAX's ``aggregate_batch_stats``); the ``fit(eval_stats_fn=)``
    hook that runs after each train epoch. Returns the model."""
    for m in model.modules():
        if isinstance(m, SubBatchNorm):
            m.aggregate_stats()
    return model


def aggregate_subbn_stats(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The functional form over a ``state_dict``: a new dict whose
    ``running_mean``/``running_var`` are aggregated wherever a module
    carries ``split_mean``/``split_var`` (a checkpoint's ``model`` entry,
    say); every other entry is passed through."""
    out = dict(state_dict)
    for key in state_dict:
        if key.endswith(".split_mean") or key == "split_mean":
            prefix = key[: -len("split_mean")]
            out[prefix + "running_mean"], out[prefix + "running_var"] = _aggregate(
                state_dict[prefix + "split_mean"], state_dict[prefix + "split_var"])
    return out


def reset_bn_splits_long_cycle(model: nn.Module, new_splits: int) -> nn.Module:
    """Multigrid long-cycle step (reference ``update_bn_splits_long_cycle``):
    every SubBatchNorm of ``model`` gets fresh split statistics at
    ``new_splits``, keeping its affine parameters and aggregated statistics.
    A model inside a ``TrainState`` goes through
    ``TrainState.reset_bn_splits``, which also re-flattens the statistics.
    Returns the model."""
    for m in model.modules():
        if isinstance(m, SubBatchNorm):
            m.reset_splits(new_splits)
    return model

"""Shared building blocks of the 0D and conv video models.

Port of ``kstar_tpu/models/common.py``. Layouts are channels-last, (B, T, F)
and (B, T, H, W, C), as in the JAX package; ``dtype`` is the compute dtype,
parameters and normalisation statistics stay f32, and logits come out f32.

Two pieces follow flax's rules rather than torch's defaults:

  * ``BatchNorm`` is flax's ``nn.BatchNorm(dtype=float32)``: statistics over
    every axis but the last, the biased variance computed as
    E[x^2] - E[x]^2 (clamped at 0), eps 1e-5, and the running update
    ``0.99 * ra + 0.01 * batch`` (``torch.nn.BatchNorm1d`` weights the batch
    by 0.1 and keeps the unbiased variance);
  * ``BiLSTM`` trains exactly flax's ``OptimizedLSTMCell`` parameters: per
    layer and direction ``w_ih`` (4H, in), ``w_hh`` (4H, H) and ONE bias
    (4H), gates packed i, f, g, o. The recurrence runs in ``torch.lstm``
    (cuDNN on the GPU) with the hidden-side bias slot fed a zero constant,
    so the effective bias is not trained twice over. It runs in f32 whatever
    the compute dtype: on the H100 build measured (torch 2.11, CUDA 12.8)
    cuDNN runs a bf16 ``torch.lstm`` step by step, a GEMM and a cell kernel
    per time step and direction, where an f32 one runs as one persistent
    kernel per layer and direction (``chip_smoke.py`` phase ``ts_models``
    times both).

The conv stacks route their activations through ``act_leaky_relu`` and
``act_relu``. While ``GUIDED_BACKPROP[0]`` is set (``viz.xai.guided_backprop``
sets it and restores it), both run ``GuidedLeakyReLU``: the same forward,
and a backward that passes the upstream gradient only where the input and
the gradient are both positive (the reference's GuidedBackpropReLU). The
switch is read at each call; this is eager PyTorch, so no traced or cached
program can keep the guided rule after the switch is cleared (the JAX
module reads its switch at trace time and must keep it away from jit).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.modules.module import _global_forward_hooks

from ..ops import bn_act as epilogue
from ..parallel.comm import current_mesh, data_size, draw_rows, gather_rows, reduce_data
from .vivit import Dense, LayerNorm, _lecun_normal_

BN_MOMENTUM = 0.99      # flax nn.BatchNorm defaults
BN_EPS = 1e-5


class NoiseLayer(nn.Module):
    """Train-only additive Gaussian input noise (reference
    src/models/NoiseLayer.py:5-16). The draw comes from ``generator`` (on
    ``x``'s device), never from torch's global RNG (in a data-parallel
    step, this rank's rows of the global batch's draw)."""

    def __init__(self, mean: float = 0.0, std: float = 1e-3):
        super().__init__()
        self.mean, self.std = mean, std

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not train or self.std == 0.0:
            return x
        if generator is None:
            raise ValueError("input noise in training draws from an explicit "
                             "torch.Generator; pass noise_generator=")
        noise = draw_rows(lambda shape: torch.randn(
            shape, generator=generator, device=x.device, dtype=x.dtype), x.shape)
        return x + self.mean + self.std * noise


def apply_act(x: torch.Tensor, act: str, alpha: float = 1.0) -> torch.Tensor:
    if act == "elu":
        return F.elu(x) if alpha == 1.0 else torch.where(x > 0, x, alpha * torch.expm1(x))
    if act == "relu":
        return F.relu(x)
    if act == "leaky_relu":
        return F.leaky_relu(x, negative_slope=alpha)
    if act == "gelu":
        return gelu_tanh(x)         # flax nn.gelu defaults to the tanh form
    raise ValueError(act)


# Set by viz.xai.guided_backprop(): the conv stacks' activations then take
# the guided-backprop backward (reference GuidedBackpropReLU,
# src/visualization/visualize_cam.py:21-54). Read at every call.
GUIDED_BACKPROP = [False]


class GuidedLeakyReLU(torch.autograd.Function):
    """Leaky ReLU whose backward is the guided-backprop rule
    ``g * (x > 0) * (g > 0)``; with ``alpha = 0`` it is exactly the
    reference's guided ReLU."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, alpha: float) -> torch.Tensor:
        ctx.save_for_backward(x)
        return torch.where(x > 0, x, alpha * x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (x,) = ctx.saved_tensors
        return g * (x > 0).to(g.dtype) * (g > 0).to(g.dtype), None


def guided_leaky_relu(x: torch.Tensor, alpha: float = 0.01) -> torch.Tensor:
    return GuidedLeakyReLU.apply(x, alpha)


def act_leaky_relu(x: torch.Tensor, alpha: float) -> torch.Tensor:
    """The conv stacks' LeakyReLU (R(2+1)D), guided-backprop-aware."""
    if GUIDED_BACKPROP[0]:
        return guided_leaky_relu(x, alpha)
    return F.leaky_relu(x, negative_slope=alpha)


def act_relu(x: torch.Tensor) -> torch.Tensor:
    """The conv stacks' ReLU (3D ResNet, SlowFast), guided-backprop-aware
    (the reference's GuidedBackpropReLUModel swaps every ReLU,
    visualize_cam.py:57-66)."""
    if GUIDED_BACKPROP[0]:
        return guided_leaky_relu(x, 0.0)
    return F.relu(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximated GELU (reference src/models/transformer.py:35-37)."""
    return F.gelu(x, approximate="tanh")


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(dtype=float32)`` over channels-last input: in
    training, batch statistics over every axis but the last (biased
    variance, E[x^2] - E[x]^2 clamped at 0) normalise the batch and move the
    running buffers by ``0.99 * ra + 0.01 * batch``; in evaluation the
    running buffers normalise. Arithmetic and output in f32 whatever the
    input dtype. ``running_mean``/``running_var`` are flax's
    ``batch_stats`` ``mean``/``var``. In a data-parallel step the batch
    statistics are those of the global batch: the sums of x and x^2 are
    summed over the data group (differentiably), so every rank normalises
    alike and keeps the same running buffers."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool = False, alpha: Optional[float] = None,
                out_dtype: Optional[torch.dtype] = None,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The f32 normalised ``x``. Given ``alpha`` (evaluation only), the
        conv epilogue instead: LeakyReLU, the cast to ``out_dtype`` and, with
        ``residual``, the residual join, in one kernel pass
        (``ops/bn_act.py``, CUDA only); ``bn_leaky_relu`` chooses between
        the two. The epilogue's arguments come through this call, and not
        around the module, so that the forward pre-hooks that read or set
        the running statistics from the conv output (``calibrate_bn``) fire
        on both routes."""
        if alpha is not None:
            if train:
                raise ValueError("BatchNorm: the fused epilogue is for evaluation")
            mul = torch.rsqrt(self.running_var + BN_EPS) * self.weight
            return epilogue.bn_act(x, self.running_mean, mul, self.bias, alpha, out_dtype,
                                   residual)
        x = x.float()
        if train:
            axes = tuple(range(x.dim() - 1))
            if current_mesh() is None:
                mean, mean2 = x.mean(axes), (x * x).mean(axes)
            else:
                n = x.numel() // x.shape[-1] * data_size()
                mean, mean2 = reduce_data(torch.stack([x.sum(axes), (x * x).sum(axes)]) / n)
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.copy_(BN_MOMENTUM * self.running_mean
                                        + (1 - BN_MOMENTUM) * mean)
                self.running_var.copy_(BN_MOMENTUM * self.running_var
                                       + (1 - BN_MOMENTUM) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        return (x - mean) * mul + self.bias


def bn_leaky_relu(bn: BatchNorm, x: torch.Tensor, train: bool, alpha: float,
                  dtype: torch.dtype, residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A conv output's epilogue: ``bn``, LeakyReLU, the cast to ``dtype``;
    with ``residual``, then LeakyReLU(residual + that) in ``dtype`` (a
    residual block's join). The one-pass kernel (``ops/bn_act.py``), through
    ``bn``'s own call so that its forward pre-hooks fire, wherever it
    computes the same thing: evaluation, no guided backprop, no forward hook
    on ``bn`` to see its f32 output, and bf16 on a CUDA device with no
    gradient to record (``takes``). A strided input or residual is made
    contiguous for it; one the kernel still refuses raises. Else the eager
    chain, counted in ``bn_act.eager``."""
    if (train or GUIDED_BACKPROP[0] or bn._forward_hooks or _global_forward_hooks
            or not epilogue.takes(x, residual, dtype, (bn.weight, bn.bias))):
        epilogue.bn_act.eager += 1
        return epilogue.act_join(bn(x, train), partial(act_leaky_relu, alpha=alpha), dtype,
                                 residual)
    return bn(x.contiguous(), train, alpha=alpha, out_dtype=dtype,
              residual=None if residual is None else residual.contiguous())


class Conv1d(nn.Module):
    """flax ``nn.Conv`` over (B, T, C): kernel cast to ``dtype``, the
    product in ``dtype`` and the bias added in ``dtype``. ``weight`` is
    (out, in, k) as in ``torch.nn.Conv1d``; ``padding`` is ``"SAME"``,
    ``"VALID"`` or the symmetric pad of each end. flax initialisation:
    lecun-normal over fan-in k * in, zero bias."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int = 1, padding="VALID", dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel, self.stride, self.dtype = kernel, stride, dtype
        if padding == "SAME":
            if stride != 1:
                raise ValueError("SAME padding is ported for stride 1 only")
            self.pad = ((kernel - 1) // 2, kernel // 2)
        elif padding == "VALID":
            self.pad = (0, 0)
        else:
            self.pad = (int(padding), int(padding))
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel))
        _lecun_normal_(self.weight.data, in_channels * kernel, generator)
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def out_len(self, t: int) -> int:
        return (t + sum(self.pad) - self.kernel) // self.stride + 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).transpose(1, 2)
        if any(self.pad):
            x = F.pad(x, self.pad)
        y = F.conv1d(x, self.weight.to(self.dtype), stride=self.stride)
        return (y + self.bias.to(self.dtype)[:, None]).transpose(1, 2)


class Conv3d(nn.Module):
    """flax ``nn.Conv`` over channels-last (B, T, H, W, C) clips with
    explicit symmetric ``padding`` (pt, ph, pw) (``kstar_tpu/models/
    r2plus1d.py _sym``): kernel cast to ``dtype``, the product in
    ``dtype``, the bias (if any) added in ``dtype``. ``weight`` is (out,
    in, kt, kh, kw) as in ``torch.nn.Conv3d``. flax initialisation:
    lecun-normal over fan-in kt * kh * kw * in, zero bias.

    The input's NDHWC layout is the ``channels_last_3d`` memory format of
    the (B, C, T, H, W) view that ``conv3d`` takes, so the permutes are
    free and cuDNN runs channels-last; the output is NDHWC again. A
    1 x 1 x 1 kernel (none is padded) runs as the strided input times the
    kernel in one GEMM over the channel axis, as fast as ``conv3d`` on an
    H100 (``python -m kstar_torch.analysis.cudnn_conv``); with it bf16
    SlowFast's single-window stream steps match its 16-window blocks to
    1e-3 in probability on that card, where through ``conv3d`` they parted
    by 0.8 (its bf16 forward amplifies a rounding-level difference)."""

    def __init__(self, in_channels: int, out_channels: int, kernel, stride=(1, 1, 1),
                 padding=(0, 0, 0), bias: bool = False, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel, self.stride = tuple(kernel), tuple(stride)
        self.padding, self.dtype = tuple(padding), dtype
        self.pointwise = self.kernel == (1, 1, 1) and not any(self.padding)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, *self.kernel))
        _lecun_normal_(self.weight.data, in_channels * int(np.prod(self.kernel)), generator)
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.pointwise:
            st, sh, sw = self.stride
            y = F.linear(x[:, ::st, ::sh, ::sw], self.weight.flatten(1).to(self.dtype))
        else:
            w = self.weight.to(self.dtype, memory_format=torch.channels_last_3d)
            y = F.conv3d(x.permute(0, 4, 1, 2, 3), w, stride=self.stride,
                         padding=self.padding).permute(0, 2, 3, 4, 1)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


def max_pool3d(x: torch.Tensor, window, stride, padding) -> torch.Tensor:
    """flax ``nn.max_pool`` over channels-last (B, T, H, W, C) with explicit
    symmetric padding: padded positions count as -inf, as in
    ``F.max_pool3d``."""
    return F.max_pool3d(x.permute(0, 4, 1, 2, 3), window, stride,
                        padding).permute(0, 2, 3, 4, 1)


class MLPHead(nn.Module):
    """``Dense -> Norm -> act -> Dense`` classification head of the
    reference classifiers; the last Dense and the output in f32."""

    def __init__(self, in_features: int, hidden: int, n_classes: int = 2,
                 norm: str = "batch", act: str = "elu", alpha: float = 1.0,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act, self.alpha, self.norm_kind = act, alpha, norm
        self.fc1 = Dense(in_features, hidden, dtype=dtype, generator=generator)
        self.norm = BatchNorm(hidden) if norm == "batch" else LayerNorm(hidden)
        self.fc2 = Dense(hidden, n_classes, generator=generator)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = self.fc1(x)
        x = self.norm(x, train) if self.norm_kind == "batch" else self.norm(x)
        return self.fc2(apply_act(x, self.act, self.alpha)).float()


class SqueezeExcite1D(nn.Module):
    """Squeeze-and-excitation over (B, T, C) (reference SqueezeExciteBlock,
    src/models/MLSTM_FCN.py:17-32): two bias-free Dense layers, the sigmoid
    in f32."""

    def __init__(self, channels: int, reduction: int = 16,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        mid = max(channels // reduction, 1)
        self.Dense_0 = Dense(channels, mid, bias=False, dtype=dtype, generator=generator)
        self.Dense_1 = Dense(mid, channels, bias=False, dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.Dense_1(F.relu(self.Dense_0(x.mean(dim=1))))
        s = torch.sigmoid(s.float()).to(x.dtype)
        return x * s[:, None, :]


class AttentionPool(nn.Module):
    """Self-attention pooling over LSTM outputs (reference CnnLSTM.attention,
    src/models/CnnLSTM.py:72-75): ``A = softmax(w_s2(tanh(w_s1(H))))`` over
    the HIDDEN axis (a reference quirk kept for parity), then
    ``mean_d(A^T H)``."""

    def __init__(self, in_features: int, hidden_dim: int,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.w_s1 = Dense(in_features, hidden_dim, dtype=dtype, generator=generator)
        self.w_s2 = Dense(hidden_dim, hidden_dim, dtype=dtype, generator=generator)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        a = self.w_s2(torch.tanh(self.w_s1(h)))
        a = torch.softmax(a.float(), dim=-1).to(h.dtype)          # (B, T, d)
        return torch.einsum("btd,bte->bde", a, h).mean(dim=1)     # (B, D_out)


class LSTMCellParams(nn.Module):
    """The trainable parameters of one flax ``OptimizedLSTMCell``: the input
    kernels ``ii|if|ig|io`` stacked as ``w_ih`` (4H, in), the recurrent
    kernels ``hi|hf|hg|ho`` as ``w_hh`` (4H, H), and their one bias (4H).
    flax initialisation: lecun-normal input kernels, an orthogonal (H, H)
    block per recurrent gate, zero bias. Split over a model group (``tp``,
    ``parallel/tp.py``), ``w_ih``/``w_hh`` hold this rank's rows and
    ``full`` all-gathers them for the recurrence."""

    tp = None

    def __init__(self, in_features: int, hidden: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.w_ih = nn.Parameter(torch.empty(4 * hidden, in_features))
        _lecun_normal_(self.w_ih.data, in_features, generator)
        self.w_hh = nn.Parameter(torch.empty(4 * hidden, hidden))
        for gate in self.w_hh.data.chunk(4):
            nn.init.orthogonal_(gate, generator=generator)
        self.bias = nn.Parameter(torch.zeros(4 * hidden))

    def full(self, name: str) -> torch.Tensor:
        w = getattr(self, name)
        if self.tp is None or name not in self.tp.names:
            return w
        return gather_rows(w, self.tp.group, self.tp.rank, self.tp.size)


class BiLSTM(nn.Module):
    """Bidirectional LSTM over (B, T, F) returning (B, T, 2 * hidden) (or
    (B, T, hidden) unidirectional), from a zero carry (reference
    src/models/CnnLSTM.py:96-98). Cell ``OptimizedLSTMCell_{l * ndir + d}``
    holds layer l, direction d (1 = reversed in time, outputs kept in
    order), flax's names. The recurrence and the output are f32 whatever
    the model's compute dtype (see the module docstring); flax's output is
    f32 too (its carry is)."""

    def __init__(self, in_features: int, hidden: int, n_layers: int = 1,
                 bidirectional: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden, self.n_layers, self.bidirectional = hidden, n_layers, bidirectional
        ndir = 2 if bidirectional else 1
        for layer in range(n_layers):
            for d in range(ndir):
                self.add_module(f"OptimizedLSTMCell_{layer * ndir + d}", LSTMCellParams(
                    in_features if layer == 0 else hidden * ndir, hidden, generator))
        # torch.lstm's hidden-side bias slot: a constant, never trained
        self.register_buffer("_zero_bias", torch.zeros(4 * hidden), persistent=False)

    def lstm_weights(self) -> list:
        """The cells' weights in ``torch.lstm``'s order: per layer and
        direction w_ih, w_hh, the bias, and the zero constant."""
        weights = []
        for cell in self.children():
            weights += [cell.full("w_ih"), cell.full("w_hh"), cell.bias, self._zero_bias]
        return weights

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ndir = 2 if self.bidirectional else 1
        h0 = torch.zeros(self.n_layers * ndir, x.shape[0], self.hidden, device=x.device)
        # train=True keeps cuDNN's training-mode workspace for a backward;
        # it has no other effect here (no dropout between layers)
        out, _, _ = torch.lstm(x.float(), (h0, h0), self.lstm_weights(), True, self.n_layers,
                               0.0, torch.is_grad_enabled(), self.bidirectional, True)
        return out


def sinusoidal_positions(max_len: int, d_model: int) -> torch.Tensor:
    """Sinusoidal positional table (max_len, d_model) with the reference's
    odd-dimension handling (reference PositionalEncoding,
    src/models/transformer.py:10-33): f32, computed in numpy as the JAX
    package does."""
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float32) * -(np.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div)
    cos = np.cos(position * div)
    pe[:, 1::2] = cos[:, :-1] if d_model % 2 != 0 else cos
    return torch.from_numpy(pe)


import dataclasses

import torch

from .cnn_lstm import CnnLSTM
from .fusion import TFN, TFNGB, MultiModalConcat, MultiModalGB
from .mlstm_fcn import MLSTMFCN
from .r2plus1d import R2Plus1DClassifier, R2Plus1DNet
from .resnet3d import Bottleneck3D, ResStage
from .slowfast import SlowFast, SlowFastEncoder
from .subbn import (SubBatchNorm, aggregate_batch_stats, aggregate_subbn_stats,
                    reset_bn_splits_long_cycle)
from .ts_transformer import Transformer0D, TransformerEncoder0D
from .vivit import ViViT, ViViTEncoder


def build_0d_model(name: str, cfg, dtype=None, generator=None):
    """0D model factory (reference train_0D_network.py:222-265 dispatch).
    ``generator`` seeds the initialisation."""
    kwargs = dataclasses.asdict(cfg)
    if dtype is not None:
        kwargs["dtype"] = dtype
    models = {"Transformer": Transformer0D, "CnnLSTM": CnnLSTM, "MLSTM_FCN": MLSTMFCN}
    if name not in models:
        raise ValueError(f"unknown 0D model: {name}")
    return models[name](**kwargs, generator=generator)


def build_video_model(name: str, cfg, dtype=None, generator=None):
    """Video model factory (reference train_vision_network.py:226-263
    dispatch). ``generator`` seeds the initialisation."""
    kwargs = dataclasses.asdict(cfg)
    if dtype is not None:
        kwargs["dtype"] = dtype
    if name == "ViViT":
        kwargs.pop("alpha", None)
        nd = kwargs.pop("norm_dtype", "float32")
        kwargs["norm_dtype"] = (nd if isinstance(nd, torch.dtype)
                                else getattr(torch, {"bf16": "bfloat16"}.get(nd, nd)))
        return ViViT(**kwargs, generator=generator)
    if name == "R2Plus1D":
        return R2Plus1DClassifier(**kwargs, generator=generator)
    if name == "SlowFast":
        return SlowFast(**kwargs, generator=generator)
    raise ValueError(f"unknown video model: {name}")

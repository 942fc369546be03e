import dataclasses

import torch

from .cnn_lstm import CnnLSTM
from .fusion import TFN, TFNGB, MultiModalConcat, MultiModalGB
from .mlstm_fcn import MLSTMFCN
from .ts_transformer import Transformer0D, TransformerEncoder0D
from .vivit import ViViT, ViViTEncoder

# models of kstar_tpu/models/ not ported yet, with the ROADMAP.md Queue 1
# item that ports them
_NOT_PORTED = {
    "R2Plus1D": "Queue 1 item 11 (conv video models)",
    "SlowFast": "Queue 1 item 11 (conv video models)",
}


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
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"video model {name!r} is not ported to kstar_torch yet: "
            f"ROADMAP.md {_NOT_PORTED[name]}")
    raise ValueError(f"unknown video model: {name}")

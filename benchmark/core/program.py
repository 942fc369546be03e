"""The system under test, built from the benchmark's weights.

The model is built on the meta device (no initialisation draws) and given
copies of the weights the benchmark made. What the program derives from
them at set-up (BatchNorm statistics here; K1's packed weights inside its
sweeper) is the program's own.
"""

from __future__ import annotations

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_model(cfg: dict, image_size: int, weights: dict, device):
    from kstar_torch import config as kcfg
    from kstar_torch.models import build_video_model

    fields = dict(cfg["program_config"], image_size=image_size)
    model_cfg = getattr(kcfg, cfg["program_config_class"])(**fields)
    with torch.device("meta"):
        model = build_video_model(cfg["model"], model_cfg, dtype=DTYPES[cfg["compute_dtype"]])
    model.load_state_dict({k: v.detach().clone() for k, v in weights.items()},
                          strict=True, assign=True)
    return model.to(device)


def normalise(clips_u8: torch.Tensor, cfg: dict) -> torch.Tensor:
    """uint8 BGR clips less the port's channel means, in the compute dtype."""
    from kstar_torch.config import PIXEL_MEAN_BGR

    mean = torch.tensor(PIXEL_MEAN_BGR, device=clips_u8.device)
    return (clips_u8.float() - mean).to(DTYPES[cfg["compute_dtype"]])


@torch.no_grad()
def calibrate_bn(model, clips: torch.Tensor) -> None:
    """Each backbone BatchNorm's running statistics set to those of its own
    input in one eval forward of ``clips``, layer after layer (as
    ``chip_smoke.py calibrate_bn`` does), so random weights see O(1)
    activations; the head's BatchNorm keeps zeros and ones."""
    from kstar_torch.models.common import BatchNorm, MLPHead

    heads = {id(m.norm) for m in model.modules() if isinstance(m, MLPHead)}

    def pre(mod, args):
        x = args[0].float()
        axes = tuple(range(x.dim() - 1))
        mod.running_mean.copy_(x.mean(axes))
        mod.running_var.copy_(x.var(axes, unbiased=False))

    hooks = [m.register_forward_pre_hook(pre) for m in model.modules()
             if isinstance(m, BatchNorm) and id(m) not in heads]
    model.eval()(clips)
    for h in hooks:
        h.remove()

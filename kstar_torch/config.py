"""Configuration: KSTAR signal schema + structured experiment configs.

The PyTorch port's own copy of ``kstar_tpu/config.py`` (stdlib only), kept
so that ``kstar_torch`` imports nothing of the JAX package. Replaces the
reference's static ``Config`` class (reference src/config.py:1-87) and the
argparse blocks duplicated across its entry scripts with dataclasses.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


# ---------------------------------------------------------------------------
# KSTAR MDSplus signal schema (reference src/config.py)
# ---------------------------------------------------------------------------

class Schema:
    """KSTAR diagnostic signal names grouped by subsystem."""

    TS_AVG_COLS = ["\\TS_NE_CORE_AVG", "\\TS_NE_EDGE_AVG", "\\TS_TE_CORE_AVG", "\\TS_TE_EDGE_AVG"]

    STATE_FIXED = 42

    DEFAULT_COLS = ["\\q95", "\\ipmhd", "\\kappa", "\\tritop", "\\tribot", "\\betap", "\\li", "\\rsurf", "\\aminor"]

    # lock-mode detection
    LM = ["\\LM01", "\\LM02", "\\LM03", "\\LM04"]

    # halo current monitoring
    HCM = (
        [f"\\HCMIL{i:02d}" for i in range(1, 17)]
        + [f"\\HCMID{i:02d}" for i in range(1, 9)]
        + [f"\\HCMCD{i:02d}" for i in range(1, 17)]
        + [f"\\HCMOD{i:02d}" for i in range(1, 9)]
    )

    # diamagnetic loop
    DL = ["\\BETAP_DLM03", "\\DMF_DLM03", "\\DLM01", "\\DLM02", "\\DLM03", "\\WTOT_DLM03"]

    # flux loop / loop voltage
    LV = ["\\LV01", "\\LV12", "\\LV23", "\\LV34", "\\LV45"]

    # Rogowski coil
    RC = ["\\RC03", "\\VCM03", "\\RCPPU1", "\\RCPPU2:FOO", "\\RCPPU2B:FOO", "\\RCPPL1", "\\RCPPL2B:FOO"]

    # TCI line-integrated density
    TCI = ["\\ne_inter01", "\\ne_tci01", "\\ne_tci02", "\\ne_tci03", "\\ne_tci04", "\\ne_tci05"]

    # Thomson scattering Te / Ne, core + edge channels
    TS_TE_CORE_COLS = [f"\\TS_CORE{i}:CORE{i}_TE" for i in range(1, 15)]
    TS_TE_EDGE_COLS = [f"\\TS_EDGE{i}:EDGE{i}_TE" for i in range(1, 15)]
    TS_NE_CORE_COLS = [f"\\TS_CORE{i}:CORE{i}_NE" for i in range(1, 15)]
    TS_NE_EDGE_COLS = [f"\\TS_EDGE{i}:EDGE{i}_NE" for i in range(1, 15)]
    TS = TS_TE_CORE_COLS + TS_TE_EDGE_COLS + TS_NE_CORE_COLS + TS_NE_EDGE_COLS

    # H-alpha
    HA = [f"\\TOR_HA{i:02d}" for i in range(0, 21)] + [f"\\POL_HA{i:02d}" for i in range(0, 11)]

    EXCEPT_COLS = [
        "\\TOR_HA00", "\\POL_HA00", "\\HCMIL09", "\\HCMIL10", "\\HCMIL11", "\\HCMIL02", "\\HCMIL04", "\\HCMIL05",
        "\\RCPPU2:FOO", "\\RCPPU2B:FOO", "\\RCPPL2B:FOO", "\\DLM02", "\\TS_CORE13:CORE13_TE", "\\TS_CORE14:CORE14_TE",
        "\\TS_EDGE13:EDGE13_TE", "\\TS_EDGE14:EDGE14_TE", "\\TS_CORE13:CORE13_NE", "\\TS_CORE14:CORE14_NE",
        "\\TS_EDGE13:EDGE13_NE", "\\TS_EDGE14:EDGE14_NE", "\\q0", "\\ne_tci01", "\\ne_tci02", "\\ne_tci03",
        "\\ne_tci04", "\\ne_tci05", "\\bcentr",
    ]

    # Thomson radial positions (m)
    CORE_RADIUS = [1.797, 1.818, 1.841, 1.862, 1.884, 1.908, 1.931, 1.954, 1.979, 2.004, 2.03, 2.056, 2.082, 2.108]
    EDGE_RADIUS = [2.108, 2.120, 2.133, 2.146, 2.153, 2.171, 2.183, 2.190, 2.197, 2.203, 2.209, 2.216, 2.229, 2.243]
    RADIUS = CORE_RADIUS + EDGE_RADIUS[1:]

    # the 18 model input features (reference src/config.py:57-61)
    INPUT_FEATURES = [
        "\\q95", "\\RC03", "\\kappa", "\\tritop", "\\tribot", "\\rsurf", "\\aminor",
        "\\BETAP_DLM03", "\\li", "\\WTOT_DLM03", "\\ne_inter01", "\\ne_nG_ratio", "\\Iv",
        "\\TS_NE_CORE_AVG", "\\TS_TE_CORE_AVG", "\\TS_TE_EDGE_AVG", "\\TS_NE_EDGE_AVG", "\\bcentr",
    ]

    # display-name map for feature-importance plots (reference src/config.py:64-87)
    FEATURE_MAP = {
        "\\q95": "q95",
        "\\ipmhd": "Ip",
        "\\kappa": "kappa",
        "\\tritop": "tri-top",
        "\\tribot": "tri-bot",
        "\\BETAP_DLM03": "betap",
        "\\betan": "betan",
        "\\li": "li",
        "\\WTOT_DLM03": "W-tot",
        "\\ne_inter01": "Ne-line",
        "\\TS_NE_CORE_AVG": "Ne-core",
        "\\TS_TE_CORE_AVG": "Te-core",
        "\\TS_NE_EDGE_AVG": "Ne-edge",
        "\\TS_TE_EDGE_AVG": "Te-edge",
        "\\nG": "N-Greenwald",
        "\\ne_nG_ratio": "NG ratio",
        "\\DLM03": "DLM03",
        "\\RC03": "Ip",
        "\\Iv": "Iv",
        "\\rsurf": "Rc",
        "\\aminor": "a",
        "\\bcentr": "B",
    }


# KSTAR IVIS camera frame rate (fps); 0D sample periods used by the reference
FPS = 210.0
DT_0D = 4.0 / 210.0      # 0D-only table period  (reference "extend" csv)
DT_MULTI = 1.0 / 210.0   # multimodal table period (reference "5ms" csv)

# per-pixel BGR mean subtracted at normalization (reference src/dataset.py:201-205)
PIXEL_MEAN_BGR = (90.0, 98.0, 102.0)


# ---------------------------------------------------------------------------
# Structured configs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class WindowConfig:
    """Sliding-window / labeling parameters shared by all three datasets."""
    seq_len: int = 21
    dist: int = 3
    dt: float = DT_0D
    tau: int = 1  # temporal subsampling (multimodal only)


@dataclass(frozen=True)
class AugmentConfig:
    """Batched on-device augmentation parameters (reference DEFAULT_AUGMENTATION_ARGS,
    src/dataset.py:12-25, with entry-script overrides train_vision_network.py:52-63)."""
    bright_val: int = 10
    bright_p: float = 0.25
    contrast_min: float = 1.0
    contrast_max: float = 1.25
    contrast_p: float = 0.25
    blur_k: int = 5
    blur_p: float = 0.25
    flip_p: float = 0.25
    vertical_ratio: float = 0.1
    vertical_p: float = 0.25
    horizontal_ratio: float = 0.1
    horizontal_p: float = 0.25


@dataclass(frozen=True)
class VideoConfig:
    resize: int = 256
    crop_size: int = 128        # reference uses image_size=128 for training crops
    in_channels: int = 3


@dataclass(frozen=True)
class ViViTConfig:
    image_size: int = 128
    patch_size: int = 16
    n_frames: int = 21
    n_classes: int = 2
    dim: int = 128
    depth: int = 2
    n_heads: int = 4
    d_head: int = 64
    scale_dim: int = 8
    dropout: float = 0.1
    embedd_dropout: float = 0.1
    pool: str = "cls"
    in_channels: int = 3
    alpha: float = 1.0
    # LN / attention-softmax accumulation dtype: "float32" (parity default)
    # or "bfloat16" (measured +4.6% on the train step — PERFORMANCE.md)
    norm_dtype: str = "float32"


@dataclass(frozen=True)
class R2Plus1DConfig:
    image_size: int = 128
    n_frames: int = 21
    n_classes: int = 2
    layer_sizes: Tuple[int, ...] = (1, 2, 2, 1)
    alpha: float = 0.01
    in_channels: int = 3


@dataclass(frozen=True)
class SlowFastConfig:
    image_size: int = 128
    n_frames: int = 20          # must be divisible by alpha (SlowFast even-seq fixup)
    n_classes: int = 2
    layers: Tuple[int, ...] = (3, 4, 6, 3)
    alpha: int = 4              # tau_slow / tau_fast ratio
    tau_fast: int = 1
    in_channels: int = 3
    base_width: int = 16        # "m" in the reference backbone (src/models/resnet.py:208)
    # SubBatchNorm split count for multigrid training; None = plain BN, the
    # reference's effective default (src/models/slowfast.py:108-109)
    base_bn_splits: Optional[int] = None


@dataclass(frozen=True)
class TransformerConfig:
    n_features: int = 18
    kernel_size: int = 5
    feature_dims: int = 128
    max_len: int = 21
    n_layers: int = 4
    n_heads: int = 8
    dim_feedforward: int = 1024
    dropout: float = 0.1
    cls_dims: int = 128
    n_classes: int = 2
    noise_std: float = 1e-3


@dataclass(frozen=True)
class CnnLSTMConfig:
    seq_len: int = 21
    n_features: int = 18
    conv_dim: int = 64
    conv_kernel: int = 3
    conv_stride: int = 1
    conv_padding: int = 1
    lstm_dim: int = 128
    n_layers: int = 4
    bidirectional: bool = True
    n_classes: int = 2
    noise_std: float = 1e-3


@dataclass(frozen=True)
class MLSTMFCNConfig:
    n_features: int = 18
    fcn_dim: int = 128
    kernel_size: int = 5
    stride: int = 1
    seq_len: int = 21
    lstm_dim: int = 128
    lstm_n_layers: int = 1
    lstm_bidirectional: bool = True
    lstm_dropout: float = 0.1
    reduction: int = 16
    alpha: float = 1.0
    n_classes: int = 2
    noise_std: float = 1e-3


@dataclass(frozen=True)
class LossConfig:
    loss_type: str = "Focal"      # CE | Focal | LDAM
    focal_gamma: float = 2.0
    ldam_max_m: float = 0.5
    ldam_s: float = 1.0
    use_weighting: bool = False   # inverse-frequency class weights
    use_drw: bool = False         # deferred re-weighting
    drw_beta: float = 0.25


@dataclass(frozen=True)
class OptimConfig:
    optimizer: str = "AdamW"      # SGD | RMSProp | Adam | AdamW
    lr: float = 2e-4
    use_scheduler: bool = True
    step_size: int = 4
    gamma: float = 0.95
    max_norm_grad: Optional[float] = 1.0


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 64
    num_epoch: int = 128
    seed: int = 42
    use_sampling: bool = False    # imbalanced re-sampling
    early_stopping: bool = True
    early_stopping_patience: int = 32
    early_stopping_delta: float = 1e-3
    verbose: int = 4
    save_dir: str = "./results"
    weight_dir: str = "./weights"
    compute_dtype: str = "bfloat16"   # tensor-core compute precision
    steps_per_dispatch: int = 1       # >1: scan K train steps per dispatch
                                      # (amortizes host->device round-trips;
                                      # numerically identical to K steps)


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout. Defaults to pure data parallelism, the only
    parallelism the reference supports (src/distributed.py, NCCL DDP)."""
    data: int = -1      # -1 => all devices
    model: int = 1


def to_json(cfg) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=2, default=str)


def tag_for(model: str, seq_len: int, dist: int, loss: LossConfig, train: TrainConfig,
            use_sampling: bool = False) -> str:
    """Checkpoint tag mirroring the reference naming scheme
    (reference train_vision_network.py:159-182): boost-type from the
    sampling / weighting / DRW combination."""
    if use_sampling and not loss.use_weighting and not loss.use_drw:
        boost = "RS"
    elif use_sampling and loss.use_weighting and not loss.use_drw:
        boost = "RS_RW"
    elif use_sampling and loss.use_drw:
        boost = "RS_DRW"
    elif not use_sampling and loss.use_weighting and not loss.use_drw:
        boost = "RW"
    elif not use_sampling and loss.use_drw:
        boost = "DRW"
    else:
        boost = "Normal"
    return f"{model}_clip_{seq_len}_dist_{dist}_{loss.loss_type}_{boost}_seed_{train.seed}"

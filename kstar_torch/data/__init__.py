"""The port's data layer: the dataset ETL (``shotlog``, ``ts_pipeline``,
``profiles``, ``video_pipeline``), window labelling, datasets, loaders,
on-device augmentation (copies of the numpy/pandas modules of
``kstar_tpu/data`` and torch counterparts of its JAX ones)."""

from . import windows
from .dataset import MultiModalDataset, TSDataset, VideoDataset, VideoStore, filter_valid_shots
from .loader import (ImbalancedSampler, epoch_batches, eval_batches,
                     prefetch_to_device, to_device)
from .splits import Scaler, deterministic_split, prepare_0d_dataset, random_split_shots, split_shots
from .synthetic import make_dataset, make_shot, save_dataset
from .augment import (apply_augment, augment_params, center_crop, make_pre_fns,
                      preprocess)
from .device_pipe import DevicePreprocessor
from .profiles import get_profile, profile_tensor
from .shotlog import detect_cutoff, detect_startup, extend_shot_log
from .ts_pipeline import build_0d_table, sync_video_0d

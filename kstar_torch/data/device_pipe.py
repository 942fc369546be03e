"""Device-side preprocessing hook for the epoch drivers.

Port of ``kstar_tpu/data/device_pipe.py``. ``DevicePreprocessor`` is a
``put`` hook for fit()/run_*_epoch: it moves the raw uint8 video batch to
the device (pinned memory, ``non_blocking``) and runs the crop/augment/
normalize pipeline (data/augment.py) there, replacing the reference's CPU
DataLoader-worker transform stack (reference src/dataset.py:124-144, hot
loop 1).
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch

from .. import resolve_device
from ..config import AugmentConfig
from ..parallel.comm import data_parallel
from .augment import preprocess
from .loader import to_device


class DevicePreprocessor:
    """put hook: (batch, labels) -> (device batch, labels on the device).

    Handles raw video arrays and multimodal {'video', '0D'} dicts; 0D data
    passes straight through (already float). ``train=True`` applies the
    probability-gated augmentations with draws from one generator on the
    device, seeded with ``seed``. ``device=None`` means the GPU. ``mesh``:
    this rank's rows go up (``parallel/mesh.py put_batch``), on the mesh's
    device, and the augmentations are drawn for the global batch.
    """

    def __init__(self, crop_size: int, cfg: Optional[AugmentConfig] = None,
                 train: bool = True, out_dtype=torch.bfloat16, seed: int = 0,
                 device=None, mesh=None):
        self.crop_size = crop_size
        self.cfg = cfg or AugmentConfig()
        self.train = train
        self.out_dtype = out_dtype
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        # one preprocessor may serve several producer threads; the draws of
        # one batch must not interleave with another's
        self._lock = threading.Lock()

    def _put(self, x):
        if self.mesh is None:
            return to_device(x, self.device)
        from ..parallel.mesh import put_batch
        return put_batch(self.mesh, x)

    def _video(self, v):
        v = self._put(v)
        with self._lock, data_parallel(self.mesh):
            return preprocess(v, self.crop_size, self.cfg, self.train,
                              self.out_dtype, self._gen)

    def __call__(self, batch_and_labels: Tuple):
        batch, labels = batch_and_labels
        if isinstance(batch, dict):
            out = dict(batch)
            out["video"] = self._video(batch["video"])
            out["0D"] = self._put(batch["0D"])
            return out, self._put(labels)
        return self._video(batch), self._put(labels)

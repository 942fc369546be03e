"""Metrics logging: JSONL scalars + optional TensorBoard.

The port's copy of ``kstar_tpu/train/logging.py``.

The reference logs Loss/F1 scalars and a per-epoch evaluation figure to
TensorBoard (reference src/train.py:229-245). TensorFlow isn't a dependency
here, so the primary sink is a JSONL file (machine-readable for the sweep
tooling); if ``tensorboardX`` happens to be importable it is used as a
secondary sink.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricWriter:
    def __init__(self, log_dir: Optional[str]):
        self.log_dir = log_dir
        self._fh = None
        self._tb = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._fh = open(os.path.join(log_dir, "metrics.jsonl"), "a")
            try:
                from tensorboardX import SummaryWriter  # optional

                self._tb = SummaryWriter(log_dir)
            except Exception:
                self._tb = None

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self._fh:
            self._fh.write(json.dumps({"tag": tag, "value": float(value),
                                       "step": int(step), "time": time.time()}) + "\n")
            self._fh.flush()
        if self._tb:
            self._tb.add_scalar(tag, value, step)

    def scalars(self, values: Dict[str, float], step: int) -> None:
        for k, v in values.items():
            self.scalar(k, v, step)

    def figure(self, tag: str, fig, step: int) -> None:
        if self.log_dir is not None:
            try:
                fig.savefig(os.path.join(self.log_dir, f"{tag.replace('/', '_')}_{step}.png"))
            except Exception:
                pass
        if self._tb:
            self._tb.add_figure(tag, fig, step)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
        if self._tb:
            self._tb.close()

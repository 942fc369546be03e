"""kstar_torch — the PyTorch/CUDA port of ``kstar_tpu`` for NVIDIA Hopper.

Module names follow ``kstar_tpu`` so each counterpart is easy to find. The
package imports ``torch``, ``numpy`` and the standard library only; the
hand-written CUDA kernels under ``csrc/`` are compiled on first use
(``ops/_build.py``).

Entry points run on the GPU unless the caller asks for the CPU: a
``device=None`` argument means ``cuda`` and raises when no GPU is present.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; anything else is passed to ``torch.device`` as
    given. A CUDA device raises at once when CUDA is unavailable."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "kstar_torch runs on the GPU by default and CUDA is not "
            "available; pass device=\"cpu\" (--device cpu) to run on the CPU")
    return device

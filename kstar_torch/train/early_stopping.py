"""Early stopping on validation score (reference src/utils/EarlyStopping.py);
the port's copy of ``kstar_tpu/train/early_stopping.py``."""

from __future__ import annotations

from typing import Optional


class EarlyStopping:
    """Patience counter on a maximized validation metric; the caller
    checkpoints on improvement (reference save_checkpoint :32-38)."""

    def __init__(self, patience: int = 32, delta: float = 1e-3, verbose: bool = False):
        self.patience = patience
        self.delta = delta
        self.verbose = verbose
        self.best: Optional[float] = None
        self.counter = 0
        self.should_stop = False

    def __call__(self, score: float) -> bool:
        """Returns True when the score improved (caller should checkpoint)."""
        if self.best is None or score > self.best + self.delta:
            self.best = score
            self.counter = 0
            return True
        self.counter += 1
        if self.verbose:
            print(f"EarlyStopping counter: {self.counter} / {self.patience}")
        if self.counter >= self.patience:
            self.should_stop = True
        return False

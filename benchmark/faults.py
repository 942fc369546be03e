"""Faults planted under the timed path, to show that ``correct`` catches
them: each is a context manager that patches the program while it is open.
The benchmark's runs never plant one; ``control.py`` and the tests do.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(owner, name, replacement):
    original = getattr(owner, name)
    setattr(owner, name, replacement(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


ALTERED_EVERY = 8


def answer_altered():
    """A sweep's answer altered where it is produced: every 8th window of a
    chunk gets 1 - p."""
    from kstar_torch.infer.continuous import VideoSweeper

    def wrap(chunk_probs):
        def altered(self, data, starts):
            p = chunk_probs(self, data, starts).clone()
            p[::ALTERED_EVERY] = 1.0 - p[::ALTERED_EVERY]
            return p
        return altered
    return _patched(VideoSweeper, "chunk_probs", wrap)


def state_unchanged():
    """A train step that returns its state unchanged: the update is never
    applied."""
    from kstar_torch.train.state import TrainState

    return _patched(TrainState, "apply_gradients",
                    lambda original: lambda self, *a, **k: None)


def half_batch():
    """Half of the batch left out of the loss, which is scaled up to the
    whole batch's (a mean taken over the rest)."""
    from kstar_torch.train import loop

    def wrap(original):
        def half(out, labels, *a, **k):
            h = labels.shape[0] // 2
            loss, logits = original(out[:h], labels[:h], *a, **k)
            return loss * (labels.shape[0] / h), logits
        return half
    return _patched(loop, "_loss_and_logits", wrap)


FAULTS = {"answer_altered": answer_altered, "state_unchanged": state_unchanged,
          "half_batch": half_batch}

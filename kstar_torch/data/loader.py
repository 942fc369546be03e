"""Host-side batch iteration: samplers, static-shape batching, device prefetch.

Port of ``kstar_tpu/data/loader.py``. Replaces the reference's torch
DataLoader + ImbalancedDatasetSampler (reference src/utils/sampler.py:5-35,
num_workers=4 cv2 pipelines) with vectorized gathers in one producer thread
that runs ahead of the train step. Batch shapes are static: train batches
drop the remainder; eval batches pad with wraparound and carry a validity
mask. ``to_device`` is the ``put`` hook: a copy from pinned host memory with
``non_blocking=True``, so the producer thread queues the upload and goes on
gathering.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch


class ImbalancedSampler:
    """Inverse class-frequency sampling with replacement
    (reference ImbalancedDatasetSampler, src/utils/sampler.py:5-35)."""

    def __init__(self, labels: np.ndarray, num_samples: Optional[int] = None):
        labels = np.asarray(labels)
        counts = np.bincount(labels, minlength=int(labels.max(initial=0)) + 1).astype(np.float64)
        counts[counts == 0] = 1.0
        self.weights = 1.0 / counts[labels]
        self.weights /= self.weights.sum()
        self.num_samples = num_samples or len(labels)
        self.n = len(labels)

    def sample(self, rng: np.random.Generator) -> np.ndarray:
        return rng.choice(self.n, size=self.num_samples, replace=True, p=self.weights)


def epoch_batches(
    n: int,
    batch_size: int,
    rng: Optional[np.random.Generator] = None,
    sampler: Optional[ImbalancedSampler] = None,
    shuffle: bool = True,
    drop_last: bool = True,
) -> Iterator[np.ndarray]:
    """Yield index arrays of exactly ``batch_size`` (drop_last) or padded with
    wraparound plus caller-side masking (see ``eval_batches``)."""
    if sampler is not None:
        order = sampler.sample(rng or np.random.default_rng())
    elif shuffle:
        order = (rng or np.random.default_rng()).permutation(n)
    else:
        order = np.arange(n)

    if len(order) == 0:
        return
    if len(order) < batch_size:
        # dataset smaller than one batch: never yield nothing — emit a single
        # wraparound-padded batch so training still takes steps
        reps = -(-batch_size // len(order))
        yield np.tile(order, reps)[:batch_size]
        return

    for i in range(0, len(order) - (batch_size - 1 if drop_last else 0), batch_size):
        chunk = order[i : i + batch_size]
        if len(chunk) < batch_size:
            chunk = np.concatenate([chunk, order[: batch_size - len(chunk)]])
        yield chunk


def eval_batches(n: int, batch_size: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Sequential fixed-size batches with a validity mask for the padded tail."""
    for i in range(0, n, batch_size):
        idx = np.arange(i, min(i + batch_size, n))
        mask = np.ones(batch_size, dtype=bool)
        if len(idx) < batch_size:
            mask[len(idx):] = False
            idx = np.concatenate([idx, np.zeros(batch_size - len(idx), dtype=np.int64)])
        yield idx, mask


def to_device(item, device):
    """put hook: numpy arrays (or a dict or tuple of them) -> tensors on
    ``device``. On a GPU each array is staged in pinned host memory and
    copied with ``non_blocking=True``; the pinned block is not reused until
    its copy has run (torch's host allocator records the copy's stream)."""
    device = torch.device(device)
    if isinstance(item, dict):
        return {k: to_device(v, device) for k, v in item.items()}
    if isinstance(item, (tuple, list)):
        return type(item)(to_device(v, device) for v in item)
    t = torch.as_tensor(np.ascontiguousarray(item))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _relay(producer_body: Callable, depth: int):
    """Shared producer-thread scaffolding for the batch generators.

    Guarantees: the sentinel is ALWAYS enqueued (even when the producer body
    raises — the exception re-raises in the consumer), and an abandoned
    consumer (the generator is closed or garbage-collected mid-epoch, e.g.
    a train step raised) unblocks the producer instead of leaving it parked
    forever on a full queue with device batches pinned in device memory:
    every put is a timeout loop checking the stop event that the consumer's
    ``finally`` sets."""
    import queue as _queue
    import threading

    q: "_queue.Queue" = _queue.Queue(maxsize=depth)
    SENTINEL = object()
    stop = threading.Event()
    err: list = []

    def send(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except _queue.Full:
                continue
        return False

    def run():
        try:
            producer_body(send, stop)
        except BaseException as e:  # noqa: BLE001 — relayed to consumer
            err.append(e)
        finally:
            send(SENTINEL)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is SENTINEL:
                break
            yield item
    finally:
        stop.set()
        t.join(timeout=5.0)
    if err:
        raise err[0]


def threaded_batches(dataset, index_iter, put: Optional[Callable] = None,
                     depth: int = 4):
    """Background-thread batch gathering: host window gathers (and optional
    device puts) run ahead of consumption so device steps never wait on IO —
    the single-process replacement for torch DataLoader workers."""
    indices = list(index_iter)

    def body(send, stop):
        for idx in indices:
            if stop.is_set():
                return
            item = dataset.batch(idx)
            if put is not None:
                item = put(item)
            if not send(item):
                return

    yield from _relay(body, depth)


def grouped_batches(dataset, index_iter, k: int, put: Optional[Callable] = None,
                    depth: int = 4, put_stack: Optional[Callable] = None):
    """Group the index stream into stacks of ``k`` batches for multi-step
    calls (train/loop.py make_scan_steps): yields ``('stack', (batch,
    labels))`` with shapes (k, B, ...) for each full group — gathered in ONE
    vectorized ``dataset.batch`` call over the concatenated indices — then
    ``('single', (batch, labels))`` for the remainder batches. Host gathers
    (and optional device puts) run in a background thread like
    ``threaded_batches``.

    Stacks go through ``put_stack`` (default ``put``). On a mesh that must
    slice axis 1, the batch, and never axis 0, the steps
    (``parallel/mesh.py put_stack``): a put that leaves fewer than ``k``
    steps raises (the trap JAX's loader guards on a stack's sharding)."""
    put_stack = put_stack or put
    indices = list(index_iter)
    n_full = len(indices) // k

    def gather_stack(group):
        batch, labels = dataset.batch(np.concatenate(group))
        shp = lambda a: a.reshape((k, -1) + a.shape[1:])
        batch = ({kk: shp(v) for kk, v in batch.items()} if isinstance(batch, dict)
                 else shp(batch))
        return batch, labels.reshape(k, -1)

    def body(send, stop):
        for i in range(n_full):
            if stop.is_set():
                return
            item = gather_stack(indices[i * k:(i + 1) * k])
            if put_stack is not None:
                item = put_stack(item)
                if item[1].shape[0] != k:
                    raise ValueError(
                        f"the stack put sliced the step axis: {item[1].shape[0]} of "
                        f"{k} steps left; a (K, B, ...) stack is split along axis 1 "
                        "(parallel.mesh.put_stack)")
            if not send(("stack", item)):
                return
        for idx in indices[n_full * k:]:
            if stop.is_set():
                return
            item = dataset.batch(idx)
            if put is not None:
                item = put(item)
            if not send(("single", item)):
                return

    yield from _relay(body, depth)


def prefetch_to_device(iterator, put: Callable, depth: int = 2):
    """Keep ``depth`` batches in flight: each is put (queued for upload)
    before the one ahead of it is handed out, so the host gather of the next
    batch overlaps the device's work on this one."""
    import collections

    queue = collections.deque()
    for item in iterator:
        queue.append(put(item))
        if len(queue) >= depth:
            yield queue.popleft()
    while queue:
        yield queue.popleft()

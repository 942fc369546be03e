"""CUDA graph capture, shared by the window loop (``infer/continuous.py
_WindowLoop``) and the train step (``train/loop.py _TrainStep``).

A graph reads its module's parameters and buffers where they lay at
capture: ``storage_key`` names that storage, and a key that changed means
a recapture. A graph's warm-up and its capture run on the device's capture
stream under one process-wide lock (``on_capture_stream``, ``capture``).
Threads that share a card (HPO trials) then never put work on a stream
that another thread is capturing, and ``torch.cuda.graph``'s device-wide
synchronise and ``empty_cache`` never fall inside another thread's
capture, where CUDA refuses them. Replays run on the caller's stream,
outside the lock."""

from __future__ import annotations

import contextlib
import threading

import torch

_LOCK = threading.RLock()
_STREAMS: dict = {}


def storage_key(module: torch.nn.Module) -> tuple:
    """(data_ptr, shape) of every parameter and buffer of ``module``."""
    return tuple((t.data_ptr(), t.shape) for t in (*module.parameters(), *module.buffers()))


@contextlib.contextmanager
def on_capture_stream(device):
    """Run the block on ``device``'s capture stream, holding the capture
    lock: the stream waits for the current stream's queued work, and the
    current stream for the block's. One stream a device, not one a capture:
    each stream that runs a GEMM keeps a cuBLAS workspace for the life of
    the process. Yields the stream."""
    device = torch.device(device)
    with _LOCK:
        if device not in _STREAMS:
            _STREAMS[device] = torch.cuda.Stream(device)
        stream, main = _STREAMS[device], torch.cuda.current_stream(device)
        stream.wait_stream(main)
        with torch.cuda.stream(stream):
            yield stream
        main.wait_stream(stream)


@contextlib.contextmanager
def capture(graph: "torch.cuda.CUDAGraph", device, pool=None):
    """Capture the block into ``graph`` on ``device``'s capture stream, under
    the capture lock (``on_capture_stream``), in thread-local mode; ``pool``
    a memory pool the graph shares (``torch.cuda.graph_pool_handle``)."""
    with on_capture_stream(device) as stream, torch.cuda.graph(
            graph, pool=pool, stream=stream, capture_error_mode="thread_local"):
        yield

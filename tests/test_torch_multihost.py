"""kstar_torch/parallel/multihost.py on the CPU: the ports of
tests/test_multihost.py.

* Explicit arguments that cannot start a group raise (no fallback to one
  process); with no arguments and no launcher it is one process.
* ``host_batch_slice`` covers the whole batch on one process, and
  ``global_batch_from_local`` puts the local rows on the mesh's device.
* Two gloo ranks (spawned, a ``file://`` rendezvous) each load only their
  ``host_batch_slice`` rows, start from different seeds until
  ``replicate_tree_multihost`` gives them rank 0's state, and take two
  data-parallel steps: the losses are one process's on the whole batch
  (step 2's loss depends on step 1's update, so the gradient sum is
  checked, not only the forward).
"""

import datetime

import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_parallel_worker as W
from kstar_torch.config import LossConfig, OptimConfig
from kstar_torch.parallel import (global_batch_from_local, host_batch_slice,
                                  init_multihost, make_mesh)
from kstar_torch.train import create_train_state, make_train_step


def test_host_batch_slice_single_process():
    s = host_batch_slice(32)
    assert (s.start, s.stop) == (0, 32)


@pytest.mark.parametrize("case", ["incomplete", "unreachable"])
def test_init_multihost_explicit_args_fail_loudly(case, tmp_path):
    """A declared topology that cannot start raises: the three arguments
    go together, and a rendezvous that cannot open its store fails."""
    if case == "incomplete":
        kwargs = dict(coordinator_address=None, num_processes=2, process_id=None)
    else:
        (tmp_path / "a_file").write_text("")
        kwargs = dict(coordinator_address=f"file://{tmp_path}/a_file/store",
                      num_processes=2, process_id=0)
    with pytest.raises((ValueError, RuntimeError)):
        init_multihost(**kwargs, device="cpu", timeout=datetime.timedelta(seconds=2))
    assert not dist.is_initialized()


def test_init_multihost_under_a_launcher(monkeypatch):
    """No arguments under a launcher's environment (torchrun's RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT): env:// joins, here a group of
    one on localhost."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for key, value in dict(RANK="0", WORLD_SIZE="1", MASTER_ADDR="localhost",
                           MASTER_PORT=str(port)).items():
        monkeypatch.setenv(key, value)
    try:
        init_multihost(device="cpu")
        assert dist.is_initialized() and dist.get_world_size() == 1
        assert dist.get_backend() == "gloo"
        assert make_mesh(device="cpu").shape == {"data": 1, "model": 1}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.parametrize("entry", ["make_mesh", "init_multihost"])
def test_the_default_device_is_the_gpu(entry, monkeypatch, tmp_path):
    """With no device named, the mesh and the backend are the GPU's, and
    raise without CUDA: no quiet fall back to a CPU mesh or to gloo."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "make_mesh":
            make_mesh()
        else:
            init_multihost(f"file://{tmp_path}/store", 1, 0)
    assert not dist.is_initialized()


def test_global_batch_from_local_single_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    init_multihost()                      # no launcher: one process
    assert not dist.is_initialized()
    mesh = make_mesh(device="cpu")
    batch = {"video": np.arange(16 * 3, dtype=np.float32).reshape(16, 3),
             "labels": np.arange(16, dtype=np.int32)}
    out = global_batch_from_local(mesh, batch)
    for key, val in batch.items():
        assert out[key].device == mesh.device
        assert np.array_equal(out[key].numpy(), val)
    assert mesh.rows(16) == slice(0, 16)


def test_two_process_dp_matches_single_process(tmp_path):
    outs = W.run_ranks(W.two_process_steps, 2, tmp_path)
    assert [o["slice"] for o in outs] == [(0, 8), (8, 16)]
    # put_replicated: rank 0's tensors everywhere, other leaves as they are
    for o in outs:
        assert torch.equal(o["replicated"]["a"], torch.zeros(3)) and o["replicated"]["b"] == "kept"
    assert outs[0]["losses"] == outs[1]["losses"]
    state = create_train_state(W.build_mlstm(torch.Generator().manual_seed(0)),
                               OptimConfig(lr=1e-3))
    x, y = W.batches(7, n=1)
    step = make_train_step(LossConfig())
    want = [float(step(state, torch.as_tensor(x[0]), torch.as_tensor(y[0]), torch.ones(2),
                       torch.tensor([0.3, 0.1]))[1]) for _ in range(2)]
    np.testing.assert_allclose(outs[0]["losses"], want, atol=1e-5)

"""kstar_torch/parallel on the CPU: data- and tensor-parallel steps on gloo
ranks (spawned processes, ``_torch_parallel_worker.run_ranks``) against the
port's one-device step and against JAX.

* JAX's ``TestParallelNumerics`` case (tests/test_train_e2e.py:129-177):
  MLSTM-FCN 16 wide, Focal, 16 samples, AdamW 1e-3, 3 steps, then the eval
  probabilities, from JAX's initial weights carried across with
  ``state_dict_from_flax``, at dp = 2 and at dp = 2 x tp = 2 (the layers
  JAX's rule picks at ``min_size=1`` column-parallel), against JAX's
  one-device run at JAX's tolerances (losses rtol 2e-4 / atol 1e-5,
  probabilities rtol 5e-3 / atol 1e-4). The input noise and the LSTM
  dropout are 0 on both sides: JAX's and torch's random streams differ.
* Each trap of the data-parallel step alone on 2 ranks, against the port's
  one-device step on the global batch, under SGD (ROADMAP.md says why not
  Adam): CE and Focal (sums) and LDAM (a weighted mean), a NaN in one
  rank's rows skipping every rank, BatchNorm (MLSTM-FCN) and SubBatchNorm
  (2 splits) statistics, and the dropout and augmentation draws (a ViViT
  with dropout 0.2 on raw clips augmented inside the step). Losses and
  parameters within 1e-5, statistics within 1e-6.
* ``fit`` on 2 ranks equals ``fit`` on one device (histories, parameters,
  the gathered eval probabilities over a padded tail), and only rank 0
  saves; the CCA step on gathered encodings equals the one-device step.
* The sharded pieces against their unsharded versions: the library sweep
  over 3 shots on 2 ranks (the pad path; ViViT through the table, R(2+1)D
  through raw windows), the ensemble over 2 ranks, and the sharded
  checkpoint round trips (tensor-parallel shards, ensemble members, one
  process).
* ``tp_param_shardings`` picks JAX's set by parameter name, and the
  optimizer moments carry the parameters' shards.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parallel_worker as W
from kstar_torch.config import LossConfig, MeshConfig, OptimConfig
from kstar_torch.parallel import Mesh, make_mesh, put_batch, shard_state_tp, tp_param_shardings
from kstar_torch.parallel.comm import data_parallel
from kstar_torch.train import create_train_state, make_train_step
from kstar_torch.train.state import load_checkpoint_sharded, save_checkpoint_sharded
from kstar_torch.weights import state_dict_from_flax

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _close(got, want, atol, rtol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# JAX's TestParallelNumerics case
# ---------------------------------------------------------------------------

JAX_CFG = dict(n_features=18, fcn_dim=16, seq_len=21, lstm_dim=16, lstm_n_layers=1,
               lstm_dropout=0.0, noise_std=0.0)


@pytest.fixture(scope="module")
def jax_case(tmp_path_factory):
    """JAX's one-device losses and probabilities, and the case file the
    ranks read (the bridged weights, the batch and the labels)."""
    from kstar_tpu.config import LossConfig as JLossConfig
    from kstar_tpu.config import MLSTMFCNConfig, OptimConfig as JOptimConfig, Schema
    from kstar_tpu.data import TSDataset, prepare_0d_dataset, synthetic
    from kstar_tpu.models import build_0d_model
    from kstar_tpu.train import create_train_state as j_state
    from kstar_tpu.train import make_eval_step, make_train_step as j_step

    cols = Schema.INPUT_FEATURES
    _, disrupt_df, ts_df = synthetic.make_dataset(n_shots=8, n_frames=192, height=32,
                                                  width=32, seed=0)
    df_train, _, _, scaler = prepare_0d_dataset(ts_df, cols, test_shot=None)
    x, y = TSDataset(df_train, disrupt_df, cols, seq_len=21, dist=3,
                     scaler=scaler).batch(np.arange(16))
    model = build_0d_model("MLSTM_FCN", MLSTMFCNConfig(**JAX_CFG))
    state = j_state(model, jnp.asarray(x), jax.random.key(0), JOptimConfig(lr=1e-3))
    params = jax.tree.map(np.asarray, state.params)
    stats = jax.tree.map(np.asarray, state.batch_stats)
    loss_cfg = JLossConfig(loss_type="Focal")
    step, evaluate = jax.jit(j_step(model, loss_cfg)), jax.jit(make_eval_step(model, loss_cfg))
    w, m, gb = jnp.ones(2), jnp.asarray([0.3, 0.1]), jnp.zeros(3)
    losses = []
    for _ in range(3):
        state, loss, _ = step(state, jnp.asarray(x), jnp.asarray(y), w, m, gb)
        losses.append(float(loss))
    _, probs, _ = evaluate(state, jnp.asarray(x), jnp.asarray(y), w, m, gb,
                           jnp.ones(len(y), jnp.float32))
    root = tmp_path_factory.mktemp("jax_case")
    torch.save({"cfg": JAX_CFG, "state_dict": state_dict_from_flax(params, stats),
                "x": np.asarray(x), "y": np.asarray(y, np.int64)}, root / "jax_case.pt")
    return root, np.asarray(losses), np.asarray(probs), params


def _chosen_jax(params, min_size):
    """Port names of the kernels JAX's ``tp_param_shardings`` splits on a
    (4, 2) mesh of the 8 virtual CPU devices."""
    from kstar_tpu.config import MeshConfig as JMeshConfig
    from kstar_tpu.parallel import make_mesh as j_make_mesh
    from kstar_tpu.parallel.tp import tp_param_shardings as j_tp

    mesh = j_make_mesh(JMeshConfig(data=4, model=2), jax.devices()[:8])
    shard = j_tp(params, mesh, min_size)
    chosen = set()
    for path, sh in jax.tree_util.tree_leaves_with_path(shard):
        if sh.spec == jax.sharding.PartitionSpec():
            continue
        *mods, leaf = [k.key for k in path]
        if len(mods) >= 2 and mods[-2].startswith("OptimizedLSTMCell_"):
            mods, leaf = mods[:-1], "w_ih" if mods[-1].startswith("i") else "w_hh"
        chosen.add(".".join(mods + ["weight" if leaf == "kernel" else leaf]))
    return chosen


@pytest.mark.parametrize("model_axis", [1, 2], ids=["dp2", "dp2xtp2"])
def test_jax_parallel_numerics(model_axis, jax_case, tmp_path):
    root, want_losses, want_probs, params = jax_case
    case = tmp_path / "case"
    case.mkdir()
    (case / "jax_case.pt").write_bytes((root / "jax_case.pt").read_bytes())
    outs = W.run_ranks(W.jax_case, 2 * model_axis, case, model_axis)
    for out in outs:
        _close(out["losses"], want_losses, atol=1e-5, rtol=2e-4, what="losses")
        _close(out["probs"].numpy(), want_probs, atol=1e-4, rtol=5e-3, what="probs")
        assert out["ckpt"] == {"differed": True, "equal": True}
        assert out["moments"]["sizes_match"] and out["moments"]["max_err"] == 0.0
    if model_axis == 1:
        assert outs[0]["chosen"] == [] and outs[0]["moments"]["shard_entries"] == 0
    else:
        # the split layers are JAX's (Dense biases go with their kernels here)
        chosen = {n for n in outs[0]["chosen"] if not n.endswith(".bias")}
        assert chosen == _chosen_jax(params, 1) and chosen
        assert all(o["moments"]["shard_entries"] > 0 for o in outs)


@pytest.mark.parametrize("name,min_size", [("MLSTM_FCN", 1), ("ViViT", 4096)])
def test_tp_param_shardings_pick_jax_set(name, min_size):
    from kstar_tpu.config import MLSTMFCNConfig
    from kstar_tpu.models import ViViT as JViViT
    from kstar_tpu.models import build_0d_model as j_build

    from kstar_torch.config import MLSTMFCNConfig as TMLSTMFCNConfig
    from kstar_torch.models import build_0d_model
    from kstar_torch.models.vivit import ViViT

    if name == "MLSTM_FCN":
        jm, x = j_build(name, MLSTMFCNConfig(**JAX_CFG)), jnp.zeros((2, 21, 18))
        tm = build_0d_model(name, TMLSTMFCNConfig(**JAX_CFG))
    else:
        kw = dict(image_size=32, patch_size=8, n_frames=4, dim=64, depth=1, n_heads=2,
                  d_head=32, scale_dim=4, dropout=0.0, embedd_dropout=0.0)
        jm, x = JViViT(**kw), jnp.zeros((1, 4, 32, 32, 3))
        tm = ViViT(**kw)
    params = jax.tree.map(np.asarray, jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1),
         "noise": jax.random.key(2)}, x, train=False)["params"])
    mesh = Mesh(shape={"data": 4, "model": 2}, rank=0, device=CPU)
    placed = tp_param_shardings(tm, mesh, min_size)
    assert set(placed) == {n for n, _ in tm.named_parameters()}
    chosen = {n for n, a in placed.items() if a and not n.endswith(".bias")}
    assert chosen == _chosen_jax(params, min_size) and chosen
    # a chosen Dense's bias is split with it; nothing else is
    assert {n for n, a in placed.items() if a and n.endswith(".bias")} == {
        n[:-len("weight")] + "bias" for n in chosen
        if n.endswith(".weight") and n[:-len("weight")] + "bias" in placed}


def test_tp_moments_carry_the_parameter_shards():
    """Rank 1 of a model axis of 2 (no collective runs while sharding): the
    flat buffer and every moment hold that rank's rows of each split
    parameter, in the parameters' order (JAX
    ``test_tp_opt_state_sharding_matches_params``)."""
    state = create_train_state(W.mlstm(noise=0.0), OptimConfig(lr=1e-3))
    x, y = W.batches(3, n=1)
    make_train_step(LossConfig())(state, torch.as_tensor(x[0]), torch.as_tensor(y[0]),
                                  torch.ones(2), torch.tensor([0.3, 0.1]))
    before = {k: v.clone() for k, v in state.opt_state.items()}
    layout = [(n, p.shape) for n, p in state.model.named_parameters()]
    mesh = Mesh(shape={"data": 1, "model": 2}, rank=1, device=CPU)
    placed = tp_param_shardings(state.model, mesh, 1)
    sharded = shard_state_tp(state, mesh, min_size=1)
    assert sharded.shard_mask is not None and int(sharded.shard_mask.sum()) > 0
    off, off_s = 0, 0
    for name, shape in layout:
        numel = shape.numel()
        for key in ("mu", "nu"):
            want = before[key][off:off + numel].view(shape)
            if placed[name]:
                want = want[shape[0] // 2:]
            got = sharded.opt_state[key][off_s:off_s + want.numel()]
            assert torch.equal(got, want.reshape(-1)), (name, key)
        p = dict(sharded.model.named_parameters())[name]
        assert p.shape[0] == (shape[0] // 2 if placed[name] else shape[0])
        off, off_s = off + numel, off_s + p.numel()
    assert off_s == sharded.flat.numel() == sharded.opt_state["mu"].numel()


# ---------------------------------------------------------------------------
# each trap of the data-parallel step
# ---------------------------------------------------------------------------

def test_dp_step_traps_match_one_device(tmp_path):
    outs = W.run_ranks(W.dp_traps, 2, tmp_path)
    for name in ("CE", "Focal", "LDAM", "nan", "subbn", "vivit"):
        (dp_losses, dp), (one_losses, one) = outs[0][name]
        _close(dp_losses, one_losses, atol=1e-5, what=name)
        _close(dp["flat"], one["flat"], atol=1e-5, what=name)
        if one["stats"] is not None:
            _close(dp["stats"], one["stats"], atol=1e-6, what=name)
        assert dp["step"] == one["step"]
        # the replicas stay equal
        assert torch.equal(outs[1][name][0][1]["flat"], dp["flat"])
    # the NaN in rank 1's rows made both ranks skip that step, as one device does
    nan_losses, nan_state = outs[0]["nan"][0]
    assert np.isnan(nan_losses[1]) and nan_state["step"] == 2
    assert np.isnan(outs[1]["nan"][0][0][1]) and outs[1]["nan"][0][1]["step"] == 2


def test_fit_and_cca_on_two_ranks(tmp_path):
    outs = W.run_ranks(W.fit_on_mesh, 2, tmp_path)
    o = outs[0]
    assert o["valid_n"] % 16            # a padded, masked valid tail
    _close(np.array(o["dp"]["hist"]), np.array(o["one"]["hist"]), atol=1e-5)
    _close(o["dp"]["flat"], o["one"]["flat"], atol=1e-5)
    for dp, one in zip(o["dp"]["eval"][:3], o["one"]["eval"][:3]):
        _close(dp, one, atol=1e-5)
    (dp_probs, dp_labels), (probs, labels) = o["dp"]["eval"][3], o["one"]["eval"][3]
    assert np.array_equal(dp_labels, labels) and len(labels) == o["valid_n"]
    _close(dp_probs, probs, atol=1e-5)
    # the last and best checkpoint of each epoch: rank 0 alone writes
    assert o["dp"]["saves"] == o["one"]["saves"] > 0 and outs[1]["dp"]["saves"] == 0
    _close(o["cca_dp"][0], o["cca_one"][0], atol=1e-5)
    _close(o["cca_dp"][1], o["cca_one"][1], atol=1e-5)


# ---------------------------------------------------------------------------
# the sharded pieces against their unsharded versions
# ---------------------------------------------------------------------------

def test_sharded_library_sweep_equals_one_rank(tmp_path):
    """And ``DevicePreprocessor(mesh=)``: each rank's rows of the
    one-device batch, augmentations drawn for the global batch."""
    from kstar_torch.infer.continuous import VideoSweeper

    outs = W.run_ranks(W.sweep_on_mesh, 2, tmp_path)
    for whole, *parts in zip(W.preprocessed(), *(o["preprocessed"] for o in outs)):
        for i in range(2):
            assert torch.equal(torch.cat([p[i] for p in parts]), whole[i])
    frames, starts = W.sweep_library()
    for name, model in W.sweep_models().items():
        want = VideoSweeper(model, 4, 16, batch_size=8, compute_dtype=torch.float32,
                            device="cpu").sweep_shots(frames, starts)
        for out in outs:
            assert [len(c) for c in out[name]] == [len(s) for s in starts]
            for a, b in zip(out[name], want):
                _close(a, b, atol=2e-5, what=name)


def test_ensemble_over_ranks_equals_unsharded(tmp_path):
    from kstar_torch.train import create_ensemble_state, make_ensemble_step

    outs = W.run_ranks(W.ensemble_on_mesh, 2, tmp_path)
    plain = create_ensemble_state(W.build_mlstm, W.ENS_SEEDS, OptimConfig(**W.SGD),
                                  device="cpu")
    step = make_ensemble_step(LossConfig())
    xs, ys = W.batches(2, n=2)
    losses = torch.stack([step(plain, torch.as_tensor(x), torch.as_tensor(y), torch.ones(2),
                               torch.tensor([0.3, 0.5]))[1] for x, y in zip(xs, ys)])
    assert outs[0]["seeds"] + outs[1]["seeds"] == list(W.ENS_SEEDS)
    for r, out in enumerate(outs):
        _close(out["losses"], losses[:, 2 * r:2 * r + 2], atol=1e-5, rtol=1e-5)
        for got, member in zip(out["flats"], plain[2 * r:2 * r + 2]):
            _close(got, member.flat.detach(), atol=1e-6, rtol=1e-5)
        assert out["restored"]


def test_sharded_checkpoint_round_trip_one_process(tmp_path):
    x, y = W.batches(5, n=1)
    state = create_train_state(W.mlstm(), OptimConfig(lr=1e-3))
    make_train_step(LossConfig())(state, torch.as_tensor(x[0]), torch.as_tensor(y[0]),
                                  torch.ones(2), torch.tensor([0.3, 0.1]))
    save_checkpoint_sharded(state, str(tmp_path / "ck"))
    fresh = create_train_state(W.mlstm(seed=3), OptimConfig(lr=1e-3))
    assert not torch.equal(fresh.flat, state.flat)
    load_checkpoint_sharded(fresh, str(tmp_path / "ck"))
    assert torch.equal(fresh.flat, state.flat) and torch.equal(fresh.stats_flat, state.stats_flat)
    assert all(torch.equal(fresh.opt_state[k], v) for k, v in state.opt_state.items())
    assert int(fresh.step) == 1 and fresh.draws == state.draws
    # a template of another layout (a list of members) is refused
    with pytest.raises(ValueError, match="layout"):
        load_checkpoint_sharded([fresh], str(tmp_path / "ck"))


# ---------------------------------------------------------------------------
# one-process guards
# ---------------------------------------------------------------------------

def test_mesh_of_one_process():
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.rank == 0 and mesh.is_main
    assert mesh.device == CPU
    with pytest.raises(AssertionError, match="mesh 2x1 != 1 devices"):
        make_mesh(MeshConfig(data=2, model=1), device="cpu")


def test_puts_split_the_batch_axis_evenly():
    mesh = Mesh(shape={"data": 2, "model": 1}, rank=1, device=CPU)
    x = np.arange(16 * 3).reshape(16, 3)
    assert torch.equal(put_batch(mesh, {"a": x})["a"], torch.as_tensor(x[8:]))
    with pytest.raises(ValueError, match="not divisible"):
        put_batch(mesh, x[:15])
    from kstar_torch.parallel import put_stack

    stack = np.arange(3 * 16).reshape(3, 16)
    assert torch.equal(put_stack(mesh, stack), torch.as_tensor(stack[:, 8:]))


def test_grouped_batches_refuse_a_put_that_splits_the_steps():
    """The trap JAX's loader guards: a (K, B, ...) stack split along the
    step axis instead of the batch axis."""
    from kstar_torch.data.loader import grouped_batches

    class DS:
        def batch(self, idx):
            return np.asarray(idx, np.float32)[:, None], np.asarray(idx) % 2

    mesh = Mesh(shape={"data": 2, "model": 1}, rank=0, device=CPU)
    wrong = lambda item: (put_batch(mesh, item[0]), put_batch(mesh, item[1]))
    idx = [np.arange(i * 4, i * 4 + 4) for i in range(4)]
    with pytest.raises(ValueError, match="sliced the step axis"):
        list(grouped_batches(DS(), iter(idx), 4, put=wrong))


def test_stacks_go_through_the_callers_put_off_the_mesh():
    """Without a mesh a multi-step epoch sends its (K, B, ...) stacks
    through the caller's ``put`` (a ``DevicePreprocessor``, say), as single
    batches; on a mesh stacks are this rank's rows of axis 1 whatever the
    pairs' put."""
    from types import SimpleNamespace

    from kstar_torch.train.loop import default_puts, run_train_epoch

    class DS:
        def __len__(self):
            return 16

        def batch(self, idx):
            return np.asarray(idx, np.float32)[..., None], np.asarray(idx) % 2

    seen = []

    def put(item):
        seen.append(tuple(item[1].shape))
        return torch.as_tensor(item[0]), torch.as_tensor(item[1])

    def scan_step(state, batch, labels, *_):
        return state, torch.zeros(labels.shape[0]), labels

    state = SimpleNamespace(device=CPU)
    run_train_epoch(None, state, DS(), 4, np.random.default_rng(0), None, None, put=put,
                    scan_step=scan_step, steps_per_dispatch=2)
    assert seen == [(2, 4), (2, 4)]

    mesh = Mesh(shape={"data": 2, "model": 1}, rank=1, device=CPU)
    pair_put, stack_put = default_puts(CPU, mesh, put)
    assert pair_put is put
    stack = np.arange(2 * 4).reshape(2, 4)
    assert torch.equal(stack_put((stack, stack))[1], torch.as_tensor(stack[:, 2:]))


def test_subbatchnorm_refuses_an_uneven_rank_batch():
    from kstar_torch.models.subbn import SubBatchNorm

    bn = SubBatchNorm(4, num_splits=2)
    mesh = Mesh(shape={"data": 2, "model": 1}, rank=0, device=CPU)
    with data_parallel(mesh), pytest.raises(ValueError, match="this rank's batch 3"):
        bn(torch.zeros(3, 5, 4), train=True)

"""Rank functions for the port's multi-process tests (test_torch_parallel.py,
test_torch_multihost.py), and the runner that spawns them.

``run_ranks(fn, world, root, *args)`` starts ``world`` processes with
``torch.multiprocessing`` (spawn), each joins a gloo group through a
``file://`` store under ``root`` (no ports), runs ``fn(mesh_or_rank, ...)``
and saves what it returns as ``root/out_<rank>.pt``; the runner returns the
list in rank order. A rank that raises fails the run, and a run that does
not end within ``timeout`` seconds is killed and fails. This module imports
torch and kstar_torch only, so a child starts quickly.
"""

from __future__ import annotations

import os
import time
import uuid

import numpy as np
import torch


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

def _entry(rank, fn, world, root, store, args):
    torch.set_num_threads(1)
    from kstar_torch.parallel import init_multihost

    init_multihost(f"file://{store}", world, rank, device="cpu")
    out = fn(rank, world, root, *args)
    torch.save(out, os.path.join(root, f"out_{rank}.pt"))
    import torch.distributed as dist

    dist.destroy_process_group()


def run_ranks(fn, world: int, root, *args, timeout: float = 240.0) -> list:
    import torch.multiprocessing as mp

    root = str(root)
    os.makedirs(root, exist_ok=True)
    store = os.path.join(root, f"store-{uuid.uuid4().hex}")
    ctx = mp.start_processes(_entry, args=(fn, world, root, store, args), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=5.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn.__name__} on {world} ranks: no end in {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(os.path.join(root, f"out_{r}.pt"), weights_only=False)
            for r in range(world)]


def check_cli_run(tmp_path, result, stem, epochs):
    """A train CLI's ``--dp 2 --device cpu`` run finished: rank 0's result
    came back, the last and best checkpoints load, and the metric log holds
    each (tag, epoch) once, so no second rank wrote beside rank 0."""
    import json

    assert result is not None and 0.0 <= result["macro_f1"] <= 1.0
    for end in ("last", "best"):
        assert int(torch.load(tmp_path / "w" / f"{stem}_{end}.ckpt")["step"]) > 0
    log = tmp_path / "r" / "tensorboard" / stem / "metrics.jsonl"
    keys = [(r["tag"], r["step"]) for r in map(json.loads, log.read_text().splitlines())]
    assert len(keys) == len(set(keys)) and {s for _, s in keys} == set(range(epochs))


# ---------------------------------------------------------------------------
# shared fixtures (built the same way in every rank and in the parent)
# ---------------------------------------------------------------------------

B, T, F = 16, 21, 18
SGD = dict(optimizer="SGD", lr=0.05, use_scheduler=False, max_norm_grad=1.0)


def batches(seed=0, n=3, b=B):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, b, T, F)).astype(np.float32)
    y = (np.arange(n * b).reshape(n, b) % 2).astype(np.int64)
    return x, y


def mlstm(noise=1e-3, seed=0):
    from kstar_torch.config import MLSTMFCNConfig
    from kstar_torch.models import build_0d_model

    cfg = MLSTMFCNConfig(n_features=F, fcn_dim=16, seq_len=T, lstm_dim=16, noise_std=noise)
    return build_0d_model("MLSTM_FCN", cfg, generator=torch.Generator().manual_seed(seed))


class TinyNet(torch.nn.Module):
    """Dense -> SubBatchNorm(splits) (none without splits) -> mean over
    time -> Dense: the smallest model whose train forward runs the split
    statistics, or none at all (a NaN then stays in its rows)."""

    def __init__(self, splits=None, seed=0):
        super().__init__()
        from kstar_torch.models.subbn import SubBatchNorm
        from kstar_torch.models.vivit import Dense

        g = torch.Generator().manual_seed(seed)
        self.fc = Dense(F, 8, generator=g)
        self.bn = SubBatchNorm(8, splits) if splits else None
        self.head = Dense(8, 2, generator=g)

    def forward(self, x, train=False, generator=None, noise_generator=None):
        h = self.fc(x)
        if self.bn is not None:
            h = self.bn(h, train)
        return self.head(h.mean(1))


def vivit(seed=0):
    from kstar_torch.models.vivit import ViViT

    return ViViT(image_size=16, patch_size=8, n_frames=4, dim=16, depth=1, n_heads=2,
                 d_head=8, scale_dim=2, dropout=0.2, embedd_dropout=0.2,
                 generator=torch.Generator().manual_seed(seed))


def video_batches(seed=0, n=2, b=8):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, size=(n, b, 4, 20, 20, 3), dtype=np.uint8)
    y = (np.arange(n * b).reshape(n, b) % 2).astype(np.int64)
    return x, y


def state_numbers(state) -> dict:
    return {"flat": state.flat.detach().clone(),
            "stats": None if state.stats_flat is None else state.stats_flat.clone(),
            "step": int(state.step)}


def run_steps(model, loss_cfg, xs, ys, mesh=None, optim=None, pre_fn=None,
              weight=None, seed=0):
    """Steps over the global batches ``xs``/``ys``: ``make_train_step``'s,
    or on a mesh ``make_dp_step_fns``' on each rank's rows: (losses,
    numbers of the final state)."""
    from kstar_torch.config import OptimConfig
    from kstar_torch.parallel import make_dp_step_fns
    from kstar_torch.train import create_train_state, make_train_step

    state = create_train_state(model, OptimConfig(**(optim or SGD)), seed=seed)
    if mesh is None:
        step = make_train_step(loss_cfg, pre_fn=pre_fn)
        put = lambda pair: tuple(torch.as_tensor(a) for a in pair)
    else:
        step, _, put = make_dp_step_fns(loss_cfg, mesh, pre_fn=pre_fn)
    w = torch.ones(2) if weight is None else torch.as_tensor(weight)
    losses = []
    for pair in zip(xs, ys):
        _, loss, _ = step(state, *put(pair), w, torch.tensor([0.3, 0.5]))
        losses.append(float(loss))
    return losses, state_numbers(state)


# ---------------------------------------------------------------------------
# rank functions
# ---------------------------------------------------------------------------

def dp_traps(rank, world, root):
    """Each trap of the data-parallel step on ``world`` ranks, with this
    rank's one-device run of the same global batches beside it."""
    from kstar_torch.config import AugmentConfig, LossConfig, MeshConfig
    from kstar_torch.data.augment import make_pre_fns
    from kstar_torch.parallel import make_mesh

    mesh = make_mesh(MeshConfig(data=world, model=1), device="cpu")
    out = {}
    xs, ys = batches()
    for loss_type in ("CE", "Focal", "LDAM"):
        cfg = LossConfig(loss_type=loss_type)
        weight = [0.7, 1.3]
        out[loss_type] = (run_steps(mlstm(), cfg, xs, ys, mesh, weight=weight),
                          run_steps(mlstm(), cfg, xs, ys, None, weight=weight))
    # a NaN in the last rank's rows of the second batch
    xn = xs.copy()
    xn[1, -1, 3, 5] = np.nan
    cfg = LossConfig(loss_type="Focal")
    out["nan"] = (run_steps(TinyNet(), cfg, xn, ys, mesh),
                  run_steps(TinyNet(), cfg, xn, ys, None))
    out["subbn"] = (run_steps(TinyNet(2), cfg, xs, ys, mesh),
                    run_steps(TinyNet(2), cfg, xs, ys, None))
    # dropout and augmentation draws: a ViViT with dropout 0.2 on raw uint8
    # clips, cropped and augmented inside the step (every gate at 0.5)
    aug = AugmentConfig(bright_p=0.5, contrast_p=0.5, blur_p=0.5, flip_p=0.5,
                        vertical_p=0.5, horizontal_p=0.5)
    pre, _ = make_pre_fns(16, aug, out_dtype=torch.float32)
    vx, vy = video_batches()
    out["vivit"] = (run_steps(vivit(), cfg, vx, vy, mesh, pre_fn=pre),
                    run_steps(vivit(), cfg, vx, vy, None, pre_fn=pre))
    return out


def jax_case(rank, world, root, model_axis):
    """JAX's ``TestParallelNumerics`` case on a (world / model_axis,
    model_axis) mesh: the bridged MLSTM-FCN (``root/jax_case.pt``: its
    state_dict, the batch, the labels), AdamW 1e-3, Focal, 3 steps on the
    global batch of 16, then the eval probabilities; with a model axis the
    layers JAX's rule picks at ``min_size=1`` are column-parallel. Also:
    the moments of a sharded state are the shards of the unsharded
    moments, and a sharded checkpoint round trip restores exactly."""
    from kstar_torch.config import LossConfig, MeshConfig, MLSTMFCNConfig, OptimConfig
    from kstar_torch.models import build_0d_model
    from kstar_torch.parallel import make_mesh, put_batch, replicate_state, shard_state_tp
    from kstar_torch.parallel.tp import tp_param_shardings
    from kstar_torch.train import create_train_state, make_eval_step, make_train_step
    from kstar_torch.train.state import load_checkpoint_sharded, save_checkpoint_sharded

    case = torch.load(os.path.join(root, "jax_case.pt"), weights_only=False)
    mesh = make_mesh(MeshConfig(data=world // model_axis, model=model_axis), device="cpu")

    def fresh(seed=0):
        model = build_0d_model("MLSTM_FCN", MLSTMFCNConfig(**case["cfg"]),
                               generator=torch.Generator().manual_seed(seed))
        return model

    model = fresh(1 + rank)                      # replicate_state makes them rank 0's
    model.load_state_dict(case["state_dict"]) if rank == 0 else None
    state = replicate_state(create_train_state(model, OptimConfig(lr=1e-3)), mesh)
    out = {"chosen": sorted(k for k, v in tp_param_shardings(model, mesh, 1).items() if v)}
    state = shard_state_tp(state, mesh, min_size=1)
    loss_cfg = LossConfig(loss_type="Focal")
    step = make_train_step(loss_cfg, mesh=mesh)
    evaluate = make_eval_step(loss_cfg, mesh=mesh)
    x, y = put_batch(mesh, case["x"]), put_batch(mesh, case["y"])
    w, m = torch.ones(2), torch.tensor([0.3, 0.1])
    losses = [float(step(state, x, y, w, m)[1]) for _ in range(3)]
    _, probs, _ = evaluate(state.model, x, y, w, m, torch.ones(len(y)))
    out.update(losses=losses, probs=probs)

    # the moments carry the parameters' shards: shard a state whose moments
    # are not zero (one unsharded step on the whole batch) and compare
    twin = create_train_state(fresh(), OptimConfig(lr=1e-3))
    make_train_step(loss_cfg)(twin, torch.as_tensor(case["x"]), torch.as_tensor(case["y"]), w, m)
    full = {k: v.clone() for k, v in twin.opt_state.items()}
    names = [n for n, p in twin.model.named_parameters()]
    sizes = [p.numel() for p in twin.params]
    shapes = [p.shape for p in twin.params]
    twin = shard_state_tp(twin, mesh, min_size=1)
    placed = tp_param_shardings(fresh(), mesh, 1)
    err, off_full, off_shard = 0.0, 0, 0
    r, n = mesh.model_index, mesh.shape["model"]
    for name, size, shape in zip(names, sizes, shapes):
        want = full["mu"][off_full:off_full + size].view(shape)
        if placed[name]:
            rows = shape[0] // n
            want = want[r * rows:(r + 1) * rows]
        got = twin.opt_state["mu"][off_shard:off_shard + want.numel()].view(want.shape)
        err = max(err, float((got - want).abs().max()))
        off_full, off_shard = off_full + size, off_shard + want.numel()
    out["moments"] = {"max_err": err, "sizes_match": all(
        v.shape == twin.flat.shape for k, v in twin.opt_state.items() if k != "count"),
        "shard_entries": 0 if twin.shard_mask is None else int(twin.shard_mask.sum())}

    # sharded checkpoint round trip into a template of another seed
    path = os.path.join(root, "ckpt_tp")
    save_checkpoint_sharded(state, path, mesh)
    template = shard_state_tp(replicate_state(
        create_train_state(fresh(7), OptimConfig(lr=1e-3)), mesh), mesh, min_size=1)
    before = float((template.flat - state.flat).abs().max())
    load_checkpoint_sharded(template, path, mesh)
    out["ckpt"] = {"differed": before > 0,
                   "equal": bool(torch.equal(template.flat, state.flat)
                                 and torch.equal(template.stats_flat, state.stats_flat)
                                 and all(torch.equal(template.opt_state[k], state.opt_state[k])
                                         for k in state.opt_state)
                                 and int(template.step) == int(state.step))}
    return out


class Encoders(torch.nn.Module):
    """Two Dense encoders with a fusion model's ``encode`` signature, for
    the CCA step."""

    def __init__(self, seed=0):
        super().__init__()
        from kstar_torch.models.vivit import Dense

        g = torch.Generator().manual_seed(seed)
        self.vis, self.ts = Dense(12, 4, generator=g), Dense(F, 3, generator=g)

    def encode(self, video, x0d):
        return None, self.vis(video), self.ts(x0d.mean(1))


def ts_datasets():
    """Tiny 0D train/valid datasets from the synthetic fixture (the valid
    set's size is not a multiple of the batch: a padded, masked tail)."""
    from kstar_torch.config import Schema
    from kstar_torch.data import TSDataset, prepare_0d_dataset, synthetic

    _, disrupt_df, ts_df = synthetic.make_dataset(n_shots=6, n_frames=160, height=32,
                                                  width=32, seed=0)
    cols = Schema.INPUT_FEATURES
    df_train, df_valid, _, scaler = prepare_0d_dataset(ts_df, cols, test_shot=None)
    mk = lambda df: TSDataset(df, disrupt_df, cols, seq_len=T, dist=3, scaler=scaler)
    return mk(df_train), mk(df_valid)


def fit_on_mesh(rank, world, root):
    """``fit`` over 2 epochs on the mesh and on one device (DRW weights,
    the imbalanced sampler, K=2 stacks, a padded valid tail), with the
    saves counted per rank; the eval step's gathered probabilities; the CCA
    step on gathered encodings; a Gradient-Blending stream step."""
    import kstar_torch.train.loop as loop
    from kstar_torch.config import LossConfig, MeshConfig, OptimConfig, TrainConfig
    from kstar_torch.data import ImbalancedSampler
    from kstar_torch.parallel import make_mesh, put_batch
    from kstar_torch.train import create_train_state, fit, make_eval_step, run_eval_epoch
    from kstar_torch.train.cca import make_cca_step

    mesh = make_mesh(MeshConfig(data=world, model=1), device="cpu")
    train_ds, valid_ds = ts_datasets()
    saves = []
    real_save = loop.save_checkpoint
    loop.save_checkpoint = lambda *a, **k: (saves.append(a[1]), real_save(*a, **k))
    out = {"valid_n": len(valid_ds)}
    for name, m in (("dp", mesh), ("one", None)):
        cfg = TrainConfig(batch_size=16, num_epoch=2, early_stopping=False, verbose=0,
                          steps_per_dispatch=2,
                          weight_dir=os.path.join(root, f"w_{name}_{rank}"))
        state = create_train_state(mlstm(), OptimConfig(**SGD))
        saves.clear()
        state, hist = fit(state, train_ds, valid_ds, cfg, LossConfig(use_drw=True),
                          sampler=ImbalancedSampler(train_ds.labels), mesh=m)
        out[name] = {"hist": (hist.train_loss, hist.valid_loss, hist.train_f1,
                              hist.valid_f1, hist.train_acc, hist.valid_acc),
                     "flat": state.flat.clone(), "saves": len(saves)}
        evaluate = make_eval_step(LossConfig(), mesh=m)
        w, ml = torch.ones(2), torch.tensor([0.3, 0.5])
        out[name]["eval"] = run_eval_epoch(evaluate, state.model, valid_ds, 16, w, ml,
                                           collect_probs=True, mesh=m)
    loop.save_checkpoint = real_save

    # CCA: the covariances of the global batch
    rng = np.random.default_rng(1)
    video = rng.normal(size=(3, 16, 12)).astype(np.float32)
    x0d = rng.normal(size=(3, 16, T, F)).astype(np.float32)
    for name, m in (("cca_dp", mesh), ("cca_one", None)):
        state = create_train_state(Encoders(), OptimConfig(**SGD))
        step = make_cca_step(2, mesh=m)
        put = (lambda a: torch.as_tensor(a)) if m is None else (lambda a: put_batch(m, a))
        losses = [float(step(state, {"video": put(v), "0D": put(x)})[1])
                  for v, x in zip(video, x0d)]
        out[name] = (losses, state.flat.clone())
    return out


def sweep_on_mesh(rank, world, root):
    """The library sweep over 3 shots split over the ranks (the pad path),
    ViViT (the spatial table) and R(2+1)D (raw windows); and this rank's
    part of a ``DevicePreprocessor(mesh=)`` batch, augmented."""
    from kstar_torch.config import MeshConfig
    from kstar_torch.infer.continuous import VideoSweeper
    from kstar_torch.parallel import make_mesh

    mesh = make_mesh(MeshConfig(data=world, model=1), device="cpu")
    frames, starts = sweep_library()
    out = {}
    for name, model in sweep_models().items():
        sw = VideoSweeper(model, 4, 16, batch_size=8, compute_dtype=torch.float32, mesh=mesh)
        out[name] = sw.sweep_shots(frames, starts)
    out["preprocessed"] = preprocessed(mesh)
    return out


def preprocessed(mesh=None):
    """Two batches through a training ``DevicePreprocessor`` (every
    augmentation gate at 0.5): on a mesh, this rank's rows."""
    from kstar_torch.config import AugmentConfig
    from kstar_torch.data import DevicePreprocessor

    aug = AugmentConfig(bright_p=0.5, contrast_p=0.5, blur_p=0.5, flip_p=0.5,
                        vertical_p=0.5, horizontal_p=0.5)
    put = DevicePreprocessor(16, aug, train=True, out_dtype=torch.float32, seed=3,
                             device="cpu", mesh=mesh)
    vx, vy = video_batches(4)
    return [put((x, y)) for x, y in zip(vx, vy)]


def sweep_library():
    rng = np.random.default_rng(0)
    lens = (40, 55, 33)
    return ([rng.integers(0, 255, (n, 16, 16, 3), dtype=np.uint8) for n in lens],
            [np.arange(n - 5, dtype=np.int64) for n in lens])


def sweep_models() -> dict:
    from kstar_torch.models.r2plus1d import R2Plus1DClassifier
    from kstar_torch.models.vivit import ViViT

    g = lambda: torch.Generator().manual_seed(0)
    return {"ViViT": ViViT(image_size=16, patch_size=8, n_frames=4, dim=16, depth=1,
                           n_heads=2, d_head=8, scale_dim=2, dropout=0.0,
                           embedd_dropout=0.0, generator=g()),
            "R2Plus1D": R2Plus1DClassifier(image_size=16, n_frames=4,
                                           layer_sizes=(1, 1, 1, 1), generator=g())}


ENS_SEEDS = (40, 41, 42, 43)


def ensemble_on_mesh(rank, world, root):
    """4 members over the ranks: 2 shared steps each (no collectives), then
    a sharded checkpoint of this rank's members and its round trip."""
    from kstar_torch.config import LossConfig, MeshConfig, OptimConfig
    from kstar_torch.parallel import make_mesh
    from kstar_torch.train import create_ensemble_state, make_ensemble_step
    from kstar_torch.train.ensemble import local_seeds
    from kstar_torch.train.state import load_checkpoint_sharded, save_checkpoint_sharded

    mesh = make_mesh(MeshConfig(data=world, model=1), device="cpu")
    states = create_ensemble_state(build_mlstm, ENS_SEEDS, OptimConfig(**SGD), mesh=mesh)
    step = make_ensemble_step(LossConfig())
    xs, ys = batches(2, n=2)
    losses = [step(states, torch.as_tensor(x), torch.as_tensor(y), torch.ones(2),
                   torch.tensor([0.3, 0.5]))[1] for x, y in zip(xs, ys)]
    path = os.path.join(root, "ckpt_members")
    save_checkpoint_sharded(states, path, mesh)
    fresh = create_ensemble_state(lambda gen: build_mlstm(torch.Generator().manual_seed(9)),
                                  ENS_SEEDS, OptimConfig(**SGD), mesh=mesh)
    load_checkpoint_sharded(fresh, path, mesh)
    return {"seeds": local_seeds(ENS_SEEDS, mesh), "losses": torch.stack(losses),
            "flats": [s.flat.clone() for s in states],
            "restored": all(torch.equal(a.flat, b.flat) and torch.equal(a.stats_flat, b.stats_flat)
                            and int(a.step) == int(b.step) == 2 and a.seed == b.seed
                            for a, b in zip(states, fresh))}


def build_mlstm(gen):
    from kstar_torch.config import MLSTMFCNConfig
    from kstar_torch.models import build_0d_model

    cfg = MLSTMFCNConfig(n_features=F, fcn_dim=8, seq_len=T, lstm_dim=8, noise_std=1e-3)
    return build_0d_model("MLSTM_FCN", cfg, generator=gen)


def two_process_steps(rank, world, root):
    """test_multihost's two-process case: each rank loads only its
    ``host_batch_slice`` rows, feeds ``global_batch_from_local``, starts
    from its own seed until ``replicate_tree_multihost`` gives it rank 0's
    state, and takes 2 data-parallel steps."""
    from kstar_torch.config import LossConfig, MeshConfig, OptimConfig
    from kstar_torch.parallel import (global_batch_from_local, host_batch_slice, make_mesh,
                                      put_replicated, replicate_tree_multihost)
    from kstar_torch.train import create_train_state, make_train_step

    mesh = make_mesh(MeshConfig(data=world, model=1), device="cpu")
    replicated = put_replicated(mesh, {"a": torch.full((3,), float(rank)), "b": "kept"})
    state = create_train_state(build_mlstm(torch.Generator().manual_seed(rank)),
                               OptimConfig(lr=1e-3))
    state = replicate_tree_multihost(mesh, state)
    x, y = batches(7, n=1)
    sl = host_batch_slice(len(y[0]))
    gx, gy = global_batch_from_local(mesh, (x[0][sl], y[0][sl]))
    step = make_train_step(LossConfig(), mesh=mesh)
    return {"slice": (sl.start, sl.stop), "replicated": replicated,
            "losses": [float(step(state, gx, gy, torch.ones(2), torch.tensor([0.3, 0.1]))[1])
                       for _ in range(2)]}

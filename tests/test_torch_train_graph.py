"""The train step as one captured CUDA graph (``train/loop.py _TrainStep``):
on one CUDA device a step replays the whole step (``pre_fn``, forward,
loss, backward, guarded update) from a graph, drawing and computing what
the eager step does; on the CPU and on a mesh every step is eager. The
update writes the state in place (``TrainState.apply_gradients``) and a
replay reseeds the graph's own generators (``TrainState.seed_generators``).

    python -m pytest tests/test_torch_train_graph.py -q                       # the CPU cases
    python3 -m pytest --noconftest -m cuda tests/test_torch_train_graph.py -q  # on the GPU machine

(``--noconftest``: ``tests/conftest.py`` imports JAX, which the GPU machine
does not have.)
"""

import threading

import numpy as np
import pytest
import torch
import torch.nn.functional as nnf
from torch import nn

from kstar_torch.config import (CnnLSTMConfig, LossConfig, MLSTMFCNConfig, OptimConfig,
                                R2Plus1DConfig, SlowFastConfig, TrainConfig,
                                TransformerConfig, ViViTConfig)
from kstar_torch.data import VideoDataset, VideoStore, make_dataset, make_pre_fns, split_shots
from kstar_torch.models import TFNGB, build_0d_model, build_video_model, resnet3d
from kstar_torch.train import (create_train_state, fit, load_checkpoint, make_scan_steps,
                               make_train_step, save_checkpoint)
from kstar_torch.train import loop
from kstar_torch.train.state import OPTIMIZERS, Optimizer, TrainState

B, L, RAW, CROP = 8, 5, 48, 32
F, T0D = 18, 21
ADAMW = OptimConfig(optimizer="AdamW", lr=1e-3, use_scheduler=True, step_size=2, gamma=0.5,
                    max_norm_grad=1.0)


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

def _linear_state(name: str) -> TrainState:
    model = nn.Sequential(nn.Linear(6, 5), nn.Tanh(), nn.Linear(5, 2))
    torch.manual_seed(0)
    # clipping at 0.5 and a rate halved every 2 updates: both engage
    tx = Optimizer(name, lr=1e-2, transition_steps=2, decay_rate=0.5, max_norm=0.5)
    return TrainState(model, tx, seed=3)


def _set_grads(state: TrainState, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    for p in state.params:
        p.grad = torch.randn(p.shape, generator=g)
    return state.flat_grads()


def _out_of_place(state: TrainState, finite: torch.Tensor, grads: torch.Tensor):
    """The update as the state wrote it before it wrote in place: new
    tensors for the optimizer state and ``step``."""
    updates, new_opt = state.tx.update(grads, state.opt_state, state.flat)
    return (torch.where(finite, state.flat + updates, state.flat),
            {k: torch.where(finite, v, state.opt_state[k]) for k, v in new_opt.items()},
            torch.where(finite, state.step + 1, state.step))


@pytest.mark.parametrize("applied", [True, False], ids=["applied", "skipped"])
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_apply_gradients_writes_the_state_in_place(name, applied):
    """``apply_gradients`` keeps the identity and storage of ``flat``, each
    ``opt_state`` tensor and ``step``, and gives the out-of-place formula's
    values to the bit, on an applied and on a skipped update."""
    state = _linear_state(name)
    state.apply_gradients(torch.tensor(True), None, _set_grads(state, 1))   # real moments
    grads = _set_grads(state, 2)
    finite = torch.tensor(applied)
    want_flat, want_opt, want_step = _out_of_place(state, finite, grads)
    before = {k: (v, v.data_ptr()) for k, v in state.opt_state.items()}
    flat, step, step_ptr = state.flat, state.step, state.step.data_ptr()
    state.apply_gradients(finite, None, grads)
    assert state.flat is flat and state.step is step and state.step.data_ptr() == step_ptr
    assert set(state.opt_state) == set(before)
    for k, (t, ptr) in before.items():
        assert state.opt_state[k] is t and t.data_ptr() == ptr, k
        assert torch.equal(t, want_opt[k]), k
    assert torch.equal(state.flat, want_flat) and torch.equal(state.step, want_step)
    assert int(state.step) == (2 if applied else 1)


def test_seed_generators_draws_what_next_generators_draws():
    """Generators kept across steps and reseeded each step draw what the new
    generators of ``next_generators`` draw, stream by stream, and ``draws``
    advances the same."""
    fresh, kept = _linear_state("adamw"), _linear_state("adamw")
    gens = tuple(torch.Generator() for _ in range(3))
    for g in gens:
        torch.rand(7, generator=g)                   # kept generators have moved on
    for _ in range(3):
        want = [torch.rand(5, generator=g) for g in fresh.next_generators()]
        assert kept.seed_generators(gens) is gens
        got = [torch.rand(5, generator=g) for g in gens]
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert len({float(w[0]) for w in want}) == 3  # three distinct streams
        assert kept.draws == fresh.draws
    assert kept.draws == 3


def _keep_steps(monkeypatch) -> list:
    """Every ``_TrainStep`` made from now on, in order."""
    made, init = [], loop._TrainStep.__init__

    def keep(self, *a, **k):
        init(self, *a, **k)
        made.append(self)

    monkeypatch.setattr(loop._TrainStep, "__init__", keep)
    return made


@pytest.mark.parametrize("kind", ["step", "scan"])
def test_cpu_steps_never_capture(kind, monkeypatch):
    """On the CPU the step and the K-step call launch eagerly: no capture,
    no replay, no graph held for the state."""
    made = _keep_steps(monkeypatch)
    model = build_video_model("ViViT", ViViTConfig(image_size=CROP, patch_size=16,
                                                   n_frames=L, dim=32, depth=1, n_heads=2,
                                                   d_head=16, scale_dim=2),
                              dtype=torch.float32, generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, ADAMW, steps_per_epoch=1)
    pre = make_pre_fns(CROP, out_dtype=torch.float32)[0]
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 256, (2, 2, L, RAW, RAW, 3), dtype=np.uint8))
    y = torch.from_numpy(rng.integers(0, 2, (2, 2)))
    aux = (torch.ones(2), torch.tensor([0.3, 0.5]))
    if kind == "step":
        step = make_train_step(LossConfig(), pre_fn=pre)
        for i in range(2):
            _, loss, _ = step(state, x[i], y[i], *aux)
        assert step.graph_captures == step.graphed_steps == 0
    else:
        _, loss, _ = make_scan_steps(LossConfig(), pre_fn=pre)(state, x, y, *aux)
        loss = loss.sum()
    assert torch.isfinite(loss) and int(state.step) == 2 and state.draws == 2
    assert len(made) == 1 and made[0].graph_captures == made[0].graphed_steps == 0
    assert made[0].graph_of(state) is None


def test_train_graphed_share_reads_the_steps_spans(monkeypatch):
    """``train_graphed_share`` (``benchmark/metrics/``): the ``train.step``
    spans inside the traced window with ``graphed`` 1, over all of them;
    silent for spans without the attribute (a program that graphs no step)
    and for none."""
    import types

    from benchmark.core.spec import Bench
    from benchmark.core.trace import TraceData
    from kstar_torch.utils import profiling
    from kstar_torch.utils.profiling import SpanRecord

    reader = Bench().metric("train_graphed_share")
    run = types.SimpleNamespace(trace=TraceData(window=(0, 1000)))
    step = lambda t, **a: SpanRecord(t, t + 100, "train.step", None, a)
    for records, want in (
            ([step(0, step=0, graphed=0), step(200, step=1, graphed=1),
              step(400, step=2, graphed=1), step(600, step=3, graphed=1),
              step(950, step=4, graphed=0)], 75.0),         # the last ends outside
            ([step(0, step=0), step(200, step=1)], None),
            ([], None)):
        monkeypatch.setattr(profiling, "spans",
                            lambda name=None, r=records: [s for s in r if name in (None, s.name)])
        assert reader.read(run) == want
    entry = {m["name"]: m for m in Bench().manifest["per_layer"]}["train_graphed_share"]
    assert entry["workloads"] == ["vivit-train-128px"] and entry["layer"] == "train step"


# ---------------------------------------------------------------------------
# CUDA
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


VIDEO = {
    "ViViT": ViViTConfig(image_size=CROP, patch_size=16, n_frames=L, dim=32, depth=2,
                         n_heads=2, d_head=16, scale_dim=2, dropout=0.1, embedd_dropout=0.1),
    "R2Plus1D": R2Plus1DConfig(image_size=CROP, n_frames=L, layer_sizes=(1, 1, 1, 1)),
    "SlowFast": SlowFastConfig(image_size=CROP, n_frames=8, layers=(1, 1, 1, 1)),
    "SlowFast_subbn2": SlowFastConfig(image_size=CROP, n_frames=8, layers=(1, 1, 1, 1),
                                      base_bn_splits=2),
}
ZERO_D = {
    "Transformer": TransformerConfig(n_features=F, feature_dims=32, n_layers=1, n_heads=4,
                                     dim_feedforward=64, cls_dims=16, max_len=T0D),
    "CnnLSTM": CnnLSTMConfig(seq_len=T0D, n_features=F, conv_dim=16, lstm_dim=16, n_layers=2),
    "MLSTM_FCN": MLSTMFCNConfig(n_features=F, fcn_dim=16, seq_len=T0D, lstm_dim=16),
}
FUSION_VIVIT = dict(image_size=CROP, patch_size=8, n_frames=L, dim=32, depth=1, n_heads=2,
                    d_head=16, scale_dim=2, dropout=0.1, embedd_dropout=0.1)
FUSION_TS = dict(n_features=F, feature_dims=32, max_len=L, n_layers=1, n_heads=4,
                 dim_feedforward=64, dropout=0.1, cls_dims=16)


def _model(name: str, dev, seed: int = 0):
    gen = torch.Generator().manual_seed(seed)
    if name in VIDEO:
        m = build_video_model(name.split("_")[0], VIDEO[name], dtype=torch.bfloat16,
                              generator=gen)
    elif name in ZERO_D:
        m = build_0d_model(name, ZERO_D[name], generator=gen)
    else:
        m = TFNGB(vivit_kwargs=FUSION_VIVIT, ts_kwargs=FUSION_TS, dtype=torch.bfloat16,
                  generator=gen)
    return m.to(dev)


def _setup(name: str, dev, members: int = 2, seed: int = 0):
    """(states, step, batches): ``members`` states of the same model (a
    model seeded from ``seed`` + the member index for an ensemble), the
    step function and a batch maker ``batch(i) -> (batch, labels)``."""
    states = [create_train_state(_model(name, dev, seed), ADAMW, steps_per_epoch=1, seed=7)
              for _ in range(members)]
    model_type = "multi-GB" if name == "TFN-GB" else "single"
    pre = make_pre_fns(CROP)[0] if name not in ZERO_D else None     # crop + augment, bf16
    step = make_train_step(LossConfig(), pre_fn=pre, model_type=model_type)
    n_frames = getattr(VIDEO.get(name), "n_frames", L)

    def batch(i):
        rng = np.random.default_rng(100 + i)
        video = lambda: torch.from_numpy(
            rng.integers(0, 256, (B, n_frames, RAW, RAW, 3), dtype=np.uint8)).to(dev)
        zero_d = lambda t: torch.from_numpy(rng.normal(size=(B, t, F)).astype(np.float32)).to(dev)
        x = (zero_d(T0D) if name in ZERO_D
             else {"video": video(), "0D": zero_d(L)} if name == "TFN-GB" else video())
        return x, torch.from_numpy(rng.integers(0, 2, B)).to(dev)

    return states, step, batch


def _aux(dev, i: int = 0, gb: bool = False):
    """(weight, m_list, gb_w): new tensors on every call, as ``fit`` hands a
    new weight each epoch."""
    return (torch.tensor([1.0 + 0.1 * i, 1.0 - 0.05 * i], device=dev),
            torch.tensor([0.3, 0.5], device=dev),
            torch.tensor([0.5, 0.3, 0.2], device=dev) if gb else None)


def _eager(step):
    """The same step function, launched eagerly (what the CPU runs)."""
    def run(state, batch, labels, weight, m_list, gb_w=None):
        loss, preds = step._eager(state, (batch, labels, weight, m_list, gb_w))
        return state, loss, preds
    return run


def _record(state, loss, preds) -> dict:
    rec = {"loss": loss.float().cpu(), "preds": preds.cpu(), "flat": state.flat.cpu(),
           "step": state.step.cpu(),
           **{f"opt.{k}": v.cpu() for k, v in state.opt_state.items()}}
    if state.stats_flat is not None:
        rec["stats"] = state.stats_flat.cpu()
    return rec


def _same(got: list, want: list) -> None:
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.keys() == w.keys()
        for k in w:
            torch.testing.assert_close(g[k], w[k], rtol=0, atol=0, equal_nan=True,
                                       msg=lambda m: f"step {i} {k}: {m}")


def _run(step, state, batch, n, aux=lambda i: None, start=0) -> list:
    out = []
    for i in range(start, start + n):
        x, y = batch(i)
        _, loss, preds = step(state, x, y, *aux(i))
        out.append(_record(state, loss, preds))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["augment_dropout", "nan_step", "new_weight"])
def test_graphed_vivit_step_matches_eager(dev, case):
    """The flagship ViViT with dropout 0.1 and the train augmentation drawing:
    8 steps replayed from the graph equal 8 eager steps to the bit (losses,
    predictions, parameters, every optimizer tensor, ``step``), with one
    eager warm-up, one capture and 7 replays. ``nan_step``: a NaN class
    weight on step 4 makes its loss NaN and the guard skips it, as it does
    eagerly; ``new_weight``: a new weight tensor every step."""
    (eager_state, graph_state), step, batch = _setup("ViViT", dev)
    if case == "augment_dropout":
        aux = lambda i: _aux(dev)
    elif case == "nan_step":
        aux = lambda i: ((torch.full((2,), float("nan"), device=dev),) + _aux(dev)[1:]
                         if i == 4 else _aux(dev))
    else:
        aux = lambda i: _aux(dev, i)
    want = _run(_eager(step), eager_state, batch, 8, aux)
    got = _run(step, graph_state, batch, 8, aux)
    _same(got, want)
    assert step.graph_captures == 1 and step.graphed_steps == 7
    assert step.graph_of(graph_state) is not None and graph_state.draws == 8
    assert step.graph_of(eager_state) is None
    assert int(graph_state.step) == (7 if case == "nan_step" else 8)
    if case == "nan_step":
        assert torch.isnan(got[4]["loss"]) and torch.equal(got[4]["flat"], got[3]["flat"])


@pytest.mark.cuda
def test_load_checkpoint_recaptures(dev, tmp_path):
    """``load_checkpoint`` gives the state new optimizer tensors and a new
    ``step``: the next step runs eagerly, the one after captures anew, and
    every step equals the eager run of the same sequence."""
    out = {}
    for kind in ("eager", "graphed"):
        (state,), step, batch = _setup("ViViT", dev, members=1)
        run = _eager(step) if kind == "eager" else step
        rec = _run(run, state, batch, 3, lambda i: _aux(dev))
        path = str(tmp_path / f"{kind}.ckpt")
        save_checkpoint(state, path)
        rec += _run(run, state, batch, 1, lambda i: _aux(dev), start=3)
        load_checkpoint(state, path)
        rec += _run(run, state, batch, 4, lambda i: _aux(dev), start=3)
        out[kind] = rec
        if kind == "graphed":
            assert step.graph_captures == 2 and step.graphed_steps == 3 + 3
    _same(out["graphed"], out["eager"])


@pytest.mark.cuda
def test_reset_bn_splits_recaptures(dev):
    """The multigrid long cycle's new split statistics (new buffers of
    another shape) recapture; every step equals the eager step from the
    same state (``_lockstep``)."""
    step, got, want, again = _lockstep("SlowFast_subbn2", dev, 6,
                                       reset=(3, lambda st: st.reset_bn_splits(4)))
    assert step.graph_captures == 2 and step.graphed_steps == 2 + 2
    _spread_or_same(got, want, again)


@pytest.mark.cuda
def test_ensemble_members_keep_their_own_graphs(dev):
    """Two members stepped in turn by one step function (the ensemble's
    ``make_ensemble_step``) each capture once and replay their own graph;
    each equals its eager twin."""
    want_states = [create_train_state(_model("ViViT", dev, s), ADAMW, steps_per_epoch=1, seed=s)
                   for s in (0, 1)]
    got_states = [create_train_state(_model("ViViT", dev, s), ADAMW, steps_per_epoch=1, seed=s)
                  for s in (0, 1)]
    _, step, batch = _setup("ViViT", dev, members=0)
    want, got = [[], []], [[], []]
    for i in range(5):
        x, y = batch(i)
        for m in range(2):
            _, loss, preds = _eager(step)(want_states[m], x, y, *_aux(dev))
            want[m].append(_record(want_states[m], loss, preds))
            _, loss, preds = step(got_states[m], x, y, *_aux(dev))
            got[m].append(_record(got_states[m], loss, preds))
    for m in range(2):
        _same(got[m], want[m])
    assert step.graph_captures == 2 and step.graphed_steps == 2 * 4
    first, second = (step.graph_of(st) for st in got_states)
    assert first is not second and first.graph.pool() == second.graph.pool()   # one pool
    assert first.inputs[0] is second.inputs[0]                        # one static batch


@pytest.mark.cuda
def test_two_threads_step_two_states_on_one_device(dev):
    """Two threads step two states on one card at once, as ``hpo_run
    --hpo_workers 2`` trains two trials, one step apart, so that one
    thread's eager warm-up and replays run while the other captures. Each
    thread captures once into a pool of its own, and each state's steps
    equal its eager twin's to the bit."""
    n = 6
    states = {s: create_train_state(_model("ViViT", dev, s), ADAMW, steps_per_epoch=1, seed=s)
              for s in (0, 1)}
    twins = {s: create_train_state(_model("ViViT", dev, s), ADAMW, steps_per_epoch=1, seed=s)
             for s in (0, 1)}
    _, eager_step, batch = _setup("ViViT", dev, members=0)
    batches = [batch(i) for i in range(n)]
    want = {s: [] for s in states}
    for s, twin in twins.items():
        for x, y in batches:
            _, loss, preds = _eager(eager_step)(twin, x, y, *_aux(dev))
            want[s].append(_record(twin, loss, preds))
    steps = {s: make_train_step(LossConfig(), pre_fn=make_pre_fns(CROP)[0]) for s in states}
    got = {s: [] for s in states}
    barrier, errors = threading.Barrier(2, timeout=120), []

    def work(s: int, lag: int) -> None:
        try:
            for phase in range(n + 1):
                barrier.wait()
                i = phase - lag
                if 0 <= i < n:
                    _, loss, preds = steps[s](states[s], *batches[i], *_aux(dev))
                    got[s].append((loss, preds))
            torch.cuda.synchronize()
        except BaseException as e:                  # noqa: BLE001 - reported below
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=work, args=(s, s)) for s in states]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for s, state in states.items():
        assert steps[s].graph_captures == 1 and steps[s].graphed_steps == n - 1
        assert [(torch.equal(l, w["loss"].to(dev)), torch.equal(p, w["preds"].to(dev)))
                for (l, p), w in zip(got[s], want[s])] == [(True, True)] * n
        _same([_record(state, *got[s][-1])], want[s][-1:])
    graphs = [steps[s].graph_of(states[s]) for s in states]
    assert graphs[0].key[-1] is not graphs[1].key[-1]
    assert graphs[0].graph.pool() != graphs[1].graph.pool()


@pytest.mark.cuda
def test_graph_goes_with_its_state_or_its_step(dev):
    """A graph is held weakly by its state: it goes when the state goes,
    and when the step function goes (a finished ``fit``) while the state
    is kept (an HPO trial's carry). With no graph of the thread left, the
    next capture takes a new pool (CUDA freed the old one with its last
    graph) and replays as the eager step."""
    import gc
    import weakref

    (kept, dropped), step, batch = _setup("ViViT", dev)
    for st in (kept, dropped):
        _run(step, st, batch, 3, lambda i: _aux(dev))
    graphs = [weakref.ref(step.graph_of(st)) for st in (kept, dropped)]
    assert all(g() is not None for g in graphs) and step.graph_captures == 2
    del dropped, st
    gc.collect()
    assert graphs[0]() is not None and graphs[1]() is None
    del step
    gc.collect()
    assert graphs[0]() is None and int(kept.step) == 3
    assert loop._shared_pool(kept.device) is None
    (twin, fresh), step, batch = _setup("ViViT", dev)
    want = _run(_eager(step), twin, batch, 5, lambda i: _aux(dev))
    _same(_run(step, fresh, batch, 5, lambda i: _aux(dev)), want)
    assert step.graph_captures == 1 and loop._shared_pool(fresh.device) is not None


@pytest.mark.cuda
def test_fit_epochs_with_threaded_batches_match_eager(dev, tmp_path, monkeypatch):
    """Two ``fit`` epochs (the producer thread's batches, DRW's new weight in
    the second epoch) end where the same epochs launched eagerly end."""
    shots, disrupt_df, _ = make_dataset(n_shots=6, n_frames=96, height=RAW, width=RAW, seed=0)
    store = VideoStore.from_arrays({s.shot: s.frames for s in shots})
    train_s, valid_s, _ = split_shots(sorted(store.arrays), None)
    mk = lambda ss: VideoDataset(store, disrupt_df, ss, seq_len=L)
    train_ds, valid_ds = mk(train_s), mk(valid_s)
    pre, pre_eval = make_pre_fns(CROP)
    out = {}
    for kind in ("eager", "graphed"):
        with monkeypatch.context() as mp:
            made = _keep_steps(mp)
            if kind == "eager":
                mp.setattr(loop._TrainStep, "__call__",
                           lambda self, state, *a: (state, *self._eager(state, (*a, None)[:5])))
            state = create_train_state(_model("ViViT", dev), ADAMW, steps_per_epoch=1, seed=7)
            cfg = TrainConfig(batch_size=B, num_epoch=2, seed=0, verbose=0,
                              weight_dir=str(tmp_path / kind))
            state, hist = fit(state, train_ds, valid_ds, cfg, LossConfig(use_drw=True),
                              tag="t", pre_fn=pre, pre_fn_eval=pre_eval)
            out[kind] = (hist.train_loss, _record(state, torch.zeros(()), torch.zeros(0)))
    assert len(made) == 1 and made[0].graph_captures == 1
    assert made[0].graphed_steps == 2 * (len(train_ds) // B) - 1
    assert out["graphed"][0] == out["eager"][0]
    _same([out["graphed"][1]], [out["eager"][1]])
    assert int(out["graphed"][1]["step"]) == 2 * (len(train_ds) // B)


def _load(dst: TrainState, src: TrainState) -> None:
    """``src``'s parameters, statistics, optimizer state, ``step`` and
    ``draws`` into ``dst`` (a state of the same model), in place."""
    with torch.no_grad():
        dst.flat.copy_(src.flat)
        if src.stats_flat is not None:
            dst.stats_flat.copy_(src.stats_flat)
        for k, v in src.opt_state.items():
            dst.opt_state[k].copy_(v)
        dst.step.copy_(src.step)
    dst.draws = src.draws


def _lockstep(name: str, dev, n: int, reset=None):
    """(step, graphed, eager, eager again): per step, the graphed state's
    step, and two eager steps of a twin loaded with the graphed state as it
    stood before that step, so each step is compared from the same state
    (SlowFast's max-pool backward adds with atomics: two eager runs part,
    and over steps the parting grows). ``reset``: (step index, a function
    applied to both states before that step)."""
    (graphed, twin), step, batch = _setup(name, dev)
    gb = name == "TFN-GB"
    got, want, again = [], [], []
    for i in range(n):
        if reset is not None and i == reset[0]:
            reset[1](graphed)
            reset[1](twin)
        x, y = batch(i)
        for out in (want, again):
            _load(twin, graphed)
            _, loss, preds = _eager(step)(twin, x, y, *_aux(dev, gb=gb))
            out.append(_record(twin, loss, preds))
        _, loss, preds = step(graphed, x, y, *_aux(dev, gb=gb))
        got.append(_record(graphed, loss, preds))
    return step, got, want, again


def _spread_or_same(got: list, want: list, again: list) -> None:
    """Step by step: to the bit where the two eager steps agree to the bit;
    else each tensor within 4x their own gap (0 where they agree)."""
    for i, (g, w, a) in enumerate(zip(got, want, again)):
        for k in w:
            spread = float((a[k].double() - w[k].double()).abs().nan_to_num().max())
            gap = float((g[k].double() - w[k].double()).abs().nan_to_num().max())
            assert gap <= 4 * spread, (i, k, gap, spread)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["R2Plus1D", "SlowFast", "CnnLSTM", "MLSTM_FCN",
                                  "Transformer", "TFN-GB"])
def test_every_trained_family_graphs_as_eager(dev, name):
    """Each family the CLIs train, its draws on (augmentation, dropout, 0D
    input noise): three graphed steps (warm-up, capture, replay), each
    against the eager step from the same state."""
    step, got, want, again = _lockstep(name, dev, 3)
    assert step.graph_captures == 1 and step.graphed_steps == 2
    _spread_or_same(got, want, again)


def _max_pool_by_slices(x: torch.Tensor, window, stride, padding) -> torch.Tensor:
    """``models/common.py max_pool3d`` as the maximum of the window's
    strided slices of the -inf padded input: the same values, and a
    backward that adds without atomics."""
    (kt, kh, kw), (st, sh, sw), (pt, ph, pw) = window, stride, padding
    xp = nnf.pad(x, (0, 0, pw, pw, ph, ph, pt, pt), value=float("-inf"))
    size = [(n + 2 * p - k) // s + 1 for n, k, s, p in
            zip(x.shape[1:4], window, stride, padding)]
    out = None
    for a in range(kt):
        for b in range(kh):
            for c in range(kw):
                v = xp[:, a:a + st * (size[0] - 1) + 1:st, b:b + sh * (size[1] - 1) + 1:sh,
                       c:c + sw * (size[2] - 1) + 1:sw]
                out = v if out is None else torch.maximum(out, v)
    return out


def test_max_pool_by_slices_equals_max_pool3d():
    """The slices' maximum gives ``models/common.py max_pool3d``'s values
    at the SlowFast stem's window, on odd and even sizes (CPU)."""
    from kstar_torch.models.common import max_pool3d

    x = torch.randn(2, 3, 9, 8, 5, generator=torch.Generator().manual_seed(0))
    for y in (x, x[:, :, :7, :7]):
        args = ((1, 3, 3), (1, 2, 2), (0, 1, 1))
        assert torch.equal(_max_pool_by_slices(y, *args), max_pool3d(y, *args))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["SlowFast", "SlowFast_subbn2"])
def test_slowfast_trajectory_without_atomics_matches_eager(dev, name, monkeypatch):
    """The whole trajectory, beside the step-by-step check: with the stem's
    max-pool backward free of atomics (``_max_pool_by_slices``) and
    cuDNN's deterministic algorithms, 6 graphed SlowFast steps equal 6
    eager steps to the bit, the SubBatchNorm model's with the long cycle's
    ``reset_bn_splits(4)`` before step 3, which recaptures. So what parts
    the two paths of the real model is the atomics' order, not a statistic
    left stale by a recapture."""
    monkeypatch.setattr(resnet3d, "max_pool3d", _max_pool_by_slices)
    reset = 3 if name == "SlowFast_subbn2" else None
    out = {}
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True):
        for kind in ("eager", "graphed"):
            (state,), step, batch = _setup(name, dev, members=1)
            run = _eager(step) if kind == "eager" else step
            rec = []
            for i in range(6):
                if i == reset:
                    state.reset_bn_splits(4)
                x, y = batch(i)
                _, loss, preds = run(state, x, y, *_aux(dev))
                rec.append(_record(state, loss, preds))
            out[kind] = rec
    assert step.graph_captures == (2 if reset else 1)
    assert step.graphed_steps == (2 + 2 if reset else 5)
    _same(out["graphed"], out["eager"])

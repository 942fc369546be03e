#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (kstar_torch) on one card.

    python3 chip_smoke.py [--seed 0] [--frames 4096]

Builds the hand-written kernels from kstar_torch/csrc, holds each against
its plain PyTorch version on the card (the conv epilogue kernel at every
shape a bf16 R(2+1)D forward at B = 128 hands it, then that whole forward
on the kernel against the eager chain, bit for bit: ``conv_epilogue``),
then drives the port's paths at the
width of the flagship ViViT (dim 128, depth 2, 4 heads x 64, MLP 1024,
128 px crop, 21-frame windows, bf16, random weights from --seed):

  sweep         the stride-1 whole-shot sweep over a synthetic 4096-frame
                shot, the probability curve and its alarm (spatial-table
                kernel)
  f32_sweep     the same sweep with compute_dtype float32 (the spatial-table
                kernel's f32 instance, split TF32): clips/s, the table,
                window loop and embedding apart, the curve against the plain
                f32 table's (three timed sweeps)
  vivit_pallas  the ViViT forward with the fused-attention kernel, in bf16
                and in f32 (its split-TF32 instance)
  stream        frames in, alarms out: block size chosen by probing at the
                camera's 210 fps, block times and frame-to-alarm latency,
                blocks against single pushes and against the plain gather
                (window-gather kernel; fused attention in a second model)
  raw_sweep     the sweep of a model without the token path (window-gather
                kernel per chunk) against the token path
  library       sweep_shots over six ragged shots in two groups against
                per-shot sweeps, then alarm scoring of the curves
  train         fit's train step at batch 64 (augmentation inside the step,
                AdamW, Focal): step times, clips/s, peak memory, launches;
                the NaN guard; card against CPU in f32
  train_cli     kstar_torch.cli.train_vision --synthetic for 2 epochs, then
                --resume for one more (the alarm sweep runs the table kernel)
  video_sweep_fallback
                the sweep's table route at 401 tokens (patch 4, 80 px), past
                what the table kernel takes: the plain table, no launch, and
                an error when the kernel is forced; the flagship takes it
  full_frame_sweep
                the flagship widths at image_size 256 over the shot's whole
                256 px frames (257 tokens, the table kernel's two-block
                cluster instance, one launch a sweep): clips/s, the table and
                window loop apart, the curve against the plain table's (timed
                once); and 512-frame sweeps at the 160, 192 and 224 px crops
                (101, 145, 197 tokens), each one launch; the table kernel is
                held against its plain version at each of those crops and
                over the whole shot at 256 px
  f32_full_frame_sweep
                the same in f32 (compute_dtype float32): the whole shot at
                256 px on the f32 instance's cluster of five 64-row blocks
                (one launch a sweep), clips/s, the table and window loop
                apart, the curve against the plain f32 table's (timed once)
                within F32_CURVE_TOL, and the 160, 192 and 224 px sweeps on
                clusters of 2, 3 and 4; the kernel is held against its plain
                version at those crops and over the whole shot

and then the three 0D models at their default widths (Transformer dim 128
x 4 layers x 8 heads, FF 1024; CnnLSTM conv 64, LSTM 128 x 4 layers,
bidirectional; MLSTM-FCN FCN 128, LSTM 128 bidirectional; 18 features,
21-sample windows, random weights from --seed), paths that run none of the
kernels (each phase reads their launch counts as 0):

  ts_models       eval forward at batch 256: f32 card against CPU, bf16
                  against f32, times, launches
  ts_sweep        predict_0d_shot / TSSweeper over a 4096-row 0D table
  ts_stream       StreamingPredictor(modality="0D"), MLSTM-FCN at 52.5 Hz
  train_0d        fit's step at batch 256 per model: times, memory,
                  launches, the NaN guard with the BatchNorm buffers, card
                  against CPU in f32
  hard_fixture_f1 bench.py's metric 3 (MLSTM-FCN hard-fixture macro-F1)
                  from the port's own data layer and trainer
  train_0d_cli    kstar_torch.cli.train_0d --model MLSTM_FCN --synthetic
                  for 2 epochs, then --resume for one more

and last the four fusion models (concat, concat_GB, TFN, TFN_GB) at the
train_multimodal CLI's widths (the ViViT above with an MLP of 512, the 0D
Transformer 128 x 4 layers x 8 heads, FF 512), paired with a 0D table of
one row per frame (1/210 s, 18 features, a random walk from --seed); the
spatial-table kernel is also held against its plain version at the fusion
ViViT's MLP of 512 over the whole shot:

  fusion_models         eval forward at batch 32: f32 card against CPU,
                        bf16 against f32, forward_spatial_cls against the
                        full forward, times, launches
  multimodal_sweep      MultiModalSweeper (batch 32) over the shot for
                        concat and TFN_GB: windows/s, the table (one
                        spatial-table launch per sweep) and the window loop
                        apart, idle share, the curve against the plain
                        table's, predict_multimodal_shot
  train_multimodal      fit's multi (concat) and multi-GB (TFN_GB) steps at
                        batch 32, card against CPU in f32, one gb_estimate
  train_multimodal_cli  kstar_torch.cli.train_multimodal --synthetic, concat
                        and TFN with dynamic Gradient Blending, 2 epochs and
                        a resume (the alarm sweep runs the table kernel)

and then the conv video models at kstar_torch/config.py's full widths
(R(2+1)D: 128 px, 21 frames, layer_sizes (1, 2, 2, 1); SlowFast: 128 px,
20 frames, layers (3, 4, 6, 3), alpha 4, m 16; SlowFast with SubBatchNorm,
base_bn_splits 2; random weights from --seed, BatchNorm statistics
calibrated on windows of the shot), whose sweep and stream take the raw
frames through the window-gather kernel (also held against its plain
version at SlowFast's 20-frame windows):

  conv_models     eval forward at batch 32: f32 card against CPU, bf16
                  against f32, times, launches, operations per clip; the
                  SubBatchNorm model after aggregation against plain
                  BatchNorms holding the aggregate
  conv_sweep      VideoSweeper (B = 128) over the shot: clips/s, one
                  window-gather launch per chunk, the curve against the
                  plain gather's, the operation bound and its share,
                  predict_video_shot
  conv_stream     StreamingPredictor: block size probed at 210 fps, 30
                  timed blocks, frame-to-alarm, blocks against single pushes
  train_conv      fit's step at batch 64 per model: times, memory,
                  launches, idle share, the NaN guard with the split
                  statistics, card against CPU in f32, the aggregation
  train_conv_cli  kstar_torch.cli.train_vision --model R2Plus1D (2 epochs
                  and a resume) and --model SlowFast --bn_splits 2: the
                  alarm sweep runs the window-gather kernel, not the table

and last the port's reload, predict, explain and report entry points, on
the checkpoints the CLI phases above wrote (into one directory that lives
until the end):

  reload_eval            kstar_torch.cli.evaluate_model on the ViViT,
                         SlowFast --bn_splits 2 (--alarms), MLSTM-FCN (0D)
                         and concat (multimodal --alarms) checkpoints: the
                         trainer's test line and alarm rows, the 0D detail
                         CSV; the table kernel on the ViViT and multimodal
                         sweeps, the window-gather kernel on SlowFast's
  continuous_prediction  kstar_torch.cli.make_continuous_prediction
                         --video_tag <train_cli's tag>: one table-kernel
                         launch, the curve against predict_video_shot, the
                         figures or their skip lines (no matplotlib); then
                         again with --compute_dtype float32, its one launch
                         on the table kernel's f32 instance
  xai                    Grad-CAM (R(2+1)D), guided-backprop saliency
                         (R(2+1)D, SlowFast) and attention rollout (ViViT)
                         at batch 2 in f32, card against CPU; no kernel
  compute_time           kstar_torch.cli.compute_time at its defaults (seven
                         models, batch 1 and 64) and model_summary's eight
                         parameter totals

and then the dataset ETL, seed ensembles, hyper-parameter search and mixup:

  etl       a raw 0D dump and five shots of 256 px frames made from --seed,
            through extend_shot_log, clean_signals, valid_shots,
            build_0d_table, sync_video_0d and the jpg repack into a
            --data_root, read back by load_data; predict_video_shot with the
            flagship ViViT (one table-kernel launch) and predict_0d_shot on
            a built shot; wall seconds per stage
  ensemble  train_0d --model MLSTM_FCN --seeds 40 41 42 43 and train_vision
            --model ViViT --seeds 1 2 (the alarm sweep runs the table
            kernel); a 4-member MLSTM-FCN ensemble against solo runs of its
            seeds on the card (f32, 3 SGD steps); the 4-member step against
            a solo step (MLSTM-FCN batch 256, ViViT batch 64)
  hpo       hpo_run --model MLSTM_FCN on the hard synthetic fixture with
            --search random (twice), --search tpe, --hpo_vmap and
            --hpo_workers 2; the repeated, --hpo_vmap and threaded runs
            against the serial one (configs, promotions, scores to 1e-6)
  mixup     mixup and the three video CutMix modes: the same draws on the
            card and on the CPU give the same batch exactly

and last data parallelism over torch.distributed (kstar_torch/parallel),
in a NCCL group of this one process and a gloo group of two spawned ranks
that share the card (NCCL refuses two ranks on one device):

  parallel  train_vision --dp 1 at the flagship widths (the alarm sweep
            runs the table kernel); 3 data-parallel steps against 3 plain
            steps at batch 64; one NCCL all-reduce of the ViViT's flat
            gradient and the two steps' p50; VideoSweeper(mesh=) over the
            library's six shots against the unsharded sweep; a sharded
            checkpoint round trip; on the two gloo ranks, MLSTM-FCN's
            data-parallel steps and the ViViT library sweep (the table
            kernel on both ranks) against one rank

and last what kstar_tpu trained, served and resumed by the port, and the
scale soaks:

  jax_checkpoint  the flagship ViViT, MLSTM-FCN, R(2+1)D and concat after 3
                  AdamW steps, written in kstar_tpu's checkpoint format by the
                  port's encoder (no JAX here): file size and read seconds;
                  load_params gives the same logits exactly, load_checkpoint
                  the same next step; evaluate_model --alarms from the ViViT
                  (table kernel) and R(2+1)D (window-gather kernel)
                  directories; train_0d --resume from the MLSTM-FCN one
  soak            the table kernel at T = 12,600 against its plain version;
                  kstar_torch.analysis.soak_long_shot at 12,600 frames (a
                  60 s shot: sweep cold and steady, plain-table curve, the
                  k = 16 stream) and soak_library_sweep at 8 shots of
                  2,300-4,096 frames (both frame ladders, a budget forced to
                  several groups, the per-shot path)

and last the repository's demos and its horizon x seed campaign through the
port, whose ViViT (64 px, dim 64, 4 heads x 32, MLP 256) takes the
spatial-table kernel's fast instance compiled for D 64 / d_head 32 in bf16
(held against its plain version at the demo's 2520 and the campaign's 1680
frames):

  demos     kstar_torch.analysis.demos: exp/demo_vivit.sh's and
            exp/demo_multimodal.sh's argument lists cut to 2 epochs (and one
            one-epoch GB estimate): alarm JSON with JAX's keys over the 33
            swept shots, one table-kernel launch per shot
  campaign  kstar_torch.analysis.campaign_dist_sweep at dist 21, seeds 40-43,
            one epoch: every member's row finite, one table-kernel launch
            per swept shot and member

Every phase prints one JSON line and any failure exits non-zero. Then come
the per-kernel summary line, the card's name and power limit as nvidia-smi
reports them, and the result line {"ok": true, "device": {...}}. Without
CUDA it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import types

import torch

SEQ_LEN, CROP, RESIZE, BATCH = 21, 128, 256, 128
SMALL_CROP = 64                   # 16 patches + cls = 17 tokens
HBM_BYTES_PER_S = 3.35e12         # H100 SXM, NVIDIA data sheet
PEAK_OPS_PER_S = {"bfloat16": 989e12,   # dense tensor cores
                  "float32": 67e12,     # f32 outside the tensor cores
                  "tf32": 495e12}       # dense tensor cores, TF32 operands


T_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line per phase, with the seconds since the script started."""
    print(json.dumps({"phase": phase, **fields,
                      "elapsed_s": time.perf_counter() - T_START}), flush=True)


def time_ms(fn, iters: int) -> float:
    """Mean device time of fn() over iters launches (CUDA events), after a
    warm-up call. The launches are queued behind a busy-wait on the device
    that outlasts their enqueueing (measured in a first pass), so a kernel
    shorter than its wrapper's host time is timed at the device's rate and
    not at the host's launch rate."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_s = time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(min(enqueue_s, 0.25) * 2 * 2e9))   # cycles; the SM clock is < 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rotating(fn, n: int = 4):
    """fn with its last n results kept alive, so that a wrapper that
    allocates its output gets other memory each launch and a result smaller
    than the 50 MB L2 is not rewritten in place there."""
    keep, i = [None] * n, [0]

    def run():
        keep[i[0] % n] = fn()
        i[0] += 1
    return run


def wall_ms(fn, warmup: bool = True) -> float:
    """Host time of fn() followed by a synchronise, after a warm-up call."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def test_line(text: str):
    """The "test macro-F1 x | ROC-AUC y" line a train or evaluate CLI prints."""
    import re

    m = re.search(r"test macro-F1 [0-9.]+ \| ROC-AUC [0-9.]+", text)
    return m.group(0) if m else None


def compare(got, want, atol: float, rtol: float, mean_tol: float) -> dict:
    """Elementwise |got - want| <= atol + rtol*|want| and a mean-error bound."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ok = bool(torch.isfinite(got).all() and (err <= atol + rtol * want.abs()).all()
              and err.mean() <= mean_tol)
    return {"max_abs_err": float(err.max()),
            "max_rel_err": float(err.max() / want.abs().max().clamp_min(1e-30)),
            "mean_abs_err": float(err.mean()), "atol": atol, "rtol": rtol,
            "mean_tol": mean_tol, "ok": ok}


def bound(ops: float, nbytes: float, dtype: str) -> tuple:
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def row_bounds(ops: float, nbytes: float, dtype: str) -> dict:
    """bound_ms and bound_by of a kernel_check row: in bf16 the tensor
    cores' rate; in f32 the lesser of two bounds, both printed: the
    operations on the f32 FMA units (67 TFLOP/s), and in split TF32 (three
    TF32 products each, 495 TFLOP/s) on the tensor cores."""
    bound_ms, bound_by = bound(ops, nbytes, dtype)
    if dtype != "float32":
        return dict(bound_ms=bound_ms, bound_by=bound_by)
    tf32_ms, tf32_by = bound(3 * ops, nbytes, "tf32")
    fields = dict(bound_f32_fma_ms=bound_ms, bound_split_tf32_ms=tf32_ms)
    if tf32_ms < bound_ms:
        bound_ms, bound_by = tf32_ms, tf32_by
    return dict(bound_ms=bound_ms, bound_by=bound_by, **fields)


def table_work(T, n_off, N, D, depth, H, dh, M, elem):
    """Operations and bytes of one spatial-table call, counting only what
    the output needs: the table keeps the cls row after the final LN, so
    the last layer needs K and V for all N rows but the query, attention,
    out-projection and FF for row 0 alone. Each input read once, output
    once."""
    inner = H * dh
    full_layer = 2 * N * (D * 3 * inner + inner * D + D * M + M * D) + 4 * H * N * N * dh
    last_layer = (2 * N * D * 2 * inner                       # K, V: all rows
                  + 2 * (D * inner + inner * D + D * M + M * D)  # Q, out, FF: cls
                  + 4 * H * N * dh)                           # cls scores and AV
    ops = ((depth - 1) * full_layer + last_layer) * n_off * T
    weights = depth * (3 * inner * D + inner * D + D * M + M * D + 2 * D + M) * elem \
        + depth * 4 * D * 4 + 2 * D * 4
    nbytes = (T * N * D + n_off * N * D + n_off * T * D) * elem + weights
    return ops, nbytes


def table_attributes(D: int, d_head: int, N: int = 1, dtype=torch.bfloat16) -> dict:
    """The fast (or f32) instance at (D, d_head) for N tokens as the card
    takes it (registers, shared memory, threads, blocks per SM, blocks per
    cluster and clusters resident) when the last K1 launch took a fast
    instance, for its kernel_check row; else nothing."""
    from kstar_torch.ops.spatial_table import fast_kernel_attributes, spatial_table

    if not (spatial_table.instance or "").startswith("fast"):
        return {}
    return {"kernel_attributes": fast_kernel_attributes(D, d_head, N, dtype)}


def time_once(fn) -> float:
    """Device time of one call of fn() (CUDA events), for a plain version
    too slow to repeat; the caller has run it once before."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def step_launches(step) -> tuple:
    """(kernel launches, device-busy ms, wall ms, the 8 kernels with the most
    device time) of one call of step() under torch.profiler; Nones when the
    profiler sees no device. The wall time includes the profiler's own host
    overhead."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and "memcpy" not in e.name.lower() and "memset" not in e.name.lower()]
    if not kernels:
        return None, None, None, None
    by_name = {}
    for e in kernels:
        n, ms = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, ms + e.device_time / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return (len(kernels), sum(e.device_time for e in kernels) / 1e3, wall_ms,
            [{"kernel": k[:96], "launches": n, "ms": ms} for k, (n, ms) in top])


def train_phase(seed: int, frames, cfg, dev) -> tuple:
    """fit's train step at the flagship's width: ViViT in bf16 over f32
    parameters, batch 64 of uint8 21-frame clips from the 256 px shot,
    cropped to 128, augmented and normalised inside the step; Focal loss
    (gamma 2), AdamW lr 2e-4 with the staircase decay (one "epoch" per step,
    so the rate steps every 4 updates), clip 1.0. 5 warm-up steps, then 30
    steps each timed on the host clock up to a synchronise. Checks: (a)
    finite losses and every parameter moved; (b) a step whose loss is made
    non-finite (NaN class weights) leaves parameters, optimizer state and
    step bit-identical; (c) card against CPU from the same weights, f32,
    dropout 0, no augmentation, 3 steps."""
    import numpy as np

    from kstar_torch.config import LossConfig, OptimConfig
    from kstar_torch.data import make_pre_fns, to_device
    from kstar_torch.losses import ldam_margins
    from kstar_torch.models import build_video_model
    from kstar_torch.train import create_train_state, make_train_step

    stage_s, t_stage = {}, [time.perf_counter()]

    def stage(name: str) -> None:
        """Seconds since the previous stage ended, up to a synchronise."""
        torch.cuda.synchronize()
        now = time.perf_counter()
        stage_s[name], t_stage[0] = now - t_stage[0], now

    B = 64
    rng = np.random.default_rng(seed)
    n_batches = 2
    starts = rng.integers(0, len(frames) - SEQ_LEN, size=(n_batches, B))
    clips = [to_device(frames[s[:, None] + np.arange(SEQ_LEN)], dev) for s in starts]
    labels = [torch.as_tensor(rng.integers(0, 2, size=B)).to(dev) for _ in range(n_batches)]
    loss_cfg = LossConfig()
    weight = torch.ones(2, device=dev)
    m_list = torch.as_tensor(ldam_margins(np.array([B // 2, B // 2]))).to(dev)

    model = build_video_model("ViViT", cfg, dtype=torch.bfloat16,
                              generator=torch.Generator().manual_seed(seed)).to(dev)
    state = create_train_state(model, OptimConfig(), steps_per_epoch=1, seed=seed)
    pre_train, pre_eval = make_pre_fns(CROP, out_dtype=torch.bfloat16)
    step = make_train_step(loss_cfg, pre_fn=pre_train)
    start_params = [p.detach().clone() for p in state.params]
    stage("batches_and_model")
    losses, times = [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(35):
        t0 = time.perf_counter()
        _, loss, _ = step(state, clips[i % n_batches], labels[i % n_batches], weight, m_list)
        torch.cuda.synchronize()
        if i >= 5:
            times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = torch.stack(losses).cpu().numpy()
    moved = [not torch.equal(a, p.detach()) for a, p in zip(start_params, state.params)]
    stage("steps")
    launches, busy_ms, prof_wall_ms, top_kernels = step_launches(
        lambda: step(state, clips[0], labels[0], weight, m_list))
    stage("profile")

    # (b) the NaN guard
    before = (state.flat.clone(), {k: v.clone() for k, v in state.opt_state.items()},
              state.step.clone())
    _, nan_loss, _ = step(state, clips[0], labels[0],
                          torch.full((2,), float("nan"), device=dev), m_list)
    guard_ok = (not bool(torch.isfinite(nan_loss)) and torch.equal(state.flat, before[0])
                and all(torch.equal(state.opt_state[k], v) for k, v in before[1].items())
                and torch.equal(state.step, before[2]))
    stage("nan_guard")

    # (c) card against CPU, f32: both sides compute the same f32 arithmetic
    # (TF32 is off) in another summation order. An AdamW step moves each
    # parameter by ~lr = 2e-4 whatever its gradient's size, and a gradient
    # element within rounding of zero may take the other sign on the other
    # device, so the parameters after 3 steps are held at 1e-4 (half of one
    # step's move), the losses at 1e-3 relative and the first step's
    # gradients at 1e-3 of their largest element. Measured on an H100:
    # 5.1e-6, 4.4e-6 and 5.5e-7.
    Bc = 8
    f32_cfg = dataclasses.replace(cfg, dropout=0.0, embedd_dropout=0.0)
    base = build_video_model("ViViT", f32_cfg, dtype=torch.float32,
                             generator=torch.Generator().manual_seed(seed + 1))
    runs = []
    for d in (dev, torch.device("cpu")):
        st = create_train_state(copy.deepcopy(base).to(d), OptimConfig(),
                                steps_per_epoch=1, seed=seed)
        stp = make_train_step(loss_cfg, pre_fn=pre_eval)    # crop + normalise only
        ls, grads = [], None
        for i in range(3):
            _, loss, _ = stp(st, clips[i % n_batches][:Bc].to(d), labels[i % n_batches][:Bc].to(d),
                             weight.to(d), m_list.to(d))
            ls.append(float(loss))
            if grads is None:
                grads = st.flat_grads().cpu()
        runs.append((np.array(ls), st.flat.cpu(), grads))
    (l_gpu, p_gpu, g_gpu), (l_cpu, p_cpu, g_cpu) = runs
    loss_rel = float(np.max(np.abs(l_gpu - l_cpu) / np.abs(l_cpu)))
    param_err = float((p_gpu - p_cpu).abs().max())
    grad_rel = float((g_gpu - g_cpu).abs().max() / g_cpu.abs().max())
    parity_ok = loss_rel <= 1e-3 and param_err <= 1e-4 and grad_rel <= 1e-3
    stage("card_vs_cpu")

    t = np.asarray(times)
    fields = dict(
        batch=B, crop=CROP, frames=SEQ_LEN, dtype="bfloat16 over f32 parameters",
        optimizer="AdamW lr 2e-4 staircase 0.95 every 4 updates, clip 1.0",
        loss="Focal gamma 2", steps_timed=len(t), step_p50_ms=float(np.median(t)),
        step_p99_ms=float(np.percentile(t, 99)), step_runs_ms=t.tolist(),
        clips_per_s=B * len(t) / (t.sum() / 1e3), peak_mem_gb=peak_gb,
        launches_per_step=launches, profiled_step_device_busy_ms=busy_ms,
        profiled_step_wall_ms=prof_wall_ms, top_kernels=top_kernels,
        # the profiled step's device time against the unprofiled step's p50
        device_idle_share=None if busy_ms is None else 1 - busy_ms / float(np.median(t)),
        losses=losses.tolist(), params_moved=f"{sum(moved)}/{len(moved)}",
        nan_guard_bit_identical=guard_ok,
        card_vs_cpu={"batch": Bc, "losses_cuda": l_gpu.tolist(), "losses_cpu": l_cpu.tolist(),
                     "loss_max_rel": loss_rel, "loss_rtol": 1e-3,
                     "param_max_abs": param_err, "param_atol": 1e-4,
                     "grad_max_rel": grad_rel, "grad_rtol": 1e-3},
        stage_s=stage_s)
    ok = bool(np.isfinite(losses).all() and all(moved) and guard_ok and parity_ok)
    return ok, fields


def train_cli_phase(tmp: str) -> tuple:
    """python -m kstar_torch.cli.train_vision --synthetic --num_epoch 2 at the
    flagship widths (the synthetic shots are 64 px, so the crop is 64), then
    --resume for one more epoch, into ``tmp`` (``reload_eval`` and
    ``continuous_prediction`` reload its checkpoint); the alarm sweep after
    each must launch the spatial-table kernel."""
    import re

    from kstar_torch.cli import train_vision

    fields, ok = {}, True
    argv = ["--model", "ViViT", "--synthetic", "--weight_dir", f"{tmp}/w",
            "--save_dir", f"{tmp}/r", "--verbose", "1"]
    for name, extra in (("first", ["--num_epoch", "2"]),
                        ("resume", ["--num_epoch", "1", "--resume"])):
        _, text, wall, launches_k = run_cli(train_vision.main, argv + extra)
        last = [f for f in os.listdir(f"{tmp}/w") if f.endswith("_last.ckpt")]
        best = [f for f in os.listdir(f"{tmp}/w") if f.endswith("_best.ckpt")]
        reports = [f for f in os.listdir(f"{tmp}/r") if f.endswith("_report.txt")]
        f1 = re.search(r"test macro-F1 ([0-9.]+)", text)
        saved_step = (int(torch.load(f"{tmp}/w/{last[0]}", map_location="cpu")["step"])
                      if last else None)
        run = dict(wall_s=wall, spatial_table_launches=launches_k["spatial_table"],
                   test_macro_f1=float(f1.group(1)) if f1 else None,
                   test_line=test_line(text),
                   checkpoints=sorted(last + best), reports=reports,
                   saved_step=saved_step,
                   datasets=re.search(r"datasets: .*", text).group(0))
        ok = ok and bool(last and best and reports and f1
                         and launches_k["spatial_table"] > 0)
        if name == "resume":
            m = re.search(r"resumed from \S+ at step (\d+)", text)
            run["resumed_at_step"] = int(m.group(1)) if m else None
            ok = ok and run["resumed_at_step"] == fields["first"]["saved_step"] \
                and saved_step > run["resumed_at_step"]
        fields[name] = run
    return ok, fields


# ---------------------------------------------------------------------------
# The 0D models: Transformer, CnnLSTM, MLSTM-FCN at their default widths
# ---------------------------------------------------------------------------

ZERO_D = ("Transformer", "CnnLSTM", "MLSTM_FCN")
TS_BATCH, TS_ROWS = 256, 4096     # the CLI's batch; 78 s of a 52.5 Hz 0D table
# ts_models: bf16 against f32 probabilities at batch 256, per model. The
# H100 readings were 2.9e-3-3.9e-3 (Transformer), ~1e-5 (CnnLSTM) and
# 4.3e-4-8e-4 (MLSTM-FCN); the recurrence runs in f32, so what bf16 rounds
# is the convs, BatchNorm inputs, attention and heads around it.
TS_BF16_PROB_TOL = {"Transformer": 1e-2, "CnnLSTM": 2e-3, "MLSTM_FCN": 2e-3}


def kernel_launches(reset: bool = False) -> dict:
    """The launch counts of the four kernels' wrappers (set to 0 first
    with ``reset``): the conv epilogue's is ``bn_act.fused``, one a launch.
    The 0D paths must launch none of them."""
    from kstar_torch.ops.attention import fused_attention
    from kstar_torch.ops.bn_act import bn_act
    from kstar_torch.ops.preprocess import gather_normalize
    from kstar_torch.ops.spatial_table import spatial_table

    counters = {"spatial_table": (spatial_table, "launches"),
                "fused_attention": (fused_attention, "launches"),
                "gather_normalize": (gather_normalize, "launches"),
                "bn_act": (bn_act, "fused")}
    if reset:
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
    return {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}


def run_cli(main_fn, argv) -> tuple:
    """One CLI ``main(argv)`` with its stdout echoed to stderr: (its result,
    the text, wall seconds, the kernels' launches counted from 0 over the
    run)."""
    import contextlib
    import io

    out = io.StringIO()
    kernel_launches(reset=True)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        result = main_fn(argv)
    wall = time.perf_counter() - t0
    launches_k = kernel_launches()
    text = out.getvalue()
    print(text, file=sys.stderr, end="")
    return result, text, wall, launches_k


def zero_d_configs() -> dict:
    """The 0D models' full default widths (kstar_torch/config.py): 18
    features, 21-sample windows."""
    from kstar_torch.config import CnnLSTMConfig, MLSTMFCNConfig, TransformerConfig

    return {"Transformer": TransformerConfig(), "CnnLSTM": CnnLSTMConfig(),
            "MLSTM_FCN": MLSTMFCNConfig()}


def zero_d_models(seed: int, cfgs: dict, dtype=torch.float32) -> dict:
    """Models on the CPU with random weights from ``seed`` and their
    BatchNorm running statistics drawn off the zeros/ones start, so that
    evaluation exercises them."""
    from kstar_torch.models import build_0d_model
    from kstar_torch.models.common import BatchNorm

    out = {}
    for i, (name, cfg) in enumerate(cfgs.items()):
        gen = torch.Generator().manual_seed(seed * 10 + i)
        model = build_0d_model(name, cfg, dtype=dtype, generator=gen)
        for bn in model.modules():
            if isinstance(bn, BatchNorm):
                bn.running_mean.normal_(0.0, 0.3, generator=gen)
                bn.running_var.uniform_(0.5, 2.0, generator=gen)
        out[name] = model
    return out


def ts_models_phase(seed: int, dev, cfgs: dict, batch: int = TS_BATCH) -> tuple:
    """Each 0D model's eval forward at ``batch`` windows: f32 on the card
    against the same weights on the CPU (TF32 off; atol 1e-4 + rtol 1e-4,
    summation order only), bf16 against f32 on the card (probabilities
    within the model's ``TS_BF16_PROB_TOL``), forward times with CUDA
    events, launches and top kernels of one forward from torch.profiler.
    (How cuDNN takes the recurrence in bf16 and the flat parameter buffer
    of training: ``python -m kstar_torch.analysis.cudnn_lstm``.) Returns
    (ok, fields, bf16 models on the card, f32 models on the card)."""
    import warnings

    import numpy as np

    from kstar_torch.models import build_0d_model

    cpu_models = zero_d_models(seed, cfgs)
    ok, fields, bf16_models, f32_models = True, {}, {}, {}
    rng = np.random.default_rng(seed)
    for name, cpu in cpu_models.items():
        cfg = cfgs[name]
        x_cpu = torch.from_numpy(rng.normal(size=(batch, SEQ_LEN, cfg.n_features))
                                 .astype(np.float32))
        x = x_cpu.to(dev)
        with torch.no_grad():
            want = cpu(x_cpu)
        f32 = copy.deepcopy(cpu).to(dev)
        kernel_launches(reset=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with torch.no_grad():
                got = f32(x)
            torch.cuda.synchronize()
        res = compare(got.cpu(), want, 1e-4, 1e-4, 1e-4)
        bf = build_0d_model(name, cfg, dtype=torch.bfloat16)
        bf.load_state_dict(cpu.state_dict())
        bf = bf.to(dev)
        with torch.no_grad():
            got_bf = bf(x)
        p_bf = torch.softmax(got_bf.float(), -1)
        p_32 = torch.softmax(got, -1)
        p_err = float((p_bf - p_32).abs().max())
        launches_k = kernel_launches()

        fwd_bf = torch.no_grad()(lambda: bf(x))
        fwd_32 = torch.no_grad()(lambda: f32(x))
        n_launch, busy_ms, _, top = step_launches(fwd_bf)
        tol = TS_BF16_PROB_TOL[name]

        entry = dict(
            params=sum(p.numel() for p in cpu.parameters()), batch=batch,
            f32_card_vs_cpu=res, bf16_vs_f32_probs_max_abs=p_err, bf16_probs_tol=tol,
            bf16_vs_f32_logits_max_abs=float((got_bf.float() - got).abs().max()),
            forward_ms_bf16=time_ms(fwd_bf, 20), forward_ms_f32=time_ms(fwd_32, 20),
            launches_per_forward_bf16=n_launch, forward_device_busy_ms_bf16=busy_ms,
            top_kernels_bf16=top, warnings_first_forward=[str(w.message)[:160] for w in caught],
            kernel_launches=launches_k)
        entry_ok = (res["ok"] and p_err <= tol
                    and bool(torch.isfinite(got_bf).all()) and got_bf.shape == (batch, 2)
                    and not any(launches_k.values()))
        entry["ok"] = entry_ok
        ok = ok and entry_ok
        fields[name] = entry
        bf16_models[name], f32_models[name] = bf.eval(), f32.eval()
    return ok, fields, bf16_models, f32_models


def ts_sweep_phase(seed: int, dev, bf16_models: dict, f32_models: dict,
                   rows: int = TS_ROWS) -> tuple:
    """predict_0d_shot and its TSSweeper for each model over a synthetic
    ``rows``-row 0D table (a random walk per feature, t0 = 1.0 s): the
    sweep's wall time (upload, chunks of 256, download; median of 3, host
    clock) and windows/s, one sweep under torch.profiler (launches, device
    busy time, idle share), the curve's length against the JAX package's
    formula, and bf16 against f32 on the card within max |dp| <= 0.05 (raw
    sweep and final curve)."""
    import numpy as np

    from kstar_torch.config import DT_0D, FPS
    from kstar_torch.data import Scaler
    from kstar_torch.infer import TSSweeper, predict_0d_shot

    rng = np.random.default_rng(seed + 1)
    values = (np.cumsum(rng.normal(size=(rows, 18)), axis=0) * 0.1).astype(np.float32)
    times = 1.0 + np.arange(rows) * DT_0D
    n_windows = rows - SEQ_LEN - 3
    interval = int(round(DT_0D * FPS))
    # kstar_tpu/infer/continuous.py:580-595: zero prefix of frame_srt + L,
    # probs[1:], zero suffix of L, then interval samples per 0D sample
    expect_len = (int(times[0] * FPS / interval) + 2 * SEQ_LEN + n_windows - 1) * interval
    data = Scaler("Robust").fit(values).transform(values)
    starts = np.arange(n_windows, dtype=np.int64)
    ok, fields = True, {}
    for name, model in bf16_models.items():
        sweeper = TSSweeper(model, SEQ_LEN, TS_BATCH, device=dev)
        sweeper.sweep(data, starts)                          # warm-up
        kernel_launches(reset=True)
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            probs = sweeper.sweep(data, starts)             # ends in a host copy
            walls.append(time.perf_counter() - t0)
        launches_k = kernel_launches()
        n_launch, busy_ms, prof_wall, top = step_launches(lambda: sweeper.sweep(data, starts))
        probs32 = TSSweeper(f32_models[name], SEQ_LEN, TS_BATCH, device=dev).sweep(data, starts)
        t0 = time.perf_counter()
        time_x, curve = predict_0d_shot(model, values, times, Scaler("Robust"), SEQ_LEN, 3,
                                        DT_0D, TS_BATCH, device=dev)
        predict_ms = (time.perf_counter() - t0) * 1e3
        _, curve32 = predict_0d_shot(f32_models[name], values, times, Scaler("Robust"),
                                     SEQ_LEN, 3, DT_0D, TS_BATCH, device=dev)
        sweep_s = float(np.median(walls))
        p_err = float(np.abs(probs - probs32).max())
        c_err = float(np.abs(curve - curve32).max())
        entry = dict(
            rows=rows, windows=n_windows, chunks=-(-n_windows // TS_BATCH), batch=TS_BATCH,
            sweep_ms=sweep_s * 1e3, sweep_runs_ms=[w * 1e3 for w in walls],
            windows_per_s=n_windows / sweep_s, predict_0d_shot_ms=predict_ms,
            profiled_sweep_launches=n_launch, profiled_sweep_device_busy_ms=busy_ms,
            profiled_sweep_wall_ms=prof_wall,
            device_idle_share=None if busy_ms is None else 1 - busy_ms / (sweep_s * 1e3),
            top_kernels=top, curve_len=len(curve), expect_len=expect_len,
            bf16_vs_f32_probs_max_abs=p_err, bf16_vs_f32_curve_max_abs=c_err, tol=0.05,
            kernel_launches=launches_k)
        entry_ok = (len(curve) == expect_len and probs.shape == (n_windows,)
                    and np.array_equal(time_x, np.arange(expect_len) / FPS)
                    and bool(np.isfinite(curve).all()) and p_err <= 0.05 and c_err <= 0.05
                    and not any(launches_k.values()))
        entry["ok"] = entry_ok
        ok = ok and entry_ok
        fields[name] = entry
    return ok, fields


def ts_stream_phase(seed: int, dev, model, n_blocks: int = 30) -> tuple:
    """StreamingPredictor(modality="0D") with MLSTM-FCN, samples arriving at
    the 0D table's rate 1/DT_0D = 52.5 Hz: the block size chosen by probing
    (smallest k whose p99 block time holds k samples' arrival time),
    ``n_blocks`` timed blocks at that k (host clock, each ends in the host
    copy of its probabilities), p50 sample-to-alarm = (k-1-i)/rate of block
    fill + the block's time; blocks of 16 against single pushes within 2e-2
    (bf16, other cuDNN kernels at batch 1) with equal alarms where the
    threshold gap allows the comparison."""
    import numpy as np

    from kstar_torch.config import DT_0D
    from kstar_torch.data import Scaler
    from kstar_torch.infer import StreamingPredictor, choose_block_size, probe_stream_blocks

    rate = 1.0 / DT_0D
    kw = dict(modality="0D", n_features=18, fps=rate)
    kernel_launches(reset=True)
    probe = probe_stream_blocks(model, SEQ_LEN, 0, torch.bfloat16, device=dev, **kw)
    k, report = choose_block_size(probe, fps=rate)
    rng = np.random.default_rng(seed + 2)
    raw = np.cumsum(rng.normal(size=(SEQ_LEN + (n_blocks + 2) * max(k, 16), 18)), axis=0)
    samples = Scaler("Robust").fit(raw).transform(raw).astype(np.float32)

    def stream(**extra):
        return StreamingPredictor(model, seq_len=SEQ_LEN, compute_dtype=torch.bfloat16,
                                  device=dev, **kw, **extra)

    sp = stream(block_size=k)
    sp.push_block(samples[:k])                                   # allocate + warm
    block_ms = []
    for i in range(1, n_blocks + 1):
        t0 = time.perf_counter()
        sp.push_block(samples[i * k:(i + 1) * k])
        block_ms.append((time.perf_counter() - t0) * 1e3)
    block_ms = np.asarray(block_ms)
    lat = block_ms[:, None] + ((k - 1 - np.arange(k)) / rate * 1e3)[None, :]

    kk = 16
    seq = samples[:2 * kk + SEQ_LEN]
    first = stream(block_size=kk, suppress_s=0.0)
    p0 = np.concatenate([first.push_block(seq[i:i + kk])[0] for i in range(0, len(seq) - kk + 1, kk)])
    armed = np.sort(p0[SEQ_LEN:])
    gap_at = int(np.argmax(np.diff(armed)))
    thr, gap = float(armed[gap_at:gap_at + 2].mean()), float(armed[gap_at + 1] - armed[gap_at])
    blk = stream(block_size=kk, suppress_s=0.0, threshold=thr)
    blk_out = [blk.push_block(seq[i:i + kk]) for i in range(0, len(seq) - kk + 1, kk)]
    blk_p, blk_a = (np.concatenate([o[j] for o in blk_out]) for j in (0, 1))
    one = stream(block_size=1, suppress_s=0.0, threshold=thr)
    one_out = [one.push(s) for s in seq[:len(blk_p)]]
    one_p, one_a = np.array([o[0] for o in one_out]), np.array([o[1] for o in one_out])
    push_err = float(np.abs(blk_p - one_p).max())
    decidable = gap > 2 * push_err
    launches_k = kernel_launches()
    ok = (push_err <= 2e-2 and bool(np.isfinite(blk_p).all())
          and (not decidable or (np.array_equal(blk_a, one_a)
                                 and blk.alarm_time == one.alarm_time))
          and not any(launches_k.values()))
    p50_block = float(np.median(block_ms))
    return ok, dict(
        model="MLSTM_FCN", rate_hz=rate, budget_ms_per_sample=1e3 / rate, chosen_k=k,
        probe_report={str(kp): r for kp, r in report.items()},
        block_p50_ms=p50_block, block_p99_ms=float(np.percentile(block_ms, 99)),
        block_runs_ms=block_ms.tolist(), per_sample_ms=p50_block / k,
        p50_sample_to_alarm_ms=float(np.median(lat)), compared_block=kk,
        blocks_vs_single_max_abs=push_err, blocks_vs_single_tol=2e-2, threshold=thr,
        threshold_gap=gap, alarms_decidable=bool(decidable),
        alarms_equal=bool(np.array_equal(blk_a, one_a)), n_alarms=int(blk_a.sum()),
        alarm_time_blocks=blk.alarm_time, alarm_time_single=one.alarm_time,
        kernel_launches=launches_k)


def train_0d_phase(seed: int, dev, cfgs: dict, batch: int = TS_BATCH,
                   parity_batch: int = 32) -> tuple:
    """fit's train step for each 0D model at ``batch``: bf16 over f32
    parameters, the CLI's defaults (AdamW 2e-4 with the staircase decay,
    clip 1.0, Focal gamma 2, input noise 1e-3, dropout 0.1); 5 warm-up
    steps, then 30 each timed on the host clock up to a synchronise; peak
    memory; launches and device-busy time of one step from torch.profiler.
    Checks: finite losses and every parameter moved; a step whose loss is
    made non-finite leaves parameters, optimizer state, step and the
    BatchNorm buffers bit-identical; card against CPU in f32 from the same
    weights (noise 0, dropout 0), 3 steps, the `train` phase's tolerances (losses 1e-3
    relative, parameters 1e-4, first gradients 1e-3 of their largest) with
    SGD: under Adam the parameters whose gradient is zero in exact
    arithmetic (a bias right before a BatchNorm, the attention's key bias)
    move by +-lr at the whim of rounding."""
    import numpy as np

    from kstar_torch.config import LossConfig, OptimConfig
    from kstar_torch.losses import ldam_margins
    from kstar_torch.models import build_0d_model
    from kstar_torch.train import create_train_state, make_train_step

    loss_cfg = LossConfig()
    ok, fields = True, {}
    for i, (name, cfg) in enumerate(cfgs.items()):
        rng = np.random.default_rng(seed + 10 + i)
        xs = [torch.from_numpy(rng.normal(size=(batch, SEQ_LEN, cfg.n_features))
                               .astype(np.float32)).to(dev) for _ in range(2)]
        ys = [torch.as_tensor(rng.integers(0, 2, size=batch)).to(dev) for _ in range(2)]
        weight = torch.ones(2, device=dev)
        m_list = torch.as_tensor(ldam_margins(np.array([batch // 2, batch // 2]))).to(dev)
        model = build_0d_model(name, cfg, dtype=torch.bfloat16,
                               generator=torch.Generator().manual_seed(seed)).to(dev)
        state = create_train_state(model, OptimConfig(), steps_per_epoch=1, seed=seed)
        step = make_train_step(loss_cfg)
        start = (state.flat.clone(), state.stats_flat.clone())
        kernel_launches(reset=True)
        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        for s in range(35):
            t0 = time.perf_counter()
            _, loss, _ = step(state, xs[s % 2], ys[s % 2], weight, m_list)
            torch.cuda.synchronize()
            if s >= 5:
                times.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        losses = torch.stack(losses).cpu().numpy()
        moved = [not torch.equal(a, p.detach()) for a, p in
                 zip(start[0].split([p.numel() for p in state.params]),
                     [p.reshape(-1) for p in state.params])]
        stats_moved = not torch.equal(start[1], state.stats_flat)
        n_launch, busy_ms, prof_wall, top = step_launches(
            lambda: step(state, xs[0], ys[0], weight, m_list))

        before = (state.flat.clone(), {k: v.clone() for k, v in state.opt_state.items()},
                  state.step.clone(), state.stats_flat.clone())
        _, nan_loss, _ = step(state, xs[0], ys[0], torch.full((2,), float("nan"), device=dev),
                              m_list)
        guard_ok = (not bool(torch.isfinite(nan_loss)) and torch.equal(state.flat, before[0])
                    and all(torch.equal(state.opt_state[k], v) for k, v in before[1].items())
                    and torch.equal(state.step, before[2])
                    and torch.equal(state.stats_flat, before[3]))
        launches_k = kernel_launches()

        quiet = {k: 0.0 for k in ("noise_std", "dropout") if hasattr(cfg, k)}
        base = build_0d_model(name, dataclasses.replace(cfg, **quiet),
                              generator=torch.Generator().manual_seed(seed + 1))
        sgd = OptimConfig(optimizer="SGD", lr=1e-2)
        runs = []
        for d in (dev, torch.device("cpu")):
            st = create_train_state(copy.deepcopy(base).to(d), sgd, steps_per_epoch=1,
                                    seed=seed)
            ls, grads = [], None
            for s in range(3):
                _, loss, _ = step(st, xs[s % 2][:parity_batch].to(d),
                                  ys[s % 2][:parity_batch].to(d), weight.to(d), m_list.to(d))
                ls.append(float(loss))
                if grads is None:
                    grads = st.flat_grads().cpu()
            runs.append((np.array(ls), st.flat.cpu(), st.stats_flat.cpu(), grads))
        (l_gpu, p_gpu, s_gpu, g_gpu), (l_cpu, p_cpu, s_cpu, g_cpu) = runs
        loss_rel = float(np.max(np.abs(l_gpu - l_cpu) / np.abs(l_cpu)))
        param_err = float((p_gpu - p_cpu).abs().max())
        stats_err = float((s_gpu - s_cpu).abs().max())
        grad_rel = float((g_gpu - g_cpu).abs().max() / g_cpu.abs().max())
        parity_ok = (loss_rel <= 1e-3 and param_err <= 1e-4 and stats_err <= 1e-4
                     and grad_rel <= 1e-3)

        t = np.asarray(times)
        entry = dict(
            batch=batch, dtype="bfloat16 over f32 parameters",
            optimizer="AdamW lr 2e-4 staircase 0.95 every 4 updates, clip 1.0",
            loss="Focal gamma 2", steps_timed=len(t), step_p50_ms=float(np.median(t)),
            step_p99_ms=float(np.percentile(t, 99)), step_runs_ms=t.tolist(),
            samples_per_s=batch * len(t) / (t.sum() / 1e3), peak_mem_gb=peak_gb,
            launches_per_step=n_launch, profiled_step_device_busy_ms=busy_ms,
            profiled_step_wall_ms=prof_wall, top_kernels=top,
            device_idle_share=None if busy_ms is None else 1 - busy_ms / float(np.median(t)),
            losses=losses.tolist(), params_moved=f"{sum(moved)}/{len(moved)}",
            batch_stats_moved=stats_moved, nan_guard_bit_identical=guard_ok,
            card_vs_cpu={"batch": parity_batch, "optimizer": "SGD lr 1e-2",
                         "losses_cuda": l_gpu.tolist(), "losses_cpu": l_cpu.tolist(),
                         "loss_max_rel": loss_rel, "loss_rtol": 1e-3,
                         "param_max_abs": param_err, "param_atol": 1e-4,
                         "batch_stats_max_abs": stats_err, "batch_stats_atol": 1e-4,
                         "grad_max_rel": grad_rel, "grad_rtol": 1e-3},
            kernel_launches=launches_k)
        entry_ok = bool(np.isfinite(losses).all() and all(moved) and stats_moved and guard_ok
                        and parity_ok and not any(launches_k.values()))
        entry["ok"] = entry_ok
        ok = ok and entry_ok
        fields[name] = entry
    return ok, fields


def hard_fixture_phase(dev, epochs: int = 15) -> tuple:
    """bench.py's metric 3 re-created from the port's own pieces: the
    hard-fixture synthetic 0D dataset (16 shots x 768 frames, seed 11,
    difficulty 1.0, 63-sample horizon), MLSTM-FCN with FCN 32 and LSTM 32 x
    1 layer in f32, trained by fit as bench.py's measure_f1_tpu trains it
    (OptimConfig(lr=1e-3): AdamW 1e-3 with the staircase decay and clip 1.0;
    Focal with inverse-frequency weights; batch 64; ``epochs`` epochs, no
    early stopping), then macro-F1 at argmax on the test split. The JAX
    package's torch-CPU mirror's F1 is read from BENCH_baseline.json."""
    import tempfile

    import numpy as np

    from kstar_torch.config import LossConfig, MLSTMFCNConfig, OptimConfig, Schema, TrainConfig
    from kstar_torch.data import TSDataset, prepare_0d_dataset
    from kstar_torch.data.synthetic import make_dataset
    from kstar_torch.models import build_0d_model
    from kstar_torch.train import create_train_state, fit, make_eval_step, run_eval_epoch

    t0 = time.perf_counter()
    cols = Schema.INPUT_FEATURES
    _, disrupt_df, ts_df = make_dataset(n_shots=16, n_frames=768, height=16, width=16,
                                        seed=11, difficulty=1.0)
    df_tr, df_va, df_te, scaler = prepare_0d_dataset(ts_df, cols, test_shot=None)
    mk = lambda df: TSDataset(df, disrupt_df, cols, seq_len=SEQ_LEN, dist=63, scaler=scaler)
    train_ds, valid_ds, test_ds = mk(df_tr), mk(df_va), mk(df_te)
    t_data = time.perf_counter() - t0
    cfg = MLSTMFCNConfig(n_features=len(cols), fcn_dim=32, seq_len=SEQ_LEN, lstm_dim=32,
                         lstm_n_layers=1)
    model = build_0d_model("MLSTM_FCN", cfg, generator=torch.Generator().manual_seed(0)).to(dev)
    state = create_train_state(model, OptimConfig(lr=1e-3), seed=0)
    loss_cfg = LossConfig(loss_type="Focal", use_weighting=True)
    kernel_launches(reset=True)
    with tempfile.TemporaryDirectory() as tmp:
        train_cfg = TrainConfig(batch_size=64, num_epoch=epochs, weight_dir=tmp,
                                early_stopping=False, verbose=0)
        t1 = time.perf_counter()
        state, hist = fit(state, train_ds, valid_ds, train_cfg, loss_cfg, tag="hard_fixture")
        t_fit = time.perf_counter() - t1
    counts = test_ds.class_counts()
    weight = torch.ones(len(counts), device=dev)
    m_list = torch.zeros(len(counts), device=dev)
    _, _, f1 = run_eval_epoch(make_eval_step(loss_cfg), model, test_ds, 64, weight, m_list)
    launches_k = kernel_launches()
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "BENCH_baseline.json")) as f:
        torch_cpu_f1 = json.load(f).get("torch_cpu_f1")
    ok = bool(f1 >= 0.80 and not any(launches_k.values()))
    return ok, dict(
        macro_f1=float(f1), f1_floor=0.80, bench_baseline_torch_cpu_f1=torch_cpu_f1,
        splits={"train": len(train_ds), "valid": len(valid_ds), "test": len(test_ds)},
        train_class_counts=train_ds.class_counts().tolist(), epochs=epochs,
        steps=int(state.step), valid_f1_last=hist.valid_f1[-1], data_s=t_data, fit_s=t_fit,
        wall_s=time.perf_counter() - t0, kernel_launches=launches_k)


def train_0d_cli_phase(tmp: str) -> tuple:
    """python -m kstar_torch.cli.train_0d --model MLSTM_FCN --synthetic
    --num_epoch 2 at the default widths, then --resume for one more epoch,
    into ``tmp`` (``reload_eval`` reloads its checkpoint): checkpoints,
    report, feature importance and the probability curve of the last shot
    (TSSweeper); no kernel of K1-K3 runs."""
    import re

    from kstar_torch.cli import train_0d

    fields, ok = {}, True
    argv = ["--model", "MLSTM_FCN", "--synthetic", "--weight_dir", f"{tmp}/w",
            "--save_dir", f"{tmp}/r", "--verbose", "1"]
    for name, extra in (("first", ["--num_epoch", "2"]),
                        ("resume", ["--num_epoch", "1", "--resume"])):
        _, text, wall, launches_k = run_cli(train_0d.main, argv + extra)
        last = [f for f in os.listdir(f"{tmp}/w") if f.endswith("_last.ckpt")]
        best = [f for f in os.listdir(f"{tmp}/w") if f.endswith("_best.ckpt")]
        reports = [f for f in os.listdir(f"{tmp}/r") if f.endswith("_report.txt")]
        f1 = re.search(r"test macro-F1 ([0-9.]+)", text)
        curve = re.search(r"probability curve of shot .*", text)
        saved_step = (int(torch.load(f"{tmp}/w/{last[0]}", map_location="cpu")["step"])
                      if last else None)
        run = dict(wall_s=wall, test_macro_f1=float(f1.group(1)) if f1 else None,
                   test_line=test_line(text),
                   checkpoints=sorted(last + best), reports=reports,
                   saved_step=saved_step, datasets=re.search(r"datasets: .*", text).group(0),
                   feature_importance=bool(re.search(r"feature importance \(top 5\)", text)),
                   prob_curve=curve.group(0) if curve else None,
                   kernel_launches=launches_k)
        ok = ok and bool(last and best and reports and f1 and curve
                         and run["feature_importance"] and not any(launches_k.values()))
        if name == "resume":
            m = re.search(r"resumed from \S+ at step (\d+)", text)
            run["resumed_at_step"] = int(m.group(1)) if m else None
            ok = ok and run["resumed_at_step"] == fields["first"]["saved_step"] \
                and saved_step > run["resumed_at_step"]
        fields[name] = run
    return ok, fields


# ---------------------------------------------------------------------------
# The fusion models: concat, TFN and their Gradient-Blending twins at the
# train_multimodal CLI's widths
# ---------------------------------------------------------------------------

FUSION_BATCH = 32                 # the train_multimodal CLI's batch
PROFILED_CHUNKS = 16              # multimodal_sweep: window chunks under the profiler
DT_MULTI = 1.0 / 210.0            # the multimodal 0D table: one row per frame
# fusion_models: bf16 against f32 probabilities at batch 32, per model. The
# H100 readings were 4.4e-3 (concat), 3.1e-3 (concat_GB), 3.7e-3 (TFN) and
# 4.3e-3 (TFN_GB): bf16 rounds the two encoders, the heads run in f32.
FUSION_BF16_PROB_TOL = {"concat": 1e-2, "concat_GB": 1e-2, "TFN": 1e-2, "TFN_GB": 1e-2}


def fusion_kwargs(crop: int = CROP) -> tuple:
    """(vivit_kwargs, ts_kwargs) at kstar_torch.cli.train_multimodal's
    defaults: ViViT dim 128, depth 2, 4 heads x 64, scale_dim 4 (MLP 512),
    patch 16; the 0D Transformer 128 wide, 4 layers, 8 heads, FF 512, cls
    128; 18 features, 21-frame windows."""
    vivit = dict(image_size=crop, patch_size=16, n_frames=SEQ_LEN, dim=128, depth=2,
                 n_heads=4, d_head=64, scale_dim=4, dropout=0.1, embedd_dropout=0.1)
    ts = dict(n_features=18, feature_dims=128, max_len=SEQ_LEN, n_layers=4, n_heads=8,
              dim_feedforward=512, dropout=0.1, cls_dims=128)
    return vivit, ts


def fusion_models(seed: int, vivit_kw: dict, ts_kw: dict, dtype=torch.float32,
                  names=("concat", "concat_GB", "TFN", "TFN_GB")) -> dict:
    """The fusion models on the CPU with random weights from ``seed``, their
    BatchNorm running statistics drawn off the zeros/ones start."""
    from kstar_torch.models import TFN, TFNGB, MultiModalConcat, MultiModalGB
    from kstar_torch.models.common import BatchNorm

    classes = {"concat": MultiModalConcat, "concat_GB": MultiModalGB, "TFN": TFN,
               "TFN_GB": TFNGB}
    out = {}
    for name in names:
        gen = torch.Generator().manual_seed(seed * 10 + 5 + list(classes).index(name))
        model = classes[name](vivit_kw, ts_kw, dtype=dtype, generator=gen)
        for bn in model.modules():
            if isinstance(bn, BatchNorm):
                bn.running_mean.normal_(0.0, 0.3, generator=gen)
                bn.running_var.uniform_(0.5, 2.0, generator=gen)
        out[name] = model
    return out


def twin(model, dtype, quiet: bool = False):
    """The same weights in another compute dtype, on the CPU; ``quiet``
    turns dropout and the input noise off."""
    vk, tk = dict(model.vivit_kwargs), dict(model.ts_kwargs)
    if quiet:
        vk.update(dropout=0.0, embedd_dropout=0.0)
        tk.update(dropout=0.0, noise_std=0.0)
    with torch.device("meta"):            # no second random initialisation
        other = type(model)(vk, tk, dtype=dtype)
    other.load_state_dict({k: v.clone() for k, v in model.state_dict().items()},
                          assign=True)
    return other


def random_walk_table(seed: int, rows: int):
    """(rows, 18) raw 0D values: a seeded random walk per feature."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return (np.cumsum(rng.normal(size=(rows, 18)), axis=0) * 0.1).astype(np.float32)


FALLBACK_CROP = 80                # patch 4: 401 tokens, past every instance of K1


def first(out):
    """The fusion logits of a forward (the multi logits of a GB model)."""
    return out[0] if isinstance(out, tuple) else out


def video_sweep_fallback_phase(frames, dev, cfg, model) -> tuple:
    """The video sweep's tri-state table route: a flagship-config ViViT at
    patch 4 over an 80 px crop (20 x 20 patches + cls = 401 tokens, past the
    257 of the kernel's largest instance) sweeps 256 frames with
    use_fused_table=None: it must report the plain table, launch the kernel
    0 times and give use_fused_table=False's curve exactly; True must raise;
    the flagship (patch 16, 128 px, 65 tokens) under None must report the
    kernel and launch it once."""
    import numpy as np

    from kstar_torch.infer import VideoSweeper
    from kstar_torch.models import build_video_model
    from kstar_torch.ops.spatial_table import spatial_table

    shot = frames[:256]
    starts = np.arange(len(shot) - SEQ_LEN - 1, dtype=np.int64)
    crop = FALLBACK_CROP
    cfg_fb = dataclasses.replace(cfg, patch_size=4, image_size=crop)
    m_fb = build_video_model("ViViT", cfg_fb, dtype=torch.bfloat16,
                             generator=torch.Generator().manual_seed(3)).to(dev)
    fields = {"tokens": (crop // 4) ** 2 + 1, "frames": len(shot), "windows": len(starts)}
    spatial_table.launches = 0
    t0 = time.perf_counter()
    auto = VideoSweeper(m_fb, SEQ_LEN, crop, BATCH, torch.bfloat16, device=dev)
    p_auto = auto.sweep(shot, starts)
    fields.update(none_ms=(time.perf_counter() - t0) * 1e3,
                  none_fused_table_active=auto.fused_table_active,
                  none_launches=spatial_table.launches)
    p_off = VideoSweeper(m_fb, SEQ_LEN, crop, BATCH, torch.bfloat16, use_fused_table=False,
                         device=dev).sweep(shot, starts)
    fields["none_equals_false_exactly"] = bool(np.array_equal(p_auto, p_off))
    try:
        VideoSweeper(m_fb, SEQ_LEN, crop, BATCH, torch.bfloat16, use_fused_table=True,
                     device=dev)
        fields["true_raised"] = None
    except ValueError as e:
        fields["true_raised"] = str(e)[:200]
    spatial_table.launches = 0
    flag = VideoSweeper(model, SEQ_LEN, CROP, BATCH, torch.bfloat16, device=dev)
    p_flag = flag.sweep(shot, starts)
    fields.update(flagship_fused_table_active=flag.fused_table_active,
                  flagship_launches=spatial_table.launches)
    ok = (fields["none_fused_table_active"] is False and fields["none_launches"] == 0
          and fields["none_equals_false_exactly"] and fields["true_raised"] is not None
          and fields["flagship_fused_table_active"] is True
          and fields["flagship_launches"] == 1 and p_auto.shape == starts.shape
          and bool(np.isfinite(p_auto).all()) and bool(np.isfinite(p_flag).all()))
    return ok, fields


def fusion_models_phase(seed: int, frames_dev, table, dev, cpu_models: dict,
                        batch: int = FUSION_BATCH) -> tuple:
    """Each fusion model's eval forward at ``batch`` paired windows of the
    shot (video bf16 and f32 from the cropped uint8 frames, the 0D rows of
    the same frames): bf16 against f32 probabilities on the card (within the
    model's FUSION_BF16_PROB_TOL), f32 on the card against the CPU at batch
    4 (atol 1e-4 + rtol 1e-4, every output of the forward), and
    forward_spatial_cls on each window's spatial-cls rows (f32, the plain
    spatial_cls per offset) against the full forward's fusion logits (1e-4);
    device ms by CUDA events, launches and busy ms of one bf16 forward.
    Returns (ok, fields, the bf16 models on the card)."""
    import numpy as np

    from kstar_torch.config import PIXEL_MEAN_BGR

    T = frames_dev.shape[0]
    starts = torch.as_tensor(np.linspace(0, T - SEQ_LEN - 1, batch).astype(np.int64),
                             device=dev)
    win = starts[:, None] + torch.arange(SEQ_LEN, device=dev)
    clips = frames_dev[win]                                  # (B, 21, crop, crop, 3) uint8
    x_bf = clips.to(torch.bfloat16) - torch.tensor(PIXEL_MEAN_BGR, dtype=torch.bfloat16,
                                                   device=dev)
    x_32 = clips.float() - torch.tensor(PIXEL_MEAN_BGR, device=dev)
    x_ts = torch.from_numpy(table).to(dev)[win]              # (B, 21, 18)
    ok, fields, bf16_models = True, {}, {}
    for name, cpu in cpu_models.items():
        f32 = copy.deepcopy(cpu).to(dev).eval()
        bf = twin(cpu, torch.bfloat16).to(dev).eval()
        kernel_launches(reset=True)
        with torch.no_grad():
            out_32, out_bf = f32(x_32, x_ts), bf(x_bf, x_ts)
            want = cpu(x_32[:4].cpu(), x_ts[:4].cpu())
            got = f32(x_32[:4], x_ts[:4])
            rows = torch.stack([torch.stack([f32.spatial_cls(f32.embed_frames(x_32[b]), off)[off]
                                             for off in range(SEQ_LEN)]) for b in range(4)])
            fast = f32.forward_spatial_cls(rows, x_ts[:4])
        torch.cuda.synchronize()
        flat = lambda o: torch.cat([t.reshape(-1) for t in (o if isinstance(o, tuple) else (o,))])
        res = compare(flat(got).cpu(), flat(want), 1e-4, 1e-4, 1e-4)
        fsc_err = float((fast - first(got)).abs().max())
        p_err = float((torch.softmax(first(out_bf).float(), -1)
                       - torch.softmax(first(out_32), -1)).abs().max())
        fwd_bf = torch.no_grad()(lambda: bf(x_bf, x_ts))
        fwd_32 = torch.no_grad()(lambda: f32(x_32, x_ts))
        n_launch, busy_ms, _, top = step_launches(fwd_bf)
        launches_k = kernel_launches()
        tol = FUSION_BF16_PROB_TOL[name]
        entry = dict(
            params=sum(p.numel() for p in cpu.parameters()), batch=batch,
            outputs=len(out_bf) if isinstance(out_bf, tuple) else 1,
            f32_card_vs_cpu=res, forward_spatial_cls_vs_full_max_abs=fsc_err,
            forward_spatial_cls_tol=1e-4, bf16_vs_f32_probs_max_abs=p_err,
            bf16_probs_tol=tol, forward_ms_bf16=time_ms(fwd_bf, 10),
            forward_ms_f32=time_ms(fwd_32, 5), launches_per_forward_bf16=n_launch,
            forward_device_busy_ms_bf16=busy_ms, top_kernels_bf16=top,
            kernel_launches=launches_k)
        entry_ok = (res["ok"] and fsc_err <= 1e-4 and p_err <= tol
                    and bool(torch.isfinite(first(out_bf)).all())
                    and first(out_bf).shape == (batch, 2) and not any(launches_k.values()))
        entry["ok"] = entry_ok
        ok = ok and entry_ok
        fields[name] = entry
        bf16_models[name] = bf
        del f32
    return ok, fields, bf16_models


def multimodal_sweep_phase(frames, values, dev, models: dict) -> tuple:
    """MultiModalSweeper at the CLI's batch over the whole shot paired with
    its 0D table (one row per frame, ladders from multimodal_ladders over the
    shot): windows/s (median of 3 host-clock sweeps, each from host frames
    to host probabilities), the load (crop, upload, embedding, table), the
    table alone and the window loop apart, the spatial-table kernel's
    launches (1 per sweep) and the route the sweeper reports, one sweep
    under torch.profiler (launches, busy ms, idle share), the curve against
    the plain table's (max |dp| <= 0.05, mean <= 5e-3) and
    predict_multimodal_shot's lengths."""
    import numpy as np

    from kstar_torch.data import Scaler
    from kstar_torch.infer import (MultiModalSweeper, multimodal_ladders,
                                   predict_multimodal_shot)
    from kstar_torch.ops.spatial_table import spatial_table

    T = len(frames)
    times = np.arange(T) * DT_MULTI
    scaler = Scaler("Robust").fit(values)
    data = scaler.transform(values)
    vk, tk = multimodal_ladders(times, 0, T - 1, 0.0, float(times[-1]), SEQ_LEN, DT_MULTI, 1)
    ok, fields, k1 = True, {}, 0
    for name, model in models.items():
        sw = MultiModalSweeper(model, SEQ_LEN, 1, CROP, FUSION_BATCH, torch.bfloat16,
                               device=dev)
        # the whole-shot curve, which also warms the sweeper up
        time_x, curve = predict_multimodal_shot(model, frames, values, times, scaler, 0,
                                                T - 1, 0.0, float(times[-1]), SEQ_LEN,
                                                dt=DT_MULTI, crop_size=CROP,
                                                batch_size=FUSION_BATCH, sweeper=sw)
        torch.cuda.synchronize()
        spatial_table.launches = 0
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            probs = sw.sweep(frames, data, vk, tk)           # ends in a host copy
            walls.append(time.perf_counter() - t0)
        launches = spatial_table.launches
        k1 += launches
        frames_dev, _ = sw.upload_shot(frames, data)
        tokens = sw.embed_tokens(frames_dev)
        loaded = sw.load_shot(frames, data)
        parts = {"load_ms": wall_ms(lambda: sw.load_shot(frames, data), warmup=False),
                 "embed_ms": wall_ms(lambda: sw.embed_tokens(frames_dev), warmup=False),
                 "table_ms": wall_ms(lambda: sw._cls_table(tokens), warmup=False),
                 "windows_ms": wall_ms(lambda: sw.sweep_table(*loaded, vk, tk),
                                       warmup=False)}
        del frames_dev, tokens
        # device busy time: the load and 16 of the window chunks under the
        # profiler (a whole sweep's ~58k kernels take the profiler ~30 s to
        # read back); every chunk has the same shapes, so the chunks' time
        # scales by the chunk count
        sub = PROFILED_CHUNKS * FUSION_BATCH
        n_load, busy_load, _, _ = step_launches(lambda: sw.load_shot(frames, data))
        n_sub, busy_sub, _, top = step_launches(
            lambda: sw.sweep_table(*loaded, vk[:sub], tk[:sub]))
        n_chunks = -(-len(vk) // FUSION_BATCH)
        busy_ms = (None if busy_sub is None
                   else busy_load + busy_sub * n_chunks / PROFILED_CHUNKS)
        n_launch = None if n_sub is None else n_load + n_sub * n_chunks // PROFILED_CHUNKS
        del loaded
        plain = MultiModalSweeper(model, SEQ_LEN, 1, CROP, FUSION_BATCH, torch.bfloat16,
                                  use_fused_table=False, device=dev)
        p_plain = plain.sweep(frames, data, vk, tk)
        err = np.abs(probs - p_plain)
        sweep_s = float(np.median(walls))
        entry = dict(
            frames=T, windows=len(vk), batch=FUSION_BATCH, chunks=-(-len(vk) // FUSION_BATCH),
            fused_table_active=sw.fused_table_active, spatial_table_launches=launches,
            sweeps_timed=len(walls), windows_per_s=len(vk) / sweep_s,
            sweep_ms=sweep_s * 1e3, sweep_runs_ms=[w * 1e3 for w in walls], **parts,
            launches_per_sweep=n_launch, device_busy_ms=busy_ms,
            profiled_chunks=PROFILED_CHUNKS,
            device_idle_share=None if busy_ms is None else 1 - busy_ms / (sweep_s * 1e3),
            top_kernels_16_chunks=top, curve_vs_plain_max_abs=float(err.max()),
            curve_vs_plain_mean_abs=float(err.mean()), curve_len=len(curve),
            time_len=len(time_x))
        entry_ok = (sw.fused_table_active is True and launches == 3
                    and probs.shape == (len(vk),) and bool(np.isfinite(probs).all())
                    and err.max() <= 5e-2 and err.mean() <= 5e-3
                    and len(time_x) == len(curve) > 0 and bool(np.isfinite(curve).all()))
        entry["ok"] = entry_ok
        ok = ok and entry_ok
        fields[name] = entry
    return ok, fields, k1


class PairedClips:
    """Paired windows of the shot for gb_estimate: uint8 21-frame clips at
    seeded starts, the 0D rows of the same frames, seeded labels (the
    dataset interface the epoch drivers read)."""

    def __init__(self, frames, values, n: int, seed: int):
        import numpy as np

        rng = np.random.default_rng(seed)
        self.frames, self.values = frames, values
        self.starts = rng.integers(0, len(frames) - SEQ_LEN, size=n)
        self.labels = rng.integers(0, 2, size=n).astype(np.int64)
        self.labels[:2] = [0, 1]

    def __len__(self):
        return len(self.labels)

    def class_counts(self):
        import numpy as np

        return np.bincount(self.labels, minlength=2)

    def batch(self, idx):
        import numpy as np

        win = self.starts[np.asarray(idx)][:, None] + np.arange(SEQ_LEN)
        return {"video": self.frames[win], "0D": self.values[win]}, self.labels[idx]


def card_vs_cpu_steps(model, batches, labels, weight, m_list, gb_w, dev, step,
                      batch: int = 4, steps: int = 3, lr: float = 1e-3,
                      stats_tol=None) -> dict:
    """``steps`` SGD steps of an f32 model (dropout and noise off) on the
    card and on the CPU from the same weights, at ``batch``. The parameters
    after the last step are held at atol 1e-4. Each step's loss is held at
    rtol 1e-3 from the same parameters on both sides (the card's state is
    set to the CPU's before each step; the update it then makes is held at
    atol 1e-4 too): TFNGB's head BatchNorm over 4 samples turns the ~3e-7
    rounding drift of two free-running trajectories into a 1.2e-3 relative
    loss difference at the third step (H100, this phase), while the same
    parameters give the same loss on both devices to 1e-7. ``batches`` are
    dicts of tensors or tensors; ``stats_tol`` = (atol, rtol) also holds the
    free-running batch statistics against the CPU's."""
    import numpy as np

    from kstar_torch.config import OptimConfig
    from kstar_torch.train import create_train_state

    sgd = OptimConfig(optimizer="SGD", lr=lr)
    make = lambda d: create_train_state(copy.deepcopy(model).to(d), sgd, steps_per_epoch=1)
    cpu, card, free = make(torch.device("cpu")), make(dev), make(dev)
    out = {"batch": batch, "optimizer": f"SGD lr {lr}", "steps": steps,
           "losses_cpu": [], "losses_cuda_same_params": [], "losses_cuda_free": []}
    update_err = 0.0
    for i in range(steps):
        b = batches[i % len(batches)]
        b = {k: v[:batch] for k, v in b.items()} if isinstance(b, dict) else b[:batch]
        put = lambda d: ({k: v.to(d) for k, v in b.items()} if isinstance(b, dict)
                         else b.to(d))
        y = labels[i % len(labels)][:batch]
        card.flat.copy_(cpu.flat)
        if cpu.stats_flat is not None:
            card.stats_flat.copy_(cpu.stats_flat)
        card.opt_state = {k: v.to(dev) for k, v in cpu.opt_state.items()}
        card.step = cpu.step.to(dev)
        args = (weight, m_list, gb_w)
        out["losses_cuda_same_params"].append(float(step(card, put(dev), y.to(dev), *args)[1]))
        out["losses_cuda_free"].append(float(step(free, put(dev), y.to(dev), *args)[1]))
        out["losses_cpu"].append(float(step(cpu, put("cpu"), y.cpu(),
                                            *(a.cpu() for a in args))[1]))
        update_err = max(update_err, float((card.flat.cpu() - cpu.flat).abs().max()))
    l_cpu = np.array(out["losses_cpu"])
    rel = lambda got: float(np.max(np.abs(np.array(got) - l_cpu) / np.abs(l_cpu)))
    out.update(loss_max_rel=rel(out["losses_cuda_same_params"]), loss_rtol=1e-3,
               free_running_loss_max_rel=rel(out["losses_cuda_free"]),
               update_max_abs=update_err,
               param_max_abs=float((free.flat.cpu() - cpu.flat).abs().max()),
               param_atol=1e-4)
    out["ok"] = bool(out["loss_max_rel"] <= 1e-3 and update_err <= 1e-4
                     and out["param_max_abs"] <= 1e-4)
    if stats_tol is not None:
        got, want = free.stats_flat.cpu(), cpu.stats_flat
        atol, rtol = stats_tol
        out.update(stats_max_abs=float((got - want).abs().max()), stats_atol=atol,
                   stats_rtol=rtol)
        out["ok"] = out["ok"] and bool(((got - want).abs() <= atol + rtol * want.abs()).all())
    return out


def train_multimodal_phase(seed: int, frames, values, dev, cpu_models: dict,
                           batch: int = FUSION_BATCH) -> tuple:
    """fit's multimodal train step at the CLI's batch and widths: a
    ``multi`` step of MultiModalConcat and a ``multi-GB`` step of TFNGB
    (GB weights 0.1/0.4/0.5), bf16 over f32 parameters, uint8 clips of the
    256 px shot cropped to 128 and augmented inside the step, AdamW 2e-4
    with the staircase decay, clip 1.0, Focal; 5 warm-up and 30 timed steps
    (host clock up to a synchronise), peak memory, launches and busy ms of
    one profiled step. Card against CPU in f32 (dropout and noise 0, no
    augmentation) at batch 4 for 3 SGD steps (``card_vs_cpu_steps``):
    losses rtol 1e-3, parameters atol 1e-4. Then one gb_estimate (n_epochs
    1) over a small paired set:
    three finite weights that sum to 1, the caller's state untouched."""
    import numpy as np

    from kstar_torch.config import LossConfig, OptimConfig
    from kstar_torch.data import make_pre_fns, to_device
    from kstar_torch.losses import ldam_margins
    from kstar_torch.train import create_train_state, make_train_step
    from kstar_torch.train.gb import gb_estimate

    rng = np.random.default_rng(seed + 20)
    n_batches = 2
    starts = rng.integers(0, len(frames) - SEQ_LEN, size=(n_batches, batch))
    batches = [to_device({"video": frames[s[:, None] + np.arange(SEQ_LEN)],
                          "0D": values[s[:, None] + np.arange(SEQ_LEN)]}, dev)
               for s in starts]
    labels = [torch.as_tensor(rng.integers(0, 2, size=batch)).to(dev) for _ in range(n_batches)]
    loss_cfg = LossConfig()
    weight = torch.ones(2, device=dev)
    m_list = torch.as_tensor(ldam_margins(np.array([batch // 2, batch // 2]))).to(dev)
    gb_w = torch.tensor([0.1, 0.4, 0.5], device=dev)
    pre_train, pre_eval = make_pre_fns(CROP, out_dtype=torch.bfloat16)
    pre32 = make_pre_fns(CROP, out_dtype=torch.float32)[1]
    ok, fields, states = True, {}, {}
    for name, model_type in (("concat", "multi"), ("TFN_GB", "multi-GB")):
        model = twin(cpu_models[name], torch.bfloat16).to(dev)
        state = create_train_state(model, OptimConfig(), steps_per_epoch=1, seed=seed)
        step = make_train_step(loss_cfg, pre_fn=pre_train, model_type=model_type)
        start = state.flat.clone()
        kernel_launches(reset=True)
        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        for i in range(35):
            t0 = time.perf_counter()
            _, loss, _ = step(state, batches[i % n_batches], labels[i % n_batches], weight,
                              m_list, gb_w)
            torch.cuda.synchronize()
            if i >= 5:
                times.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        losses = torch.stack(losses).cpu().numpy()
        moved = float((state.flat != start).float().mean())
        n_launch, busy_ms, prof_wall, top = step_launches(
            lambda: step(state, batches[0], labels[0], weight, m_list, gb_w))
        launches_k = kernel_launches()
        del start

        quiet = twin(cpu_models[name], torch.float32, quiet=True)
        parity = card_vs_cpu_steps(quiet, batches, labels, weight, m_list, gb_w, dev,
                                   make_train_step(loss_cfg, pre_fn=pre32,
                                                   model_type=model_type))

        t = np.asarray(times)
        entry = dict(
            model_type=model_type, params=int(state.flat.numel()), batch=batch,
            dtype="bfloat16 over f32 parameters",
            optimizer="AdamW lr 2e-4 staircase 0.95 every 4 updates, clip 1.0",
            loss="Focal gamma 2" + (", GB weights 0.1/0.4/0.5" if model_type == "multi-GB"
                                    else ""),
            steps_timed=len(t), step_p50_ms=float(np.median(t)),
            step_p99_ms=float(np.percentile(t, 99)), step_runs_ms=t.tolist(),
            samples_per_s=batch * len(t) / (t.sum() / 1e3), peak_mem_gb=peak_gb,
            launches_per_step=n_launch, profiled_step_device_busy_ms=busy_ms,
            profiled_step_wall_ms=prof_wall, top_kernels=top,
            device_idle_share=None if busy_ms is None else 1 - busy_ms / float(np.median(t)),
            losses=losses.tolist(), params_moved_share=moved,
            card_vs_cpu=parity, kernel_launches=launches_k)
        entry_ok = bool(np.isfinite(losses).all() and moved > 0.5 and parity["ok"]
                        and not any(launches_k.values()))
        entry["ok"] = entry_ok
        ok = ok and entry_ok
        fields[name] = entry
        states[name] = state

    # one Gradient-Blending estimate from the TFNGB state
    state = states.pop("TFN_GB")
    del states
    flat0, step0 = state.flat.clone(), int(state.step)
    t0 = time.perf_counter()
    w = gb_estimate(state, PairedClips(frames, values, 2 * batch, seed + 30),
                    PairedClips(frames, values, batch, seed + 31), loss_cfg, batch,
                    n_epochs=1, seed=seed, pre_fn=pre_train, pre_fn_eval=pre_eval)
    est_s = time.perf_counter() - t0
    vals = np.array(list(w.values()))
    untouched = torch.equal(state.flat, flat0) and int(state.step) == step0
    gb_ok = (list(w) == ["video", "0D", "multi"] and bool(np.isfinite(vals).all())
             and abs(vals.sum() - 1.0) < 1e-6 and untouched)
    fields["gb_estimate"] = dict(model="TFN_GB", n_epochs=1, train=2 * batch, valid=batch,
                                 weights=w, seconds=est_s, state_untouched=untouched,
                                 ok=gb_ok)
    return ok and gb_ok, fields


def train_multimodal_cli_phase(root: str) -> tuple:
    """python -m kstar_torch.cli.train_multimodal --synthetic at the default
    widths for 2 epochs and then --resume for one more, for concat fusion
    and for TFN with dynamic Gradient Blending (re-estimated every epoch,
    one probe epoch; its resume with --skip_extras), into ``root/<label>``
    (``reload_eval`` reloads concat's checkpoint and holds its alarm files):
    checkpoints, report, alarm artifacts; each alarm sweep must launch the
    spatial-table kernel."""
    import re

    from kstar_torch.cli import train_multimodal

    fields, ok = {}, True
    for label, model_args, resume_extra in (
            ("concat", ["--model_type", "concat"], []),
            ("TFN_GB", ["--model_type", "TFN", "--use_GB", "--gb_dynamic",
                        "--epoch_per_GB_estimate", "1", "--n_epochs_GB_estimate", "1"],
             ["--skip_extras"])):
        tmp = f"{root}/{label}"
        argv = model_args + ["--synthetic", "--weight_dir", f"{tmp}/w",
                             "--save_dir", f"{tmp}/r", "--verbose", "1"]
        runs = {}
        for name, extra in (("first", ["--num_epoch", "2"]),
                            ("resume", ["--num_epoch", "1", "--resume"]
                             + resume_extra)):
            _, text, wall, launches_k = run_cli(train_multimodal.main, argv + extra)
            files = sorted(os.listdir(f"{tmp}/w")) + sorted(os.listdir(f"{tmp}/r"))
            last = [f for f in files if f.endswith("_last.ckpt")]
            best = [f for f in files if f.endswith("_best.ckpt")]
            reports = [f for f in files if f.endswith("_report.txt")]
            alarms = [f for f in files if f.endswith(("_alarms.json", "_alarms.csv",
                                                      "_threshold_tradeoff.csv",
                                                      "_dwell_tradeoff.csv",
                                                      "_operating_grid.csv"))]
            f1 = re.search(r"test macro-F1 ([0-9.]+)", text)
            gb = re.search(r"final GB weights: (.*)", text)
            saved_step = (int(torch.load(f"{tmp}/w/{last[0]}", map_location="cpu")["step"])
                          if last else None)
            run = dict(wall_s=wall, test_macro_f1=float(f1.group(1)) if f1 else None,
                       test_line=test_line(text),
                       checkpoints=sorted(last + best), reports=reports,
                       alarm_artifacts=len(alarms), saved_step=saved_step,
                       datasets=re.search(r"datasets: .*", text).group(0),
                       gb_weights=gb.group(1) if gb else None,
                       skipped="alarm evaluation skipped" in text,
                       kernel_launches=launches_k)
            # a run without --skip_extras sweeps the test shots for its
            # alarms (the table kernel)
            swept = "--skip_extras" not in extra
            ok = ok and bool(last and best and reports and f1 and len(alarms) == 5
                             and not run["skipped"]
                             and (launches_k["spatial_table"] > 0) == swept
                             and (gb is not None) == ("--use_GB" in model_args))
            if name == "resume":
                m = re.search(r"resumed from \S+ at step (\d+)", text)
                run["resumed_at_step"] = int(m.group(1)) if m else None
                ok = ok and run["resumed_at_step"] == runs["first"]["saved_step"] \
                    and saved_step > run["resumed_at_step"]
            runs[name] = run
        fields[label] = runs
    return ok, fields


# ---------------------------------------------------------------------------
# The conv video models: R(2+1)D and SlowFast at their configs' full widths
# ---------------------------------------------------------------------------

CONV_SEQ = {"R2Plus1D": 21, "SlowFast": 20, "SlowFast_subbn2": 20}
# conv epilogue kernel (bn_act) launches in one bf16 evaluation forward on
# the card: R(2+1)D's 32 conv outputs; SlowFast runs its own BatchNorm chain
CONV_EPILOGUES = {"R2Plus1D": 32, "SlowFast": 0, "SlowFast_subbn2": 0}
CONV_BATCH, CONV_TRAIN_BATCH = 32, 64
PLAIN_CHUNKS = 8                  # conv_sweep: chunks compared with the plain gather
# conv_models: bf16 against f32 probabilities at batch 32, per model. The
# H100 readings were 4.5e-3 (R(2+1)D), 5.3e-2 (SlowFast) and 4.1e-2 (with
# SubBatchNorm): over 16 bottlenecks of two pathways the bf16 convs part
# SlowFast's pooled features 11-13% (of the largest) from the f32 ones, as
# JAX's own bf16 model's do (tests/test_torch_models_conv.py holds the
# port's bf16 gap within twice JAX's on the same weights).
CONV_BF16_PROB_TOL = {"R2Plus1D": 1e-2, "SlowFast": 0.1, "SlowFast_subbn2": 0.1}


def conv_model(key: str, dtype=torch.float32, seed=None):
    """R(2+1)D, SlowFast or SlowFast with SubBatchNorm (base_bn_splits 2) at
    kstar_torch/config.py's full widths; random weights from ``seed``
    (None: no initialisation draws, for a model built on the meta device)."""
    from kstar_torch.config import R2Plus1DConfig, SlowFastConfig
    from kstar_torch.models import build_video_model

    name, cfg = {"R2Plus1D": ("R2Plus1D", R2Plus1DConfig()),
                 "SlowFast": ("SlowFast", SlowFastConfig()),
                 "SlowFast_subbn2": ("SlowFast", SlowFastConfig(base_bn_splits=2))}[key]
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    return build_video_model(name, cfg, dtype=dtype, generator=gen)


def conv_twin(model, key: str, dtype):
    """The same weights and statistics in another compute dtype, on the CPU."""
    with torch.device("meta"):             # no second random initialisation
        other = conv_model(key, dtype)
    other.load_state_dict({k: v.detach().cpu().clone() for k, v in model.state_dict().items()},
                          assign=True)
    return other


@torch.no_grad()
def calibrate_bn(model, x) -> None:
    """Set every backbone BatchNorm's running statistics (a SubBatchNorm's
    split and aggregated ones too) to the statistics of its own input in one
    eval forward of ``x``, layer after layer, so that random weights see
    O(1) activations in evaluation as trained ones do. The head's BatchNorm
    keeps its zeros/ones: its statistics run over clips, and the noise
    frames' clips pool to nearly the same features, so calibrating it would
    divide by a vanishing spread and blow rounding up into the logits."""
    from kstar_torch.models import SubBatchNorm
    from kstar_torch.models.common import BatchNorm, MLPHead

    heads = {id(m.norm) for m in model.modules() if isinstance(m, MLPHead)}

    def pre(mod, args):
        inp = args[0].float()
        axes = tuple(range(inp.dim() - 1))
        mean, var = inp.mean(axes), inp.var(axes, unbiased=False)
        mod.running_mean.copy_(mean)
        mod.running_var.copy_(var)
        if isinstance(mod, SubBatchNorm):
            mod.split_mean.copy_(mean.expand_as(mod.split_mean))
            mod.split_var.copy_(var.expand_as(mod.split_var))

    hooks = [m.register_forward_pre_hook(pre) for m in model.modules()
             if isinstance(m, (BatchNorm, SubBatchNorm)) and id(m) not in heads]
    model.eval()(x)
    for h in hooks:
        h.remove()


@torch.no_grad()
def conv_flops(model, clip) -> float:
    """Operations (2 x multiply-adds) of every conv and Dense in one forward
    of ``clip`` (1, L, H, W, C), from the shapes the layers see."""
    from kstar_torch.models.common import Conv3d
    from kstar_torch.models.vivit import Dense

    total = [0]

    def hook(mod, args, out):
        total[0] += 2 * out.numel() * mod.weight.shape[1:].numel()

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (Conv3d, Dense))]
    model.eval()(clip)
    for h in hooks:
        h.remove()
    return float(total[0]) / clip.shape[0]


def conv_clips(frames_dev, L: int, batch: int):
    """(batch, L, crop, crop, 3) uint8 windows spread over the cropped shot."""
    import numpy as np

    T = frames_dev.shape[0]
    starts = torch.as_tensor(np.linspace(0, T - L - 1, batch).astype(np.int64),
                             device=frames_dev.device)
    return frames_dev[starts[:, None] + torch.arange(L, device=frames_dev.device)]


def bn_act_checks(seed: int, frames_dev, dev) -> tuple:
    """The conv epilogue kernel (ops/bn_act.py) on the main path's own data:
    a bf16 R(2+1)D at kstar_torch/config.py's widths (random weights from
    ``seed``, BatchNorm statistics calibrated on 8 windows of the cropped
    shot) over ``BATCH`` windows hands each BatchNorm its conv output and,
    at the residual joins, the shortcut. For every distinct (shape,
    residual) among the 32, and at the largest shape once more with a
    residual (the batch's conv output in reverse order), a kernel_check
    row: the kernel against its plain version bit for bit, device ms by
    CUDA events against the plain version's, GB/s over the bytes it must
    move (2 read and 2 written an element, 2 more read with the residual)
    and the byte bound at 3.35 TB/s. Then the whole forward on the kernel
    and on the eager chain (a module forward hook sends every BatchNorm to
    the eager chain), cuDNN deterministic: the logits equal bit for bit,
    device ms of each, and the kernel's launches a forward (32, none on the
    eager chain). Returns (rows, forward fields, forward ok)."""
    from kstar_torch.config import PIXEL_MEAN_BGR
    from kstar_torch.models.common import BN_EPS, BatchNorm
    from kstar_torch.ops.bn_act import bn_act, bn_act_reference

    model = conv_model("R2Plus1D", torch.bfloat16, seed=seed * 10 + 30).to(dev)
    L = CONV_SEQ["R2Plus1D"]
    x = (conv_clips(frames_dev, L, BATCH).to(torch.bfloat16)
         - torch.tensor(PIXEL_MEAN_BGR, dtype=torch.bfloat16, device=dev))
    calibrate_bn(model, x[:8])
    cases = {}

    def capture(mod, args, kwargs):
        if "alpha" in kwargs:
            r = kwargs["residual"]
            cases.setdefault((tuple(args[0].shape), r is not None),
                             (mod, args[0], r, kwargs["alpha"]))

    hooks = [m.register_forward_pre_hook(capture, with_kwargs=True)
             for m in model.modules() if isinstance(m, BatchNorm)]
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    (shape, _), (bn, big, _, alpha) = max(cases.items(), key=lambda kv: kv[1][1].numel())
    cases.setdefault((shape, True), (bn, big, big.flip(0), alpha))
    rows = []
    for (shape, has_res), (bn, inp, res, alpha) in cases.items():
        with torch.no_grad():
            mul = torch.rsqrt(bn.running_var + BN_EPS) * bn.weight
            args = (inp, bn.running_mean, mul, bn.bias, alpha, torch.bfloat16, res)
            got, want = bn_act(*args), bn_act_reference(*args)
            torch.cuda.synchronize()
            equal = torch.equal(got, want)
            res_cmp = compare(got, want, 0.0, 0.0, 0.0)
            del got, want
            ms = time_ms(lambda: bn_act(*args), 20)
            plain_ms = time_ms(lambda: bn_act_reference(*args), 5)
        moved = inp.numel() * (6 if has_res else 4) + 3 * 4 * shape[-1]
        bound_ms, bound_by = bound(4.0 * inp.numel(), moved, "float32")  # no tensor-core work
        rows.append(dict(
            name="bn_act", case=f"R(2+1)D {list(shape)}{' + residual' if has_res else ''} "
                                f"bf16 (conv path)",
            dtype="bfloat16", shape=list(shape), route="cuda",
            source="kstar_torch/csrc/bn_act.cu",
            replaces="none (XLA fuses kstar_tpu/models/r2plus1d.py:57-58, :115)", **res_cmp,
            bit_equal=equal, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None, instance="residual" if has_res else "plain",
            gb_s=moved / ms / 1e6, hbm_share=moved / ms / 1e-3 / HBM_BYTES_PER_S))
        rows[-1]["ok"] = res_cmp["ok"] and equal
    del cases, big, bn, inp, res

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    fwd = torch.no_grad()(lambda: model(x))
    counts, logits, ms = {}, {}, {}
    try:
        for path in ("kernel", "eager"):
            hook = (torch.nn.modules.module.register_module_forward_hook(lambda *a: None)
                    if path == "eager" else None)
            try:
                before = (bn_act.fused, bn_act.eager)
                logits[path] = fwd()
                counts[path] = (bn_act.fused - before[0], bn_act.eager - before[1])
                ms[path] = time_ms(fwd, 3)
            finally:
                if hook is not None:
                    hook.remove()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    fields = dict(
        batch=BATCH, frames=L, crop=CROP, cases=len(rows),
        forward_ms_kernel=ms["kernel"], forward_ms_eager=ms["eager"],
        forward_epilogues_kernel=dict(zip(("fused", "eager"), counts["kernel"])),
        forward_epilogues_eager=dict(zip(("fused", "eager"), counts["eager"])),
        forward_bit_equal=torch.equal(logits["kernel"], logits["eager"]),
        forward_finite=bool(torch.isfinite(logits["kernel"]).all()))
    ok = (fields["forward_bit_equal"] and fields["forward_finite"]
          and counts["kernel"] == (CONV_EPILOGUES["R2Plus1D"], 0)
          and counts["eager"] == (0, CONV_EPILOGUES["R2Plus1D"]))
    return rows, fields, ok


def conv_models_phase(seed: int, frames_dev, dev, batch: int = CONV_BATCH) -> tuple:
    """Each conv model's eval forward at ``batch`` windows of the cropped
    shot, with its BatchNorm statistics calibrated on 8 of them
    (``calibrate_bn``): bf16 against f32 probabilities on the card (within
    CONV_BF16_PROB_TOL), f32 card against CPU at batch 2 (atol 1e-4 + rtol
    1e-4; TF32 is off), device ms by CUDA events, launches and busy ms of
    one bf16 forward, operations per clip; no K1-K3 launch, and the conv
    epilogue kernel's 32 a bf16 R(2+1)D forward (three: the forward, the
    encoding, the profiled forward), none for SlowFast. SlowFast with
    SubBatchNorm: after two train-mode forwards and an aggregation, its
    eval forward equals a plain SlowFast's holding the aggregated
    statistics in its BatchNorms (f32, atol 1e-4 + rtol 1e-4). Returns
    (ok, fields, the calibrated f32 models on the CPU, the bf16 models on
    the card, operations per clip)."""
    from kstar_torch.config import PIXEL_MEAN_BGR
    from kstar_torch.models import aggregate_batch_stats

    mean32 = torch.tensor(PIXEL_MEAN_BGR, device=dev)
    ok, fields, cpu_models, bf16_models, flops = True, {}, {}, {}, {}
    for i, key in enumerate(CONV_SEQ):
        L = CONV_SEQ[key]
        clips = conv_clips(frames_dev, L, batch)
        x_32 = clips.float() - mean32
        x_bf = clips.to(torch.bfloat16) - mean32.to(torch.bfloat16)
        f32 = conv_model(key, seed=seed * 10 + 40 + i).to(dev)
        calibrate_bn(f32, x_32[:8])
        cpu = conv_twin(f32, key, torch.float32).eval()
        bf = conv_twin(f32, key, torch.bfloat16).to(dev).eval()
        kernel_launches(reset=True)
        with torch.no_grad():
            out_32, out_bf = f32(x_32), bf(x_bf)
            want, got = cpu(x_32[:2].cpu()), f32(x_32[:2])
            h_32, h_bf = f32.encode(x_32), bf.encode(x_bf)
        torch.cuda.synchronize()
        res = compare(got.cpu(), want, 1e-4, 1e-4, 1e-4)
        p_32, p_bf = torch.softmax(out_32, -1), torch.softmax(out_bf, -1)
        p_err = float((p_bf - p_32).abs().max())
        h_rel = float((h_bf - h_32).abs().max() / h_32.abs().max())
        fwd_bf = torch.no_grad()(lambda: bf(x_bf))
        fwd_32 = torch.no_grad()(lambda: f32(x_32))
        n_launch, busy_ms, _, top = step_launches(fwd_bf)
        launches_k = kernel_launches()
        flops[key] = conv_flops(bf, x_bf[:1])
        tol = CONV_BF16_PROB_TOL[key]
        ms_bf = time_ms(fwd_bf, 5)
        entry = dict(
            params=sum(p.numel() for p in cpu.parameters()), batch=batch, frames=L, crop=CROP,
            gflop_per_clip=flops[key] / 1e9, f32_card_vs_cpu=res,
            bf16_vs_f32_probs_max_abs=p_err, bf16_probs_tol=tol,
            bf16_vs_f32_encode_max_rel=h_rel,
            probs_spread=float(p_32[:, 0].max() - p_32[:, 0].min()),
            forward_ms_bf16=ms_bf, forward_ms_f32=time_ms(fwd_32, 3),
            launches_per_forward_bf16=n_launch, forward_device_busy_ms_bf16=busy_ms,
            top_kernels_bf16=None if top is None else top[:5], kernel_launches=launches_k)
        entry_ok = (res["ok"] and p_err <= tol and out_bf.shape == (batch, 2)
                    and bool(torch.isfinite(out_bf).all())
                    and launches_k == dict.fromkeys(launches_k, 0) | {
                        "bn_act": 3 * CONV_EPILOGUES[key]})
        if key == "SlowFast_subbn2":
            sub = conv_twin(f32, key, torch.float32).to(dev)
            with torch.no_grad():
                for half in x_32.chunk(2):
                    sub(half, train=True)
                aggregate_batch_stats(sub)
                with torch.device("meta"):
                    plain = conv_model("SlowFast")
                plain.load_state_dict({k: v.clone() for k, v in sub.state_dict().items()
                                       if "split_" not in k}, assign=True)
                plain.eval()
                agg = compare(sub.eval()(x_32), plain(x_32), 1e-4, 1e-4, 1e-5)
            entry["aggregated_vs_plain_bn"] = agg
            entry_ok = entry_ok and agg["ok"]
            del sub, plain
        entry["ok"] = entry_ok
        ok = ok and entry_ok
        fields[key] = entry
        cpu_models[key], bf16_models[key] = cpu, bf
        del f32, x_32
    return ok, fields, cpu_models, bf16_models, flops


def conv_sweep_phase(frames, frames_dev, dev, models: dict, flops: dict) -> tuple:
    """VideoSweeper (B = 128) over the whole cropped shot for R(2+1)D (21
    frames) and SlowFast (20): clips/s, median of 3 sweeps each ending in the
    device-to-host copy (after a warm-up over two chunks, which have the
    sweep's shapes); one window-gather launch per chunk and no
    spatial-table launch; the first ``PLAIN_CHUNKS`` chunks of the curve
    against the same windows through the plain gather (max |dp| <= 0.05,
    mean <= 5e-3, raw_sweep's rule); the operation bound (operations
    counted from the conv shapes over the bf16 peak) and the share of it the
    sweep reaches; launches and busy ms of two chunks under the profiler,
    scaled to the sweep; peak memory; predict_video_shot over the shot's
    first 1024 frames; each chunk's R(2+1)D forward runs its 32 conv
    epilogues on the epilogue kernel. An R(2+1)D sweep takes ~5 s, so the
    warm-up, the plain-gather curve and predict_video_shot run on parts of
    the shot. Returns (ok, fields, window-gather launches, epilogue-kernel
    launches)."""
    import numpy as np

    from kstar_torch.config import FPS
    from kstar_torch.infer import VideoSweeper, chunkify_starts, predict_video_shot
    from kstar_torch.ops.preprocess import gather_normalize_reference

    T = frames_dev.shape[0]
    ok, fields, k3, epi = True, {}, {}, {}
    for key in ("R2Plus1D", "SlowFast"):
        L, model = CONV_SEQ[key], models[key]
        starts = np.arange(T - L - 1, dtype=np.int64)
        n_chunks = len(chunkify_starts(starts, BATCH))
        sw = VideoSweeper(model, L, CROP, BATCH, torch.bfloat16, device=dev)
        sw.sweep_device(frames_dev, starts[:2 * BATCH])             # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernel_launches(reset=True)
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            probs = sw.sweep_device(frames_dev, starts)           # ends in a host copy
            walls.append(time.perf_counter() - t0)
        launches = kernel_launches()
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        sub = starts[:PLAIN_CHUNKS * BATCH]
        with torch.no_grad():                 # the sweep's chunks through the plain gather
            p_plain = torch.cat([torch.softmax(model(gather_normalize_reference(
                frames_dev, c, L, torch.bfloat16)).float(), -1)[:, 0]
                for c in torch.from_numpy(chunkify_starts(sub, BATCH)).to(dev)])
        err = np.abs(probs[:len(sub)] - p_plain.cpu().numpy()[:len(sub)])
        n_sub, busy_sub, _, top = step_launches(
            lambda: sw.sweep_table(frames_dev, starts[:2 * BATCH]))
        kernel_launches(reset=True)
        time_x, curve = predict_video_shot(model, frames[:1024], 0, 1024 - int(FPS), L,
                                           crop_size=CROP, batch_size=BATCH, device=dev)
        pred_k = kernel_launches()
        pred_launches = pred_k["gather_normalize"]
        pred_chunks = len(chunkify_starts(np.arange(1024 - L - 3), BATCH))
        sweep_s = float(np.median(walls))
        bound_ms = len(starts) * flops[key] / PEAK_OPS_PER_S["bfloat16"] * 1e3
        busy_ms = None if busy_sub is None else busy_sub * n_chunks / 2
        expect_len = L + (1024 - L - 3) - 2
        entry = dict(
            frames=T, seq_len=L, windows=len(starts), batch=BATCH, chunks=n_chunks,
            clips_per_s=len(starts) / sweep_s, sweep_ms=sweep_s * 1e3,
            sweep_runs_ms=[w * 1e3 for w in walls], launches_3_sweeps=launches,
            operation_bound_ms=bound_ms, bound_share=bound_ms / (sweep_s * 1e3),
            launches_per_sweep=None if n_sub is None else n_sub * n_chunks // 2,
            device_busy_ms=busy_ms,
            device_idle_share=None if busy_ms is None else 1 - busy_ms / (sweep_s * 1e3),
            top_kernels_2_chunks=None if top is None else top[:5], peak_mem_gb=peak_gb,
            plain_gather_windows=len(sub), curve_vs_plain_gather_max_abs=float(err.max()),
            curve_vs_plain_gather_mean_abs=float(err.mean()),
            predict_curve_len=len(curve), predict_expect_len=expect_len,
            predict_gather_launches=pred_launches)
        entry_ok = (launches["gather_normalize"] == 3 * n_chunks
                    and launches["spatial_table"] == 0 and launches["fused_attention"] == 0
                    and launches["bn_act"] == CONV_EPILOGUES[key] * 3 * n_chunks
                    and probs.shape == starts.shape and bool(np.isfinite(probs).all())
                    and err.max() <= 5e-2 and err.mean() <= 5e-3
                    and len(curve) == len(time_x) == expect_len
                    and bool(np.isfinite(curve).all()) and pred_launches == pred_chunks
                    and pred_k["bn_act"] == CONV_EPILOGUES[key] * pred_chunks)
        entry["ok"] = entry_ok
        ok = ok and entry_ok
        fields[key] = entry
        k3[key] = launches["gather_normalize"] + pred_launches
        epi[key] = launches["bn_act"] + pred_k["bn_act"]
    return ok, fields, k3, epi


def conv_stream_phase(frames, dev, models: dict, n_blocks: int = 30) -> tuple:
    """StreamingPredictor with R(2+1)D (21 frames) and SlowFast (20):
    choose_block_size over probe_stream_blocks at 210 fps, then
    ``n_blocks`` timed blocks at that size (one window-gather launch each);
    p50 frame-to-alarm by M2's definition; blocks against single pushes
    (|dp| <= 2e-2, equal alarms where the threshold gap decides them).
    Whether a block keeps up with the camera is reported, not required.
    Each timed block's R(2+1)D forward runs its 32 conv epilogues on the
    epilogue kernel. Returns (ok, fields, window-gather launches,
    epilogue-kernel launches)."""
    import numpy as np

    from kstar_torch.config import FPS
    from kstar_torch.infer import StreamingPredictor, choose_block_size, probe_stream_blocks

    c0 = RESIZE // 2 - CROP // 2
    cropped = np.ascontiguousarray(frames[:, c0:c0 + CROP, c0:c0 + CROP])
    ok, fields, k3, epi = True, {}, {}, {}
    for key in ("R2Plus1D", "SlowFast"):
        L, model = CONV_SEQ[key], models[key]
        mk = lambda **kw: StreamingPredictor(model, seq_len=L, crop_size=CROP,
                                             compute_dtype=torch.bfloat16, device=dev, **kw)
        k, report = choose_block_size(probe_stream_blocks(model, L, CROP, torch.bfloat16,
                                                          device=dev), fps=FPS)
        sp = mk(block_size=k)
        sp.push_block(cropped[:k])                               # allocate + warm
        kernel_launches(reset=True)
        times = []
        for i in range(1, n_blocks + 1):
            t0 = time.perf_counter()
            sp.push_block(cropped[i * k:(i + 1) * k])
            times.append((time.perf_counter() - t0) * 1e3)
        launches = kernel_launches()
        block_ms = np.asarray(times)
        lat = block_ms[:, None] + ((k - 1 - np.arange(k)) / FPS * 1e3)[None, :]
        # blocks against single pushes over a dark start, so p moves
        kk = max(k, 16)
        seq = frames[:2 * kk].copy()
        seq[:L + 3] //= 4
        probe = mk(block_size=kk, suppress_s=0.0)
        p0 = np.concatenate([probe.push_block(seq[:kk])[0], probe.push_block(seq[kk:])[0]])
        armed = np.sort(p0[L:])
        gap_at = int(np.argmax(np.diff(armed)))
        thr = float(armed[gap_at:gap_at + 2].mean())
        gap = float(armed[gap_at + 1] - armed[gap_at])
        blk = mk(block_size=kk, suppress_s=0.0, threshold=thr)
        blk_out = [blk.push_block(seq[:kk]), blk.push_block(seq[kk:])]
        blk_p, blk_a = (np.concatenate([o[j] for o in blk_out]) for j in (0, 1))
        one = mk(block_size=1, suppress_s=0.0, threshold=thr)
        one_out = [one.push(f) for f in seq]
        one_p, one_a = np.array([o[0] for o in one_out]), np.array([o[1] for o in one_out])
        push_err = float(np.abs(blk_p - one_p).max())
        decidable = gap > 2 * push_err
        p50_block = float(np.median(block_ms))
        entry = dict(
            seq_len=L, fps=FPS, chosen_k=k, probe_report={str(kp): r for kp, r in report.items()},
            p50_frame_to_alarm_ms=float(np.median(lat)), block_p50_ms=p50_block,
            block_p99_ms=float(np.percentile(block_ms, 99)), per_frame_ms=p50_block / k,
            sustains=p50_block / k <= 1e3 / FPS, launches=launches, blocks=n_blocks,
            compared_block=kk, blocks_vs_single_max_abs=push_err, blocks_vs_single_tol=2e-2,
            threshold=thr, threshold_gap=gap, alarms_decidable=bool(decidable),
            alarms_equal=bool(np.array_equal(blk_a, one_a)))
        entry_ok = (launches["gather_normalize"] == n_blocks and launches["spatial_table"] == 0
                    and launches["fused_attention"] == 0
                    and launches["bn_act"] == CONV_EPILOGUES[key] * n_blocks
                    and bool(np.isfinite(blk_p).all())
                    and push_err <= 2e-2
                    and (not decidable or (np.array_equal(blk_a, one_a)
                                           and blk.alarm_time == one.alarm_time)))
        entry["ok"] = entry_ok
        ok = ok and entry_ok
        fields[key] = entry
        k3[key] = launches["gather_normalize"]
        epi[key] = launches["bn_act"]
    return ok, fields, k3, epi


def train_conv_phase(seed: int, frames, dev, cpu_models: dict,
                     batch: int = CONV_TRAIN_BATCH) -> tuple:
    """fit's train step at batch 64 for R(2+1)D, SlowFast and SlowFast with
    SubBatchNorm (bn_splits 2): bf16 over f32 parameters, uint8 clips of the
    256 px shot cropped to 128 and augmented inside the step, AdamW 2e-4
    with the staircase decay, clip 1.0, Focal; 5 warm-up and 30 timed steps
    (host clock up to a synchronise), clips/s, peak memory, launches, busy
    ms and idle share of one profiled step. The NaN guard leaves the
    parameters, optimizer state, step and every statistic (the split ones
    too) bit-identical. Card against CPU in f32 at batch 4 for 3 SGD steps
    (``card_vs_cpu_steps``): losses rtol 1e-3, parameters atol 1e-4, the
    statistics atol 1e-4 + rtol 1e-5 (the stem's running variance of
    pixel-scale conv outputs is in the thousands, where one f32 ulp is
    ~2e-4). With SubBatchNorm, one aggregation after the steps equals its
    numpy formula."""
    import numpy as np

    from kstar_torch.config import LossConfig, OptimConfig
    from kstar_torch.data import make_pre_fns, to_device
    from kstar_torch.losses import ldam_margins
    from kstar_torch.models import SubBatchNorm, aggregate_batch_stats
    from kstar_torch.train import create_train_state, make_train_step

    rng = np.random.default_rng(seed + 50)
    loss_cfg = LossConfig()
    weight = torch.ones(2, device=dev)
    m_list = torch.as_tensor(ldam_margins(np.array([batch // 2, batch // 2]))).to(dev)
    gb_w = torch.zeros(3, device=dev)
    pre_train = make_pre_fns(CROP, out_dtype=torch.bfloat16)[0]
    pre32 = make_pre_fns(CROP, out_dtype=torch.float32)[1]
    ok, fields = True, {}
    for key, cpu in cpu_models.items():
        L = CONV_SEQ[key]
        starts = rng.integers(0, len(frames) - L, size=(2, batch))
        batches = [to_device(frames[s[:, None] + np.arange(L)], dev) for s in starts]
        labels = [torch.as_tensor(rng.integers(0, 2, size=batch)).to(dev) for _ in range(2)]
        model = conv_twin(cpu, key, torch.bfloat16).to(dev)
        state = create_train_state(model, OptimConfig(), steps_per_epoch=1, seed=seed)
        step = make_train_step(loss_cfg, pre_fn=pre_train)
        start = state.flat.clone()
        kernel_launches(reset=True)
        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        for i in range(35):
            t0 = time.perf_counter()
            _, loss, _ = step(state, batches[i % 2], labels[i % 2], weight, m_list)
            torch.cuda.synchronize()
            if i >= 5:
                times.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        losses = torch.stack(losses).cpu().numpy()
        moved = float((state.flat != start).float().mean())
        del start
        n_launch, busy_ms, prof_wall, top = step_launches(
            lambda: step(state, batches[0], labels[0], weight, m_list))
        launches_k = kernel_launches()

        # the NaN guard, every statistic included
        before = (state.flat.clone(), {k: v.clone() for k, v in state.opt_state.items()},
                  state.step.clone(), state.stats_flat.clone())
        _, nan_loss, _ = step(state, batches[0], labels[0],
                              torch.full((2,), float("nan"), device=dev), m_list)
        guard_ok = (not bool(torch.isfinite(nan_loss)) and torch.equal(state.flat, before[0])
                    and all(torch.equal(state.opt_state[k], v) for k, v in before[1].items())
                    and torch.equal(state.step, before[2])
                    and torch.equal(state.stats_flat, before[3]))
        subbns = [m for m in state.model.modules() if isinstance(m, SubBatchNorm)]
        agg_err = None
        if subbns:
            with torch.no_grad():
                aggregate_batch_stats(state.model)
            agg_err = 0.0
            for m in subbns:
                sm, sv = m.split_mean.cpu().double().numpy(), m.split_var.cpu().double().numpy()
                mean = sm.mean(0)
                var = sv.mean(0) + ((sm - mean) ** 2).mean(0)
                agg_err = max(agg_err, float(np.abs(m.running_mean.cpu().numpy() - mean).max()),
                              float(np.abs(m.running_var.cpu().numpy() - var).max()
                                    / max(np.abs(var).max(), 1.0)))
        del state, model

        quiet = conv_twin(cpu, key, torch.float32).train()
        parity = card_vs_cpu_steps(quiet, batches, labels, weight, m_list, gb_w, dev,
                                   make_train_step(loss_cfg, pre_fn=pre32),
                                   stats_tol=(1e-4, 1e-5))
        t = np.asarray(times)
        entry = dict(
            params=int(sum(p.numel() for p in cpu.parameters())), batch=batch, frames=L,
            dtype="bfloat16 over f32 parameters",
            optimizer="AdamW lr 2e-4 staircase 0.95 every 4 updates, clip 1.0",
            loss="Focal gamma 2", steps_timed=len(t), step_p50_ms=float(np.median(t)),
            step_p99_ms=float(np.percentile(t, 99)), clips_per_s=batch * len(t) / (t.sum() / 1e3),
            peak_mem_gb=peak_gb, launches_per_step=n_launch,
            profiled_step_device_busy_ms=busy_ms, profiled_step_wall_ms=prof_wall,
            top_kernels=None if top is None else top[:5],
            device_idle_share=None if busy_ms is None else 1 - busy_ms / float(np.median(t)),
            losses_first_last=[float(losses[0]), float(losses[-1])],
            params_moved_share=moved, nan_guard_bit_identical=guard_ok,
            subbn_modules=len(subbns), aggregate_vs_numpy_max_err=agg_err,
            card_vs_cpu=parity, kernel_launches=launches_k)
        entry_ok = bool(np.isfinite(losses).all() and moved > 0.5 and guard_ok and parity["ok"]
                        and not any(launches_k.values())
                        and (key != "SlowFast_subbn2" or (subbns and agg_err <= 1e-6)))
        entry["ok"] = entry_ok
        ok = ok and entry_ok
        fields[key] = entry
        del batches
    return ok, fields


def train_conv_cli_phase(root: str) -> tuple:
    """python -m kstar_torch.cli.train_vision --synthetic with --model
    R2Plus1D for 2 epochs and a --resume for one more, and with --model
    SlowFast --bn_splits 2 for 2 epochs: checkpoints, report, the alarm
    JSON/CSV files (the CLI's alarm sweep is best-effort, so their presence
    is checked), window-gather launches from the alarm sweep and no
    spatial-table launch, and the SlowFast checkpoint's aggregated
    statistics equal to the aggregate of its split statistics. Each writes
    into ``root/<label>`` (``reload_eval`` reloads the SlowFast checkpoint).
    Returns (ok, fields, window-gather launches)."""
    import re

    from kstar_torch.cli import train_vision
    from kstar_torch.models import aggregate_subbn_stats

    fields, ok, k3 = {}, True, 0
    for label, model_args, runs in (
            ("R2Plus1D", ["--model", "R2Plus1D"],
             (("first", ["--num_epoch", "2"]), ("resume", ["--num_epoch", "1", "--resume"]))),
            ("SlowFast_bn_splits_2", ["--model", "SlowFast", "--bn_splits", "2"],
             (("first", ["--num_epoch", "2"]),))):
        tmp = f"{root}/{label}"
        argv = model_args + ["--synthetic", "--weight_dir", f"{tmp}/w",
                             "--save_dir", f"{tmp}/r", "--verbose", "1"]
        out_runs = {}
        for name, extra in runs:
            _, text, wall, launches_k = run_cli(train_vision.main, argv + extra)
            files = sorted(os.listdir(f"{tmp}/w")) + sorted(os.listdir(f"{tmp}/r"))
            last = [f for f in files if f.endswith("_last.ckpt")]
            best = [f for f in files if f.endswith("_best.ckpt")]
            reports = [f for f in files if f.endswith("_report.txt")]
            alarms = [f for f in files if f.endswith(("_alarms.json", "_alarms.csv"))]
            f1 = re.search(r"test macro-F1 ([0-9.]+)", text)
            sd = torch.load(f"{tmp}/w/{last[0]}", map_location="cpu") if last else None
            k3 += launches_k["gather_normalize"]
            run = dict(wall_s=wall, test_macro_f1=float(f1.group(1)) if f1 else None,
                       test_line=test_line(text),
                       checkpoints=sorted(last + best), reports=reports,
                       alarm_files=alarms, saved_step=None if sd is None else int(sd["step"]),
                       datasets=re.search(r"datasets: .*", text).group(0),
                       skipped="alarm evaluation skipped" in text,
                       kernel_launches=launches_k)
            run_ok = bool(last and best and reports and f1 and len(alarms) == 2
                          and not run["skipped"] and launches_k["gather_normalize"] > 0
                          and launches_k["spatial_table"] == 0)
            if "--bn_splits" in model_args and sd is not None:
                agg = aggregate_subbn_stats(sd["model"])
                keys = [k for k in sd["model"] if k.endswith(("running_mean", "running_var"))
                        and k.rsplit(".", 1)[0] + ".split_mean" in sd["model"]]
                run["aggregated_keys"] = len(keys)
                run_ok = run_ok and bool(keys) and all(
                    torch.equal(sd["model"][k], agg[k]) for k in keys)
            if name == "resume":
                m = re.search(r"resumed from \S+ at step (\d+)", text)
                run["resumed_at_step"] = int(m.group(1)) if m else None
                run_ok = (run_ok and run["resumed_at_step"] == out_runs["first"]["saved_step"]
                          and run["saved_step"] > run["resumed_at_step"])
            run["ok"] = run_ok
            ok = ok and run_ok
            out_runs[name] = run
        fields[label] = out_runs
    return ok, fields, k3


# ---------------------------------------------------------------------------
# Reload, predict, explain and report: the checkpoints the CLI phases wrote
# ---------------------------------------------------------------------------

# xai: card against CPU on the maps in [0, 1], (max, mean) |d|. Grad-CAM
# and rollout hold 1e-4. The input-gradient maps pass through a hard test
# at every activation (x > 0 for the LeakyReLU's slope, and g > 0 for the
# guided rule), so a value that is zero up to f32 rounding takes one branch
# on the card and the other on the CPU: the guided saliency of R(2+1)D
# parted by 1.6e-3 max, 1.3e-5 mean (2.4% of pixels over 1e-4; SlowFast
# 7.4e-5 max) on one H100, 700 W, and its limits are 6x and 8x that. The
# plain input gradient of R(2+1)D parted by 2.8e-2 max, 6.7e-4 mean, so it
# is held instead against its own sensitivity on the card: its mean
# card-CPU gap within XAI_SENSITIVITY_FACTOR x the mean change that a one-ulp
# nudge of the input makes to the card's own map.
XAI_TOL = {"gradcam": (1e-4, 1e-4), "guided": (1e-2, 1e-4), "rollout": (1e-4, 1e-4)}
XAI_SENSITIVITY_FACTOR = 10.0
MODEL_SUMMARY_CHOICES = ("ViViT", "R2Plus1D", "SlowFast", "Transformer", "CnnLSTM",
                         "MLSTM_FCN", "concat", "TFN")
COMPUTE_TIME_MODELS = ("ViViT", "R2Plus1D", "SlowFast", "Transformer", "CnnLSTM",
                       "MLSTM_FCN", "multimodal")


def have_matplotlib() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def figures_check(text: str, paths) -> dict:
    """The figure rule of the CLIs: each file written where matplotlib
    imports, else one skip line naming it and no file."""
    skipped = [p for p in paths
               if f"figure skipped: matplotlib is not installed ({p})" in text]
    written = [p for p in paths if os.path.exists(p) and os.path.getsize(p) > 0]
    mpl = have_matplotlib()
    ok = (written == list(paths) and not skipped) if mpl else \
        (skipped == list(paths) and not written)
    return dict(matplotlib=mpl, written=len(written), skipped=len(skipped), ok=ok)


def reload_eval_phase(root: str, trained: dict) -> tuple:
    """python -m kstar_torch.cli.evaluate_model on the checkpoints the CLI
    phases wrote, at their batch sizes: ViViT and SlowFast --bn_splits 2
    (--kind vision --alarms), MLSTM-FCN (--kind 0D) and concat (--kind
    multimodal --alarms). Each "test macro-F1 | ROC-AUC" line equals the
    trainer's; the alarm JSON/CSV rows equal the trainer's files; the 0D
    detail CSV has one row per train, valid and test sample; the
    spatial-table kernel launches on the ViViT and multimodal sweeps, the
    window-gather kernel on SlowFast's, neither on the 0D run. Returns (ok,
    fields, spatial-table launches, window-gather launches)."""
    import json as _json
    import re

    import pandas as pd

    from kstar_torch.cli import evaluate_model

    cases = (
        # label, directory, evaluate_model flags, the trainer's run, kernel launched
        ("ViViT", "vivit", ["--kind", "vision", "--model", "ViViT", "--alarms",
                            "--batch_size", "64"],
         trained["train_cli"]["resume"], "spatial_table"),
        ("SlowFast_bn_splits_2", "SlowFast_bn_splits_2",
         ["--kind", "vision", "--model", "SlowFast", "--bn_splits", "2", "--alarms",
          "--batch_size", "64"],
         trained["train_conv_cli"]["SlowFast_bn_splits_2"]["first"], "gather_normalize"),
        ("MLSTM_FCN", "0d", ["--kind", "0D", "--model", "MLSTM_FCN", "--batch_size", "256"],
         trained["train_0d_cli"]["resume"], None),
        ("concat", "concat", ["--kind", "multimodal", "--model_type", "concat", "--alarms",
                              "--batch_size", "32"],
         trained["train_multimodal_cli"]["concat"]["resume"], "spatial_table"),
    )
    ok, fields, k1, k3 = True, {}, 0, 0
    for label, sub, flags, run, kernel in cases:
        d = f"{root}/{sub}"
        _, text, wall, launches_k = run_cli(evaluate_model.main, flags + [
            "--synthetic", "--weight_dir", f"{d}/w", "--save_dir", f"{d}/eval"])
        k1 += launches_k["spatial_table"]
        k3 += launches_k["gather_normalize"]
        entry = dict(wall_s=wall, test_line=test_line(text), trainer_test_line=run["test_line"],
                     kernel_launches=launches_k)
        entry_ok = entry["test_line"] is not None and entry["test_line"] == run["test_line"]
        if kernel is None:
            entry_ok = entry_ok and not any(launches_k.values())
        else:
            other = {"spatial_table": "gather_normalize",
                     "gather_normalize": "spatial_table"}[kernel]
            entry_ok = (entry_ok and launches_k[kernel] > 0 and launches_k[other] == 0
                        and launches_k["fused_attention"] == 0)
        if "--alarms" in flags:
            same = {}
            for suffix in ("_alarms.csv", "_alarms.json"):
                got = [f for f in os.listdir(f"{d}/eval") if f.endswith(suffix)]
                want = [f for f in os.listdir(f"{d}/r") if f.endswith(suffix)]
                if suffix.endswith(".csv"):
                    same[suffix] = bool(got and want) and pd.read_csv(
                        f"{d}/eval/{got[0]}").equals(pd.read_csv(f"{d}/r/{want[0]}"))
                else:
                    same[suffix] = bool(got and want) and _json.load(
                        open(f"{d}/eval/{got[0]}")) == _json.load(open(f"{d}/r/{want[0]}"))
            entry["alarm_files_equal_trainer"] = same
            entry_ok = entry_ok and all(same.values())
        else:
            detail = [f for f in os.listdir(f"{d}/eval") if f.endswith("_detail.csv")]
            sizes = re.search(r"datasets: train (\d+) valid (\d+) test (\d+)", run["datasets"])
            want = {"train": int(sizes.group(1)), "valid": int(sizes.group(2)),
                    "test": int(sizes.group(3))}
            got = (pd.read_csv(f"{d}/eval/{detail[0]}").task.value_counts().to_dict()
                   if detail else {})
            entry["detail_rows"] = got
            entry_ok = entry_ok and got == want
        entry["ok"] = entry_ok
        ok = ok and entry_ok
        fields[label] = entry
    return ok, fields, k1, k3


def continuous_prediction_phase(root: str, dev, extra=(), instance=None) -> tuple:
    """python -m kstar_torch.cli.make_continuous_prediction --synthetic at its
    default widths (the flagship ViViT, a 0D Transformer with random weights)
    with --video_tag of train_cli's checkpoint and the ``extra`` flags (say
    --compute_dtype float32): one spatial-table launch for the whole-shot
    video sweep (on an instance whose name starts with ``instance`` where
    given: the CLI's 64 px crop packs F frames), the printed alarm line, the
    curve equal to predict_video_shot called directly with the same weights,
    frames and dtype (|dp| <= 1e-6), and the figures and GIFs by the figure
    rule. Returns (ok, fields, spatial-table launches)."""
    import re

    import numpy as np

    from kstar_torch.cli import make_continuous_prediction
    from kstar_torch.cli.common import load_data
    from kstar_torch.config import DT_0D, ViViTConfig
    from kstar_torch.infer import predict_video_shot
    from kstar_torch.models import build_video_model
    from kstar_torch.train import load_params

    wdir = f"{root}/vivit/w"
    tag = [f for f in os.listdir(wdir) if f.endswith("_best.ckpt")][0][:-len("_best.ckpt")]
    from kstar_torch.ops.spatial_table import spatial_table

    argv = ["--synthetic", "--video_tag", tag, "--weight_dir", wdir,
            "--save_dir", f"{root}/prediction", *extra]
    res, text, wall, launches_k = run_cli(make_continuous_prediction.main, argv)
    taken = spatial_table.instance
    shot = res["shot"]
    alarm = re.search(rf"shot {shot} \| video alarm at .*", text)

    args = make_continuous_prediction.build_parser().parse_args(argv)
    disrupt_df, _, store = load_data(args, need_video=True, dt=DT_0D)
    frames = np.asarray(store.arrays[shot])
    row = disrupt_df[disrupt_df.shot == shot].iloc[0]
    crop = min(args.image_size, frames.shape[1])
    dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    model = build_video_model("ViViT", ViViTConfig(
        image_size=args.image_size, patch_size=min(args.patch_size, crop // 4),
        n_frames=args.seq_len, dim=args.dim, depth=args.depth, n_heads=args.n_heads,
        d_head=args.d_head, scale_dim=args.scale_dim), dtype=dtype).to(dev)
    load_params(model, f"{wdir}/{tag}_best.ckpt")
    _, direct = predict_video_shot(model, frames, int(row.frame_startup),
                                   int(row.frame_cutoff), seq_len=args.seq_len,
                                   dist=args.dist, crop_size=crop,
                                   batch_size=args.batch_size, compute_dtype=dtype,
                                   device=dev)
    p_vid = res["video"][1]
    err = (float(np.abs(p_vid - direct).max()) if p_vid.shape == direct.shape
           else float("inf"))
    figs = figures_check(text, [f"{root}/prediction/{name}" for name in (
        f"prob_0D_{shot}.png", f"real_time_disruption_prediction_0D_{shot}.gif",
        f"prob_video_{shot}.png", f"real_time_disruption_prediction_{shot}.gif")])
    fields = dict(wall_s=wall, compute_dtype=args.compute_dtype, shot=shot,
                  alarm_line=alarm.group(0) if alarm else None,
                  curve_len=int(len(p_vid)), curve_max=float(np.max(p_vid)),
                  vs_direct_max_abs=err, zero_d_curve=res["0D"] is not None,
                  kernel_launches=launches_k, spatial_table_instance=taken, figures=figs)
    ok = (launches_k["spatial_table"] == 1 and launches_k["gather_normalize"] == 0
          and launches_k["fused_attention"] == 0 and alarm is not None
          and bool(np.isfinite(p_vid).all()) and err <= 1e-6
          and res["0D"] is not None and figs["ok"]
          and (instance is None or (taken or "").startswith(instance)))
    return ok, fields, launches_k["spatial_table"]


def xai_phase(seed: int, frames_dev, dev, conv_cpu: dict) -> tuple:
    """kstar_torch.viz XAI at full width, batch 2, f32 (TF32 off): Grad-CAM
    on R(2+1)D (21 x 128 x 128), guided-backprop saliency on R(2+1)D and on
    SlowFast (20 frames), both on the calibrated conv models, and space and
    temporal attention rollout on the flagship ViViT; each on the card
    against the CPU on the same weights (XAI_TOL on the maps in [0, 1]; the
    plain input gradient of R(2+1)D against its own one-ulp sensitivity),
    ms of a second call, peak memory; the guided switch off after
    its context; collect_attention refusing ViViT(use_pallas=True); no
    K1-K3 launch."""
    import numpy as np

    from kstar_torch.config import PIXEL_MEAN_BGR, ViViTConfig
    from kstar_torch.models import ViViT, build_video_model
    from kstar_torch.models import common as mcommon
    from kstar_torch.viz import (collect_attention, gradcam_r2plus1d,
                                 guided_backprop_saliency, vivit_attention_rollout)

    mean32 = torch.tensor(PIXEL_MEAN_BGR, device=dev)
    vivit = build_video_model("ViViT", ViViTConfig(), dtype=torch.float32,
                              generator=torch.Generator().manual_seed(seed + 70))
    vivit_card = copy.deepcopy(vivit).to(dev)

    def plain_saliency(model, x, device):
        """The same map from the plain input gradient (no guided rule)."""
        x = x.to(device).requires_grad_(True)
        (g,) = torch.autograd.grad(model.to(device).eval()(x)[:, 0].sum(), x)
        sal = g.abs().amax(-1).cpu().numpy()
        return sal / np.maximum(sal.reshape(len(sal), -1).max(1)[:, None, None, None], 1e-8)

    cases = (
        ("gradcam_R2Plus1D", "gradcam", gradcam_r2plus1d, "R2Plus1D", 21),
        ("guided_saliency_R2Plus1D", "guided", guided_backprop_saliency, "R2Plus1D", 21),
        ("plain_gradient_R2Plus1D", "plain", plain_saliency, "R2Plus1D", 21),
        ("guided_saliency_SlowFast", "guided", guided_backprop_saliency, "SlowFast", 20),
        ("rollout_space_ViViT", "rollout", lambda m, x, device: vivit_attention_rollout(
            m, x, "space", device=device), "ViViT", SEQ_LEN),
        ("rollout_temporal_ViViT", "rollout", lambda m, x, device: vivit_attention_rollout(
            m, x, "temporal", device=device), "ViViT", SEQ_LEN),
    )
    ok, fields = True, {}
    kernel_launches(reset=True)
    for label, kind, fn, key, L in cases:
        x = conv_clips(frames_dev, L, 2).float() - mean32
        if key == "ViViT":
            cpu, card = vivit, vivit_card
        else:
            cpu = conv_cpu[key]
            card = conv_twin(cpu, key, torch.float32).to(dev).eval()
        fn(card, x, device=dev)                               # cuDNN/cuBLAS set-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = fn(card, x, device=dev)                         # ends in a host copy
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2**30
        want = fn(cpu, x.cpu(), device="cpu")
        diff = np.abs(got - want)
        entry = dict(shape=list(got.shape), ms=ms, peak_gib=peak,
                     max_abs=float(diff.max()), mean_abs=float(diff.mean()),
                     frac_above_1e4=float((diff > 1e-4).mean()), map_max=float(got.max()))
        if kind in ("guided", "plain"):
            # the card's own map after a one-ulp nudge of every input value
            sign = torch.sign(torch.randn(x.shape, generator=torch.Generator(
                device=dev).manual_seed(seed), device=dev))
            nudged = np.abs(got - fn(card, x * (1 + 2.0 ** -23 * sign), device=dev))
            entry.update(ulp_nudge_max_abs=float(nudged.max()),
                         ulp_nudge_mean_abs=float(nudged.mean()))
        if kind == "plain":
            entry["mean_tol"] = XAI_SENSITIVITY_FACTOR * entry["ulp_nudge_mean_abs"]
            entry["ok"] = bool(np.isfinite(got).all() and entry["mean_abs"] <= entry["mean_tol"])
        else:
            entry["max_tol"], entry["mean_tol"] = XAI_TOL[kind]
            entry["ok"] = bool(np.isfinite(got).all() and entry["max_abs"] <= entry["max_tol"]
                               and entry["mean_abs"] <= entry["mean_tol"])
        ok = ok and entry["ok"]
        fields[label] = entry
        if key != "ViViT":
            del card
    fields["guided_switch_off"] = mcommon.GUIDED_BACKPROP[0] is False
    fused = ViViT(dtype=torch.bfloat16, use_pallas=True,
                  generator=torch.Generator().manual_seed(seed + 71)).to(dev)
    try:
        collect_attention(fused, conv_clips(frames_dev, SEQ_LEN, 1).float(), device=dev)
        refused = False
    except ValueError:
        refused = True
    fields["use_pallas_refused"] = refused
    fields["kernel_launches"] = kernel_launches()
    ok = (ok and fields["guided_switch_off"] and refused
          and not any(fields["kernel_launches"].values()))
    return ok, fields


def compute_time_phase(root: str) -> tuple:
    """python -m kstar_torch.cli.compute_time --out <file> at its defaults
    (seven models, batch 1 and 64, 16 timed forwards each; bf16), one
    compact line per model, then python -m kstar_torch.cli.model_summary for
    each of its eight choices with the total parameters (R(2+1)D 1,587,523
    and SlowFast 2,451,846 as PERF.md counts them); no K1-K3 launch, and
    R(2+1)D's bf16 forwards on the conv epilogue kernel, 32 launches each."""
    import json as _json
    import re

    import numpy as np

    from kstar_torch.cli import compute_time, model_summary

    out_path = f"{root}/compute_time.json"
    _, _, wall, launches_k = run_cli(compute_time.main, ["--out", out_path])
    with open(out_path) as f:
        saved = _json.load(f)
    want_keys = {f"{m}_b{b}" for m in COMPUTE_TIME_MODELS for b in (1, 64)}
    epilogues = launches_k["bn_act"]
    ok = (set(saved) == want_keys and epilogues > 0
          and epilogues % CONV_EPILOGUES["R2Plus1D"] == 0
          and not any(n for k, n in launches_k.items() if k != "bn_act"))
    per_model = {}
    for m in COMPUTE_TIME_MODELS:
        row = {"model": m}
        for b in (1, 64):
            st = saved.get(f"{m}_b{b}", {})
            row[f"b{b}_p50_ms"] = st.get("p50_s", float("nan")) * 1e3
            row[f"b{b}_p99_ms"] = st.get("p99_s", float("nan")) * 1e3
            row[f"b{b}_clips_per_s"] = st.get("clips_per_s", float("nan"))
            ok = ok and bool(np.isfinite(row[f"b{b}_p50_ms"]) and row[f"b{b}_p50_ms"] > 0)
        print(_json.dumps({"phase": "compute_time_model", **row}), flush=True)
        per_model[m] = row
    totals, summary_launches = {}, {}
    for choice in MODEL_SUMMARY_CHOICES:
        _, text, _, launches_s = run_cli(model_summary.main, ["--model", choice])
        m = re.search(r"Total Parameters: ([0-9,]+)", text)
        totals[choice] = int(m.group(1).replace(",", "")) if m else None
        summary_launches[choice] = sum(launches_s.values())
    ok = (ok and all(totals.values()) and totals["R2Plus1D"] == 1_587_523
          and totals["SlowFast"] == 2_451_846 and not any(summary_launches.values()))
    return ok, dict(compute_time_wall_s=wall, kernel_launches=launches_k,
                    model_summary_params=totals,
                    model_summary_launches=summary_launches)


# ---------------------------------------------------------------------------
# The dataset ETL, seed ensembles, hyper-parameter search and mixup
# ---------------------------------------------------------------------------

ETL_SHOTS, ETL_FRAMES, ETL_RAW_ROWS = 5, 640, 1600
ETL_TS_CHANNELS = 4                # Thomson channels per core/edge x Te/Ne group
ENSEMBLE_SEEDS_0D, ENSEMBLE_SEEDS_VISION = (40, 41, 42, 43), (1, 2)
MEMBERS_TIMED = 4                  # members of the timed ensemble steps
ENSEMBLE_STEP_BATCH = {"MLSTM_FCN": TS_BATCH, "ViViT": 64}   # the CLIs' batches
WARMUP_STEPS, TIMED_STEPS = 5, 30
MEMBER_TOL = 1e-6                  # member against solo, f32 parameters


def etl_frames(seed: int, n: int, size: int) -> tuple:
    """One shot's camera frames, (n, size, size, 3) uint8: dark before the
    plasma starts (frame 10% of n), a radial glow through the flat-top, a
    quench flash and dark again from the cutoff (frame 92% of n), over a
    faint fixed noise pattern. Returns (frames, startup, cutoff)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    startup, cutoff = int(0.1 * n), int(0.92 * n)
    b = np.zeros(n, np.float32)
    b[startup:cutoff] = 150 + 20 * np.sin(np.arange(cutoff - startup) / 30.0)
    b[cutoff - 8:cutoff] = 230
    yy, xx = np.mgrid[0:size, 0:size]
    r = np.sqrt((yy - size / 2) ** 2 + (xx - size / 2) ** 2)
    glow = np.clip(1.2 - r / (0.6 * size), 0.05, 1.0).astype(np.float32)
    noise = rng.integers(0, 12, size=(size, size, 3), dtype=np.uint8)
    frames = np.empty((n, size, size, 3), np.uint8)
    for i in range(n):
        frames[i] = (np.clip(b[i] * glow, 0, 240).astype(np.uint8)[..., None]
                     + np.roll(noise, i, axis=1))
    return frames, startup, cutoff


def etl_raw_dump(seed: int, shots: dict) -> "pd.DataFrame":
    """A raw multi-rate MDSplus-style 0D dump, shaped like the fixture of
    tests/test_etl.py and tests/test_torch_etl.py: ETL_RAW_ROWS samples at
    random times over each shot's video span, the signals build_0d_table
    turns into the 18 input features in raw units (A, m^-3, eV, negative
    Rogowski currents), with NaNs, infs and zeros to clean."""
    import numpy as np
    import pandas as pd

    from kstar_torch.config import FPS, Schema

    rng = np.random.default_rng(seed)
    rows = []
    n = ETL_RAW_ROWS
    for shot, n_frames in shots.items():
        t = np.sort(rng.uniform(0, n_frames / FPS, n))
        d = {"shot": shot, "time": t}
        for j, c in enumerate(Schema.DEFAULT_COLS):
            d[c] = 1.0 + 0.2 * j + 0.1 * np.sin(t * (j + 1)) + rng.normal(0, 0.02, n)
        d["\\ipmhd"] = -(0.4 + 0.05 * t) * 1e6
        d["\\aminor"] = 0.5 + 0.01 * np.cos(t)
        d["\\RC03"] = 0.6 + 0.1 * t
        d["\\VCM03"] = 0.7 + 0.1 * t
        d["\\ne_inter01"] = 2 + 0.2 * t
        d["\\BETAP_DLM03"] = 0.5 + 3 * np.sin(t)
        d["\\WTOT_DLM03"] = 1e5 * (1 + 0.1 * t)
        d["\\bcentr"] = -1.8 + rng.normal(0, 0.01, n)
        d["\\TOR_HA01"] = 1e18 * (1 + rng.random(n))
        for g, scale in ((Schema.TS_TE_CORE_COLS, 1e3), (Schema.TS_TE_EDGE_COLS, 3e2),
                         (Schema.TS_NE_CORE_COLS, 3e19), (Schema.TS_NE_EDGE_COLS, 1e19)):
            for k, c in enumerate(g[:ETL_TS_CHANNELS]):
                d[c] = scale * (1 + 0.1 * k + 0.05 * np.sin(t)) * rng.uniform(0.9, 1.1, n)
        df = pd.DataFrame(d)
        df.loc[rng.choice(n, 10, replace=False), "\\q95"] = np.nan
        df.loc[rng.choice(n, 3, replace=False), "\\li"] = np.inf
        df.loc[rng.choice(n, 5, replace=False), Schema.TS_TE_CORE_COLS[0]] = np.nan
        df.loc[rng.choice(n, 4, replace=False), "\\kappa"] = 0.0
        rows.append(df)
    return pd.concat(rows, ignore_index=True)


def etl_phase(seed: int, root: str, dev) -> tuple:
    """The dataset ETL from a raw dump to a --data_root, then the port's
    loaders and whole-shot predictions on what it built: ETL_SHOTS shots of
    ETL_FRAMES 256 px frames (etl_frames) and a raw 0D dump (etl_raw_dump);
    extend_shot_log over the frames' brightness, clean_signals ->
    valid_shots -> build_0d_table -> sync_video_0d; the frames written as
    jpg folders (cv2) and repacked by repack_jpg_folder into
    video/<shot>.npy, the log and table into shot_list.csv and ts_data.csv;
    load_data/VideoStore read it back; predict_video_shot with the flagship
    ViViT (bf16, random weights from ``seed``; one spatial-table launch) and
    predict_0d_shot with MLSTM-FCN at its default widths on one built shot.
    Wall seconds per stage. Checks: the detected startup and cutoff equal
    the generator's, every shot kept, the repacked arrays equal what was
    loaded, finite curves of the expected length, K1 exactly 1."""
    import argparse

    import cv2
    import numpy as np

    from kstar_torch.cli.common import load_data
    from kstar_torch.config import DT_0D, FPS, MLSTMFCNConfig, Schema, ViViTConfig
    from kstar_torch.data import Scaler, build_0d_table, extend_shot_log, sync_video_0d
    from kstar_torch.data.ts_pipeline import clean_signals, valid_shots
    from kstar_torch.data.video_pipeline import repack_jpg_folder
    from kstar_torch.infer import predict_0d_shot, predict_video_shot
    from kstar_torch.models import build_0d_model, build_video_model

    stage_s, t_stage = {}, [time.perf_counter()]

    def stage(name: str) -> None:
        now = time.perf_counter()
        stage_s[name], t_stage[0] = now - t_stage[0], now

    shot_ids = [40000 + i for i in range(ETL_SHOTS)]
    made = {s: etl_frames(seed + i, ETL_FRAMES + 32 * i, RESIZE)
            for i, s in enumerate(shot_ids)}
    raw = etl_raw_dump(seed, {s: len(f) for s, (f, _, _) in made.items()})
    stage("generate")
    log = extend_shot_log({s: f for s, (f, _, _) in made.items()})
    stage("extend_shot_log")
    cleaned = clean_signals(raw)
    kept = valid_shots(cleaned)
    stage("clean_and_valid_shots")
    table = build_0d_table(raw, log, dt=DT_0D)
    stage("build_0d_table")
    sync = sync_video_0d(table, log)
    stage("sync_video_0d")

    os.makedirs(f"{root}/video", exist_ok=True)
    for s, (frames, _, _) in made.items():
        os.makedirs(f"{root}/jpg/{s}", exist_ok=True)
        for i, f in enumerate(frames):
            cv2.imwrite(f"{root}/jpg/{s}/{i:06d}.jpg", f)
    stage("write_jpg")
    repacked = {}
    for s in shot_ids:
        repacked[s] = repack_jpg_folder(f"{root}/jpg/{s}")
        np.save(f"{root}/video/{s}.npy", repacked[s])
    log.to_csv(f"{root}/shot_list.csv", index=False)
    table.to_csv(f"{root}/ts_data.csv", index=False)
    stage("repack_and_save")

    ns = argparse.Namespace(synthetic=False, data_root=root)
    disrupt_df, ts_df, store = load_data(ns, need_video=True, dt=DT_0D)
    stage("load_data")

    shot = shot_ids[0]
    row = disrupt_df[disrupt_df.shot == shot].iloc[0]
    vivit = build_video_model("ViViT", ViViTConfig(), dtype=torch.bfloat16,
                              generator=torch.Generator().manual_seed(seed + 50)).to(dev)
    kernel_launches(reset=True)
    time_v, prob_v = predict_video_shot(
        vivit, np.asarray(store.arrays[shot]), int(row.frame_startup), int(row.frame_cutoff),
        seq_len=SEQ_LEN, dist=3, crop_size=CROP, batch_size=BATCH,
        compute_dtype=torch.bfloat16, device=dev)
    k1 = kernel_launches()["spatial_table"]
    stage("predict_video_shot")
    kernel_launches(reset=True)
    cols = Schema.INPUT_FEATURES
    mlstm = build_0d_model("MLSTM_FCN", MLSTMFCNConfig(), dtype=torch.bfloat16,
                           generator=torch.Generator().manual_seed(seed + 51)).to(dev)
    d = ts_df[ts_df.shot == shot]
    time_0, prob_0 = predict_0d_shot(mlstm, d[cols].to_numpy(np.float32), d["time"].to_numpy(),
                                     Scaler("Robust"), seq_len=SEQ_LEN, dist=3, dt=DT_0D,
                                     batch_size=TS_BATCH, device=dev)
    k_0d = kernel_launches()
    stage("predict_0d_shot")

    truth = {s: (st, cut) for s, (_, st, cut) in made.items()}
    detected = {int(r.shot): (int(r.frame_startup), int(r.frame_cutoff))
                for r in log.itertuples()}
    loaded_equal = all(np.array_equal(np.asarray(store.arrays[s]), repacked[s])
                       for s in shot_ids)
    n_v = int(row.frame_startup) + SEQ_LEN + max(
        min(len(store.arrays[shot]), int(row.frame_cutoff) + int(FPS))
        - int(row.frame_startup) - SEQ_LEN - 3, 0) - 2
    fields = dict(
        shots=len(shot_ids), frames=[len(f) for f, _, _ in made.values()],
        frame_px=RESIZE, raw_rows=len(raw), raw_columns=raw.shape[1],
        shots_kept_valid=[int(s) for s in kept], table_rows=len(table),
        table_shots=sorted(int(s) for s in table.shot.unique()),
        table_columns=table.shape[1], sync_rows=len(sync),
        jpg_bytes=sum(os.path.getsize(os.path.join(dp, f))
                      for dp, _, fs in os.walk(f"{root}/jpg") for f in fs),
        detected_startup_cutoff=detected, generated_startup_cutoff=truth,
        repacked_equal_loaded=loaded_equal,
        repack_vs_frames_mean_abs=float(np.mean([np.abs(repacked[s].astype(np.int16)
                                                         - made[s][0]).mean()
                                                 for s in shot_ids])),
        video_curve_len=len(prob_v), video_curve_max=float(np.max(prob_v)),
        zero_d_curve_len=len(prob_0), zero_d_curve_max=float(np.max(prob_0)),
        spatial_table_launches=k1, kernel_launches_0d=k_0d, stage_s=stage_s)
    ok = bool(detected == truth and sorted(kept) == shot_ids
              and fields["table_shots"] == shot_ids and len(sync) == len(table)
              and set(cols) <= set(table.columns) and loaded_equal
              and sorted(store.arrays) == shot_ids
              and len(prob_v) == n_v and np.isfinite(prob_v).all()
              and len(prob_0) > 0 and np.isfinite(prob_0).all()
              and k1 == 1 and not any(k_0d.values()))
    return ok, fields, k1


def _seeded_checkpoints(w: str, seeds) -> dict:
    """{seed: [the member's best/last checkpoint names]} under ``w``."""
    names = os.listdir(w)
    return {s: sorted(f for f in names if f.endswith(".ckpt")
                      and (f"_seed_{s}_best" in f or f"_seed_{s}_last" in f))
            for s in seeds}


def ensemble_phase(seed: int, root: str, frames, dev) -> tuple:
    """Seed ensembles through the train CLIs and on the card.

    (a) python -m kstar_torch.cli.train_0d --model MLSTM_FCN --seeds 40 41 42
    43 --synthetic --num_epoch 2 and train_vision --model ViViT --seeds 1 2
    --synthetic --num_epoch 2 at their default widths: per-seed checkpoints,
    each seed's best valid F1, the "continuing with best seed" line (the
    argmax), the test line, and the ViViT alarm sweep's spatial-table
    launches (> 0; none for the 0D run).
    (b) member against solo on the card: a 4-member MLSTM-FCN ensemble in
    f32 (input noise and dropout on) and a solo state of each seed, 3 SGD
    steps on shared batches of 256; max |parameter difference| <= 1e-6.
    (c) step times: the 4-member ensemble step against one solo step, 5
    warm-ups then 30 each timed on the host clock up to a synchronise,
    MLSTM-FCN bf16 at batch 256 and the flagship ViViT bf16 at batch 64
    (uint8 clips of the shot, augmented inside each member's step); the
    launches and device-busy time of one profiled step of each."""
    import re

    import numpy as np

    from kstar_torch.cli import train_0d, train_vision
    from kstar_torch.config import LossConfig, MLSTMFCNConfig, OptimConfig, ViViTConfig
    from kstar_torch.data import make_pre_fns, to_device
    from kstar_torch.losses import ldam_margins
    from kstar_torch.models import build_0d_model, build_video_model
    from kstar_torch.train import (create_ensemble_state, create_train_state,
                                   make_ensemble_step, make_train_step)

    fields, ok = {}, True
    k1_total = 0
    for name, main_fn, model, seeds in (
            ("train_0d", train_0d.main, "MLSTM_FCN", ENSEMBLE_SEEDS_0D),
            ("train_vision", train_vision.main, "ViViT", ENSEMBLE_SEEDS_VISION)):
        w, r = f"{root}/{name}/w", f"{root}/{name}/r"
        argv = ["--model", model, "--seeds", *map(str, seeds), "--synthetic",
                "--num_epoch", "2", "--weight_dir", w, "--save_dir", r, "--verbose", "1"]
        _, text, wall, launches_k = run_cli(main_fn, argv)
        f1s = {int(s): float(f) for s, f in
               re.findall(r"seed (\d+): best valid f1 ([0-9.]+)", text)}
        cont = re.search(r"continuing with best seed (\d+)", text)
        ckpts = _seeded_checkpoints(w, seeds)
        best_seed = seeds[int(np.argmax([f1s.get(s, -1.0) for s in seeds]))]
        run = dict(wall_s=wall, seeds=list(seeds), best_valid_f1=f1s,
                   continuing_with=int(cont.group(1)) if cont else None,
                   argmax_seed=best_seed, checkpoints=ckpts, test_line=test_line(text),
                   kernel_launches=launches_k)
        run_ok = bool(list(f1s) == list(seeds) and cont and int(cont.group(1)) == best_seed
                      and all(len(v) == 2 for v in ckpts.values()) and run["test_line"])
        if model == "ViViT":
            run_ok = run_ok and launches_k["spatial_table"] > 0 and "alarm summary" in text
            k1_total += launches_k["spatial_table"]
        else:
            run_ok = run_ok and not any(launches_k.values())
        run["ok"] = run_ok
        ok = ok and run_ok
        fields[name] = run

    # (b) members against solo runs, f32
    rng = np.random.default_rng(seed + 60)
    B = TS_BATCH
    cfg0 = MLSTMFCNConfig()
    xs = [torch.from_numpy(rng.normal(size=(B, SEQ_LEN, cfg0.n_features)).astype(np.float32))
          .to(dev) for _ in range(3)]
    ys = [torch.as_tensor(rng.integers(0, 2, size=B)).to(dev) for _ in range(3)]
    weight = torch.ones(2, device=dev)
    m_list = torch.as_tensor(ldam_margins(np.array([B // 2, B // 2]))).to(dev)
    make0 = lambda dtype: (lambda gen: build_0d_model("MLSTM_FCN", cfg0, dtype=dtype,
                                                      generator=gen))
    sgd = OptimConfig(optimizer="SGD", lr=1e-2)
    seeds = ENSEMBLE_SEEDS_0D
    members = create_ensemble_state(make0(torch.float32), seeds, sgd, device=dev)
    estep = make_ensemble_step(LossConfig())
    for x, y in zip(xs, ys):
        estep(members, x, y, weight, m_list)
    step = make_train_step(LossConfig())
    diffs = {}
    for s, member in zip(seeds, members):
        solo = create_train_state(make0(torch.float32)(torch.Generator().manual_seed(s)).to(dev),
                                  sgd, seed=s)
        for x, y in zip(xs, ys):
            step(solo, x, y, weight, m_list)
        diffs[s] = max(float((member.flat - solo.flat).abs().max()),
                       float((member.stats_flat - solo.stats_flat).abs().max()))
    moved = all(int(m.step) == 3 for m in members)
    fields["member_vs_solo"] = dict(model="MLSTM_FCN", dtype="float32", batch=B,
                                    optimizer="SGD lr 1e-2", steps=3, max_abs=diffs,
                                    tol=MEMBER_TOL)
    ok = ok and moved and max(diffs.values()) <= MEMBER_TOL

    # (c) the ensemble step against a solo step
    def timed(fn) -> list:
        times = []
        for i in range(WARMUP_STEPS + TIMED_STEPS):
            t0 = time.perf_counter()
            fn(i)
            torch.cuda.synchronize()
            if i >= WARMUP_STEPS:
                times.append((time.perf_counter() - t0) * 1e3)
        return times

    timing = {}
    xb = [x[:ENSEMBLE_STEP_BATCH["MLSTM_FCN"]] for x in xs[:2]]
    vis_cfg = ViViTConfig()
    Bv = ENSEMBLE_STEP_BATCH["ViViT"]
    starts = rng.integers(0, len(frames) - SEQ_LEN, size=(2, Bv))
    clips = [to_device(frames[s[:, None] + np.arange(SEQ_LEN)], dev) for s in starts]
    yv = [torch.as_tensor(rng.integers(0, 2, size=Bv)).to(dev) for _ in range(2)]
    pre_train, _ = make_pre_fns(CROP, out_dtype=torch.bfloat16)
    for key, make, batches, labels, pre, batch in (
            ("MLSTM_FCN", make0(torch.bfloat16), xb,
             [y[:ENSEMBLE_STEP_BATCH["MLSTM_FCN"]] for y in ys[:2]], None,
             ENSEMBLE_STEP_BATCH["MLSTM_FCN"]),
            ("ViViT", lambda gen: build_video_model("ViViT", vis_cfg, dtype=torch.bfloat16,
                                                    generator=gen), clips, yv, pre_train, Bv)):
        seeds4 = tuple(range(seed, seed + MEMBERS_TIMED))
        states = create_ensemble_state(make, seeds4, OptimConfig(), device=dev)
        estep = make_ensemble_step(LossConfig(), pre_fn=pre)
        solo = states[0]
        sstep = make_train_step(LossConfig(), pre_fn=pre)
        torch.cuda.reset_peak_memory_stats()
        t_ens = timed(lambda i: estep(states, batches[i % 2], labels[i % 2], weight, m_list))
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        t_solo = timed(lambda i: sstep(solo, batches[i % 2], labels[i % 2], weight, m_list))
        p50_e, p50_s = float(np.median(t_ens)), float(np.median(t_solo))
        prof = {}
        for part, fn in (("ensemble", lambda: estep(states, batches[0], labels[0], weight,
                                                    m_list)),
                         ("solo", lambda: sstep(solo, batches[0], labels[0], weight, m_list))):
            n_launch, busy_ms, _, _ = step_launches(fn)
            prof[f"{part}_launches"] = n_launch
            prof[f"{part}_device_busy_ms"] = busy_ms
        timing[key] = dict(batch=batch, members=MEMBERS_TIMED, dtype="bfloat16",
                           ensemble_step_p50_ms=p50_e, solo_step_p50_ms=p50_s,
                           ensemble_over_solo=p50_e / p50_s,
                           ensemble_step_p99_ms=float(np.percentile(t_ens, 99)),
                           solo_step_p99_ms=float(np.percentile(t_solo, 99)),
                           ensemble_samples_per_s=MEMBERS_TIMED * batch / (p50_e / 1e3),
                           ensemble_peak_mem_gb=peak_gb, **prof,
                           ensemble_device_idle_share=(
                               None if prof["ensemble_device_busy_ms"] is None
                               else 1 - prof["ensemble_device_busy_ms"] / p50_e),
                           solo_device_idle_share=(
                               None if prof["solo_device_busy_ms"] is None
                               else 1 - prof["solo_device_busy_ms"] / p50_s))
        ok = ok and bool(np.isfinite(t_ens).all() and np.isfinite(t_solo).all())
        del states, solo
    fields["step_times"] = timing
    return ok, fields, k1_total


HPO_SCORE_TOL = 1e-6    # valid macro-F1 per trial and epoch, against the serial run


def hpo_phase(root: str) -> tuple:
    """python -m kstar_torch.cli.hpo_run --model MLSTM_FCN --synthetic
    --synthetic_difficulty 1 --synthetic_shots 20 --n_trials 4 --max_epochs
    4, five times: --search random twice (the card's own run-to-run
    spread), --search tpe (2 random startup trials, then TPE proposals 2 at
    a time), --hpo_vmap (JAX's grouped rungs; the serial trainable in the
    port) and --hpo_workers 2 (two trials at a time on threads, round robin
    over the cards there are). On the hard fixture the trials score apart,
    so the rungs promote some and stop others. Each: the best trial, the
    test line, hpo_MLSTM_FCN.json written, wall seconds. The repeated,
    --hpo_vmap and threaded runs must give the serial random run's trial
    configs and rung promotions (epochs per trial), and its scores to
    HPO_SCORE_TOL; no K1-K3 launch."""
    import json as _json

    base = ["--model", "MLSTM_FCN", "--synthetic", "--synthetic_difficulty", "1",
            "--synthetic_shots", "20", "--n_trials", "4", "--max_epochs", "4"]
    from kstar_torch.cli import hpo_run

    fields, ok, logs = {"score_tol": HPO_SCORE_TOL}, True, {}
    for name, extra in (("random", ["--search", "random"]),
                        ("random_again", ["--search", "random"]),
                        ("tpe", ["--search", "tpe", "--tpe_startup", "2", "--tpe_batch", "2"]),
                        ("hpo_vmap", ["--hpo_vmap"]),
                        ("workers2", ["--hpo_workers", "2"])):
        out = f"{root}/hpo/{name}"
        (best, results), text, wall, launches_k = run_cli(hpo_run.main,
                                                          base + extra + ["--save_dir", out])
        path = f"{out}/hpo_MLSTM_FCN.json"
        logs[name] = _json.load(open(path)) if os.path.exists(path) else []
        fields[name] = dict(
            wall_s=wall, best_trial=best.trial_id, best_valid_f1=best.best,
            best_config=best.config, test_line=test_line(text), json_written=bool(logs[name]),
            trials=[{"trial": t["trial"], "epochs": t["epochs"], "scores": t["scores"]}
                    for t in logs[name]], kernel_launches=launches_k)
        ok = ok and bool(logs[name] and len(logs[name]) == 4 and test_line(text)
                         and not any(launches_k.values()))
    serial = logs["random"]
    # the hard fixture must separate the trials, or the comparisons below hold
    # for any trainable
    ok = ok and len({t["epochs"] for t in serial}) > 1 and \
        len({round(max(t["scores"]), 6) for t in serial}) > 1
    for other in ("random_again", "hpo_vmap", "workers2"):
        same = ([(t["config"], t["epochs"]) for t in serial]
                == [(t["config"], t["epochs"]) for t in logs[other]])
        score_diff = max((abs(a - b) for s, g in zip(serial, logs[other])
                          for a, b in zip(s["scores"], g["scores"])), default=float("nan"))
        fields[f"{other}_vs_serial"] = dict(same_configs_and_promotions=same,
                                            max_abs_score_diff=score_diff)
        ok = ok and same and score_diff <= HPO_SCORE_TOL
    return ok, fields


def mixup_phase(seed: int, dev) -> tuple:
    """Mixup and the three video CutMix modes on a (16, 21, 128, 128, 3) f32
    batch: the same draws (from one CPU generator) applied on the card and
    on the CPU must give exactly the same mixed batch, labels and weight;
    one draw from a generator on the card runs too."""
    from kstar_torch.train import mixup as mx

    g = torch.Generator().manual_seed(seed + 70)
    x = torch.randn(16, SEQ_LEN, CROP, CROP, 3, generator=g)
    y = torch.randint(0, 2, (16,), generator=g)
    x_dev, y_dev = x.to(dev), y.to(dev)
    results, ok = {}, True
    cases = [("mixup", None, mx.mixup_draw(g, 16))]
    cases += [(f"cutmix_{m}", m, mx.video_cutmix_draw(g, x.shape, m)) for m in mx.CUTMIX_MODES]
    for name, mode, draws in cases:
        if mode is None:
            cpu, card = mx.mixup_apply(x, y, *draws), mx.mixup_apply(x_dev, y_dev, *draws)
        else:
            cpu = mx.video_cutmix_apply(x, y, mode, *draws)
            card = mx.video_cutmix_apply(x_dev, y_dev, mode, *draws)
        equal = all(torch.equal(a, b.cpu()) for a, b in zip(cpu, card))
        results[name] = dict(equal=equal, lam=float(draws[0]), lam_adj=float(cpu[3]),
                             replaced_share=float((cpu[0] != x).float().mean()))
        ok = ok and equal
    gen_dev = torch.Generator(device=dev).manual_seed(seed)
    on_card = mx.video_cutmix(gen_dev, x_dev, y_dev, mode="both")
    ok = ok and bool(torch.isfinite(on_card[0]).all()) and on_card[0].device.type == "cuda"
    return ok, dict(batch=list(x.shape), dtype="float32", cases=results)


# ---------------------------------------------------------------------------
# Parallel: --dp over torch.distributed (NCCL at world 1; two gloo ranks
# sharing the card)
# ---------------------------------------------------------------------------

PAR_WARMUP, PAR_TIMED = 5, 30      # steps, as the train phase times them
PAR_PARITY_TOL = 1e-6              # DP against plain at world 1: losses, parameters
PAIR_SGD = dict(optimizer="SGD", lr=0.05, use_scheduler=False, max_norm_grad=1.0)
PAIR_TOL = 1e-4                    # pair against world 1, f32: losses (relative), parameters


def pair_batches(seed: int):
    import numpy as np

    rng = np.random.default_rng(seed + 20)
    x = rng.normal(size=(3, TS_BATCH, SEQ_LEN, 18)).astype(np.float32)
    y = rng.integers(0, 2, size=(3, TS_BATCH)).astype(np.int64)
    return x, y


def pair_mlstm(seed: int, dev, mesh=None):
    """The MLSTM-FCN at its default widths (f32) and 3 SGD steps on the
    pair's batches, data-parallel on ``mesh``: (losses, final flat)."""
    from kstar_torch.config import LossConfig, MLSTMFCNConfig, OptimConfig
    from kstar_torch.models import build_0d_model
    from kstar_torch.parallel import put_batch
    from kstar_torch.train import create_train_state, make_train_step

    model = build_0d_model("MLSTM_FCN", MLSTMFCNConfig(),
                           generator=torch.Generator().manual_seed(seed)).to(dev)
    st = create_train_state(model, OptimConfig(**PAIR_SGD), seed=seed)
    step = make_train_step(LossConfig(), mesh=mesh)
    put = (lambda a: torch.as_tensor(a).to(dev)) if mesh is None else \
        (lambda a: put_batch(mesh, a))
    w, m = torch.ones(2, device=dev), torch.tensor([0.3, 0.5], device=dev)
    x, y = pair_batches(seed)
    losses = [float(step(st, put(x[i]), put(y[i]), w, m)[1]) for i in range(len(x))]
    return losses, st.flat.detach().cpu()


def pair_rank(rank: int, root: str, seed: int) -> None:
    """One of two ranks of a gloo group on cuda:0 (NCCL refuses two ranks on
    one device): the MLSTM-FCN data-parallel steps and the ViViT library
    sweep (each rank sweeps its half through the spatial-table kernel)."""
    import numpy as np
    import torch.distributed as dist

    from kstar_torch.config import MeshConfig, ViViTConfig
    from kstar_torch.infer import VideoSweeper
    from kstar_torch.models import build_video_model
    from kstar_torch.ops import _build
    from kstar_torch.parallel import init_multihost, make_mesh

    _build.build()                         # the parent's build, loaded
    torch.backends.cuda.matmul.allow_tf32 = False   # the parent's arithmetic (main)
    torch.backends.cudnn.allow_tf32 = False
    init_multihost(f"file://{root}/pair_store", 2, rank, device="cuda", backend="gloo")
    mesh = make_mesh(MeshConfig(data=2, model=1), devices=["cuda:0", "cuda:0"])
    losses, flat = pair_mlstm(seed, mesh.device, mesh)
    lib = np.load(f"{root}/lib.npz")
    shots = [lib[f"arr_{i}"] for i in range(len(lib.files))]
    starts = [np.arange(len(s) - SEQ_LEN - 1, dtype=np.int64) for s in shots]
    model = build_video_model("ViViT", ViViTConfig(), dtype=torch.bfloat16,
                              generator=torch.Generator().manual_seed(seed)).to(mesh.device)
    kernel_launches(reset=True)
    curves = VideoSweeper(model, SEQ_LEN, CROP, BATCH, torch.bfloat16,
                          mesh=mesh).sweep_shots(shots, starts)
    torch.save({"losses": losses, "flat": flat, "curves": curves,
                "k1": kernel_launches()["spatial_table"], "backend": dist.get_backend()},
               f"{root}/pair_{rank}.pt")
    dist.destroy_process_group()


def parallel_phase(seed: int, root: str, frames, cfg, model, lib, lib_starts, lib_probs,
                   budget: int, dev) -> tuple:
    """The port's data parallelism on the card, in a NCCL group of one rank
    (this process) and a gloo group of two ranks sharing the card:

      (a) train_vision --dp 1 at the flagship widths with train_cli's
          synthetic arguments (its alarm sweep launches the table kernel);
          3 data-parallel steps against 3 plain steps from the same weights
          on the same batches (batch 64, augmentation and dropout on: the
          all-reduces are identities at world 1);
      (b) one NCCL all-reduce of the ViViT's flat gradient, and the
          data-parallel step's p50 against the plain step's at batch 64
          (5 warm-up and 30 timed steps each, host clock to a synchronise);
      (c) VideoSweeper(mesh=) over the library's six shots against the
          unsharded sweep (the same groups: equal);
      (d) a sharded checkpoint of the data-parallel state and its round
          trip into a state of another seed (bit-exact);
      (e) two gloo ranks on cuda:0: MLSTM-FCN (default widths, f32, SGD)
          3 data-parallel steps at global batch 256 against one rank, and
          the ViViT library sweep split over the two (the table kernel on
          both) against (c)'s curves.

    Returns (ok, fields, K1 launches of (a) and (c))."""
    import numpy as np
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from kstar_torch.cli import train_vision
    from kstar_torch.config import LossConfig, MeshConfig, OptimConfig
    from kstar_torch.data import make_pre_fns, to_device
    from kstar_torch.infer import VideoSweeper
    from kstar_torch.models import build_video_model
    from kstar_torch.parallel import init_multihost, make_mesh, put_batch, replicate_state
    from kstar_torch.train import create_train_state, make_train_step
    from kstar_torch.train.state import load_checkpoint_sharded, save_checkpoint_sharded

    os.makedirs(root, exist_ok=True)
    init_multihost(f"file://{root}/store", 1, 0, device="cuda")
    mesh = make_mesh(MeshConfig(data=1, model=1))
    fields = {"backend": dist.get_backend(), "world": dist.get_world_size()}
    ok = fields["backend"] == "nccl"

    # (a) the CLI
    argv = ["--model", "ViViT", "--synthetic", "--weight_dir", f"{root}/w",
            "--save_dir", f"{root}/r", "--verbose", "1", "--num_epoch", "2", "--dp", "1"]
    _, text, wall, launches_k = run_cli(train_vision.main, argv)
    ckpts = sorted(f for f in os.listdir(f"{root}/w") if f.endswith(".ckpt"))
    k1 = launches_k["spatial_table"]
    fields["train_vision_dp1"] = dict(wall_s=wall, spatial_table_launches=k1,
                                      test_line=test_line(text), checkpoints=ckpts)
    ok = ok and k1 > 0 and len(ckpts) == 2 and test_line(text) is not None

    # (a, b) data-parallel steps against plain steps
    B = 64
    rng = np.random.default_rng(seed + 10)
    starts = rng.integers(0, len(frames) - SEQ_LEN, size=(2, B))
    clips = [frames[s[:, None] + np.arange(SEQ_LEN)] for s in starts]
    labels = [rng.integers(0, 2, size=B) for _ in range(2)]
    pre_train, _ = make_pre_fns(CROP, out_dtype=torch.bfloat16)
    weight, m_list = torch.ones(2, device=dev), torch.tensor([0.3, 0.5], device=dev)
    runs = {}
    for name, m in (("plain", None), ("dp", mesh)):
        st = create_train_state(
            build_video_model("ViViT", cfg, dtype=torch.bfloat16,
                              generator=torch.Generator().manual_seed(seed)).to(dev),
            OptimConfig(), steps_per_epoch=1, seed=seed)
        if m is not None:
            st = replicate_state(st, m)
        step = make_train_step(LossConfig(), pre_fn=pre_train, mesh=m)
        put = (lambda a: to_device(a, dev)) if m is None else (lambda a: put_batch(m, a))
        xs, ys = [put(c) for c in clips], [put(lb) for lb in labels]
        losses, times, flat3 = [], [], None
        for i in range(3 + PAR_WARMUP + PAR_TIMED):
            t0 = time.perf_counter()
            _, loss, _ = step(st, xs[i % 2], ys[i % 2], weight, m_list)
            torch.cuda.synchronize()
            if i < 3:
                losses.append(float(loss))
            if i == 2:
                flat3 = st.flat.clone()
            if i >= 3 + PAR_WARMUP:
                times.append((time.perf_counter() - t0) * 1e3)
        runs[name] = (np.array(losses), flat3, np.array(times), st)
    loss_err = float(np.max(np.abs(runs["dp"][0] - runs["plain"][0])))
    param_err = float((runs["dp"][1] - runs["plain"][1]).abs().max())
    n_params = runs["dp"][3].flat.numel()
    buf = torch.ones(n_params, device=dev)
    ar_ms = time_ms(lambda: dist.all_reduce(buf, group=mesh.data_group), 20)
    fields["steps"] = dict(
        batch=B, losses_dp=runs["dp"][0].tolist(), losses_plain=runs["plain"][0].tolist(),
        loss_max_abs=loss_err, param_max_abs=param_err, tol=PAR_PARITY_TOL,
        dp_step_p50_ms=float(np.median(runs["dp"][2])),
        plain_step_p50_ms=float(np.median(runs["plain"][2])),
        steps_timed=PAR_TIMED)
    fields["all_reduce"] = dict(elements=n_params, bytes=4 * n_params, ms=ar_ms, world=1)
    ok = ok and loss_err <= PAR_PARITY_TOL and param_err <= PAR_PARITY_TOL

    # (c) the sharded library sweep at world 1
    kernel_launches(reset=True)
    got = VideoSweeper(model, SEQ_LEN, CROP, BATCH, torch.bfloat16, mesh=mesh).sweep_shots(
        lib, lib_starts, hbm_budget_bytes=budget)
    k1_sweep = kernel_launches()["spatial_table"]
    sweep_err = max(float(np.abs(a - b).max()) for a, b in zip(got, lib_probs))
    fields["sharded_sweep"] = dict(shots=len(lib), spatial_table_launches=k1_sweep,
                                   max_abs_vs_unsharded=sweep_err)
    k1 += k1_sweep
    ok = ok and k1_sweep == len(lib) and sweep_err == 0.0

    # (d) the sharded checkpoint round trip
    st = runs["dp"][3]
    save_checkpoint_sharded(st, f"{root}/ckpt", mesh)
    tmpl = create_train_state(
        build_video_model("ViViT", cfg, dtype=torch.bfloat16,
                          generator=torch.Generator().manual_seed(seed + 1)).to(dev),
        OptimConfig(), steps_per_epoch=1, seed=seed + 1)
    load_checkpoint_sharded(tmpl, f"{root}/ckpt", mesh)
    ckpt_ok = (torch.equal(tmpl.flat, st.flat) and torch.equal(tmpl.step, st.step)
               and all(torch.equal(tmpl.opt_state[k], v) for k, v in st.opt_state.items())
               and (tmpl.seed, tmpl.draws) == (st.seed, st.draws))
    fields["checkpoint_bit_exact"] = ckpt_ok
    ok = ok and ckpt_ok

    # (e) two gloo ranks on the card, against one rank
    np.savez(f"{root}/lib.npz", *[f[:, (f.shape[1] - CROP) // 2:(f.shape[1] + CROP) // 2,
                                      (f.shape[2] - CROP) // 2:(f.shape[2] + CROP) // 2]
                                   for f in lib])
    t0 = time.perf_counter()
    mp.spawn(pair_rank, args=(root, seed), nprocs=2, join=True)
    pair_s = time.perf_counter() - t0
    pair = [torch.load(f"{root}/pair_{r}.pt", weights_only=False) for r in range(2)]
    one_losses, one_flat = pair_mlstm(seed, dev)
    p_loss = max(float(np.max(np.abs(np.array(p["losses"]) - one_losses) / np.abs(one_losses)))
                 for p in pair)
    p_param = max(float((p["flat"] - one_flat).abs().max()) for p in pair)
    errs = [np.abs(a - b) for p in pair for a, b in zip(p["curves"], lib_probs)]
    c_max, c_mean = max(float(e.max()) for e in errs), max(float(e.mean()) for e in errs)
    fields["gloo_pair"] = dict(
        backend=pair[0]["backend"], device="cuda:0 shared by 2 ranks", wall_s=pair_s,
        mlstm_fcn=dict(batch=TS_BATCH, loss_max_rel=p_loss, param_max_abs=p_param,
                       tol=PAIR_TOL),
        vivit_sweep=dict(spatial_table_launches=[p["k1"] for p in pair],
                         max_abs_vs_world1=c_max, mean_abs_vs_world1=c_mean))
    ok = ok and (p_loss <= PAIR_TOL and p_param <= PAIR_TOL and all(p["k1"] > 0 for p in pair)
                 and c_max <= 5e-2 and c_mean <= 5e-3)
    dist.destroy_process_group()
    return bool(ok), fields, k1


# ---------------------------------------------------------------------------
# What kstar_tpu trained, served and resumed by the port: JAX-format
# checkpoints; and the scale soaks (a 60 s shot, a library of full shots)
# ---------------------------------------------------------------------------

JAX_CKPT_STEPS, JAX_CKPT_BATCH = 3, 8       # AdamW steps before the file is written
SOAK_FRAMES = 12600                         # 60 s at 210 fps: the JAX soak's shot
SOAK_SHOTS = 8                              # of the 50-shot library: cut for time only


def jax_checkpoint_phase(seed: int, root: str, dev) -> tuple:
    """Checkpoints in kstar_tpu's format (``save_checkpoint``'s tree, written
    by the port's encoder: ``flax_checkpoint_tree`` + ``write_flax_checkpoint``,
    no JAX on the machine) of four models at full width, each after 3 AdamW
    steps at the CLIs' optimizer (real Adam moments, batch 8, bf16 over f32
    parameters): the flagship ViViT, MLSTM-FCN at train_0d's defaults,
    R(2+1)D at evaluate_model's conv config and concat at train_multimodal's
    defaults. For each, under the tag its CLI derives: the file's size and
    read seconds; ``load_params`` into a model of another seed gives the
    original's eval logits exactly; ``load_checkpoint`` into a fresh state,
    then one step, gives the original state's next loss (the ``train``
    phase's 1e-3 relative; the same draws, so 0.0 is expected). Then
    evaluate_model --alarms on the ViViT (the table kernel) and R(2+1)D (the
    window-gather kernel) directories, and train_0d --resume for one epoch
    from the MLSTM-FCN one. Returns (ok, fields, K1 launches, K3 launches)."""
    import re

    from kstar_torch.cli import evaluate_model, train_0d
    from kstar_torch.cli.common import configs_from_args, make_tag
    from kstar_torch.config import LossConfig, OptimConfig, R2Plus1DConfig, ViViTConfig
    from kstar_torch.models import build_0d_model, build_video_model
    from kstar_torch.train import (create_train_state, load_checkpoint, load_params,
                                   make_train_step)
    from kstar_torch.train.flax_ckpt import read_flax_checkpoint, write_flax_checkpoint
    from kstar_torch.train.state import flax_checkpoint_tree

    def tag_of(parser, argv, name):
        args = parser.parse_args(argv)
        train_cfg, loss_cfg, _ = configs_from_args(args)
        return make_tag(name, args, loss_cfg, train_cfg)

    zero_d_argv = ["--model", "MLSTM_FCN", "--synthetic"]
    mlstm_cfg = train_0d.model_config(train_0d.build_parser().parse_args(zero_d_argv), 18)
    vivit_kw, ts_kw = fusion_kwargs()
    B, g = JAX_CKPT_BATCH, torch.Generator(device=dev).manual_seed(seed)
    clips = lambda L: torch.randn((B, L, CROP, CROP, 3), generator=g, device=dev)
    models = {
        # name: (make the model from a seed, the step's model_type, a batch,
        #        the tag's CLI parser and flags)
        "ViViT": (lambda s: build_video_model("ViViT", ViViTConfig(), dtype=torch.bfloat16,
                                              generator=torch.Generator().manual_seed(s)),
                  "single", clips(SEQ_LEN), evaluate_model.build_parser(),
                  ["--kind", "vision", "--model", "ViViT"]),
        "MLSTM_FCN": (lambda s: build_0d_model("MLSTM_FCN", mlstm_cfg, dtype=torch.bfloat16,
                                               generator=torch.Generator().manual_seed(s)),
                      "single", torch.randn((B, SEQ_LEN, 18), generator=g, device=dev),
                      train_0d.build_parser(), zero_d_argv),
        "R2Plus1D": (lambda s: build_video_model(
            "R2Plus1D", R2Plus1DConfig(image_size=CROP, n_frames=SEQ_LEN,
                                       layer_sizes=(1, 2, 2, 1), alpha=0.01),
            dtype=torch.bfloat16, generator=torch.Generator().manual_seed(s)),
            "single", clips(SEQ_LEN), evaluate_model.build_parser(),
            ["--kind", "vision", "--model", "R2Plus1D"]),
        "concat": (lambda s: fusion_models(s, vivit_kw, ts_kw, dtype=torch.bfloat16,
                                           names=("concat",))["concat"],
                   "multi", {"video": clips(SEQ_LEN),
                             "0D": torch.randn((B, SEQ_LEN, 18), generator=g, device=dev)},
                   evaluate_model.build_parser(), ["--kind", "multimodal"]),
    }
    labels = torch.arange(B, device=dev) % 2
    weight, m_list = torch.ones(2, device=dev), torch.tensor([0.3, 0.5], device=dev)
    ok, fields = True, {}
    for name, (make, model_type, batch, parser, argv) in models.items():
        tag = tag_of(parser, argv + ["--synthetic"], name)
        wdir = f"{root}/{name}/w"
        step = make_train_step(LossConfig(), model_type=model_type)
        state = create_train_state(make(seed).to(dev), OptimConfig(), steps_per_epoch=1,
                                   seed=seed)
        for _ in range(JAX_CKPT_STEPS):
            step(state, batch, labels, weight, m_list)
        tree = flax_checkpoint_tree(state)
        t0 = time.perf_counter()
        for which in ("best", "last"):
            write_flax_checkpoint(f"{wdir}/{tag}_{which}.ckpt", tree)
        write_s = (time.perf_counter() - t0) / 2
        path = f"{wdir}/{tag}_last.ckpt"
        t0 = time.perf_counter()
        read_flax_checkpoint(path)
        read_s = time.perf_counter() - t0
        # the parameters through load_params: the same eval logits, exactly
        fresh = make(seed + 100).to(dev)
        t0 = time.perf_counter()
        load_params(fresh, path)
        load_s = time.perf_counter() - t0
        x = batch if model_type == "single" else (batch["video"], batch["0D"])
        with torch.no_grad():
            state.model.eval()
            want = state.model(*(x if isinstance(x, tuple) else (x,))).float()
            got = fresh.eval()(*(x if isinstance(x, tuple) else (x,))).float()
            state.model.train()
        logits_err = float((got - want).abs().max())
        # the whole state through load_checkpoint: the same next step
        resumed = create_train_state(make(seed + 100).to(dev), OptimConfig(),
                                     steps_per_epoch=1, seed=seed)
        load_checkpoint(resumed, path)
        resumed_at = (int(resumed.step), int(resumed.opt_state["count"]), resumed.draws)
        _, loss_a, _ = step(state, batch, labels, weight, m_list)
        _, loss_b, _ = step(resumed, batch, labels, weight, m_list)
        loss_rel = float((loss_a - loss_b).abs() / loss_a.abs())
        entry = dict(tag=tag, file_mb=os.path.getsize(path) / 1e6,
                     parameters=int(state.flat.numel()), write_s=write_s, read_s=read_s,
                     load_params_s=load_s, logits_max_abs=logits_err,
                     resumed_step_count_draws=resumed_at, next_loss=float(loss_a),
                     next_loss_resumed=float(loss_b), next_loss_rel=loss_rel, loss_rtol=1e-3)
        entry["ok"] = (logits_err == 0.0 and loss_rel <= 1e-3 and bool(torch.isfinite(loss_a))
                       and resumed_at == (JAX_CKPT_STEPS,) * 3)
        ok = ok and entry["ok"]
        fields[name] = entry
        del state, fresh, resumed

    k1 = k3 = 0
    for name, kernel in (("ViViT", "spatial_table"), ("R2Plus1D", "gather_normalize")):
        d = f"{root}/{name}"
        _, text, wall, launches_k = run_cli(evaluate_model.main, models[name][4] + [
            "--alarms", "--batch_size", "64", "--synthetic", "--weight_dir", f"{d}/w",
            "--save_dir", f"{d}/eval"])
        k1 += launches_k["spatial_table"]
        k3 += launches_k["gather_normalize"]
        alarms = [f for f in os.listdir(f"{d}/eval") if f.endswith("_alarms.json")]
        other = "gather_normalize" if kernel == "spatial_table" else "spatial_table"
        fields[name]["evaluate_model"] = dict(wall_s=wall, test_line=test_line(text),
                                              alarm_files=alarms, kernel_launches=launches_k)
        run_ok = (test_line(text) is not None and len(alarms) == 1
                  and launches_k[kernel] > 0 and launches_k[other] == 0)
        fields[name]["evaluate_model"]["ok"] = run_ok
        ok = ok and run_ok

    d = f"{root}/MLSTM_FCN"
    _, text, wall, launches_k = run_cli(train_0d.main, zero_d_argv + [
        "--weight_dir", f"{d}/w", "--save_dir", f"{d}/r", "--num_epoch", "1", "--resume",
        "--skip_extras", "--verbose", "1"])
    m = re.search(r"resumed from \S+ at step (\d+)", text)
    fields["MLSTM_FCN"]["train_0d_resume"] = dict(
        wall_s=wall, resumed_at_step=int(m.group(1)) if m else None,
        test_line=test_line(text), kernel_launches=launches_k)
    ok = ok and bool(m) and int(m.group(1)) == JAX_CKPT_STEPS and test_line(text) is not None
    return ok, fields, k1, k3


def soak_phase(seed: int, root: str, dev, tol: tuple) -> tuple:
    """The scale soaks: K1 at T = 12,600 (the 60 s shot's tokens, flagship
    ViViT) against its plain version within ``tol``, timed; then
    ``kstar_torch.analysis.soak_long_shot`` at 12,600 frames (the sweep cold
    and steady, the plain-table curve, the k = 16 stream; its own checks)
    and ``soak_library_sweep`` at ``SOAK_SHOTS`` shots of the 50-shot
    library's length distribution (both ladders at the default budget, a
    budget forced to a quarter of the stack, the per-shot path; its own
    checks). Returns (ok, fields, K1 launches, K3 launches, the K1
    kernel_check row)."""
    import torch.nn.functional as F

    from kstar_torch.analysis import soak_library_sweep, soak_long_shot
    from kstar_torch.config import ViViTConfig
    from kstar_torch.infer import VideoSweeper
    from kstar_torch.models import build_video_model
    from kstar_torch.ops.spatial_table import (extract_spatial_weights, spatial_table,
                                               spatial_table_reference)

    cfg = ViViTConfig()
    model = build_video_model("ViViT", cfg, dtype=torch.bfloat16,
                              generator=torch.Generator().manual_seed(seed)).to(dev).eval()
    sw = VideoSweeper(model, SEQ_LEN, CROP, BATCH, torch.bfloat16, device=dev)
    frames = soak_long_shot.make_shot(SOAK_FRAMES, RESIZE, seed)
    tokens = F.pad(sw.embed_tokens(sw.upload_shot(frames)), (0, 0, 1, 0))   # (T, 65, D)
    del frames
    hp = dict(depth=cfg.depth, n_heads=cfg.n_heads, d_head=cfg.d_head)
    w = extract_spatial_weights(model, SEQ_LEN, cfg.depth, torch.bfloat16)
    run = lambda: spatial_table(tokens, w, SEQ_LEN, compute_dtype=torch.bfloat16, **hp)
    plain = lambda: spatial_table_reference(tokens, w, SEQ_LEN, compute_dtype=torch.bfloat16,
                                            **hp)
    res = compare(run(), plain(), *tol)
    T, N, D = tokens.shape
    ops, nbytes = table_work(T, SEQ_LEN, N, D, cfg.depth, cfg.n_heads, cfg.d_head,
                             cfg.dim * cfg.scale_dim, tokens.element_size())
    bound_ms, bound_by = bound(ops, nbytes, "bfloat16")
    check = dict(name="spatial_table", case=f"long shot T={T} bf16 (soak path)",
                 dtype="bfloat16", shape=list(tokens.shape), route="cuda",
                 source="kstar_torch/csrc/spatial_table.cu",
                 replaces="kstar_tpu/ops/spatial_table.py:371", **res,
                 ms=time_ms(run, 3), plain_ms=time_ms(plain, 1), bound_ms=bound_ms,
                 bound_by=bound_by, library_ms=None, instance=spatial_table.instance,
                 frames_per_block=spatial_table.frames_per_block, path="soak",
                 **table_attributes(D, cfg.d_head))
    del tokens, w, sw, model
    torch.cuda.empty_cache()

    fields, ok = {}, True
    t0 = time.perf_counter()
    try:
        fields["long_shot"] = soak_long_shot.main(SOAK_FRAMES, dev, seed=seed,
                                                  out_dir=f"{root}/gif")
    except RuntimeError as e:              # a failed check of the soak: the phase fails
        fields["long_shot"], ok = {"error": str(e)}, False
    fields["long_shot_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    try:
        fields["library"] = soak_library_sweep.main(SOAK_SHOTS, dev, seed=seed)
    except RuntimeError as e:
        fields["library"], ok = {"error": str(e)}, False
    fields["library_s"] = time.perf_counter() - t0
    long, lib = fields["long_shot"], fields["library"]
    k1 = long.get("k1_launches", 0) + sum(r["k1_launches"] for r in lib.get("runs", {}).values())
    k3 = long.get("k3_launches", 0)
    return ok and k1 > 0 and k3 > 0, fields, k1, k3, check


# ---------------------------------------------------------------------------
# The repository's demos and the horizon x seed campaign through the port:
# the demo ViViT's widths take K1's fast instance compiled for D 64 / d_head 32
# ---------------------------------------------------------------------------

# exp/demo_vivit.sh's ViViT (also the multimodal demo's and the campaign's):
# 64 px, patch 16 (17 tokens with the cls), dim 64, 4 heads x 32, MLP 256
DEMO_VIVIT = dict(image_size=SMALL_CROP, patch_size=16, dim=64, depth=2, n_heads=4,
                  d_head=32, scale_dim=4)
DEMO_TABLE_FRAMES = {"demos": 2520, "campaign": 1680}   # the demo's and the campaign's shots
DEMO_CUT = ["--num_epoch", "2"]                         # the demos, cut for time only
GB_CUT = ["--epoch_per_GB_estimate", "1", "--n_epochs_GB_estimate", "1"]
CAMPAIGN_CUT = ["--dist", "21", "--epochs", "1"]        # one horizon, all four seeds
DEMO_INSTANCE = "fast_D64_F7"                           # 7 frames of 17 tokens a block
# K1's general instance in bf16 is held at a width no fast instance takes
GENERAL_CHECK_VIVIT = dict(dim=96, n_heads=2, d_head=48, scale_dim=2)
GENERAL_CHECK_FRAMES = 512


def demo_table_checks(seed: int, frames, dev, tol: tuple) -> list:
    """K1 at the demo ViViT's widths (N 17, D 64, 4 x 32, MLP 256, depth 2,
    bf16; random weights from ``seed``), which take the fast instance
    compiled for D 64 / d_head 32 (``DEMO_INSTANCE``), over the first 2520 (the demo's shot) and 1680 (the campaign's)
    frames of ``frames`` cropped to 64 px: each against its plain version
    within ``tol``, timed, with its bound, and the whole-shot sweep of those
    frames (``VideoSweeper.sweep_device``, host time to the copy back) for
    the kernel's share of it. Returns the kernel_check rows; ``path`` names
    the phase whose launches the summary line reports."""
    import numpy as np
    import torch.nn.functional as F

    from kstar_torch.config import ViViTConfig
    from kstar_torch.infer import VideoSweeper
    from kstar_torch.models import build_video_model
    from kstar_torch.ops.spatial_table import (extract_spatial_weights, spatial_table,
                                               spatial_table_reference)

    cfg = ViViTConfig(n_frames=SEQ_LEN, **DEMO_VIVIT)
    model = build_video_model("ViViT", cfg, dtype=torch.bfloat16,
                              generator=torch.Generator().manual_seed(seed)).to(dev).eval()
    sw = VideoSweeper(model, SEQ_LEN, SMALL_CROP, BATCH, torch.bfloat16, device=dev)
    w = extract_spatial_weights(model, SEQ_LEN, cfg.depth, torch.bfloat16)
    hp = dict(depth=cfg.depth, n_heads=cfg.n_heads, d_head=cfg.d_head)
    rows = []
    for path, T in DEMO_TABLE_FRAMES.items():
        shot = sw.upload_shot(frames[:T])
        tokens = F.pad(sw.embed_tokens(shot), (0, 0, 1, 0))
        starts = np.arange(len(tokens) - SEQ_LEN - 1, dtype=np.int64)
        sweep_ms = wall_ms(lambda: sw.sweep_device(shot, starts))
        run = lambda: spatial_table(tokens, w, SEQ_LEN, compute_dtype=torch.bfloat16, **hp)
        plain = lambda: spatial_table_reference(tokens, w, SEQ_LEN,
                                                compute_dtype=torch.bfloat16, **hp)
        res = compare(run(), plain(), *tol)
        T, N, D = tokens.shape
        ops, nbytes = table_work(T, SEQ_LEN, N, D, cfg.depth, cfg.n_heads, cfg.d_head,
                                 cfg.dim * cfg.scale_dim, tokens.element_size())
        bound_ms, bound_by = bound(ops, nbytes, "bfloat16")
        rows.append(dict(
            name="spatial_table", case=f"demo ViViT T={T} N={N} D={D} bf16 ({path} path)",
            dtype="bfloat16", shape=list(tokens.shape), route="cuda",
            source="kstar_torch/csrc/spatial_table.cu",
            replaces="kstar_tpu/ops/spatial_table.py:371", **res, ms=time_ms(run, 3),
            plain_ms=time_ms(plain, 1), bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None, instance=spatial_table.instance,
            frames_per_block=spatial_table.frames_per_block, path=path,
            sweep_ms=sweep_ms, **table_attributes(D, cfg.d_head)))
        rows[-1]["k1_share_of_sweep"] = rows[-1]["ms"] / sweep_ms
        rows[-1]["ok"] = res["ok"] and spatial_table.instance == DEMO_INSTANCE
    return rows


def demos_phase(root: str) -> tuple:
    """``kstar_torch.analysis.demos.main`` on the card: the ViViT demo
    (exp/demo_vivit.sh's exact list) and the concat-GB multimodal demo, cut
    to ``DEMO_CUT`` epochs (the multimodal one also to one GB estimate of one
    epoch). Each passes if it returns, writes ``{tag}_alarms.json`` with the
    keys of the JAX file of the same tag (the multimodal one: at least
    those) over the 17 + 16 swept shots, and
    launches K1 once per swept shot. Returns (ok, fields, K1 launches)."""
    import numpy as np

    from kstar_torch.analysis import demos
    from kstar_torch.ops.spatial_table import spatial_table

    fields, ok, k1 = {}, True, 0
    for name, extra in (("vivit", DEMO_CUT), ("multimodal", DEMO_CUT + GB_CUT)):
        spatial_table.launches = 0
        t0 = time.perf_counter()
        out = demos.main(name, extra, save_dir=f"{root}/{name}",
                         weight_dir=f"{root}/{name}/weights")
        launches = spatial_table.launches
        k1 += launches
        port, jax = out["alarms"], out["jax_alarms"]
        swept = None if port is None else port["n_disrupt"] + port["n_normal"]
        # the JAX multimodal files predate the dwell key (min_dwell_s)
        keys_ok = port is not None and jax is not None and (
            set(port) == set(jax) if name == "vivit" else set(jax) <= set(port))
        demo_ok = bool(keys_ok and swept == 33 and launches == swept
                   and np.isfinite(port["detection_rate"])
                   and np.isfinite(port["false_alarm_rate"]))
        fields[name] = {"tag": out["tag"], "seconds": time.perf_counter() - t0,
                        "k1_launches": launches, "alarms": port,
                        "test_macro_f1": float(out["results"]["macro_f1"]), "ok": demo_ok}
        ok = ok and demo_ok
    return ok, fields, k1


def campaign_phase(root: str) -> tuple:
    """``kstar_torch.analysis.campaign_dist_sweep.main`` on the card at one
    horizon (dist 21) and all four seeds, cut to one epoch: every member's
    row finite, and K1 launched once per shot of each member's sweep.
    Returns (ok, fields, K1 launches)."""
    import numpy as np

    from kstar_torch.analysis import campaign_dist_sweep as campaign
    from kstar_torch.ops.spatial_table import spatial_table

    spatial_table.launches = 0
    summary = campaign.main(CAMPAIGN_CUT + ["--out_dir", root])
    launches = spatial_table.launches
    rows = summary["rows"]
    metrics = ("test_macro_f1", "test_roc_auc", "best_valid_f1", "detection_rate",
               "false_alarm_rate")
    swept = sum(r["n_disrupt"] + r["n_normal"] for r in rows)
    ok = bool(len(rows) == len(campaign.SEEDS) and launches == swept > 0
              and all(np.isfinite(r[k]) for r in rows for k in metrics))
    return ok, {"k1_launches": launches, "swept_shots": swept, "rows": rows,
                "wall_clock": summary["wall_clock"]}, launches


# ---------------------------------------------------------------------------
# The full frame: the flagship ViViT over the patch-16 crops of the stored
# 256 px frames past 128 px (N 101..257), on K1's one-frame instances
# ---------------------------------------------------------------------------

FULL_FRAME = 256                  # the size the ETL decodes to and bench.py's shot has
WIDE_CROPS = (160, 192, 224, 256)  # 101, 145, 197 and 257 tokens with the cls
WIDE_TABLE_FRAMES = 512           # frames of the kernel_check rows (and of the crop sweeps)


def full_frame_model(seed: int, cfg, dev, dtype=torch.bfloat16):
    """The flagship ViViT at image_size 256 (its positional embedding covers
    257 tokens, a prefix of it any smaller crop), random weights from seed,
    computing in ``dtype`` (f32: the same parameters as the bf16 model)."""
    from kstar_torch.models import build_video_model

    cfg_ff = dataclasses.replace(cfg, image_size=FULL_FRAME)
    model = build_video_model("ViViT", cfg_ff, dtype=torch.bfloat16,
                              generator=torch.Generator().manual_seed(seed + 14))
    if dtype == torch.float32:
        model = f32_twin(model, cfg_ff, dev)
    return model.to(dev).eval()


def full_frame_phase_name(dtype) -> str:
    return "full_frame_sweep" if dtype == torch.bfloat16 else "f32_full_frame_sweep"


def wide_table_checks(seed: int, frames, dev, cfg, tol: tuple, dtype=torch.bfloat16) -> list:
    """K1 at the flagship widths past 80 tokens (21 offsets, in ``dtype``):
    the first 512 frames of ``frames`` at each crop of WIDE_CROPS, and the
    whole shot at 256 px, each against its plain version within ``tol``,
    timed (the plain version once), with its bound (in f32 both bounds),
    instance and attributes. A row is right only if it took the fast (or
    f32) instance for its N that owns one frame (``fast_D128_N<N>_C<blocks
    per frame>``, ``fast_f32_D128_N<N>_C<blocks>``). ``path`` names the
    sweep whose launches the summary line reports."""
    import torch.nn.functional as F

    from kstar_torch.infer import VideoSweeper
    from kstar_torch.ops.spatial_table import (extract_spatial_weights, fast_applies,
                                               fast_instance_name, spatial_table,
                                               spatial_table_reference)

    model = full_frame_model(seed, cfg, dev, dtype)
    w = extract_spatial_weights(model, SEQ_LEN, cfg.depth, dtype)
    hp = dict(depth=cfg.depth, n_heads=cfg.n_heads, d_head=cfg.d_head)
    dt, phase = str(dtype).split(".")[1], full_frame_phase_name(dtype)
    short = "bf16" if dtype == torch.bfloat16 else "f32"
    rows = []
    for crop, T in [(c, WIDE_TABLE_FRAMES) for c in WIDE_CROPS] + [(FULL_FRAME, len(frames))]:
        sw = VideoSweeper(model, SEQ_LEN, crop, BATCH, dtype, device=dev)
        tokens = F.pad(sw.embed_tokens(sw.upload_shot(frames[:T])), (0, 0, 1, 0))
        run = lambda: spatial_table(tokens, w, SEQ_LEN, compute_dtype=dtype, **hp)
        plain = lambda: spatial_table_reference(tokens, w, SEQ_LEN, compute_dtype=dtype, **hp)
        res = compare(run(), plain(), *tol)
        T, N, D = tokens.shape
        ops, nbytes = table_work(T, SEQ_LEN, N, D, cfg.depth, cfg.n_heads, cfg.d_head,
                                 cfg.dim * cfg.scale_dim, tokens.element_size())
        path = phase if crop == FULL_FRAME else f"{phase} crop {crop}"
        # the f32 plain table over the whole shot takes seconds: timed once
        slow = dtype == torch.float32 and T > WIDE_TABLE_FRAMES
        rows.append(dict(
            name="spatial_table",
            case=f"flagship crop {crop} px N={N} T={T} {short} ({path} path)",
            dtype=dt, shape=list(tokens.shape), route="cuda",
            source="kstar_torch/csrc/spatial_table.cu",
            replaces="kstar_tpu/ops/spatial_table.py:371", **res,
            ms=time_ms(run, 1 if slow else 3),
            plain_ms=time_once(plain) if slow else time_ms(plain, 1),
            **row_bounds(ops, nbytes, dt), library_ms=None, instance=spatial_table.instance,
            frames_per_block=spatial_table.frames_per_block, path=path,
            **table_attributes(D, cfg.d_head, N, dtype)))
        want = (fast_instance_name(N, D, cfg.d_head, dtype)
                if fast_applies(N, D, cfg.d_head, cfg.dim * cfg.scale_dim, dtype) else None)
        rows[-1]["ok"] = (res["ok"] and want is not None and "_N" in want
                          and spatial_table.instance == want)
        del tokens
    return rows


def full_frame_sweep_phase(seed: int, frames, dev, cfg, dtype=torch.bfloat16) -> tuple:
    """The flagship ViViT at image_size 256, computing in ``dtype``, sweeps
    the whole shot as the repository stores it (256 px, no crop) with
    use_fused_table=None: it must take the kernel (K1's cluster instance at
    257 tokens, bf16 or f32) and launch it once per sweep. Clips/s over 3
    sweeps after a warm-up, the embedding, table and window loop apart, the
    curve against the plain table's (the route the sweep took before K1 took
    257 tokens, timed once) to M1's limits (f32: F32_CURVE_TOL); and a sweep
    of the first 512 frames at each smaller crop of WIDE_CROPS, one launch
    each, against its plain curve. Returns (ok, fields, {path: K1
    launches})."""
    import numpy as np
    import torch.nn.functional as F

    from kstar_torch.infer import VideoSweeper
    from kstar_torch.ops.spatial_table import (extract_spatial_weights, fast_instance_name,
                                               spatial_table)

    model = full_frame_model(seed, cfg, dev, dtype)
    phase = full_frame_phase_name(dtype)
    curve_tol = (5e-2, 5e-3) if dtype == torch.bfloat16 else F32_CURVE_TOL
    hp = dict(depth=cfg.depth, n_heads=cfg.n_heads, d_head=cfg.d_head)
    starts = np.arange(len(frames) - SEQ_LEN - 1, dtype=np.int64)
    sw = VideoSweeper(model, SEQ_LEN, FULL_FRAME, BATCH, dtype, device=dev)
    shot = sw.upload_shot(frames)
    sw.sweep_device(shot, starts)                       # warm-up
    torch.cuda.synchronize()
    spatial_table.launches = 0
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        probs = sw.sweep_device(shot, starts)          # ends in a host copy
        walls.append(time.perf_counter() - t0)
    launches = {phase: spatial_table.launches}
    instance = spatial_table.instance
    sweep_s = float(np.median(walls))
    w = extract_spatial_weights(model, SEQ_LEN, cfg.depth, dtype)
    tokens = F.pad(sw.embed_tokens(shot), (0, 0, 1, 0))
    table = sw.embed_all(shot)
    phases = {"embed_ms": wall_ms(lambda: sw.embed_tokens(shot)),
              "table_ms": wall_ms(lambda: spatial_table(
                  tokens, w, SEQ_LEN, compute_dtype=dtype, **hp)),
              "windows_ms": wall_ms(lambda: sw.sweep_table(table, starts))}
    del tokens, table
    plain_sw = VideoSweeper(model, SEQ_LEN, FULL_FRAME, BATCH, dtype,
                            use_fused_table=False, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    probs_plain = plain_sw.sweep_device(shot, starts)
    plain_s = time.perf_counter() - t0
    err = np.abs(probs - probs_plain)
    n_tok = (FULL_FRAME // 16) ** 2 + 1
    fields = dict(frames=len(frames), frame_px=FULL_FRAME, tokens=n_tok,
                  dtype=str(dtype).split(".")[1], windows=len(starts), batch=BATCH,
                  fused_table_active=sw.fused_table_active,
                  plain_fused_table_active=plain_sw.fused_table_active,
                  spatial_table_launches=launches[phase], instance=instance,
                  clips_per_s=len(starts) / sweep_s, sweep_ms=sweep_s * 1e3,
                  sweep_runs_ms=[x * 1e3 for x in walls], **phases,
                  plain_table_sweep_ms=plain_s * 1e3,
                  plain_table_clips_per_s=len(starts) / plain_s,
                  curve_vs_plain_max_abs=float(err.max()),
                  curve_vs_plain_mean_abs=float(err.mean()), curve_tol=curve_tol)
    ok = bool(fields["fused_table_active"] is True and fields["plain_fused_table_active"] is False
          and launches[phase] == 3 and probs.shape == starts.shape
          and instance == fast_instance_name(n_tok, cfg.dim, cfg.d_head, dtype)
          and bool(np.isfinite(probs).all()) and fields["curve_vs_plain_max_abs"] <= curve_tol[0]
          and fields["curve_vs_plain_mean_abs"] <= curve_tol[1])
    del shot
    sub = frames[:WIDE_TABLE_FRAMES]
    sub_starts = np.arange(len(sub) - SEQ_LEN - 1, dtype=np.int64)
    fields["crops"] = {}
    for crop in WIDE_CROPS[:-1]:
        csw = VideoSweeper(model, SEQ_LEN, crop, BATCH, dtype, device=dev)
        spatial_table.launches = 0
        p_k = csw.sweep(sub, sub_starts)
        path = f"{phase} crop {crop}"
        launches[path] = spatial_table.launches
        p_p = VideoSweeper(model, SEQ_LEN, crop, BATCH, dtype, use_fused_table=False,
                           device=dev).sweep(sub, sub_starts)
        e = np.abs(p_k - p_p)
        fields["crops"][crop] = dict(tokens=(crop // 16) ** 2 + 1, frames=len(sub),
                                     fused_table_active=csw.fused_table_active,
                                     spatial_table_launches=launches[path],
                                     instance=spatial_table.instance,
                                     curve_vs_plain_max_abs=float(e.max()),
                                     curve_vs_plain_mean_abs=float(e.mean()))
        ok = bool(ok and csw.fused_table_active is True and launches[path] == 1
                  and np.isfinite(p_k).all() and e.max() <= curve_tol[0]
                  and e.mean() <= curve_tol[1])
    return ok, fields, launches


F32_INSTANCE = "fast_f32_D128_F1"   # K1's f32 instance at the flagship's 65 tokens
# f32 curves: the kernel's table is within the f32 table limits (1e-4 +
# 1e-4 |x|, mean 1e-5) of the plain one, and the window loop is the same
# f32 arithmetic on both, so the probabilities are held to the same limits
F32_CURVE_TOL = (1e-4, 1e-5)


def f32_twin(model, cfg, dev):
    """The flagship ViViT with the same parameters, computing in f32."""
    from kstar_torch.models import build_video_model

    twin = build_video_model("ViViT", cfg, dtype=torch.float32)
    twin.load_state_dict(model.state_dict())
    return twin.to(dev).eval()


def f32_sweep_phase(frames_dev, dev, cfg, model) -> tuple:
    """VideoSweeper(compute_dtype=torch.float32) over the whole uploaded
    shot (the flagship ViViT's f32 twin, use_fused_table=None): it must take
    K1's f32 instance and launch it once per sweep. Clips/s over 3 sweeps
    after a warm-up, the embedding, table and window loop apart, the curve
    against the plain f32 table's (timed once) within F32_CURVE_TOL.
    Returns (ok, fields, K1 launches of the timed sweeps)."""
    import numpy as np
    import torch.nn.functional as F

    from kstar_torch.infer import VideoSweeper
    from kstar_torch.ops.spatial_table import extract_spatial_weights, spatial_table

    m32 = f32_twin(model, cfg, dev)
    hp = dict(depth=cfg.depth, n_heads=cfg.n_heads, d_head=cfg.d_head)
    starts = np.arange(len(frames_dev) - SEQ_LEN - 1, dtype=np.int64)
    sw = VideoSweeper(m32, SEQ_LEN, CROP, BATCH, torch.float32, device=dev)
    sw.sweep_device(frames_dev, starts)                 # warm-up
    torch.cuda.synchronize()
    spatial_table.launches = 0
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        probs = sw.sweep_device(frames_dev, starts)    # ends in a host copy
        walls.append(time.perf_counter() - t0)
    launches, instance = spatial_table.launches, spatial_table.instance
    sweep_s = float(np.median(walls))
    w = extract_spatial_weights(m32, SEQ_LEN, cfg.depth, torch.float32)
    tokens = F.pad(sw.embed_tokens(frames_dev), (0, 0, 1, 0))
    table = sw.embed_all(frames_dev)
    phases = {"embed_ms": wall_ms(lambda: sw.embed_tokens(frames_dev)),
              "table_ms": wall_ms(lambda: spatial_table(
                  tokens, w, SEQ_LEN, compute_dtype=torch.float32, **hp)),
              "windows_ms": wall_ms(lambda: sw.sweep_table(table, starts))}
    del tokens, table
    plain_sw = VideoSweeper(m32, SEQ_LEN, CROP, BATCH, torch.float32, use_fused_table=False,
                            device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    probs_plain = plain_sw.sweep_device(frames_dev, starts)
    plain_s = time.perf_counter() - t0
    err = np.abs(probs - probs_plain)
    fields = dict(frames=len(frames_dev), windows=len(starts), batch=BATCH, dtype="float32",
                  fused_table_active=sw.fused_table_active, instance=instance,
                  spatial_table_launches=launches, clips_per_s=len(starts) / sweep_s,
                  sweep_ms=sweep_s * 1e3, sweep_runs_ms=[x * 1e3 for x in walls], **phases,
                  plain_table_sweep_ms=plain_s * 1e3,
                  plain_table_clips_per_s=len(starts) / plain_s,
                  curve_vs_plain_max_abs=float(err.max()),
                  curve_vs_plain_mean_abs=float(err.mean()), curve_tol=F32_CURVE_TOL)
    ok = bool(sw.fused_table_active is True and plain_sw.fused_table_active is False
              and instance == F32_INSTANCE and launches == 3 and probs.shape == starts.shape
              and np.isfinite(probs).all() and err.max() <= F32_CURVE_TOL[0]
              and err.mean() <= F32_CURVE_TOL[1])
    return ok, fields, launches


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--frames", type=int, default=4096)
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a GPU",
              file=sys.stderr)
        return 1
    import numpy as np
    import torch.nn.functional as F

    from kstar_torch.config import FPS, PIXEL_MEAN_BGR, ViViTConfig
    from kstar_torch.eval.alarms import score_alarm_rows
    from kstar_torch.infer import (StreamingPredictor, VideoSweeper, alarm_times,
                                   choose_block_size, predict_video_shot,
                                   probe_stream_blocks, startup_suppression,
                                   warning_time)
    from kstar_torch.models import ViViT, build_video_model
    from kstar_torch.ops import _build
    from kstar_torch.ops.attention import (fused_attention,
                                           fused_attention_reference)
    from kstar_torch.ops.preprocess import (gather_normalize,
                                            gather_normalize_reference)
    from kstar_torch.ops.spatial_table import (extract_spatial_weights,
                                               spatial_table,
                                               spatial_table_reference)
    from kstar_torch.analysis.soak_library_sweep import library_phases
    from kstar_torch.utils.profiling import recording

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    failures = []
    # the train CLIs' checkpoints and files, reloaded by the last phases
    cli_dir = tempfile.TemporaryDirectory(prefix="chip_smoke-")
    cli_root = cli_dir.name

    # ---- env ----
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit("env", device=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    # ---- build ----
    t0 = time.perf_counter()
    reports = _build.build()
    ptxas = [line.strip() for text in reports.values() for line in text.splitlines()
             if "registers" in line or "spill" in line or "Compiling entry" in line]
    emit("build", seconds=time.perf_counter() - t0, sources=_build.sources(),
         ptxas=ptxas)

    # ---- flagship model, shot and its tokens ----
    cfg = ViViTConfig()
    gen = torch.Generator().manual_seed(args.seed)
    model = build_video_model("ViViT", cfg, dtype=torch.bfloat16, generator=gen).to(dev)
    frames = np.random.default_rng(args.seed).integers(
        0, 255, size=(args.frames, RESIZE, RESIZE, 3), dtype=np.uint8)
    sweeper = VideoSweeper(model, SEQ_LEN, CROP, BATCH, torch.bfloat16, device=dev)
    frames_dev = sweeper.upload_shot(frames)
    tokens = F.pad(sweeper.embed_tokens(frames_dev), (0, 0, 1, 0))   # (T, 65, D)
    small = VideoSweeper(model, SEQ_LEN, SMALL_CROP, BATCH, torch.bfloat16, device=dev)
    tokens_small = F.pad(small.embed_tokens(small.upload_shot(frames[:64])),
                         (0, 0, 1, 0))                               # (64, 17, D)
    hp = dict(depth=cfg.depth, n_heads=cfg.n_heads, d_head=cfg.d_head)
    M = cfg.dim * cfg.scale_dim
    # the fusion models at the train_multimodal CLI's widths (f32 on the CPU;
    # the phases make their bf16 twins) and the 0D table of the shot
    fusion_vivit, fusion_ts = fusion_kwargs()
    fusion_cpu = fusion_models(args.seed, fusion_vivit, fusion_ts)
    shot_values = random_walk_table(args.seed + 3, args.frames)

    # ---- kernels: each against its plain version ----
    checks = []
    # bf16 tolerance: kernel and plain version round to bf16 (8 significant
    # bits) at the same points but sum in another order, so an intermediate
    # may land one bf16 ulp (2^-8 relative) apart and carry that through two
    # layers; after the final LayerNorm the outputs are O(1), so isolated
    # elements may differ by a few 2^-8 while the mean error stays below one
    # ulp at 1.0. f32: the same algorithm, differing only in summation order.
    TOL = {"bfloat16": (6.25e-2, 6.25e-2, 2 ** -8), "float32": (1e-4, 1e-4, 1e-5)}
    # the f32 rows (the f32 sweep's table and its 64 px crop) must take the
    # f32 instance; its T = 4096 plain table (~0.47 s on an H100) is timed once
    for label, toks, cd, iters in (
            ("flagship T=4096 bf16 (main path)", tokens, torch.bfloat16, 3),
            ("flagship T=4096 f32 (f32 path)", tokens, torch.float32, 3),
            ("flagship T=64 f32", tokens[:64], torch.float32, 5),
            ("small crop N=17 T=64 f32", tokens_small, torch.float32, 10),
            ("flagship T=64 bf16", tokens[:64], torch.bfloat16, 10),
            ("flagship T=61 bf16 (T no multiple of the frames per block)", tokens[:61],
             torch.bfloat16, 10),
            ("flagship T=1 bf16 (one frame in a block of several)", tokens[100:101],
             torch.bfloat16, 10),
            ("small crop N=17 T=64 bf16", tokens_small, torch.bfloat16, 10)):
        w = extract_spatial_weights(model, SEQ_LEN, cfg.depth, cd)
        x = toks.to(cd)
        run = lambda: spatial_table(x, w, SEQ_LEN, compute_dtype=cd, **hp)
        plain = lambda: spatial_table_reference(x, w, SEQ_LEN, compute_dtype=cd, **hp)
        got, want = run(), plain()
        torch.cuda.synchronize()
        dt = str(cd).split(".")[1]
        res = compare(got, want, *TOL[dt])
        T, N, D = x.shape
        ops, nbytes = table_work(T, SEQ_LEN, N, D, cfg.depth, cfg.n_heads,
                                 cfg.d_head, M, x.element_size())
        instance = spatial_table.instance
        checks.append(dict(
            name="spatial_table", case=label, dtype=dt, shape=list(x.shape),
            route="cuda", source="kstar_torch/csrc/spatial_table.cu",
            replaces="kstar_tpu/ops/spatial_table.py:371", **res,
            ms=time_ms(run, iters),
            plain_ms=time_once(plain) if T > 1024 and dt == "float32"
            else time_ms(plain, max(iters // 3, 1)),
            **row_bounds(ops, nbytes, dt), library_ms=None,
            instance=instance, frames_per_block=spatial_table.frames_per_block,
            **table_attributes(D, cfg.d_head, N, cd)))
        if dt == "float32":
            checks[-1]["path"] = "f32"
            checks[-1]["ok"] = res["ok"] and instance.startswith("fast_f32")
        emit("kernel_check", **checks[-1])
    # the multimodal sweep's table: the fusion CLI's ViViT (scale_dim 4, an
    # MLP of 512) over the whole shot
    fusion_bf = twin(fusion_cpu["concat"], torch.bfloat16).to(dev).eval()
    with torch.no_grad():
        fz_tokens = F.pad(fusion_bf.embed_frames(
            frames_dev.to(torch.bfloat16)
            - torch.tensor(PIXEL_MEAN_BGR, dtype=torch.bfloat16, device=dev)), (0, 0, 1, 0))
    fz_w = extract_spatial_weights(fusion_bf, SEQ_LEN, fusion_vivit["depth"], torch.bfloat16)
    fz_M = fusion_vivit["dim"] * fusion_vivit["scale_dim"]
    run = lambda: spatial_table(fz_tokens, fz_w, SEQ_LEN, compute_dtype=torch.bfloat16, **hp)
    plain = lambda: spatial_table_reference(fz_tokens, fz_w, SEQ_LEN,
                                            compute_dtype=torch.bfloat16, **hp)
    res = compare(run(), plain(), *TOL["bfloat16"])
    T, N, D = fz_tokens.shape
    ops, nbytes = table_work(T, SEQ_LEN, N, D, cfg.depth, cfg.n_heads, cfg.d_head, fz_M,
                             fz_tokens.element_size())
    bound_ms, bound_by = bound(ops, nbytes, "bfloat16")
    checks.append(dict(
        name="spatial_table", case=f"fusion ViViT MLP {fz_M} T={T} bf16 (multimodal path)",
        dtype="bfloat16", shape=list(fz_tokens.shape), route="cuda",
        source="kstar_torch/csrc/spatial_table.cu",
        replaces="kstar_tpu/ops/spatial_table.py:371", **res, ms=time_ms(run, 3),
        plain_ms=time_ms(plain, 1), bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        instance=spatial_table.instance, frames_per_block=spatial_table.frames_per_block,
        path="multimodal_sweep", **table_attributes(D, cfg.d_head)))
    emit("kernel_check", **checks[-1])
    del fusion_bf, fz_tokens, fz_w
    # K1's general instance in bf16 at a width no fast instance is compiled
    # for (dim 96, 2 heads x 48, MLP 192, N 17), so that it stays held
    # against its plain version: no configuration of the repository takes it
    gw = GENERAL_CHECK_VIVIT
    gen_model = ViViT(image_size=SMALL_CROP, patch_size=16, n_frames=SEQ_LEN, depth=2,
                      generator=torch.Generator().manual_seed(args.seed + 5), **gw).to(dev)
    gen_tokens = F.pad(torch.randn(GENERAL_CHECK_FRAMES, 16, gw["dim"],
                                   generator=torch.Generator().manual_seed(args.seed + 6)),
                       (0, 0, 1, 0)).to(dev, torch.bfloat16)
    gen_w = extract_spatial_weights(gen_model, SEQ_LEN, 2, torch.bfloat16)
    gen_hp = dict(depth=2, n_heads=gw["n_heads"], d_head=gw["d_head"])
    run = lambda: spatial_table(gen_tokens, gen_w, SEQ_LEN, compute_dtype=torch.bfloat16,
                                **gen_hp)
    plain = lambda: spatial_table_reference(gen_tokens, gen_w, SEQ_LEN,
                                            compute_dtype=torch.bfloat16, **gen_hp)
    res = compare(run(), plain(), *TOL["bfloat16"])
    T, N, D = gen_tokens.shape
    gen_M = gw["dim"] * gw["scale_dim"]
    ops, nbytes = table_work(T, SEQ_LEN, N, D, 2, gw["n_heads"], gw["d_head"], gen_M,
                             gen_tokens.element_size())
    bound_ms, bound_by = bound(ops, nbytes, "bfloat16")
    checks.append(dict(
        name="spatial_table",
        case=f"general instance bf16 D={D} {gw['n_heads']}x{gw['d_head']} MLP {gen_M} "
             f"T={T} N={N}", dtype="bfloat16", shape=list(gen_tokens.shape), route="cuda",
        source="kstar_torch/csrc/spatial_table.cu",
        replaces="kstar_tpu/ops/spatial_table.py:371", **res, ms=time_ms(run, 3),
        plain_ms=time_ms(plain, 1), bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        instance=spatial_table.instance, frames_per_block=spatial_table.frames_per_block))
    checks[-1]["ok"] = res["ok"] and spatial_table.instance == "general"
    emit("kernel_check", **checks[-1])
    if not checks[-1]["ok"]:
        failures.append(f"spatial_table {checks[-1]['case']}")
    del gen_model, gen_tokens, gen_w
    # K1 past 80 tokens at the flagship widths: the 160 .. 256 px crops of
    # the stored 256 px frames, each on a fast instance that owns one frame
    checks += wide_table_checks(args.seed, frames, dev, cfg, TOL["bfloat16"])
    for c in checks[-len(WIDE_CROPS) - 1:]:
        emit("kernel_check", **c)
    # and in f32, each on the f32 instance's cluster of blocks for its N
    checks += wide_table_checks(args.seed, frames, dev, cfg, TOL["float32"], torch.float32)
    for c in checks[-len(WIDE_CROPS) - 1:]:
        emit("kernel_check", **c)
    # the ragged case must take the fast instance with several frames per block
    ragged = next(c for c in checks if "T=61" in c["case"])
    if ragged["frames_per_block"] < 2 or 61 % ragged["frames_per_block"] == 0:
        failures.append(f"spatial_table ragged case ran {ragged['instance']}")

    g = torch.Generator(device=dev).manual_seed(args.seed)
    # the forward's shapes at 8 windows (vivit_pallas) and at the stream's
    # block of 16
    for shape in ((8 * SEQ_LEN, cfg.n_heads, 65, cfg.d_head),
                  (8, cfg.n_heads, SEQ_LEN + 1, cfg.d_head),
                  (16 * SEQ_LEN, cfg.n_heads, 65, cfg.d_head),
                  (16, cfg.n_heads, SEQ_LEN + 1, cfg.d_head)):
        for cd in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn(shape, generator=g, device=dev).to(cd)
                       for _ in range(3))
            scale = cfg.d_head ** -0.5
            dt = str(cd).split(".")[1]
            got = fused_attention(q, k, v, scale)
            want = fused_attention_reference(q, k, v, scale)
            torch.cuda.synchronize()
            # f32: online vs two-pass softmax, summation order only; bf16:
            # both compute in f32 and round once, so at most one bf16 ulp
            tol = (2e-5, 2e-5, 1e-6) if dt == "float32" else (1e-2, 1e-2, 1e-3)
            res = compare(got, want, *tol)
            BH, N, D = shape[0] * shape[1], shape[2], shape[3]
            instance = fused_attention.instance
            checks.append(dict(
                name="fused_attention", case=f"{list(shape)} {dt}", dtype=dt,
                shape=list(shape), route="cuda", source="kstar_torch/csrc/attention.cu",
                replaces="kstar_tpu/ops/attention.py:60", **res,
                ms=time_ms(lambda: fused_attention(q, k, v, scale), 50),
                plain_ms=time_ms(lambda: fused_attention_reference(q, k, v, scale), 50),
                **row_bounds(4.0 * BH * N * N * D, 4.0 * BH * N * D * q.element_size(), dt),
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, scale=scale), 50),
                instance=instance))
            if dt == "float32":      # the split-TF32 tensor-core instance
                checks[-1]["path"] = "f32 attention"
                checks[-1]["ok"] = res["ok"] and instance.startswith("tf32x3")
            emit("kernel_check", **checks[-1])

    # window gather + normalise: exact (uint8 minus an integer mean is
    # representable in bf16 and f32), so the tolerance is 0. Bytes: every
    # output element written once, every distinct frame the windows touch
    # and the starts read once; one subtraction per element.
    T = args.frames
    small_frames = small.upload_shot(frames[:64])                     # 64 frames
    for label, src, st, cd, iters, L in (
            ("stream block k=16, 37 frames bf16 (main path)", frames_dev[:SEQ_LEN + 16],
             torch.arange(16, device=dev), torch.bfloat16, 50, SEQ_LEN),
            (f"sweep chunk B={BATCH}, T={T} bf16 (main path)", frames_dev,
             torch.arange(BATCH, device=dev) + T // 2, torch.bfloat16, 20, SEQ_LEN),
            (f"SlowFast sweep chunk B={BATCH}, T={T}, L=20 bf16 (conv path)", frames_dev,
             torch.arange(BATCH, device=dev) + T // 2, torch.bfloat16, 20, 20),
            (f"small crop {SMALL_CROP} px, 8 windows f32", small_frames,
             torch.arange(8, device=dev) * 5, torch.float32, 50, SEQ_LEN),
            (f"clipped at both ends, T={T} bf16", frames_dev,
             torch.tensor([-40, -SEQ_LEN, -1, 0, T - SEQ_LEN - 1, T - SEQ_LEN, T - 2,
                           T + 9], device=dev), torch.bfloat16, 50, SEQ_LEN)):
        got = gather_normalize(src, st, L, cd)
        want = gather_normalize_reference(src, st, L, cd)
        torch.cuda.synchronize()
        res = compare(got, want, 0.0, 0.0, 0.0)
        idx = torch.clamp(st[:, None] + torch.arange(1, L + 1, device=dev), 0,
                          len(src) - 1)
        frame_bytes = src[0].numel()
        nbytes = (got.numel() * got.element_size()
                  + int(torch.unique(idx).numel()) * frame_bytes + st.numel() * 8)
        bound_ms, bound_by = bound(got.numel(), nbytes, "float32")   # no tensor-core work
        checks.append(dict(
            name="gather_normalize", case=label, dtype=str(cd).split(".")[1],
            shape=[list(src.shape), list(st.shape)], route="cuda",
            source="kstar_torch/csrc/preprocess.cu",
            replaces="kstar_tpu/ops/preprocess.py:76", **res,
            ms=time_ms(rotating(lambda: gather_normalize(src, st, L, cd)), iters),
            plain_ms=time_ms(rotating(
                lambda: gather_normalize_reference(src, st, L, cd)), iters),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            instance=gather_normalize.instance, seq_len=L))
        if L == 20:
            checks[-1]["path"] = "conv SlowFast"
        emit("kernel_check", **checks[-1])
    # the conv epilogue: exact (the kernel rounds where the plain version
    # does), at R(2+1)D's own shapes; then its whole forward on both routes
    t0 = time.perf_counter()
    epi_rows, epi_fields, epi_ok = bn_act_checks(args.seed, frames_dev, dev)
    for c in epi_rows:
        checks.append(c)
        emit("kernel_check", **c)
    emit("conv_epilogue", **epi_fields, seconds=time.perf_counter() - t0, ok=epi_ok)
    if not epi_ok:
        failures.append("conv_epilogue")
    torch.cuda.empty_cache()
    failures += [f"{c['name']} {c['case']}" for c in checks if not c["ok"]]

    # ---- sweep: the main path ----
    n_windows = args.frames - SEQ_LEN - 1
    starts = np.arange(n_windows, dtype=np.int64)
    sweeper.sweep_device(frames_dev, starts)                 # warm-up
    torch.cuda.synchronize()
    spatial_table.launches = fused_attention.launches = 0
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        probs = sweeper.sweep_device(frames_dev, starts)    # ends in a host copy
        walls.append(time.perf_counter() - t0)
    launches = {"spatial_table": spatial_table.launches,
                "fused_attention": fused_attention.launches}
    sweep_s = float(np.median(walls))

    w_main = extract_spatial_weights(model, SEQ_LEN, cfg.depth, torch.bfloat16)
    table = sweeper.embed_all(frames_dev)
    phases = {"embed_ms": wall_ms(lambda: sweeper.embed_tokens(frames_dev)),
              "table_ms": wall_ms(lambda: spatial_table(
                  tokens, w_main, SEQ_LEN, compute_dtype=torch.bfloat16, **hp)),
              "windows_ms": wall_ms(lambda: sweeper.sweep_table(table, starts))}

    plain_sweeper = VideoSweeper(model, SEQ_LEN, CROP, BATCH, torch.bfloat16,
                                 use_fused_table=False, device=dev)
    probs_plain = plain_sweeper.sweep_device(frames_dev, starts)
    curve_err = float(np.abs(probs - probs_plain).max())
    curve_mean_err = float(np.abs(probs - probs_plain).mean())
    # the two curves differ only through the table's bf16 rounding (above)
    curve_ok = (probs.shape == (n_windows,) and bool(np.isfinite(probs).all())
                and curve_err <= 5e-2 and curve_mean_err <= 5e-3)

    frame_end = args.frames - int(FPS)          # the curve covers the whole shot
    time_x, prob = predict_video_shot(model, frames, 0, frame_end, SEQ_LEN,
                                      crop_size=CROP, batch_size=BATCH, device=dev)
    expect_len = SEQ_LEN + (args.frames - SEQ_LEN - 3) - 2
    t_alarm = alarm_times(time_x, prob)
    pred_ok = prob.shape == (expect_len,) and bool(np.isfinite(prob).all())
    sweep_ok = curve_ok and pred_ok and launches["spatial_table"] > 0
    emit("sweep", frames=args.frames, windows=n_windows, batch=BATCH,
         clips_per_s=n_windows / sweep_s, sweep_ms=sweep_s * 1e3,
         sweep_runs_ms=[w * 1e3 for w in walls], **phases,
         launches=launches, curve_vs_plain_max_abs=curve_err,
         curve_vs_plain_mean_abs=curve_mean_err, curve_len=len(prob),
         expect_len=expect_len, alarm_s=t_alarm,
         warning_s=warning_time(t_alarm, float(time_x[-1])),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30, ok=sweep_ok)
    if not sweep_ok:
        failures.append("sweep")

    # ---- f32_sweep: the same sweep in f32 (K1's split-TF32 instance) ----
    t0 = time.perf_counter()
    f32_ok, f32_fields, k1_f32 = f32_sweep_phase(frames_dev, dev, cfg, model)
    emit("f32_sweep", **f32_fields, seconds=time.perf_counter() - t0, ok=f32_ok)
    if not f32_ok:
        failures.append("f32_sweep")

    # ---- video_sweep_fallback: the table route where the kernel refuses ----
    t0 = time.perf_counter()
    fb_ok, fb_fields = video_sweep_fallback_phase(frames, dev, cfg, model)
    emit("video_sweep_fallback", **fb_fields, seconds=time.perf_counter() - t0, ok=fb_ok)
    if not fb_ok:
        failures.append("video_sweep_fallback")

    # ---- full_frame_sweep: the flagship ViViT over the stored 256 px frame ----
    t0 = time.perf_counter()
    ff_ok, ff_fields, k1_full = full_frame_sweep_phase(args.seed, frames, dev, cfg)
    emit("full_frame_sweep", **ff_fields, seconds=time.perf_counter() - t0, ok=ff_ok)
    if not ff_ok:
        failures.append("full_frame_sweep")

    # ---- f32_full_frame_sweep: the same in f32 (K1's f32 clusters) ----
    t0 = time.perf_counter()
    ff32_ok, ff32_fields, k1_full32 = full_frame_sweep_phase(args.seed, frames, dev, cfg,
                                                             torch.float32)
    emit("f32_full_frame_sweep", **ff32_fields, seconds=time.perf_counter() - t0, ok=ff32_ok)
    if not ff32_ok:
        failures.append("f32_full_frame_sweep")

    # ---- vivit_pallas: ViViT with the fused-attention kernel ----
    # ViViT's defaults are the flagship ViViTConfig
    pallas = ViViT(dtype=torch.bfloat16, use_pallas=True).to(dev).eval()
    pallas.load_state_dict(model.state_dict())
    stride = (args.frames - SEQ_LEN) // 8           # 8 windows spread over the shot
    win = torch.arange(8, device=dev)[:, None] * stride + torch.arange(SEQ_LEN, device=dev)
    mean = torch.tensor(PIXEL_MEAN_BGR, dtype=torch.bfloat16, device=dev)
    x = frames_dev[win].to(torch.bfloat16) - mean           # (8, 21, 128, 128, 3)
    with torch.no_grad():
        fused_attention.launches = 0
        logits_k = pallas(x)
        torch.cuda.synchronize()
        launches["fused_attention"] = fused_attention.launches
        logits_p = model(x)
    # use_pallas=False rounds the attention logits to bf16 before the f32
    # softmax (models/vivit.py), the kernel keeps them in f32; that gap
    # reads 0.0101 at seed 0 on an H100, and the limit is five times it
    logit_err = float((logits_k - logits_p).abs().max())
    expect = 2 * cfg.depth                # one per MHSA: spatial + temporal layers
    # the same forward in f32: the kernel's split-TF32 instance against the
    # plain f32 attention, the same arithmetic up to summation order and the
    # split, held to the f32 table limit (1e-4)
    pallas32 = ViViT(dtype=torch.float32, use_pallas=True).to(dev).eval()
    pallas32.load_state_dict(model.state_dict())
    plain32 = f32_twin(model, cfg, dev)
    x32 = frames_dev[win].float() - mean.float()
    with torch.no_grad():
        fused_attention.launches = 0
        logits32_k = pallas32(x32)
        torch.cuda.synchronize()
        k2_f32 = fused_attention.launches
        instance32 = fused_attention.instance
        logit32_err = float((logits32_k - plain32(x32)).abs().max())
    pallas_ok = (launches["fused_attention"] == expect and logits_k.shape == (8, 2)
                 and bool(torch.isfinite(logits_k).all()) and logit_err <= 0.05
                 and k2_f32 == expect and instance32.startswith("tf32x3")
                 and bool(torch.isfinite(logits32_k).all()) and logit32_err <= 1e-4)
    emit("vivit_pallas", input=list(x.shape), launches=launches["fused_attention"],
         expect_launches=expect, logits_max_abs_vs_plain=logit_err,
         f32_launches=k2_f32, f32_instance=instance32,
         f32_logits_max_abs_vs_plain=logit32_err, f32_logits_tol=1e-4, ok=pallas_ok)
    del pallas32, plain32, x32
    if not pallas_ok:
        failures.append("vivit_pallas")


    # ---- stream: frames in, alarms out ----
    budget_ms = 1e3 / FPS
    probe = probe_stream_blocks(model, SEQ_LEN, CROP, torch.bfloat16, device=dev)
    k, report = choose_block_size(probe, fps=FPS)
    c0 = RESIZE // 2 - CROP // 2                             # the crop _prep makes
    cropped = np.ascontiguousarray(frames[:, c0:c0 + CROP, c0:c0 + CROP])

    def stream(**kw):
        return StreamingPredictor(kw.pop("model", model), seq_len=SEQ_LEN, crop_size=CROP,
                                  compute_dtype=torch.bfloat16, device=dev, **kw)

    def timed_blocks(kb: int, n: int = 30) -> tuple:
        """n push_block steps of kb frames, host clock around each (a step
        ends in the host copy of its probabilities); returns the block times
        in ms and the gather launches counted over the n steps."""
        sp = stream(block_size=kb)
        sp.push_block(cropped[:kb])                          # allocate + warm
        gather_normalize.launches = fused_attention.launches = 0
        times = []
        for i in range(1, n + 1):
            t0 = time.perf_counter()
            sp.push_block(cropped[i * kb:(i + 1) * kb])
            times.append((time.perf_counter() - t0) * 1e3)
        return np.asarray(times), gather_normalize.launches

    block_ms, stream_launches = timed_blocks(k)
    steps_ok = stream_launches == 30 and fused_attention.launches == 0
    # frame i of a block waits (k-1-i)/fps for the block to fill, then the block
    fill_ms = (k - 1 - np.arange(k)) / FPS * 1e3
    lat = block_ms[:, None] + fill_ms[None, :]

    def breakdown(kb: int, n: int = 20) -> dict:
        """Where a block of kb frames spends its time: each stage alone and
        the whole block, host clock around a synchronised call, taken in
        turns (the host's speed drifts) and reported as medians of n."""
        stage = torch.from_numpy(cropped[:kb]).pin_memory()
        ext = torch.empty((SEQ_LEN + kb, CROP, CROP, 3), dtype=torch.uint8, device=dev)
        st = torch.arange(kb, device=dev)
        x = gather_normalize(ext, st, SEQ_LEN)
        forward = torch.no_grad()(lambda: torch.softmax(model(x).float(), dim=-1)[:, 0])
        p = forward()
        sp = stream(block_size=kb)
        stages = {"upload_ms": lambda: ext[SEQ_LEN:].copy_(stage, non_blocking=True),
                  "gather_ms": lambda: gather_normalize(ext, st, SEQ_LEN),
                  "forward_ms": forward,
                  "download_ms": p.cpu,
                  "block_ms": lambda: sp.push_block(cropped[:kb])}
        times = {name: [] for name in stages}
        for i in range(n + 1):                               # the first turn warms up
            for name, fn in stages.items():
                ms = wall_ms(fn, warmup=False)
                if i:
                    times[name].append(ms)
        parts = {name: float(np.median(t)) for name, t in times.items()}
        parts["upload_share"] = parts["upload_ms"] / parts["block_ms"]
        parts["per_frame_ms"] = parts["block_ms"] / kb
        return parts

    breakdowns = {str(kb): breakdown(kb) for kb in sorted({k, 16})}

    # the same frames (uncropped: the predictor crops on push) through the
    # kernel, the plain gather and single pushes; suppress_s 0 arms the alarm
    # after the 21 frames that fill the window
    kk = max(k, 16)
    seq = frames[:2 * kk].copy()
    seq[:SEQ_LEN + 3] //= 4                                   # a dark start, so p moves
    runs = {}
    for name, kw in (("kernel", {}), ("plain", dict(use_fused_gather=False))):
        gather_normalize.launches = 0
        pred = stream(block_size=kk, suppress_s=0.0, **kw)
        probs = np.concatenate([pred.push_block(seq[:kk])[0], pred.push_block(seq[kk:])[0]])
        runs[name] = (probs, gather_normalize.launches)
    bit_identical = bool(np.array_equal(runs["kernel"][0], runs["plain"][0]))
    gather_ok = bit_identical and runs["kernel"][1] == 2 and runs["plain"][1] == 0
    # threshold in the widest gap of the armed frames' probabilities
    armed = np.sort(runs["kernel"][0][SEQ_LEN:])
    gap_at = int(np.argmax(np.diff(armed)))
    thr, gap = float(armed[gap_at:gap_at + 2].mean()), float(armed[gap_at + 1] - armed[gap_at])
    blk = stream(block_size=kk, suppress_s=0.0, threshold=thr)
    blk_out = [blk.push_block(seq[:kk]), blk.push_block(seq[kk:])]
    blk_p, blk_a = (np.concatenate([o[i] for o in blk_out]) for i in (0, 1))
    one = stream(block_size=1, suppress_s=0.0, threshold=thr)
    gather_normalize.launches = 0
    one_out = [one.push(f) for f in seq]
    one_p, one_a = np.array([o[0] for o in one_out]), np.array([o[1] for o in one_out])
    single_launches = gather_normalize.launches
    # batch 1 and batch kk may take other cuBLAS kernels, so the bf16
    # activations round apart: probabilities agree to 2e-2, not bit for bit;
    # an alarm is compared where the threshold gap exceeds twice that error
    push_err = float(np.abs(blk_p - one_p).max())
    decidable = gap > 2 * push_err
    push_ok = (push_err <= 2e-2 and single_launches == 2 * kk
               and (not decidable or (np.array_equal(blk_a, one_a)
                                      and blk.alarm_time == one.alarm_time)))
    # the same blocks through the model with the fused-attention kernel
    gather_normalize.launches = fused_attention.launches = 0
    fa = stream(model=pallas, block_size=kk, suppress_s=0.0)
    fa_p = np.concatenate([fa.push_block(seq[:kk])[0], fa.push_block(seq[kk:])[0]])
    fa_err = float(np.abs(fa_p - runs["kernel"][0]).max())
    fa_ok = (fused_attention.launches == 2 * expect and gather_normalize.launches == 2
             and bool(np.isfinite(fa_p).all()) and fa_err <= 0.05)
    p50_block = float(np.median(block_ms))
    stream_ok = (steps_ok and gather_ok and push_ok and fa_ok
                 and bool(np.isfinite(blk_p).all()) and blk_p.shape == (2 * kk,))
    emit("stream", fps=FPS, budget_ms_per_frame=budget_ms, chosen_k=k,
         probe_report={str(kp): r for kp, r in report.items()},
         p50_frame_to_alarm_ms=float(np.median(lat)),
         block_p50_ms=p50_block, block_p99_ms=float(np.percentile(block_ms, 99)),
         block_runs_ms=block_ms.tolist(),
         per_frame_ms=p50_block / k, sustains=p50_block / k <= budget_ms,
         breakdown=breakdowns, launches={"gather_normalize": stream_launches, "steps": 30},
         plain_gather_bit_identical=bit_identical, compared_block=kk,
         blocks_vs_single_max_abs=push_err, blocks_vs_single_tol=2e-2,
         threshold=thr, threshold_gap=gap, alarms_decidable=bool(decidable),
         alarms_equal=bool(np.array_equal(blk_a, one_a)), n_alarms=int(blk_a.sum()),
         alarm_time_blocks=blk.alarm_time, alarm_time_single=one.alarm_time,
         single_push_launches=single_launches,
         fused_attention_launches=fused_attention.launches,
         expect_fused_attention_launches=2 * expect,
         fused_attention_probs_max_abs=fa_err, ok=stream_ok)
    launches["gather_normalize"] = stream_launches
    if not stream_ok:
        failures.append("stream")

    # ---- raw_sweep: a model without the token path gathers raw windows ----
    class PixelsOnly(torch.nn.Module):
        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def forward(self, x):
            return self.inner(x)

    raw = VideoSweeper(PixelsOnly(model), SEQ_LEN, CROP, BATCH, torch.bfloat16, device=dev)
    sub = frames_dev[:512]
    sub_starts = np.arange(len(sub) - SEQ_LEN - 1, dtype=np.int64)
    n_chunks = -(-len(sub_starts) // BATCH)
    raw.sweep_device(sub, sub_starts)                        # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gather_normalize.launches = spatial_table.launches = 0
    t0 = time.perf_counter()
    p_raw = raw.sweep_device(sub, sub_starts)
    raw_ms = (time.perf_counter() - t0) * 1e3
    raw_launches = {"gather_normalize": gather_normalize.launches,
                    "spatial_table": spatial_table.launches}
    p_tok = sweeper.sweep_device(sub, sub_starts)
    raw_err = np.abs(p_raw - p_tok)
    # both paths compute the same windows in bf16, rounding at other points
    raw_ok = (raw_launches == {"gather_normalize": n_chunks, "spatial_table": 0}
              and p_raw.shape == sub_starts.shape and bool(np.isfinite(p_raw).all())
              and raw_err.max() <= 5e-2 and raw_err.mean() <= 5e-3)
    emit("raw_sweep", frames=len(sub), windows=len(sub_starts), batch=BATCH,
         chunks=n_chunks, launches=raw_launches, sweep_ms=raw_ms,
         clips_per_s=len(sub_starts) / raw_ms * 1e3,
         vs_token_path_max_abs=float(raw_err.max()),
         vs_token_path_mean_abs=float(raw_err.mean()),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30, ok=bool(raw_ok))
    if not raw_ok:
        failures.append("raw_sweep")

    # ---- library: sweep_shots over ragged shots, then alarm scoring ----
    lengths = [1500, 700, 2048, 1100, 900, 1300]             # frame buckets 1280 and 2048
    lib = [frames[a:a + n] for a, n in zip((0, 300, 2048, 1700, 2900, 600), lengths)]
    lib_starts = [np.arange(n - SEQ_LEN - 1, dtype=np.int64) for n in lengths]
    shot_bytes = 2048 * CROP * CROP * 3                      # the largest bucket
    spatial_table.launches = gather_normalize.launches = 0
    with recording() as lib_spans:
        t0 = time.perf_counter()
        lib_probs = sweeper.sweep_shots(lib, lib_starts, hbm_budget_bytes=3 * shot_bytes + 1)
        lib_s = time.perf_counter() - t0
    lib_launches = spatial_table.launches
    timings, shapes = library_phases(lib_spans)
    shapes = [[list(f), list(c)] for f, c in shapes]
    lib_max = lib_mean = 0.0
    for shot, st, got in zip(lib, lib_starts, lib_probs):
        alone = sweeper.sweep_device(sweeper.upload_shot(shot), st)
        err = np.abs(got - alone)
        lib_max, lib_mean = max(lib_max, float(err.max())), max(lib_mean, float(err.mean()))
    curves = []
    all_p = np.concatenate(lib_probs)
    lib_thr = float(np.quantile(all_p, 0.999))             # a few crossings in the library
    for i, (n, raw_p) in enumerate(zip(lengths, lib_probs)):
        prob = startup_suppression(np.concatenate(
            [np.zeros(SEQ_LEN, np.float32), raw_p[1:-1]]), int(FPS))
        disrupt = i % 2 == 0
        row = types.SimpleNamespace(tipminf=(n - 20) / FPS if disrupt else float("nan"),
                                    tftsrt=0.0, is_disrupt=disrupt)
        curves.append((30000 + i, row, np.arange(len(prob)) / FPS, prob))
    rows, summary = score_alarm_rows(curves, threshold=lib_thr, t_min=1.0)
    lib_ok = (len(lib_probs) == 6 and lib_launches == 6
              and [len(p) for p in lib_probs] == [len(st) for st in lib_starts]
              and bool(np.isfinite(all_p).all())
              and [sh[0][:2] for sh in shapes] == [[3, 1280], [3, 2048]]
              and lib_max <= 5e-2 and lib_mean <= 5e-3
              and summary["n_shots"] == 6 and summary["n_disrupt"] == 3
              and summary["detected"] + summary["missed"] == 3
              and [r["shot"] for r in rows] == [c[0] for c in curves])
    emit("library", shots=lengths, group_shapes=shapes, launches={"spatial_table": lib_launches},
         sweep_s=lib_s, clips_per_s=len(all_p) / lib_s, timings=timings,
         vs_single_shot_max_abs=lib_max, vs_single_shot_mean_abs=lib_mean,
         alarm_threshold=lib_thr, alarm_summary=summary, ok=bool(lib_ok))
    if not lib_ok:
        failures.append("library")

    t0 = time.perf_counter()
    train_ok, train_fields = train_phase(args.seed, frames, cfg, dev)
    emit("train", **train_fields, seconds=time.perf_counter() - t0, ok=train_ok)
    if not train_ok:
        failures.append("train")
    t0 = time.perf_counter()
    cli_ok, cli_fields = train_cli_phase(f"{cli_root}/vivit")
    emit("train_cli", **cli_fields, seconds=time.perf_counter() - t0, ok=cli_ok)
    if not cli_ok:
        failures.append("train_cli")

    # ---- the 0D models: no kernel of K1-K3 runs on these paths ----
    cfgs = zero_d_configs()
    t0 = time.perf_counter()
    ts_ok, ts_fields, bf16_0d, f32_0d = ts_models_phase(args.seed, dev, cfgs)
    emit("ts_models", **ts_fields, seconds=time.perf_counter() - t0, ok=ts_ok)
    t0 = time.perf_counter()
    sw_ok, sw_fields = ts_sweep_phase(args.seed, dev, bf16_0d, f32_0d)
    emit("ts_sweep", **sw_fields, seconds=time.perf_counter() - t0, ok=sw_ok)
    t0 = time.perf_counter()
    st_ok, st_fields = ts_stream_phase(args.seed, dev, bf16_0d["MLSTM_FCN"])
    emit("ts_stream", **st_fields, seconds=time.perf_counter() - t0, ok=st_ok)
    t0 = time.perf_counter()
    tr0_ok, tr0_fields = train_0d_phase(args.seed, dev, cfgs)
    emit("train_0d", **tr0_fields, seconds=time.perf_counter() - t0, ok=tr0_ok)
    hf_ok, hf_fields = hard_fixture_phase(dev)
    emit("hard_fixture_f1", **hf_fields, ok=hf_ok)
    t0 = time.perf_counter()
    cli0_ok, cli0_fields = train_0d_cli_phase(f"{cli_root}/0d")
    emit("train_0d_cli", **cli0_fields, seconds=time.perf_counter() - t0, ok=cli0_ok)
    for name, phase_ok in (("ts_models", ts_ok), ("ts_sweep", sw_ok), ("ts_stream", st_ok),
                           ("train_0d", tr0_ok), ("hard_fixture_f1", hf_ok),
                           ("train_0d_cli", cli0_ok)):
        if not phase_ok:
            failures.append(name)

    # ---- the fusion models at the train_multimodal CLI's widths ----
    t0 = time.perf_counter()
    fm_ok, fm_fields, fusion_bf16 = fusion_models_phase(args.seed, frames_dev, shot_values,
                                                         dev, fusion_cpu)
    emit("fusion_models", **fm_fields, seconds=time.perf_counter() - t0, ok=fm_ok)
    t0 = time.perf_counter()
    ms_ok, ms_fields, k1_multimodal = multimodal_sweep_phase(
        frames, shot_values, dev, {k: fusion_bf16[k] for k in ("concat", "TFN_GB")})
    emit("multimodal_sweep", **ms_fields, seconds=time.perf_counter() - t0, ok=ms_ok)
    del fusion_bf16
    t0 = time.perf_counter()
    tm_ok, tm_fields = train_multimodal_phase(args.seed, frames, shot_values, dev, fusion_cpu)
    emit("train_multimodal", **tm_fields, seconds=time.perf_counter() - t0, ok=tm_ok)
    t0 = time.perf_counter()
    tmc_ok, tmc_fields = train_multimodal_cli_phase(cli_root)
    emit("train_multimodal_cli", **tmc_fields, seconds=time.perf_counter() - t0, ok=tmc_ok)
    for name, phase_ok in (("fusion_models", fm_ok), ("multimodal_sweep", ms_ok),
                           ("train_multimodal", tm_ok), ("train_multimodal_cli", tmc_ok)):
        if not phase_ok:
            failures.append(name)

    # ---- the conv video models: R(2+1)D and SlowFast (K3 on their raw path) ----
    t0 = time.perf_counter()
    cm_ok, cm_fields, conv_cpu, conv_bf16, conv_ops = conv_models_phase(args.seed, frames_dev,
                                                                        dev)
    emit("conv_models", **cm_fields, seconds=time.perf_counter() - t0, ok=cm_ok)
    t0 = time.perf_counter()
    cs_ok, cs_fields, k3_sweep, epi_sweep = conv_sweep_phase(frames, frames_dev, dev, conv_bf16,
                                                             conv_ops)
    emit("conv_sweep", **cs_fields, seconds=time.perf_counter() - t0, ok=cs_ok)
    t0 = time.perf_counter()
    ct_ok, ct_fields, k3_stream, epi_stream = conv_stream_phase(frames, dev, conv_bf16)
    emit("conv_stream", **ct_fields, seconds=time.perf_counter() - t0, ok=ct_ok)
    del conv_bf16
    t0 = time.perf_counter()
    tc_ok, tc_fields = train_conv_phase(args.seed, frames, dev, conv_cpu)
    emit("train_conv", **tc_fields, seconds=time.perf_counter() - t0, ok=tc_ok)
    t0 = time.perf_counter()
    tcc_ok, tcc_fields, k3_cli = train_conv_cli_phase(cli_root)
    emit("train_conv_cli", **tcc_fields, seconds=time.perf_counter() - t0, ok=tcc_ok)
    for name, phase_ok in (("conv_models", cm_ok), ("conv_sweep", cs_ok),
                           ("conv_stream", ct_ok), ("train_conv", tc_ok),
                           ("train_conv_cli", tcc_ok)):
        if not phase_ok:
            failures.append(name)

    # ---- reload, predict, explain and report (the CLI phases' checkpoints) ----
    trained = {"train_cli": cli_fields, "train_0d_cli": cli0_fields,
               "train_multimodal_cli": tmc_fields, "train_conv_cli": tcc_fields}
    t0 = time.perf_counter()
    re_ok, re_fields, k1_reload, k3_reload = reload_eval_phase(cli_root, trained)
    emit("reload_eval", **re_fields, seconds=time.perf_counter() - t0, ok=re_ok)
    t0 = time.perf_counter()
    cp_ok, cp_fields, k1_prediction = continuous_prediction_phase(cli_root, dev)
    emit("continuous_prediction", **cp_fields, seconds=time.perf_counter() - t0, ok=cp_ok)
    # the same CLI in f32: one launch of K1's f32 instance
    t0 = time.perf_counter()
    cp32_ok, cp32_fields, k1_prediction_f32 = continuous_prediction_phase(
        cli_root, dev, ["--compute_dtype", "float32"], "fast_f32_D128")
    emit("continuous_prediction", **cp32_fields, seconds=time.perf_counter() - t0, ok=cp32_ok)
    cp_ok = cp_ok and cp32_ok
    t0 = time.perf_counter()
    xai_ok, xai_fields = xai_phase(args.seed, frames_dev, dev, conv_cpu)
    emit("xai", **xai_fields, seconds=time.perf_counter() - t0, ok=xai_ok)
    t0 = time.perf_counter()
    timing_ok, timing_fields = compute_time_phase(cli_root)
    emit("compute_time", **timing_fields, seconds=time.perf_counter() - t0, ok=timing_ok)
    for name, phase_ok in (("reload_eval", re_ok), ("continuous_prediction", cp_ok),
                           ("xai", xai_ok), ("compute_time", timing_ok)):
        if not phase_ok:
            failures.append(name)

    # ---- the dataset ETL, seed ensembles, hyper-parameter search, mixup ----
    t0 = time.perf_counter()
    etl_ok, etl_fields, k1_etl = etl_phase(args.seed, f"{cli_root}/etl", dev)
    emit("etl", **etl_fields, seconds=time.perf_counter() - t0, ok=etl_ok)
    t0 = time.perf_counter()
    ens_ok, ens_fields, k1_ensemble = ensemble_phase(args.seed, f"{cli_root}/ensemble",
                                                     frames, dev)
    emit("ensemble", **ens_fields, seconds=time.perf_counter() - t0, ok=ens_ok)
    t0 = time.perf_counter()
    hpo_ok, hpo_fields = hpo_phase(cli_root)
    emit("hpo", **hpo_fields, seconds=time.perf_counter() - t0, ok=hpo_ok)
    t0 = time.perf_counter()
    mix_ok, mix_fields = mixup_phase(args.seed, dev)
    emit("mixup", **mix_fields, seconds=time.perf_counter() - t0, ok=mix_ok)
    for name, phase_ok in (("etl", etl_ok), ("ensemble", ens_ok), ("hpo", hpo_ok),
                           ("mixup", mix_ok)):
        if not phase_ok:
            failures.append(name)

    # ---- data parallelism over torch.distributed ----
    t0 = time.perf_counter()
    par_ok, par_fields, k1_parallel = parallel_phase(
        args.seed, f"{cli_root}/parallel", frames, cfg, model, lib, lib_starts, lib_probs,
        3 * shot_bytes + 1, dev)
    emit("parallel", **par_fields, seconds=time.perf_counter() - t0, ok=par_ok)
    if not par_ok:
        failures.append("parallel")

    # ---- what kstar_tpu trained, served and resumed; the scale soaks ----
    t0 = time.perf_counter()
    jc_ok, jc_fields, k1_jax, k3_jax = jax_checkpoint_phase(args.seed, f"{cli_root}/jax_ckpt",
                                                            dev)
    emit("jax_checkpoint", **jc_fields, seconds=time.perf_counter() - t0, ok=jc_ok)
    if not jc_ok:
        failures.append("jax_checkpoint")
    t0 = time.perf_counter()
    soak_ok, soak_fields, k1_soak, k3_soak, soak_check = soak_phase(
        args.seed, f"{cli_root}/soak", dev, TOL["bfloat16"])
    checks.append(soak_check)
    emit("kernel_check", **soak_check)
    emit("soak", **soak_fields, seconds=time.perf_counter() - t0, ok=soak_ok)
    if not soak_ok:
        failures.append("soak")
    if not soak_check["ok"]:
        failures.append(f"spatial_table {soak_check['case']}")

    # ---- the demos and the campaign: K1's fast instance at D 64 / d_head 32 ----
    demo_checks = demo_table_checks(args.seed, frames, dev, TOL["bfloat16"])
    for c in demo_checks:
        checks.append(c)
        emit("kernel_check", **c)
        if not c["ok"]:
            failures.append(f"spatial_table {c['case']}")
    t0 = time.perf_counter()
    dm_ok, dm_fields, k1_demos = demos_phase(f"{cli_root}/demos")
    emit("demos", **dm_fields, seconds=time.perf_counter() - t0, ok=dm_ok)
    t0 = time.perf_counter()
    cg_ok, cg_fields, k1_campaign = campaign_phase(f"{cli_root}/campaign")
    emit("campaign", **cg_fields, seconds=time.perf_counter() - t0, ok=cg_ok)
    for name, phase_ok in (("demos", dm_ok), ("campaign", cg_ok)):
        if not phase_ok:
            failures.append(name)
    cli_dir.cleanup()

    # K3's launches on the main paths: the ViViT stream, and the conv models'
    # sweeps, streams, CLI alarm sweeps and reload sweep, the R(2+1)D alarm
    # sweep from a JAX-format checkpoint and the long shot's stream; the
    # L = 20 row the SlowFast part. K1's: the sweeps above plus the reload
    # and prediction sweeps, the ETL-built shot's sweep, the ViViT ensemble's
    # alarm sweep, the parallel phase's CLI alarm sweep and sharded library
    # sweep, the ViViT alarm sweep from a JAX-format checkpoint and the
    # soaks' sweeps, the demos' and the campaign's alarm sweeps and the
    # full-frame sweeps; the T = 12,600 row the soaks' part, the demo-width
    # rows the demos' and the campaign's, the rows past 80 tokens their
    # full-frame sweep's.
    k3_slowfast = k3_sweep["SlowFast"] + k3_stream["SlowFast"] + k3_reload
    launches["gather_normalize"] += (sum(k3_sweep.values()) + sum(k3_stream.values())
                                     + k3_cli + k3_reload)
    launches["spatial_table"] += (k1_reload + k1_prediction + k1_etl + k1_ensemble
                                  + k1_parallel + k1_jax + k1_soak + k1_demos + k1_campaign
                                  + sum(k1_full.values()) + sum(k1_full32.values()))
    launches["gather_normalize"] += k3_jax + k3_soak
    # the conv epilogue kernel's on the main paths: R(2+1)D's sweeps (and
    # predict_video_shot) and stream blocks
    launches["bn_act"] = sum(epi_sweep.values()) + sum(epi_stream.values())

    kernel_rows = []
    for c in checks:
        entry = {k: c[k] for k in ("name", "route", "source", "replaces")}
        n_launch = {"multimodal_sweep": k1_multimodal, "conv SlowFast": k3_slowfast,
                    "soak": k1_soak, "demos": k1_demos, "campaign": k1_campaign,
                    "f32": k1_f32 + k1_prediction_f32, "f32 attention": k2_f32,
                    **k1_full, **k1_full32}.get(c.get("path"), launches[c["name"]])
        entry.update(launches=n_launch, max_abs_err=c["max_abs_err"],
                     ms=c["ms"], plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
                     bound_by=c["bound_by"], library_ms=c["library_ms"],
                     case=c["case"], max_rel_err=c["max_rel_err"],
                     atol=c["atol"], rtol=c["rtol"], ok=c["ok"], instance=c["instance"])
        for key in ("frames_per_block", "kernel_attributes", "gb_s", "hbm_share"):
            if key in c:
                entry[key] = c[key]
        kernel_rows.append(entry)
    print(json.dumps({"kernels": kernel_rows}), flush=True)
    if failures:
        print(f"chip_smoke: failed: {', '.join(failures)}", file=sys.stderr)
        return 1
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

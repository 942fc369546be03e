"""How cuDNN takes the 0D models' LSTM recurrence.

    python -m kstar_torch.analysis.cudnn_lstm [--batch 256] [--seed 0]

The 0D models run their ``BiLSTM`` through ``torch.lstm`` in f32 whatever
their compute dtype (``models/common.py``). This reads, on the card it runs
on, for CnnLSTM and MLSTM-FCN at their default widths (18 features,
21-sample windows, random weights from --seed):

* the recurrence alone in f32 and in bf16: device ms (CUDA events over 20
  calls), launches and top kernels of one call (torch.profiler), and the
  bf16 output's largest difference from f32;
* the f32 eval forward with the parameters rebound as views of one
  ``TrainState`` flat buffer (the layout cuDNN is handed in training): the
  warnings it raises, its launches and top kernels, and whether its logits
  equal the plain model's bit for bit.

Prints one JSON line per model and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import warnings

import torch


def event_ms(fn, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profiled(fn) -> dict:
    """Launches, device-busy ms and the 3 kernels with the most device time
    of one call of fn()."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and "memcpy" not in e.name.lower() and "memset" not in e.name.lower()]
    by_name = {}
    for e in kernels:
        n, ms = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, ms + e.device_time / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:3]
    return {"launches": len(kernels), "device_busy_ms": sum(e.device_time for e in kernels) / 1e3,
            "top_kernels": [{"kernel": k[:96], "launches": n, "ms": ms} for k, (n, ms) in top]}


def recurrence(lstm, inp: torch.Tensor) -> dict:
    """``lstm``'s recurrence alone on ``inp`` in f32 and in bf16."""
    ndir = 2 if lstm.bidirectional else 1
    out, ref = {}, None
    for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        weights = [w.to(dt) for w in lstm.lstm_weights()]
        h0 = torch.zeros(lstm.n_layers * ndir, inp.shape[0], lstm.hidden, dtype=dt,
                         device=inp.device)
        fwd = torch.no_grad()(lambda: torch.lstm(inp.to(dt), (h0, h0), weights, True,
                                                 lstm.n_layers, 0.0, False,
                                                 lstm.bidirectional, True)[0])
        y = fwd().float()
        ref = y if ref is None else ref
        out[name] = dict(ms=event_ms(fwd), max_abs_vs_f32=float((y - ref).abs().max()),
                         **profiled(fwd))
    out["input"] = list(inp.shape)
    return out


def flat_buffer(model, x: torch.Tensor) -> dict:
    """The eval forward with the parameters as views of a TrainState's flat
    buffer, against the same model as built."""
    from ..config import OptimConfig
    from ..train import create_train_state

    with torch.no_grad():
        want = model(x)
    flat_model = copy.deepcopy(model)
    create_train_state(flat_model, OptimConfig())
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with torch.no_grad():
            got = flat_model(x)
        torch.cuda.synchronize()
    return dict(logits_equal=bool(torch.equal(got, want)),
                warnings=[str(w.message)[:160] for w in caught],
                **profiled(torch.no_grad()(lambda: flat_model(x))))


def main(argv=None) -> int:
    from ..config import CnnLSTMConfig, MLSTMFCNConfig
    from ..models import build_0d_model

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: this probe reads the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    for i, (name, cfg) in enumerate((("CnnLSTM", CnnLSTMConfig()),
                                     ("MLSTM_FCN", MLSTMFCNConfig()))):
        gen = torch.Generator().manual_seed(args.seed * 10 + i)
        model = build_0d_model(name, cfg, generator=gen).to(dev).eval()
        x = torch.randn(args.batch, 21, cfg.n_features, generator=gen).to(dev)
        lstm = model.rnn if hasattr(model, "rnn") else model.lstm
        tokens = x.shape[1] if hasattr(model, "rnn") else model.conv2.weight.shape[0]
        inp = torch.randn(args.batch, tokens, lstm.OptimizedLSTMCell_0.w_ih.shape[1],
                          generator=gen).to(dev)
        print(json.dumps({"model": name, "batch": args.batch,
                          "recurrence": recurrence(lstm, inp),
                          "flat_buffer": flat_buffer(model, x)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

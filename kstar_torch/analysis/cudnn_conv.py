"""How cuDNN takes the conv video models' 3-D convolutions.

    python -m kstar_torch.analysis.cudnn_conv [--seed 0]

R(2+1)D and SlowFast (kstar_torch/config.py's full widths, bf16 over f32
parameters, random weights from --seed) run their convs on channels-last
clips (``models/common.py Conv3d``): ``F.conv3d`` on cuDNN, and a 1x1x1
conv as one GEMM over the channel axis. This reads, on the card it runs
on, for each model at batch 32 and at the sweep's chunk of 128 windows:

* the eval forward's device ms (CUDA events over 5 calls) with
  ``torch.backends.cudnn.benchmark`` off and on, in turns (off, on, off,
  on): whether letting cuDNN time its algorithms at each new shape pays;
* the same forward with the 1x1x1 convs through ``F.conv3d`` instead of
  the GEMM, in turns with the port's path;
* one forward under torch.profiler (benchmark off): launches, device-busy
  ms, and the device ms of the kernels cuDNN runs in the NCHW layout in f32
  (its fallback for a conv whose channel counts its channels-last bf16
  kernels do not take) and of the copies around them;
* the convs whose input or output channels are not a multiple of 8;

and at batch 1 (a streaming step's single window) and 2, each 1x1x1
conv's output through ``F.conv3d`` against the GEMM on the inputs one
forward hands it (the largest difference relative to the output's
largest value, per conv, the worst five), and the logits of the two paths.

Prints one JSON line per model and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch
import torch.nn.functional as F

from .cudnn_lstm import event_ms


def kernel_split(fn) -> dict:
    """Launches and device ms of one call of fn(): in all, in NCHW-layout
    conv kernels, and in copy kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and "memcpy" not in e.name.lower() and "memset" not in e.name.lower()]
    ms = lambda ks: sum(e.device_time for e in ks) / 1e3
    nchw = [e for e in kernels if "nchw" in e.name.lower() and "fprop" in e.name.lower()]
    copies = [e for e in kernels if "copy" in e.name.lower() or "transpose" in e.name.lower()]
    return {"launches": len(kernels), "device_busy_ms": ms(kernels),
            "nchw_conv_launches": len(nchw), "nchw_conv_ms": ms(nchw),
            "copy_launches": len(copies), "copy_ms": ms(copies)}


def pointwise_convs(model) -> list:
    from ..models.common import Conv3d

    return [(name, m) for name, m in model.named_modules()
            if isinstance(m, Conv3d) and m.pointwise]


def odd_convs(model) -> list:
    """(name, in, out) of the k > 1 convs with a channel count that is not
    a multiple of 8."""
    from ..models.common import Conv3d

    return [(name, m.weight.shape[1], m.weight.shape[0]) for name, m in model.named_modules()
            if isinstance(m, Conv3d) and not m.pointwise
            and (m.weight.shape[0] % 8 or m.weight.shape[1] % 8)]


def _as_conv3d(m, x: torch.Tensor) -> torch.Tensor:
    """A 1x1x1 ``Conv3d`` through ``F.conv3d`` on channels-last input."""
    w = m.weight.to(m.dtype, memory_format=torch.channels_last_3d)
    y = F.conv3d(x.to(m.dtype).permute(0, 4, 1, 2, 3), w,
                 stride=m.stride).permute(0, 2, 3, 4, 1)
    return y if m.bias is None else y + m.bias.to(m.dtype)


def set_pointwise_conv3d(model, on: bool) -> None:
    """Run the model's 1x1x1 convs through ``F.conv3d`` (``on``) or as the
    port runs them, as one GEMM."""
    for _, m in pointwise_convs(model):
        if on:
            m.forward = _as_conv3d.__get__(m)
        else:
            m.__dict__.pop("forward", None)


@torch.no_grad()
def pointwise_agreement(model, x: torch.Tensor) -> dict:
    """Each 1x1x1 conv through ``F.conv3d`` against the GEMM on the input
    the GEMM forward hands it, and the logits of the two paths."""
    inputs = {}

    def keep(name):
        def hook(mod, args, out):
            inputs.setdefault(name, args[0])
        return hook

    hooks = [m.register_forward_hook(keep(name)) for name, m in pointwise_convs(model)]
    logits_gemm = model(x)
    for h in hooks:
        h.remove()
    errs = []
    for name, m in pointwise_convs(model):
        want = m(inputs[name]).float()
        got = _as_conv3d(m, inputs[name]).float()
        errs.append((float((got - want).abs().max() / want.abs().max().clamp_min(1e-30)),
                     name, list(inputs[name].shape)))
    set_pointwise_conv3d(model, True)
    logits_conv3d = model(x)
    set_pointwise_conv3d(model, False)
    return {"worst_pointwise_rel": sorted(errs, reverse=True)[:5],
            "logits_max_abs": float((logits_conv3d - logits_gemm).abs().max())}


def main(argv=None) -> int:
    from ..config import PIXEL_MEAN_BGR, R2Plus1DConfig, SlowFastConfig
    from ..models import build_video_model

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: this probe reads the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    mean = torch.tensor(PIXEL_MEAN_BGR, dtype=torch.bfloat16, device=dev)
    for i, (name, cfg) in enumerate((("R2Plus1D", R2Plus1DConfig()),
                                     ("SlowFast", SlowFastConfig()))):
        gen = torch.Generator().manual_seed(args.seed * 10 + i)
        model = build_video_model(name, cfg, dtype=torch.bfloat16,
                                  generator=gen).to(dev).eval()
        clips = lambda batch: torch.randint(
            0, 256, (batch, cfg.n_frames, cfg.image_size, cfg.image_size, 3),
            dtype=torch.uint8, generator=gen).to(dev).to(torch.bfloat16) - mean
        out = {"model": name, "frames": cfg.n_frames, "odd_channel_convs": odd_convs(model)}
        for batch in (1, 2):
            out[f"pointwise_batch_{batch}"] = pointwise_agreement(model, clips(batch))
        for batch in (32, 128):
            x = clips(batch)
            fwd = torch.no_grad()(lambda: model(x))
            runs = {"off": [], "on": []}
            for bench in (False, True, False, True):
                torch.backends.cudnn.benchmark = bench
                runs["on" if bench else "off"].append(event_ms(fwd, 5))
            torch.backends.cudnn.benchmark = False
            pointwise = {"gemm": [], "conv3d": []}
            for conv3d in (False, True, True, False):
                set_pointwise_conv3d(model, conv3d)
                pointwise["conv3d" if conv3d else "gemm"].append(event_ms(fwd, 5))
            out[f"batch_{batch}"] = {"ms_benchmark_off": runs["off"],
                                     "ms_benchmark_on": runs["on"],
                                     "ms_1x1x1_as_gemm": pointwise["gemm"],
                                     "ms_1x1x1_as_conv3d": pointwise["conv3d"],
                                     **kernel_split(fwd)}
        print(json.dumps(out), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The conv epilogue (``kstar_torch/ops/bn_act.py``): BatchNorm in evaluation,
LeakyReLU and the cast to bf16 of a conv output, with the residual blocks'
join, in one pass.

On the CPU: the plain version equals the eager chain it replaces bit for bit
at every R(2+1)D channel count; R(2+1)D routes its 32 epilogues through
``common.bn_leaky_relu``, whose choice of the one-pass route keeps the
BatchNorms' forward pre-hooks (``calibrate_bn``) and leaves training, grad,
guided backprop, f32 and post-hooked BatchNorms on the eager chain; the
sweep's chunk spans carry the counts that ``conv_epilogue_fused_share``
reads.

``cuda``-marked, on the GPU (``python -m pytest -m cuda
tests/test_torch_bn_act.py``): the kernel against the plain version bit for
bit, and a whole bf16 R(2+1)D forward on it against the eager forward.
"""

import types

import numpy as np
import pytest
import torch

from kstar_torch.config import R2Plus1DConfig
from kstar_torch.infer.continuous import VideoSweeper, chunkify_starts
from kstar_torch.models import build_video_model
from kstar_torch.models import common
from kstar_torch.models.common import BN_EPS, BatchNorm, act_leaky_relu
from kstar_torch.ops import bn_act as ops
from kstar_torch.utils import profiling

# every channel count of R(2+1)D's conv outputs at the reference's defaults
CHANNELS = [21, 32, 42, 45, 64, 72, 115, 128, 144, 230, 288]
ALPHA = 0.01
N_EPILOGUES = 32            # conv outputs of one R(2+1)D forward at (1, 2, 2, 1)


def _bn(c: int, g: torch.Generator) -> BatchNorm:
    bn = BatchNorm(c)
    bn.weight.data = torch.randn(c, generator=g) * 0.5 + 1
    bn.bias.data = torch.randn(c, generator=g) * 0.3
    bn.running_mean.copy_(torch.randn(c, generator=g) * 2)
    bn.running_var.copy_(torch.rand(c, generator=g) * 4 + 0.05)
    return bn.eval()


def _eager(bn, x, residual=None):
    """The chain the epilogue replaces, as R(2+1)D ran it before."""
    y = act_leaky_relu(bn(x), ALPHA).to(torch.bfloat16)
    return y if residual is None else act_leaky_relu(residual + y, ALPHA).to(y.dtype)


def _case(c: int, shape=(2, 3, 5, 7), seed=0, device="cpu"):
    """A BatchNorm of ``c`` channels and bf16 (…, c) input and residual with
    values on both sides of 0 and of the rounding boundaries."""
    g = torch.Generator().manual_seed(seed + c)
    bn = _bn(c, g)
    x = (torch.randn(*shape, c, generator=g) * 3).to(torch.bfloat16)
    r = (torch.randn(*shape, c, generator=g) * 2).to(torch.bfloat16)
    return bn.to(device), x.to(device), r.to(device)


def _mul(bn):
    return torch.rsqrt(bn.running_var + BN_EPS) * bn.weight


@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize("c", CHANNELS)
def test_reference_equals_the_eager_chain(c, residual):
    bn, x, r = _case(c)
    r = r if residual else None
    with torch.no_grad():
        want = _eager(bn, x, r)
        got = ops.bn_act_reference(x, bn.running_mean, _mul(bn), bn.bias, ALPHA,
                                   torch.bfloat16, r)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_batchnorm_without_epilogue_arguments_is_unchanged():
    """No ``alpha``: the f32 normalised input, as every other caller has it;
    the epilogue is for evaluation only, and the kernel's alone: it has no
    CPU version."""
    bn, x, _ = _case(45)
    with torch.no_grad():
        want = (x.float() - bn.running_mean) * _mul(bn) + bn.bias
        assert torch.equal(bn(x), want) and bn(x).dtype == torch.float32
        with pytest.raises(ValueError, match="not supported"):
            bn(x, alpha=ALPHA, out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="evaluation"):
        bn(x, True, alpha=ALPHA, out_dtype=torch.bfloat16)


def _r2plus1d(dtype=torch.bfloat16, seed=0):
    cfg = R2Plus1DConfig(image_size=32, n_frames=5, layer_sizes=(1, 2, 2, 1))
    torch.manual_seed(seed)
    model = build_video_model("R2Plus1D", cfg, dtype=dtype)
    g = torch.Generator().manual_seed(seed)
    clips = torch.randint(0, 256, (2, 5, 32, 32, 3), generator=g).float() - 128
    return model.eval(), clips


def _forward_counts(model, clips, train=False):
    fused, eager = ops.bn_act.fused, ops.bn_act.eager
    out = model(clips, train)
    return out, ops.bn_act.fused - fused, ops.bn_act.eager - eager


def test_every_r2plus1d_epilogue_goes_through_the_chooser():
    """32 epilogues a forward, on the CPU all eager; the pre-hook of every
    backbone BatchNorm sees its conv's raw output."""
    model, clips = _r2plus1d()
    seen, raw = {}, {}
    hooks = []
    for name, m in model.named_modules():
        if isinstance(m, BatchNorm) and name.startswith("backbone"):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, args, name=name: seen.__setitem__(name, args[0])))
        if name.endswith("Conv_0"):
            hooks.append(m.register_forward_hook(
                lambda mod, args, out, name=name: raw.__setitem__(
                    name.replace("Conv_0", "BatchNorm_0"), out)))
    with torch.no_grad():
        _, fused, eager = _forward_counts(model, clips)
    for h in hooks:
        h.remove()
    assert (fused, eager) == (0, N_EPILOGUES)
    assert len(seen) == N_EPILOGUES and seen.keys() == raw.keys()
    assert all(torch.equal(seen[k], raw[k]) for k in seen)


def test_calibrate_bn_sets_each_batchnorm_to_its_conv_output_statistics():
    from benchmark.core.program import calibrate_bn

    model, clips = _r2plus1d()
    raw = {}
    hooks = [m.register_forward_hook(lambda mod, args, out, name=name: raw.__setitem__(
        name.replace("Conv_0", "BatchNorm_0"), out.float()))
        for name, m in model.named_modules() if name.endswith("Conv_0")]
    calibrate_bn(model, clips)
    for h in hooks:
        h.remove()
    mods = dict(model.named_modules())
    for name, out in raw.items():
        axes = tuple(range(out.dim() - 1))
        assert torch.equal(mods[name].running_mean, out.mean(axes))
        assert torch.equal(mods[name].running_var, out.var(axes, unbiased=False))


def _takes_anywhere(x, residual=None, out_dtype=torch.bfloat16, params=()):
    """``takes`` without its device test, so that the CPU shows the
    chooser's other conditions."""
    tensors = (x, *params) if residual is None else (x, residual, *params)
    return (out_dtype == torch.bfloat16 and x.dtype == torch.bfloat16
            and (residual is None or residual.dtype == torch.bfloat16)
            and not (torch.is_grad_enabled() and any(t.requires_grad for t in tensors)))


def _plain_launch(x, residual, out, vecs, alpha):
    """The kernel's launch, done by the plain version on the CPU."""
    out.copy_(ops.bn_act_reference(x, *vecs, alpha, out.dtype, residual))


EAGER_CASES = ["train", "grad", "guided", "f32", "post_hook"]


@pytest.mark.parametrize("case", ["fused"] + EAGER_CASES)
def test_the_chooser_keeps_the_eager_chain_where_the_kernel_cannot_serve(monkeypatch, case):
    """With the device test lifted, a bf16 evaluation forward without grad
    calls every BatchNorm with the epilogue's arguments (the one-pass route,
    its launch run here by the plain version), counted in ``bn_act.fused``,
    and gives the eager forward's logits;
    training, grad mode with parameters requiring grad, guided backprop, an
    f32 model each take the eager chain, counted in ``bn_act.eager``, 32 a
    forward, and a BatchNorm with a forward hook takes it alone."""
    model, clips = _r2plus1d(torch.float32 if case == "f32" else torch.bfloat16)
    with torch.no_grad():
        want = model(clips)
    monkeypatch.setattr(ops, "takes", _takes_anywhere)
    monkeypatch.setattr(ops, "_launch", _plain_launch)
    routed = []
    bns = [m for n, m in model.named_modules() if isinstance(m, BatchNorm)
           and n.startswith("backbone")]
    for m in bns:
        m.register_forward_pre_hook(
            lambda mod, args, kwargs: routed.append("alpha" in kwargs), with_kwargs=True)
    if case == "post_hook":
        outs = []
        bns[3].register_forward_hook(lambda mod, args, out: outs.append(out.dtype))
    if case == "guided":
        monkeypatch.setattr(common, "GUIDED_BACKPROP", [True])
    with torch.set_grad_enabled(case == "grad"):
        _, fused, eager = _forward_counts(model, clips, train=case == "train")
        got = model(clips, case == "train")
    assert len(routed) == 2 * N_EPILOGUES
    if case == "fused":
        assert all(routed) and (fused, eager) == (N_EPILOGUES, 0) and torch.equal(got, want)
        return
    if case == "post_hook":
        # the hooked BatchNorm alone takes the eager chain and sees f32
        assert (fused, eager) == (N_EPILOGUES - 1, 1) and torch.equal(got, want)
        assert sum(not r for r in routed) == 2 and outs == [torch.float32] * 2
    else:
        assert (fused, eager) == (0, N_EPILOGUES) and not any(routed)


@pytest.mark.parametrize("layout", ["strided", "misaligned"])
def test_the_chooser_gives_the_kernel_every_layout_or_raises(monkeypatch, layout):
    """A layout is no reason for the eager chain: with the device test
    lifted, a strided conv output and residual reach the kernel as
    contiguous copies (one fused epilogue, the eager chain's result); a
    contiguous view the kernel cannot take, 16-byte misaligned, raises."""
    monkeypatch.setattr(ops, "takes", _takes_anywhere)
    monkeypatch.setattr(ops, "_launch", _plain_launch)
    bn, x, r = _case(44, (2, 3, 5, 8))
    fused, eager = ops.bn_act.fused, ops.bn_act.eager
    with torch.no_grad():
        if layout == "misaligned":
            flat = torch.cat([x.new_zeros(1), x.reshape(-1)])
            with pytest.raises(ValueError, match="not supported"):
                common.bn_leaky_relu(bn, flat[1:].view(x.shape), False, ALPHA, torch.bfloat16)
            assert (ops.bn_act.fused, ops.bn_act.eager) == (fused, eager)
            return
        strided, r_strided = x.transpose(1, 2), r.transpose(1, 2)
        got = common.bn_leaky_relu(bn, strided, False, ALPHA, torch.bfloat16, r_strided)
        want = _eager(bn, strided, r_strided)
    assert (ops.bn_act.fused - fused, ops.bn_act.eager - eager) == (1, 0)
    assert torch.equal(got, want)


def test_conv_sweep_chunks_carry_their_epilogues():
    """Each raw-frame ``sweep.chunk`` span carries the epilogues its forward
    ran (32) and how many were fused (0 on the CPU); the metric reads their
    share."""
    model, _ = _r2plus1d(torch.float32)
    sweeper = VideoSweeper(model, 5, 32, 4, torch.float32, device="cpu")
    frames = torch.randint(0, 256, (15, 32, 32, 3), dtype=torch.uint8).numpy()
    starts = np.arange(len(frames) - 6)
    with profiling.recording() as rec:
        sweeper.sweep_table(sweeper.embed_all(torch.from_numpy(frames)), starts)
    chunks = [s for s in rec if s.name == "sweep.chunk"]
    assert len(chunks) == len(chunkify_starts(starts, 4))
    assert all(s.attrs["epilogues"] == N_EPILOGUES and s.attrs["fused_epilogues"] == 0
               for s in chunks)


def _metric_run(monkeypatch, records):
    monkeypatch.setattr(profiling, "spans",
                        lambda name=None: [s for s in records if name in (None, s.name)])
    return types.SimpleNamespace(trace=types.SimpleNamespace(window=(0, 1000)))


def _span(start, end, name, **attrs):
    return profiling.SpanRecord(start, end, name, None, attrs)


def test_fused_share_metric_reads_the_chunk_spans(monkeypatch):
    from benchmark.core.spec import Bench

    read = Bench().metric("conv_epilogue_fused_share").read
    run = _metric_run(monkeypatch, [
        _span(0, 100, "sweep.chunk", shot=1, epilogues=32, fused_epilogues=32),
        _span(100, 200, "sweep.chunk", shot=1, epilogues=32, fused_epilogues=0),
        _span(200, 300, "sweep.chunk", shot=1),                     # a graphed chunk
        _span(900, 1100, "sweep.chunk", shot=2, epilogues=32, fused_epilogues=0)])
    assert read(run) == pytest.approx(50.0)
    # silent without the counters (the parent's program, the ViViT cells)
    assert read(_metric_run(monkeypatch, [_span(0, 100, "sweep.chunk", shot=1)])) is None
    assert read(types.SimpleNamespace(trace=None)) is None


# ---------------------------------------------------------------- on the GPU


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


def _kernel_vs_plain(dev, c, shape, residual, seed=0):
    bn, x, r = _case(c, shape, seed, dev)
    r = r if residual else None
    with torch.no_grad():
        mul = _mul(bn)
        before = ops.bn_act.fused
        got = ops.bn_act(x, bn.running_mean, mul, bn.bias, ALPHA, torch.bfloat16, r)
        torch.cuda.synchronize()
        assert ops.bn_act.fused == before + 1
        want = ops.bn_act_reference(x, bn.running_mean, mul, bn.bias, ALPHA, torch.bfloat16, r)
        eager = _eager(bn, x, r)
    assert torch.equal(want, eager)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize("c", CHANNELS)
def test_kernel_equals_plain_bit_for_bit(dev, c, residual):
    """Below a wave (one vector a thread) and past it (the grid's stride
    keeps each thread's channels)."""
    _kernel_vs_plain(dev, c, (2, 3, 5, 7), residual)
    _kernel_vs_plain(dev, c, (64, 21, 16, 16), residual)


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize("shape", [(1,), (3,), (1, 1, 9), (5, 1, 13), (1001,)],
                         ids=["1", "3", "9", "65", "1001"])
@pytest.mark.parametrize("c", [1, 3, 21, 45])
def test_kernel_on_totals_that_are_no_multiple_of_8(dev, c, shape, residual):
    _kernel_vs_plain(dev, c, shape, residual)


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take_and_the_chooser_copies_a_strided_input(dev):
    """The kernel raises for a strided, f32 or misaligned input; the chooser
    hands it a strided conv output and residual made contiguous (one fused
    epilogue, equal to the eager chain), and a misaligned one raises there
    too: no quiet eager chain for a layout."""
    bn, x, r = _case(45, (2, 3, 5, 8), device=dev)
    strided = x.transpose(1, 2)
    with torch.no_grad():
        mul = _mul(bn)
        with pytest.raises(ValueError, match="not supported"):
            ops.bn_act(strided, bn.running_mean, mul, bn.bias, ALPHA, torch.bfloat16)
        with pytest.raises(ValueError, match="not supported"):
            ops.bn_act(x.float(), bn.running_mean, mul, bn.bias, ALPHA, torch.bfloat16)
        unaligned = x.reshape(-1)[1:1 + x.numel() // 45 * 44].view(x.shape[:-1] + (44,))
        with pytest.raises(ValueError, match="not supported"):
            ops.bn_act(unaligned, bn.running_mean[:44], mul[:44], bn.bias[:44], ALPHA,
                       torch.bfloat16)
        with pytest.raises(ValueError, match="not supported"):
            ops.bn_act(x.cpu(), bn.running_mean, mul, bn.bias, ALPHA, torch.bfloat16)
        bn44 = _bn(44, torch.Generator().manual_seed(1)).to(dev)
        fused, eager = ops.bn_act.fused, ops.bn_act.eager
        got = common.bn_leaky_relu(bn, strided, False, ALPHA, torch.bfloat16,
                                   r.transpose(1, 2))
        assert (ops.bn_act.fused - fused, ops.bn_act.eager - eager) == (1, 0)
        assert torch.equal(got, _eager(bn, strided, r.transpose(1, 2)))
        with pytest.raises(ValueError, match="not supported"):
            common.bn_leaky_relu(bn44, unaligned, False, ALPHA, torch.bfloat16)


def _gpu_r2plus1d(dev, batch, seed=0):
    """R(2+1)D at 128 px and 21 frames, bf16, its BatchNorms calibrated on
    the clips (benchmark/core/program.py calibrate_bn)."""
    from benchmark.core.program import calibrate_bn

    torch.manual_seed(seed)
    model = build_video_model("R2Plus1D", R2Plus1DConfig(), dtype=torch.bfloat16).to(dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    clips = (torch.randint(0, 256, (batch, 21, 128, 128, 3), generator=g, device=dev).float()
             - 128).to(torch.bfloat16)
    calibrate_bn(model, clips)
    return model.eval(), clips


def _no_fusion(monkeypatch):
    monkeypatch.setattr(ops, "takes", lambda *a, **k: False)


@pytest.mark.cuda
def test_r2plus1d_forward_on_the_kernel_equals_the_eager_forward(dev, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    model, clips = _gpu_r2plus1d(dev, 6)
    with torch.no_grad():
        got, fused, eager = _forward_counts(model, clips)
        again, *_ = _forward_counts(model, clips)
        assert (fused, eager) == (N_EPILOGUES, 0)
        _no_fusion(monkeypatch)
        want, fused, eager = _forward_counts(model, clips)
        assert (fused, eager) == (0, N_EPILOGUES)
    assert torch.equal(got, again)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_calibrate_bn_gives_the_same_statistics_on_both_paths(dev, monkeypatch):
    def stats(model):
        return {k: v.clone() for k, v in model.state_dict().items() if "running" in k}

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    fused, _ = _gpu_r2plus1d(dev, 4, seed=1)
    _no_fusion(monkeypatch)
    eager, _ = _gpu_r2plus1d(dev, 4, seed=1)
    a, b = stats(fused), stats(eager)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.cuda
@pytest.mark.parametrize("case", EAGER_CASES)
def test_gpu_chooser_takes_the_eager_chain(dev, monkeypatch, case):
    cfg = R2Plus1DConfig(image_size=32, n_frames=5, layer_sizes=(1, 2, 2, 1))
    torch.manual_seed(0)
    model = build_video_model("R2Plus1D", cfg, dtype=torch.float32 if case == "f32"
                              else torch.bfloat16).to(dev).eval()
    clips = torch.randn(2, 5, 32, 32, 3, device=dev) * 50
    if case == "post_hook":
        model.backbone.conv1.spatial.BatchNorm_0.register_forward_hook(lambda *a: None)
    if case == "guided":
        monkeypatch.setattr(common, "GUIDED_BACKPROP", [True])
    with torch.set_grad_enabled(case == "grad"):
        _, fused, eager = _forward_counts(model, clips, train=case == "train")
    if case == "post_hook":
        assert (fused, eager) == (N_EPILOGUES - 1, 1)
    else:
        assert (fused, eager) == (0, N_EPILOGUES)

"""kstar_torch.utils on the CPU: parameter counts equal to kstar_tpu's
``param_count`` for each of the model_summary CLI's eight choices at small
widths (BatchNorm statistics are buffers in the port and ``batch_stats`` in
JAX, so neither counts them), the summary table's total, the module graph,
the profiler trace and the memory statistics."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kstar_torch.config as tconfig
from kstar_torch.models import TFN as TTFN
from kstar_torch.models import MultiModalConcat as TMultiModalConcat
from kstar_torch.models import build_0d_model, build_video_model
from kstar_torch.utils import (device_memory_stats, model_summary, param_count,
                               profile_trace, render_model_graph)
from kstar_torch.utils.profiling import span
from kstar_tpu import config as jconfig
from kstar_tpu.models import TFN, MultiModalConcat
from kstar_tpu.models import build_0d_model as j_build_0d_model
from kstar_tpu.models import build_video_model as j_build_video_model
from kstar_tpu.utils.summary import param_count as j_param_count

L, T0D, H, F = 8, 21, 32, 18
VIVIT_KW = dict(image_size=H, patch_size=8, n_frames=L, dim=32, depth=1, n_heads=2,
                d_head=16, scale_dim=2)
TS_KW = dict(n_features=F, feature_dims=16, max_len=L, n_layers=1, n_heads=2,
             dim_feedforward=32)
CONFIGS = {
    "ViViT": ("ViViTConfig", VIVIT_KW),
    "R2Plus1D": ("R2Plus1DConfig", dict(image_size=H, n_frames=L, layer_sizes=(1, 1, 1, 1))),
    "SlowFast": ("SlowFastConfig", dict(image_size=H, n_frames=L, layers=(1, 1, 1, 1))),
    "Transformer": ("TransformerConfig", dict(n_features=F, max_len=T0D, feature_dims=16,
                                              n_layers=1, n_heads=2, dim_feedforward=32,
                                              cls_dims=16)),
    "CnnLSTM": ("CnnLSTMConfig", dict(seq_len=T0D, n_features=F, conv_dim=8, lstm_dim=8,
                                      n_layers=1)),
    "MLSTM_FCN": ("MLSTMFCNConfig", dict(seq_len=T0D, n_features=F, fcn_dim=16, lstm_dim=8)),
}


def _pair(name):
    """(JAX parameter count from the shapes of ``init``, the port model, its
    sample inputs)."""
    if name in ("concat", "TFN"):
        jm = (MultiModalConcat if name == "concat" else TFN)(
            vivit_kwargs=dict(VIVIT_KW), ts_kwargs=dict(TS_KW))
        tm = (TMultiModalConcat if name == "concat" else TTFN)(dict(VIVIT_KW), dict(TS_KW))
        sample = (np.zeros((1, L, H, H, 3), np.float32), np.zeros((1, L, F), np.float32))
    else:
        cls, kw = CONFIGS[name]
        video = name in ("ViViT", "R2Plus1D", "SlowFast")
        build, j_build = ((build_video_model, j_build_video_model) if video
                          else (build_0d_model, j_build_0d_model))
        jm = j_build(name, getattr(jconfig, cls)(**kw))
        tm = build(name, getattr(tconfig, cls)(**kw))
        sample = ((np.zeros((1, L, H, H, 3), np.float32),) if video
                  else (np.zeros((1, T0D, F), np.float32),))
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(0), "noise": jax.random.key(1),
         "dropout": jax.random.key(2)}, *map(jnp.asarray, sample), train=False))
    return j_param_count(shapes["params"]), tm, tuple(map(torch.from_numpy, sample))


@pytest.mark.parametrize("name", list(CONFIGS) + ["concat", "TFN"])
def test_param_count_and_summary_total_match_jax(name):
    want, tm, sample = _pair(name)
    assert param_count(tm) == want
    text = model_summary(tm, *sample, depth=2)
    assert f"Total Parameters: {want:,}" in text
    assert text.splitlines()[0] == f"{type(tm).__name__} Summary"
    assert "(root)" in text and "float32[1, 2]" in text


def test_render_model_graph_writes_its_png(tmp_path):
    _, tm, _ = _pair("MLSTM_FCN")
    out = render_model_graph(tm, save_path=str(tmp_path / "graph.png"), depth=2)
    assert out == str(tmp_path / "graph.png") and (tmp_path / "graph.png").stat().st_size > 0


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with span("before"):                # no session: not recorded
        pass
    with profile_trace(str(tmp_path / "trace")):
        with span("sweep.windows", shot=3):
            torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    events = trace["traceEvents"]
    assert any("mm" in ev.get("name", "") for ev in events)
    # the program's span, on the trace's time base, around the op it holds
    (sp,) = [ev for ev in events if ev.get("cat") == "kstar_torch"]
    assert sp["name"] == "sweep.windows" and sp["args"]["shot"] == "3"
    assert not any(ev.get("name") == "before" for ev in events)
    (mm,) = [ev for ev in events if ev.get("name") == "aten::mm"]
    assert sp["ts"] <= mm["ts"] and mm["ts"] + mm["dur"] <= sp["ts"] + sp["dur"]


def test_device_memory_stats_is_none_on_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: its statistics would be returned")
    assert device_memory_stats() is None

"""XAI: Grad-CAM and guided backprop for the conv video models, attention
rollout for ViViT.

Port of ``kstar_tpu/viz/xai.py`` (rebuilds of reference
src/visualization/visualize_cam.py and visualize_attention.py):

  * Grad-CAM — the conv5 stage output of R(2+1)D is computed by running the
    backbone's stages, and the gradient of the class score with respect to
    it comes from ``torch.autograd.grad`` over pool -> head, everything
    after conv5 (as JAX's ``score`` does, ``kstar_tpu/viz/xai.py:50-54``).
    Weights are the time+space-averaged gradients; the CAM is the ReLU of
    the weighted activation sum, bilinearly upsampled (half-pixel centres,
    ``align_corners=False``, as ``jax.image.resize``) and normalised by each
    clip's maximum.
  * Guided backprop — inside ``guided_backprop()`` the conv stacks'
    activations (``models.common.act_leaky_relu`` / ``act_relu``) pass the
    gradient only where input and gradient are both positive.
  * Attention rollout — ViViT's ``MHSA`` appends its softmax map to a
    capture list for one forward, and rollout multiplies (A + I)/2 across
    layers with top-k discard masking (reference spatio/temporal_rollout
    :70-135).

Every function puts the model in evaluation mode (no running statistic
moves) and on the GPU unless ``device="cpu"`` is given (the module is moved
there, as ``infer.latency.measure_model`` moves it), and returns numpy
arrays.
"""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device


def _on_device(model, video, device):
    device = resolve_device(device)
    model = model.to(device).eval()
    if not isinstance(video, torch.Tensor):
        video = torch.from_numpy(np.asarray(video, np.float32))
    return model, video.to(device, torch.float32)


# ---------------------------------------------------------------------------
# Grad-CAM (R2Plus1D)
# ---------------------------------------------------------------------------

def gradcam_r2plus1d(model, video, target_class: int = 0, device=None) -> np.ndarray:
    """CAM heatmaps for a batch of clips.

    video: (B, T, H, W, C) float input. Returns (B, T', H, W) heatmaps in
    [0, 1] upsampled to the input's spatial size."""
    model, x = _on_device(model, video, device)
    bb = model.backbone
    with torch.no_grad():
        acts = x.to(bb.dtype)
        for stage in (bb.conv1, bb.conv2, bb.conv3, bb.conv4, bb.conv5):
            acts = stage(acts)                                  # (B, T', H', W', C')
    acts.requires_grad_(True)
    with torch.enable_grad():
        logits = model.head(acts.mean(dim=(1, 2, 3)).float())
        (grads,) = torch.autograd.grad(logits[:, target_class].sum(), acts)

    with torch.no_grad():
        # weights: gradients averaged over time and space (reference :85-90)
        w = grads.mean(dim=(1, 2, 3), keepdim=True)             # (B,1,1,1,C')
        cam = torch.clamp((w * acts).sum(dim=-1), min=0.0)      # (B, T', H', W')
        H, W = x.shape[2], x.shape[3]
        cam = F.interpolate(cam.float(), size=(H, W), mode="bilinear",
                            align_corners=False)
    cam = cam.cpu().numpy()
    mx = cam.reshape(cam.shape[0], -1).max(axis=1)[:, None, None, None]
    return cam / np.maximum(mx, 1e-8)


def overlay_cam(frame_u8: np.ndarray, cam: np.ndarray, alpha: float = 0.4) -> np.ndarray:
    """JET-style heatmap overlay on a BGR frame (reference :100-116)."""
    import matplotlib.cm as cm

    heat = (cm.jet(np.clip(cam, 0, 1))[..., :3] * 255).astype(np.uint8)[..., ::-1]
    return np.clip((1 - alpha) * frame_u8 + alpha * heat, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Attention rollout (ViViT)
# ---------------------------------------------------------------------------

def collect_attention(model, video, which: str = "space", device=None) -> list:
    """Run ViViT once, capturing the attention maps of the chosen
    transformer.

    Returns a list of (B', heads, N, N) f32 arrays, one per depth layer in
    the order of the layer index ``attn_0, attn_1, ...`` (the numeric order
    JAX's sort restores), where B' = B*T for the spatial transformer and B
    for the temporal one."""
    model, x = _on_device(model, video, device)
    enc = model.encoder
    name = "space_transformer" if which == "space" else "temporal_transformer"
    transformer = getattr(enc, name)
    layers = [getattr(transformer, f"attn_{i}") for i in range(transformer.depth)]
    if any(m.use_pallas for m in layers):
        raise ValueError(
            "no sown attention maps found — attention rollout needs the "
            "einsum attention path (the fused Pallas attention never "
            "materializes the attention matrix); rebuild the model with "
            "use_pallas=False for XAI")
    captures = [[] for _ in layers]
    try:
        for m, cap in zip(layers, captures):
            m.capture = cap
        with torch.no_grad():
            model(x)
    finally:
        for m in layers:
            m.capture = None
    return [cap[0].float().cpu().numpy() for cap in captures]


def rollout(attentions, discard_ratio: float = 0.9, head_fusion: str = "mean") -> np.ndarray:
    """Multiply (A + I)/2 across layers with per-layer top-k discard
    (reference spatio_rollout/temporal_rollout :70-135). attentions:
    list of (B, H, N, N). Returns (B, N) cls-token attention per batch."""
    B, _, N, _ = attentions[0].shape
    result = np.broadcast_to(np.eye(N, dtype=np.float32), (B, N, N)).copy()
    for attn in attentions:
        if head_fusion == "max":
            fused = attn.max(axis=1)
        elif head_fusion == "min":
            fused = attn.min(axis=1)
        else:
            fused = attn.mean(axis=1)                      # (B, N, N)
        flat = fused.reshape(B, -1)
        k = int(flat.shape[1] * discard_ratio)
        if k > 0:
            thresh = np.partition(flat, k - 1, axis=1)[:, k - 1][:, None, None]
            keep = fused >= thresh
            # never discard the cls column
            keep[:, :, 0] = True
            fused = fused * keep
        a = (fused + np.eye(N, dtype=np.float32)) / 2.0
        a = a / np.maximum(a.sum(axis=-1, keepdims=True), 1e-8)
        result = np.einsum("bij,bjk->bik", a, result)
    mask = result[:, 0, 1:]                                # cls -> patches
    return mask / np.maximum(mask.max(axis=1, keepdims=True), 1e-8)


@contextmanager
def guided_backprop():
    """Within this context the conv stacks' activations
    (``models.common.act_leaky_relu`` / ``act_relu``: R(2+1)D's LeakyReLUs
    and the 3D-ResNet/SlowFast ReLUs) use the guided-backprop backward
    (reference GuidedBackpropReLU, visualize_cam.py:21-54): gradient flows
    only where input > 0 AND upstream grad > 0. The switch is restored on
    exit, also when the body raises. It is read when a forward runs, so
    the backward of a graph recorded inside the context keeps the guided
    rule; not thread-safe (one switch per process)."""
    from ..models import common

    before = common.GUIDED_BACKPROP[0]
    common.GUIDED_BACKPROP[0] = True
    try:
        yield
    finally:
        common.GUIDED_BACKPROP[0] = before


def guided_backprop_saliency(model, video, target_class: int = 0,
                             device=None) -> np.ndarray:
    """Input-space guided-backprop saliency for a conv video model
    (R2Plus1D / SlowFast): |d score / d input| with the guided rule, maxed
    over channels and normalized per clip. video: (B, T, H, W, C) float.
    Returns (B, T, H, W) in [0, 1]."""
    model, x = _on_device(model, video, device)
    x.requires_grad_(True)
    with guided_backprop(), torch.enable_grad():
        logits = model(x)
        (g,) = torch.autograd.grad(logits[:, target_class].sum(), x)
    sal = g.float().abs().amax(dim=-1).cpu().numpy()
    mx = sal.reshape(sal.shape[0], -1).max(axis=1)[:, None, None, None]
    return sal / np.maximum(mx, 1e-8)


def vivit_attention_rollout(model, video, which: str = "space",
                            discard_ratio: float = 0.9, head_fusion: str = "mean",
                            device=None) -> np.ndarray:
    """End-to-end rollout.

    which='space': returns (B, T, h, w) per-frame patch heatmaps.
    which='temporal': returns (B, T) per-frame importances."""
    attns = collect_attention(model, video, which, device)
    mask = rollout(attns, discard_ratio, head_fusion)
    B, T = video.shape[0], video.shape[1]
    if which == "space":
        side = int(np.sqrt(mask.shape[1]))
        return mask.reshape(B, T, side, side)
    return mask

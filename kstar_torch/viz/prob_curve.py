"""Probability-curve figures + real-time GIF rendering.

The port's copy of ``kstar_tpu/viz/prob_curve.py`` (host-side matplotlib
over numpy curves; every curve passed in is a host array). Rebuild of
reference plotting: the 12-panel 0D-signals + probability figure
(reference plot_exp_prob_type_1, src/utils/utility.py:685-835), the zoomed
warning-time figure (plot_exp_prob_type_2 :837-870), the learning-curve plot
(:1180-1199), and the side-by-side camera/probability animation
(reference generate_real_time_experiment,
src/visualization/visualize_application.py:310-351).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _mpl():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_shot_probability(
    ts_shot,                     # per-shot 0D dataframe (time + signals)
    time_x: np.ndarray,
    probs: np.ndarray,
    shot: int,
    tftsrt: float,
    t_tq: float,
    t_cq: float,
    signals: Optional[Sequence[str]] = None,
    save_path: Optional[str] = None,
):
    """Multi-panel figure: key 0D signals over time with the disruption
    probability in the last panel, TQ/CQ marked (reference
    plot_exp_prob_type_1)."""
    plt = _mpl()
    signals = list(signals or [c for c in ts_shot.columns
                               if c.startswith("\\")][:11])
    n = len(signals) + 1
    ncols = 3
    nrows = (n + ncols - 1) // ncols
    fig, axes = plt.subplots(nrows, ncols, figsize=(4 * ncols, 2.2 * nrows),
                             sharex=True)
    axes = np.atleast_2d(axes)

    t = ts_shot["time"].values
    for i, col in enumerate(signals):
        ax = axes[i // ncols][i % ncols]
        ax.plot(t, ts_shot[col].values, lw=0.8)
        ax.set_title(col.lstrip("\\"), fontsize=8)
        for tv, c in ((tftsrt, "g"), (t_tq, "orange"), (t_cq, "r")):
            ax.axvline(tv, color=c, lw=0.6, ls="--")

    ax = axes[(n - 1) // ncols][(n - 1) % ncols]
    ax.plot(time_x, probs, "b", lw=1.0)
    ax.axhline(0.5, color="k", lw=0.5, ls=":")
    for tv, c in ((tftsrt, "g"), (t_tq, "orange"), (t_cq, "r")):
        ax.axvline(tv, color=c, lw=0.6, ls="--")
    ax.set_ylim(0, 1)
    ax.set_title("disruption probability", fontsize=8)
    ax.set_xlabel("time (s)")

    for j in range(n, nrows * ncols):
        axes[j // ncols][j % ncols].axis("off")

    fig.suptitle(f"shot {shot}")
    fig.tight_layout()
    if save_path:
        os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
        fig.savefig(save_path)
    return fig


def plot_shot_probability_zoom(
    time_x: np.ndarray,
    probs: np.ndarray,
    shot: int,
    tftsrt: float,
    t_tq: float,
    t_cq: float,
    t_warning: float,
    save_path: Optional[str] = None,
    zoom: float = 1.0,
):
    """Zoomed probability curve near the quench with the warning line at
    ``t_cq - t_warning`` (reference plot_exp_prob_type_2)."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.plot(time_x, probs, "b")
    ax.axhline(0.5, color="k", lw=0.5, ls=":")
    ax.axvline(t_tq, color="orange", ls="--", label="thermal quench")
    ax.axvline(t_cq, color="r", ls="--", label="current quench")
    ax.axvline(t_cq - t_warning, color="purple", ls="-.", label="warning")
    ax.set_xlim(max(t_cq - zoom, 0), t_cq + 0.2)
    ax.set_ylim(0, 1)
    ax.set_xlabel("time (s)")
    ax.set_ylabel("p(disruption)")
    ax.legend(fontsize=8)
    ax.set_title(f"shot {shot} (zoom)")
    fig.tight_layout()
    if save_path:
        base, ext = os.path.splitext(save_path)
        fig.savefig(f"{base}-zoom{ext or '.png'}")
    return fig


def plot_learning_curve(history, save_path: Optional[str] = None,
                        figsize: Tuple[int, int] = (12, 6)):
    """Loss + F1 learning curves (reference plot_learning_curve,
    src/utils/utility.py:1180-1199)."""
    plt = _mpl()
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=figsize)
    epochs = np.arange(1, len(history.train_loss) + 1)
    ax1.plot(epochs, history.train_loss, label="train")
    ax1.plot(epochs, history.valid_loss, label="valid")
    ax1.set_xlabel("epoch"); ax1.set_ylabel("loss"); ax1.legend()
    ax2.plot(epochs, history.train_f1, label="train")
    ax2.plot(epochs, history.valid_f1, label="valid")
    ax2.set_xlabel("epoch"); ax2.set_ylabel("macro F1"); ax2.legend()
    fig.tight_layout()
    if save_path:
        os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
        fig.savefig(save_path)
    return fig


def show_all_frames(frames_u8: np.ndarray, n_cols: int = 8,
                    max_frames: int = 64, save_path: Optional[str] = None):
    """Frame browser: dump a shot's frames in a time grid
    (reference show_all_frame, src/visualization/visualize_video.py:12)."""
    plt = _mpl()
    n = min(len(frames_u8), max_frames)
    sel = np.linspace(0, len(frames_u8) - 1, n).astype(int)
    n_rows = (n + n_cols - 1) // n_cols
    fig, axes = plt.subplots(n_rows, n_cols, figsize=(2 * n_cols, 2 * n_rows))
    axes = np.atleast_2d(axes)
    for i, f in enumerate(sel):
        ax = axes[i // n_cols][i % n_cols]
        ax.imshow(frames_u8[f][..., ::-1])
        ax.set_title(f"t={f}", fontsize=7)
        ax.axis("off")
    for j in range(n, n_rows * n_cols):
        axes[j // n_cols][j % n_cols].axis("off")
    fig.tight_layout()
    if save_path:
        os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
        fig.savefig(save_path)
    return fig


def realtime_frame_indices(n_probs: int, frame_srt: int, frame_end: int,
                           fps: int = 210) -> list:
    """The reference's exact non-uniform animation-frame subsampling
    (reference visualize_application.py:279-296): every 22nd probability
    index during flat-top, EVERY index inside the ~29-frame window before
    ``frame_end`` (the quench), then back to every 22nd — including the
    reference's quirk of comparing the prob-relative index against the
    absolute ``frame_end`` (so densification only engages when the index
    range reaches it)."""
    idx_distance = 21
    idx_interval = 0
    indices = []
    for idx in range(0, min(n_probs, frame_end - frame_srt + fps)):
        if idx_interval > idx_distance:
            indices.append(idx)
            idx_interval = 1
        else:
            idx_interval += 1
        if idx > frame_end - int(1.4 * fps / 10) and idx_distance > 0 and idx < frame_end:
            idx_distance = 0
        elif idx > frame_end and idx_distance == 0:
            idx_distance = 21
    return indices


def adaptive_camera_fps(t_disrupt: float) -> int:
    """Shot-length-adapted camera sample rate for the real-time experiment's
    time axis (reference visualize_application.py:433-440): the camera clock
    drifts over long shots, so the assumed fps steps down with the thermal
    quench time."""
    if t_disrupt < 5:
        return 210
    elif 5 < t_disrupt < 10:
        return 207
    elif 10 < t_disrupt < 15:
        return 204
    return 200


def render_realtime_gif(
    frames_u8: np.ndarray,       # (T, H, W, C) shot frames (BGR)
    time_x: np.ndarray,
    probs: np.ndarray,
    shot: int,
    t_cq: float,
    save_path: str = "./results/real_time_disruption_prediction.gif",
    fps_out: int = 12,
    max_frames: int = 480,
    densify_near_quench: bool = True,
):
    """Side-by-side (camera | probability-so-far) animation via
    matplotlib FuncAnimation + PillowWriter (reference
    visualize_application.py:310-351), with the reference's exact
    non-uniform frame subsampling: every 22nd frame during flat-top, every
    frame in the ~29-frame pre-quench window (reference :279-296,
    index-parity-tested in tests/test_viz_xai.py)."""
    plt = _mpl()
    from matplotlib.animation import FuncAnimation, PillowWriter

    n = len(frames_u8)
    idx_cq = int(np.clip(np.searchsorted(time_x, t_cq), 0, n - 1))
    if densify_near_quench:
        sel = np.asarray(realtime_frame_indices(n, 0, idx_cq), dtype=int)
        if len(sel) == 0:
            sel = np.arange(min(n, max_frames))
        elif len(sel) > max_frames:
            # safety cap: thin the flat-top stretch, keep the dense window
            dense = sel[sel > idx_cq - 32]
            sparse = sel[sel <= idx_cq - 32]
            if len(sparse):
                keep = np.linspace(0, len(sparse) - 1,
                                   max(max_frames - len(dense), 2), dtype=int)
                sel = np.unique(np.concatenate([sparse[keep], dense]))
            else:
                sel = dense[:max_frames]
    else:
        sel = np.arange(min(n, max_frames))

    fig, (ax_img, ax_prob) = plt.subplots(1, 2, figsize=(10, 4))
    im = ax_img.imshow(frames_u8[0][..., ::-1])  # BGR -> RGB
    ax_img.axis("off")
    line, = ax_prob.plot([], [], "b")
    ax_prob.axhline(0.5, color="k", lw=0.5, ls=":")
    ax_prob.axvline(t_cq, color="r", ls="--")
    ax_prob.set_xlim(0, time_x[-1] if len(time_x) else 1)
    ax_prob.set_ylim(0, 1)
    ax_prob.set_xlabel("time (s)")
    ax_prob.set_ylabel("p(disruption)")

    def update(k):
        f = sel[k]
        im.set_data(frames_u8[min(f, n - 1)][..., ::-1])
        m = min(f, len(time_x))
        line.set_data(time_x[:m], probs[:m])
        ax_img.set_title(f"shot {shot} | t={f / 210.0:.3f}s", fontsize=9)
        return im, line

    anim = FuncAnimation(fig, update, frames=len(sel), blit=True)
    os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
    anim.save(save_path, writer=PillowWriter(fps=fps_out))
    plt.close(fig)
    return save_path

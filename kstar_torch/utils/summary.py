"""Model structure summaries (port of ``kstar_tpu/utils/summary.py``, a
rebuild of reference plot_model_structure.py + the per-model ``summary()``
methods): the module tree to ``depth`` with each module's output shape (from
forward hooks over one evaluation forward) and parameter count, and the
module hierarchy drawn as a box-and-edge diagram. Parameters only are
counted: BatchNorm statistics are buffers here, as they are ``batch_stats``
and not ``params`` in the JAX package."""

from __future__ import annotations

import os
from typing import Optional

import torch
from torch import nn


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def _shape(out) -> str:
    if isinstance(out, torch.Tensor):
        return f"{str(out.dtype).replace('torch.', '')}{list(out.shape)}"
    if isinstance(out, (tuple, list)):
        return ", ".join(_shape(o) for o in out)
    return type(out).__name__


def model_summary(model: nn.Module, *sample_args, save_path: Optional[str] = None,
                  depth: int = 3) -> str:
    """Table of the module tree to ``depth``: path, module class, output
    shape and parameter count (the submodules' included), then the total.
    ``sample_args`` run one evaluation forward on the model's device."""
    device = next(model.parameters()).device
    modules = [(name, m) for name, m in model.named_modules()
               if name.count(".") < depth]
    outputs, hooks = {}, []
    for name, m in modules:
        hooks.append(m.register_forward_hook(
            lambda mod, args, out, name=name: outputs.__setitem__(name, _shape(out))))
    was_training = model.training
    try:
        model.eval()
        with torch.no_grad():
            model(*(a.to(device) for a in sample_args))
    finally:
        for h in hooks:
            h.remove()
        model.train(was_training)

    rows = [("path", "module", "outputs", "params")]
    rows += [(name or "(root)", type(m).__name__, outputs.get(name, "-"),
              f"{param_count(m):,}") for name, m in modules]
    widths = [max(len(r[i]) for r in rows) for i in range(4)]
    fmt = lambda r: "  ".join(c.ljust(w) if i < 3 else c.rjust(w)
                              for i, (c, w) in enumerate(zip(r, widths)))
    lines = [f"{type(model).__name__} Summary", fmt(rows[0]),
             "-" * len(fmt(rows[0]))] + [fmt(r) for r in rows[1:]]
    n_buf = sum(b.numel() for b in model.buffers())
    lines += ["", f"Total Parameters: {param_count(model):,}",
              f"Buffers (batch statistics and tables, not counted): {n_buf:,}"]
    text = "\n".join(lines)
    if save_path:
        os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
        with open(save_path, "w") as f:
            f.write(text)
    return text


def render_model_graph(model: nn.Module, save_path: str, depth: int = 3,
                       title: Optional[str] = None) -> str:
    """Render the module hierarchy as a layered box-and-edge diagram
    (replaces the reference's torchviz/hiddenlayer graphs,
    reference plot_model_structure.py:1-3): one column per module depth,
    a box per submodule that holds parameters, annotated with its parameter
    count, edges from parent to child. Pure matplotlib — no graphviz."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    # the module tree to `depth` as (path, n_params) nodes; modules without
    # parameters are left out, as they have no entry in a flax params tree
    nodes = {(): param_count(model)}

    def walk(mod, path):
        if len(path) >= depth:
            return
        for name, sub in mod.named_children():
            n = param_count(sub)
            if n:
                nodes[path + (name,)] = n
                walk(sub, path + (name,))

    walk(model, ())

    # leaf-first vertical layout: each childless node takes a row; parents
    # center on their children
    children = {p: [q for q in nodes if q[:-1] == p and len(q) == len(p) + 1]
                for p in nodes}
    ys: dict = {}
    next_row = [0.0]

    def place(p):
        ch = children[p]
        if not ch:
            ys[p] = next_row[0]
            next_row[0] += 1.0
            return ys[p]
        ys[p] = float(np.mean([place(c) for c in ch]))
        return ys[p]

    place(())

    fig_h = max(2.5, 0.42 * next_row[0] + 1)
    fig_w = 3.2 * (depth + 1)
    fig, ax = plt.subplots(figsize=(fig_w, fig_h))
    root_name = type(model).__name__

    def fmt(n):
        return f"{n/1e6:.2f}M" if n >= 1e6 else (f"{n/1e3:.1f}k" if n >= 1e3 else str(n))

    for path, n in nodes.items():
        x, y = len(path), ys[path]
        label = (path[-1] if path else root_name) + f"\n{fmt(n)} params"
        ax.text(x, y, label, ha="center", va="center", fontsize=7,
                bbox=dict(boxstyle="round,pad=0.35", fc="#e8f0fe", ec="#4472c4"))
        if path:
            ax.plot([x - 1 + 0.32, x - 0.32], [ys[path[:-1]], y],
                    color="#888888", lw=0.8, zorder=0)

    ax.set_xlim(-0.6, depth + 0.6)
    ax.set_ylim(-1, next_row[0])
    ax.invert_yaxis()
    ax.axis("off")
    ax.set_title(title or f"{root_name} module graph "
                 f"({fmt(nodes[()])} parameters)")
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
    fig.savefig(save_path, dpi=130)
    plt.close(fig)
    return save_path

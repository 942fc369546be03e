"""Exploratory data analysis through the port: shot-log statistics, window
and label balance across prediction distances, 0D signal distributions.

    python -m kstar_torch.analysis.eda --synthetic
    python -m kstar_torch.analysis.eda --data_root ./dataset

The port's twin of ``analysis/eda.py``: the same data (``cli/common.py
load_data``, the 0D table at ``DT_0D``), the same printed lines and the
same figure, written through ``draw_figure`` (a skip line where matplotlib
is missing) into ``results/torch/eda`` by default. It does no tensor work,
so it takes no device.
"""

from __future__ import annotations

import argparse
import os

DISTS = (1, 2, 3, 4, 5, 8, 12, 20)


def eda_figure(dists, ratios, ts_df, cols, path: str):
    """The class imbalance against the distance, and the first six
    signals' distributions (JAX's figure)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 4))
    ax1.plot(dists, ratios, "o-")
    ax1.set_xlabel("prediction distance (samples)")
    ax1.set_ylabel("disruptive fraction")
    ax1.set_title("class imbalance vs distance")
    for c in cols[:6]:
        ax2.hist(ts_df[c].dropna().values, bins=50, alpha=0.4, label=c.lstrip("\\"),
                 density=True)
    ax2.legend(fontsize=7)
    ax2.set_title("signal distributions")
    fig.tight_layout()
    fig.savefig(path)
    return fig


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data_root", type=str, default="./dataset")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--save_dir", type=str, default="./results/torch/eda")
    p.add_argument("--seq_len", type=int, default=21)
    args = p.parse_args(argv)

    from ..cli.common import draw_figure, load_data
    from ..config import DT_0D, Schema
    from ..data import TSDataset

    ns = argparse.Namespace(synthetic=args.synthetic, data_root=args.data_root,
                            random_seed=42)
    disrupt_df, ts_df, _ = load_data(ns, need_video=False, dt=DT_0D)
    cols = Schema.INPUT_FEATURES
    os.makedirs(args.save_dir, exist_ok=True)

    durations = disrupt_df.tipminf - disrupt_df.tftsrt
    print(f"shots: {len(disrupt_df)} | plasma duration mean {durations.mean():.2f}s "
          f"min {durations.min():.2f}s max {durations.max():.2f}s")

    ratios = []
    for dist in DISTS:
        ds = TSDataset(ts_df, disrupt_df, cols, seq_len=args.seq_len, dist=dist, dt=DT_0D)
        c = ds.class_counts()
        ratios.append(c[0] / max(c.sum(), 1))
        print(f"dist {dist:3d}: {len(ds):6d} windows | disruptive {c[0]} ({ratios[-1]:.3%})")

    path = os.path.join(args.save_dir, "eda.png")
    if draw_figure(path, lambda: eda_figure(DISTS, ratios, ts_df, cols, path)) is not None:
        print(f"wrote {path}")
    return {"dists": list(DISTS), "disruptive_fraction": ratios}


if __name__ == "__main__":
    main()

"""Aggregate saved trial npz files into mean/min/max band plots of PI vs
SLAM similarity and distance error: the flags, printed lines and output
figure of the JAX package's ``experiments/plot_trials_2d.py`` (pandas
aggregation over seeds), on the host only.

    python -m sspslam_tpu_torch.experiments.plot_trials_2d \
        [--data-dir data] [--out figures/trials_2d.png]

It reads the npz files ``run_pathint`` / ``run_slam --save`` write.
pandas and matplotlib are imported when they are needed.
"""

import argparse
import glob
import os
import zipfile

import numpy as np


def load_trials(pattern):
    import pandas as pd
    rows = []
    for fname in sorted(glob.glob(pattern)):
        try:
            with np.load(fname, allow_pickle=True) as f:
                keys = set(f.files)
                kind = "slam" if "slam_error" in keys else "pi"
                rows.append({
                    "file": fname,
                    "kind": kind,
                    "ts": f["ts"],
                    "sims": f[f"{kind}_sims"],
                    "error": f[f"{kind}_error"],
                })
        except (OSError, zipfile.BadZipFile, KeyError) as e:
            print(f"skipping {fname}: {e}")
    return pd.DataFrame(rows)


def band(ax, df, column, label, color):
    if df.empty:
        return
    n = min(len(r) for r in df[column])
    data = np.stack([np.asarray(r)[:n] for r in df[column]])
    ts = np.asarray(df.iloc[0]["ts"])[:n]
    ax.plot(ts, data.mean(axis=0), label=label, color=color)
    ax.fill_between(ts, data.min(axis=0), data.max(axis=0), alpha=0.25,
                    color=color, lw=0)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data-dir", default="data")
    parser.add_argument("--pi-glob", default="pi*_seed_*.npz")
    parser.add_argument("--slam-glob", default="slam_*_seed_*.npz")
    parser.add_argument("--out", default="figures/trials_2d.png")
    args = parser.parse_args(argv)

    pi_df = load_trials(os.path.join(args.data_dir, args.pi_glob))
    slam_df = load_trials(os.path.join(args.data_dir, args.slam_glob))
    print(f"{len(pi_df)} PI trials, {len(slam_df)} SLAM trials")
    if pi_df.empty and slam_df.empty:
        raise SystemExit("no trial data found; run run_pathint / "
                         "run_slam with --save first")

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from ..utils.figure_utils import palette

    fig, axes = plt.subplots(2, 1, figsize=(6, 5), sharex=True)
    band(axes[0], pi_df, "sims", "PI", palette[0])
    band(axes[0], slam_df, "sims", "SLAM", palette[1])
    axes[0].set_ylabel("cosine similarity")
    axes[0].legend()
    band(axes[1], pi_df, "error", "PI", palette[0])
    band(axes[1], slam_df, "error", "SLAM", palette[1])
    axes[1].set_ylabel("distance error")
    axes[1].set_xlabel("time (s)")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    fig.savefig(args.out, dpi=120)
    plt.close(fig)
    print(f"saved {args.out}")
    return fig


if __name__ == "__main__":
    main()

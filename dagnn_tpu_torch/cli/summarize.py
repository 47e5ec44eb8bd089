"""Aggregate BO results across seeds.

A copy of dagnn_tpu/cli/summarize.py (numpy only), the equivalent of the
reference summarizer (reference: dvae/bayesian_optimization/summarize.py):
parse Test_RMSE_ll.txt -> mean±std RMSE / log-likelihood / Pearson r
tables; list best architecture scores per round from best_arc_scores.txt.
matplotlib is imported only by --plot (plot_best_arcs).

    python -m dagnn_tpu_torch.cli.summarize --res_dir results/bo
"""

from __future__ import annotations

import argparse
import os
import re

import numpy as np


def parse_rmse_ll(path):
    pat = re.compile(r"Test RMSE: ([-\d.]+), ll: ([-\d.]+), Pearson r: ([-\d.]+)")
    rows = []
    with open(path) as f:
        for line in f:
            m = pat.search(line)
            if m:
                rows.append(tuple(float(g) for g in m.groups()))
    return np.asarray(rows)


def plot_best_arcs(res_dir: str) -> str:
    """Best-architecture score progression across BO rounds (the reference
    summarizer's matplotlib plot): one-series line, direct end label."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    scores = []
    with open(os.path.join(res_dir, "best_arc_scores.txt")) as f:
        for line in f:
            parts = line.rsplit(",", 1)
            if len(parts) == 2:
                try:
                    scores.append(float(parts[1]))
                except ValueError:
                    pass
    out = os.path.join(res_dir, "best_arc_scores.png")
    fig, ax = plt.subplots(figsize=(6, 3.4), dpi=150)
    x = np.arange(1, len(scores) + 1)
    ax.plot(x, scores, color="#2D5B8E", linewidth=2, marker="o",
            markersize=5)
    if scores:
        ax.annotate(f"{scores[-1]:.4f}", (x[-1], scores[-1]),
                    textcoords="offset points", xytext=(6, 4),
                    fontsize=9, color="#333333")
    ax.set_xticks(x)  # rounds are integers
    ax.set_xlabel("BO round")
    ax.set_ylabel("best score found")
    ax.set_title("Bayesian optimization: best architecture score")
    ax.grid(True, color="#e6e6e6", linewidth=0.6)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    fig.tight_layout()
    fig.savefig(out)
    plt.close(fig)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--res_dir", default="results/bo")
    p.add_argument("--plot", action="store_true",
                   help="write best_arc_scores.png progression plot")
    args = p.parse_args(argv)

    path = os.path.join(args.res_dir, "Test_RMSE_ll.txt")
    if os.path.exists(path):
        rows = parse_rmse_ll(path)
        if len(rows):
            mean, std = rows.mean(0), rows.std(0)
            print(f"{len(rows)} seeds")
            print(f"RMSE      {mean[0]:.4f} ± {std[0]:.4f}")
            print(f"log-lik   {mean[1]:.4f} ± {std[1]:.4f}")
            print(f"Pearson r {mean[2]:.4f} ± {std[2]:.4f}")
    arcs = os.path.join(args.res_dir, "best_arc_scores.txt")
    if os.path.exists(arcs):
        print("\nbest architecture scores:")
        with open(arcs) as f:
            for line in f:
                print(" ", line.strip())
        if args.plot:
            print("wrote", plot_best_arcs(args.res_dir))


if __name__ == "__main__":
    main()

"""DAG visualization without native graph libraries.

A copy of dagnn_tpu/utils/plot.py (numpy and a lazy matplotlib import).

The reference draws decoded architectures / Bayesian networks through
pygraphviz + igraph (reference: dvae/util.py:470-572 ``plot_DAG`` /
``draw_network`` / ``draw_BN``). Both are C libraries; here the same
capability is a pure matplotlib renderer over :class:`NAGraph` — layered
("dot"-style) layout derived from the topological levels the framework
already computes, same ENAS op label/color scheme, fixed BN node positions.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from dagnn_tpu_torch.data.na import NAGraph

# ENAS op labels/colors (reference dvae/util.py:504-531 add_node)
_ENAS_STYLE = {
    0: ("input", "skyblue"),
    1: ("output", "pink"),
    2: ("conv3", "yellow"),
    3: ("sep3", "orange"),
    4: ("conv5", "greenyellow"),
    5: ("sep5", "seagreen"),
    6: ("avg3", "azure"),
    7: ("max3", "beige"),
}

# BN variable labels + fixed positions (reference dvae/util.py:539-543)
_BN_LABELS = dict(zip(range(2, 10), "ASTLBEXD"))
_BN_POS = dict(zip(range(2, 10), [(0, 3), (2.75, 3), (0, 2), (2, 2),
                                  (3.5, 1), (1.5, 1), (1.5, 0), (3.5, 0)]))


def _layered_positions(g: NAGraph, backbone: bool):
    """dot-like layout: y = -topo level, x = centered slot within level."""
    n = g.num_nodes
    if backbone:
        return {i: (0.0, -float(i)) for i in range(n)}
    level = np.zeros(n, dtype=np.int64)
    for j in range(n):  # adj is upper-triangular for valid DAGs; iterate anyway
        preds = np.nonzero(g.adj[:, j])[0]
        if len(preds):
            level[j] = level[preds].max() + 1
    pos = {}
    for lv in np.unique(level):
        ids = np.nonzero(level == lv)[0]
        for k, i in enumerate(ids):
            pos[int(i)] = (k - (len(ids) - 1) / 2.0, -float(lv))
    return pos


def plot_dag(
    g: Optional[NAGraph],
    res_dir: str,
    name: str,
    backbone: bool = False,
    data_type: str = "ENAS",
    pdf: bool = False,
) -> str:
    """Render a decoded DAG to ``<res_dir>/<name>.png`` (or ``.pdf``).

    Mirrors the reference API (dvae/util.py:471-479): ``g=None`` renders an
    'invalid' placeholder; ``backbone`` draws the main chain vertically;
    ``data_type`` selects the ENAS op style or the fixed-position BN style.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    path = os.path.join(res_dir, name + (".pdf" if pdf else ".png"))
    os.makedirs(res_dir, exist_ok=True)
    fig, ax = plt.subplots(figsize=(4, 5))
    ax.axis("off")

    if g is None:
        ax.text(0.5, 0.5, "invalid", ha="center", va="center", fontsize=18,
                bbox=dict(boxstyle="square", fc="white", ec="black"))
        fig.savefig(path, bbox_inches="tight")
        plt.close(fig)
        return path

    types = np.asarray(g.types)
    if data_type == "BN":
        # hide input/output vertices, fixed variable positions (util.py:539-571)
        show = [i for i in range(g.num_nodes) if types[i] not in (0, 1)]
        pos = {i: _BN_POS.get(int(types[i]), (0, 0)) for i in show}
        labels = {i: _BN_LABELS.get(int(types[i]), "?") for i in show}
        colors = {i: "white" for i in show}
        shown = set(show)
        edges = [(int(i), int(j)) for i, j in zip(*np.nonzero(g.adj))
                 if i in shown and j in shown]
    else:
        show = list(range(g.num_nodes))
        pos = _layered_positions(g, backbone)
        labels, colors = {}, {}
        for i in show:
            lab, col = _ENAS_STYLE.get(int(types[i]), ("", "aliceblue"))
            labels[i], colors[i] = lab, col
        edges = [(int(i), int(j)) for i, j in zip(*np.nonzero(g.adj))]

    for i, j in edges:
        (x0, y0), (x1, y1) = pos[i], pos[j]
        ax.annotate("", xy=(x1, y1), xytext=(x0, y0),
                    arrowprops=dict(arrowstyle="-|>", lw=1.0, color="black",
                                    shrinkA=14, shrinkB=14))
    for i in show:
        x, y = pos[i]
        ax.text(x, y, labels[i], ha="center", va="center", fontsize=10,
                bbox=dict(boxstyle="square,pad=0.4" if data_type != "BN"
                          else "circle,pad=0.4",
                          fc=colors[i], ec="black"))
    xs = [p[0] for p in pos.values()] or [0]
    ys = [p[1] for p in pos.values()] or [0]
    ax.set_xlim(min(xs) - 1, max(xs) + 1)
    ax.set_ylim(min(ys) - 1, max(ys) + 1)
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
    return path

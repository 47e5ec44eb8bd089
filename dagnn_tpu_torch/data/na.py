"""NA (ENAS neural architectures) and BN (Bayesian networks) dataset layer.

A copy of dagnn_tpu/data/na.py (numpy only), so the port parses, shuffles
and splits the same graphs as the JAX package; tests/test_torch_na.py holds
the two bit for bit.

Replaces the reference's igraph-based loaders and codecs (reference:
dvae/util.py:67-385) with plain numpy structures: each DAG is a type
sequence + dense adjacency (max_n is tiny — 8 for NA, 10 for BN), which is
exactly the padded-dense form both the TPU VAE decoder and the DAGNN encoder
batching consume.

Text formats (one graph per line, ``row, y``):
  ENAS: row = [[type, flags...] x n]; graph has n+2 vertices —
        vertex 0 input (type 0), vertex i+1 = op (type+2), vertex n+1
        output (type 1). Edges: chain i -> i+1, per-flag j -> i+1 (flags
        index from vertex 0), and n -> n+1 (dvae/util.py:264-290 pyg variant).
  BN:   row = [[type, flags...] x n]; flags index from vertex j+1; rows with
        no flags connect from the input; loose ends connect to the output
        (dvae/util.py:292-339).
"""

from __future__ import annotations

import ast
import dataclasses
import gzip
import random
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from dagnn_tpu_torch.dag.batch import DAGGraph

START_TYPE = 0
END_TYPE = 1


@dataclasses.dataclass(frozen=True)
class GraphArgs:
    """Dataset-level graph metadata (reference dvae/util.py:94-99,222-227)."""

    num_vertex_type: int
    max_n: int
    start_type: int = START_TYPE
    end_type: int = END_TYPE
    num_class: int = 1


@dataclasses.dataclass
class NAGraph:
    """A small DAG as type sequence + dense adjacency. adj[i, j] = edge i->j."""

    types: np.ndarray       # [n] int32 (includes start/end vertices)
    adj: np.ndarray         # [n, n] uint8
    y: float = 0.0

    @property
    def num_nodes(self) -> int:
        return int(self.types.shape[0])

    def edges(self) -> Tuple[np.ndarray, np.ndarray]:
        s, d = np.nonzero(self.adj)
        return s.astype(np.int64), d.astype(np.int64)


def parse_enas_row(row) -> NAGraph:
    if isinstance(row, str):
        row = ast.literal_eval(row)
    n = len(row)
    nn = n + 2
    types = np.empty(nn, np.int32)
    adj = np.zeros((nn, nn), np.uint8)
    types[0] = START_TYPE
    for i, node in enumerate(row):
        types[i + 1] = node[0] + 2
        adj[i, i + 1] = 1                       # chain from previous vertex
        for j, flag in enumerate(node[1:]):
            if flag == 1:
                adj[j, i + 1] = 1               # flags index from vertex 0
    types[nn - 1] = END_TYPE
    adj[n, nn - 1] = 1                          # last op feeds the output
    return NAGraph(types=types, adj=adj)


def parse_bn_row(row) -> NAGraph:
    if isinstance(row, str):
        row = ast.literal_eval(row)
    n = len(row)
    nn = n + 2
    types = np.empty(nn, np.int32)
    adj = np.zeros((nn, nn), np.uint8)
    types[0] = START_TYPE
    end_vertices = [True] * n
    for i, node in enumerate(row):
        types[i + 1] = node[0] + 2
        if sum(node[1:]) == 0:
            adj[0, i + 1] = 1                   # orphan rows hang off the input
        else:
            for j, flag in enumerate(node[1:]):
                if flag == 1:
                    adj[j + 1, i + 1] = 1       # flags index from vertex j+1
                    end_vertices[j] = False
    types[nn - 1] = END_TYPE
    for j, loose in enumerate(end_vertices):
        if loose:
            adj[j + 1, nn - 1] = 1              # loose ends feed the output
    return NAGraph(types=types, adj=adj)


def graph_to_enas_row(g: NAGraph) -> List[List[int]]:
    """Inverse codec: NAGraph -> nested ENAS row (dvae/util.py:168-180)."""
    n = g.num_nodes - 2
    row = []
    for i in range(1, n + 1):
        entry = [int(g.types[i]) - 2]
        entry += [int(g.adj[j, i]) for j in range(i - 1)]
        row.append(entry)
    return row


def graph_to_bn_adj_str(g: NAGraph) -> str:
    """Flattened 8x8 inner adjacency ordered by type (dvae/util.py:389-395)."""
    types = np.asarray(g.types[1:-1])
    order = np.argsort(types, kind="stable")
    inner = np.asarray(g.adj[1:-1, 1:-1])
    inner = inner[order][:, order]
    return " ".join(str(int(v)) for v in inner.reshape(-1))


def na_graph_to_dag(g: NAGraph, num_vertex_type: int) -> DAGGraph:
    """Convert to the framework's DAGGraph with one-hot x (dvae pipeline
    passes one-hot vertex types as node features, dvae/util.py:355-385)."""
    x = np.zeros((g.num_nodes, num_vertex_type), np.float32)
    x[np.arange(g.num_nodes), g.types] = 1.0
    s, d = g.edges()
    dag = DAGGraph(
        num_nodes=g.num_nodes,
        edge_src=s,
        edge_dst=d,
        x=x,
        extras={"vtype": g.types.astype(np.int32)},
        y={"y": np.asarray(g.y, dtype=np.float32)},
    )
    dag.ensure_levels()
    return dag


def _load_rows(path, parse, with_y: bool, burn_in: int):
    graphs = []
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as f:
        for i, line in enumerate(f):
            if i < burn_in:
                continue
            line = line.strip()
            if not line:
                continue
            if with_y:
                row, y = ast.literal_eval(line)
            else:
                row, y = ast.literal_eval(line), 0.0
            g = parse(row)
            g.y = float(y)
            graphs.append(g)
    return graphs


def load_enas(
    path,
    n_types: int = 6,
    burn_in: int = 1000,
    rand_seed: int = 0,
    with_y: bool = True,
    max_count: Optional[int] = None,
) -> Tuple[List[NAGraph], List[NAGraph], GraphArgs]:
    """Load ENAS graphs with the reference's burn-in, shuffle, and 90/10
    split semantics (dvae/util.py:67-100): skip the first `burn_in` rows,
    shuffle with random.Random(rand_seed), split 90/10.
    """
    graphs = _load_rows(path, parse_enas_row, with_y, burn_in)
    if max_count is not None:
        graphs = graphs[:max_count]
    args = GraphArgs(num_vertex_type=n_types + 2,
                     max_n=max(g.num_nodes for g in graphs))
    random.Random(rand_seed).shuffle(graphs)
    ng = len(graphs)
    cut = int(ng * 0.9)
    return graphs[:cut], graphs[cut:], args


def load_bn(
    path,
    n_types: int = 8,
    rand_seed: int = 0,
    with_y: bool = True,
    max_count: Optional[int] = None,
) -> Tuple[List[NAGraph], List[NAGraph], GraphArgs]:
    """Load BN graphs (dvae/util.py:197-232): no burn-in, same shuffle/split."""
    graphs = _load_rows(path, parse_bn_row, with_y, burn_in=0)
    if max_count is not None:
        graphs = graphs[:max_count]
    args = GraphArgs(num_vertex_type=n_types + 2,
                     max_n=max(g.num_nodes for g in graphs))
    random.Random(rand_seed).shuffle(graphs)
    ng = len(graphs)
    cut = int(ng * 0.9)
    return graphs[:cut], graphs[cut:], args


def synthetic_bn_rows(num: int, n: int = 8, n_types: int = 8, seed: int = 0,
                      edge_p: float = 0.35, score: bool = True) -> List[str]:
    """Generate a synthetic BN corpus in the reference text format, for use
    when the original asia_200k.txt blob is unavailable. Each row permutes
    the `n_types` variable types (BN validity requires each type exactly
    once, dvae/util.py:634-649) over a random upper-triangular structure.

    score=True (default) computes each structure's REAL BIC against the
    sampled Asia dataset (vae/bn_score.py — the reference scores via an
    external R/bnlearn script, evaluate_BN.py:15-21), so the y column
    carries actual structure->score signal for latent-space evaluation
    and BO; score=False emits fast placeholder noise (unit tests only).
    """
    rng = np.random.default_rng(seed)
    eva = None
    if score:
        from dagnn_tpu_torch.vae.bn_score import EvalBN
        eva = EvalBN(seed=seed)
    rows = []
    for _ in range(num):
        perm = rng.permutation(n_types)[:n]
        row = []
        for i in range(n):
            flags = (rng.random(i) < edge_p).astype(int).tolist()
            row.append([int(perm[i])] + flags)
        if eva is not None:
            g = parse_bn_row(str(row))
            y = float(eva.eval(graph_to_bn_adj_str(g)))
        else:
            y = float(rng.normal(-12000.0, 500.0))
        rows.append(f"{row}, {y}")
    return rows


def synthetic_bn_corpus(num: int, n_types: int = 8, seed: int = 0
                        ) -> Tuple[List[NAGraph], List[NAGraph], GraphArgs]:
    """`num` synthetic_bn_rows parsed into BN graphs with their scores,
    split 90/10 in row order: the corpus train_vae --data-type BN uses when
    no BN file is given."""
    gs = []
    for r in synthetic_bn_rows(num, n_types=n_types, seed=seed):
        row, y = ast.literal_eval(r)
        g = parse_bn_row(row)
        g.y = y
        gs.append(g)
    cut = int(len(gs) * 0.9)
    return gs[:cut], gs[cut:], GraphArgs(num_vertex_type=n_types + 2,
                                         max_n=max(g.num_nodes for g in gs))


# --- validity checkers (dvae/util.py:599-649) ---

def is_valid_dag(g: NAGraph, start_type=START_TYPE, end_type=END_TYPE) -> bool:
    n = g.num_nodes
    adj = np.asarray(g.adj)
    # acyclicity via numpy Kahn
    indeg = adj.sum(0)
    order_seen = 0
    active = np.ones(n, bool)
    work = True
    while work:
        front = np.flatnonzero(active & (indeg == 0))
        work = front.size > 0
        order_seen += front.size
        for v in front:
            indeg = indeg - adj[v]
        active[front] = False
    if order_seen != n:
        return False
    n_start = int((g.types == start_type).sum())
    n_end = int((g.types == end_type).sum())
    indeg_all = adj.sum(0)
    outdeg_all = adj.sum(1)
    for v in range(n):
        if indeg_all[v] == 0 and g.types[v] != start_type:
            return False
        if outdeg_all[v] == 0 and g.types[v] != end_type:
            return False
    return n_start == 1 and n_end == 1


def is_valid_enas(g: NAGraph, start_type=START_TYPE, end_type=END_TYPE) -> bool:
    if not is_valid_dag(g, start_type, end_type):
        return False
    n = g.num_nodes
    for i in range(n - 2):
        if not g.adj[i, i + 1]:
            return False
    return int(np.asarray(g.adj)[:, n - 1].sum()) == 1


def is_valid_bn(g: NAGraph, start_type=START_TYPE, end_type=END_TYPE,
                nvt: int = 10) -> bool:
    adj = np.asarray(g.adj)
    n = g.num_nodes
    indeg = adj.sum(0).copy()
    active = np.ones(n, bool)
    seen = 0
    while True:
        front = np.flatnonzero(active & (indeg == 0))
        if front.size == 0:
            break
        seen += front.size
        for v in front:
            indeg = indeg - adj[v]
        active[front] = False
    if seen != n:
        return False
    n_start = int((g.types == start_type).sum())
    n_end = int((g.types == end_type).sum())
    return (n_start == 1 and n_end == 1
            and len(set(g.types.tolist())) == nvt and n == nvt)

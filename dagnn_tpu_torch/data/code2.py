"""ogbg-code2 dataset pipeline: raw readers, vocab, sequence codecs, edge
augmentation.

A copy of dagnn_tpu/data/code2.py (numpy only), so the port builds the same
graphs, vocabularies and scores as the JAX package; tests/test_torch_data.py
holds the two to equal outputs. One difference: the raw CSVs are read with
gzip and the csv module rather than pandas, which the port does not depend
on. The original replaces the reference's OGB fork + driver-side transforms:
  * raw CSV reading (reference: ogb/io/read_graph_raw.py:10-120 format —
    edge.csv.gz, num-node-list, num-edge-list, node-feat, additional node
    files node_is_attributed/node_dfs_order/node_depth, graph-label as
    space-joined subtokens, split indices under split/project/),
  * per-graph topo-level annotation + len_longest_path at load time
    (the fork's hook, ogb/io/read_graph_pyg.py:51-54),
  * vocabulary construction (ogbg-code/utils.py:32-86), sequence <-> index
    array codecs (:138-179),
  * edge augmentation: `augment_edge` (AST + inverse + next-token + inverse,
    2-bit attrs, utils.py:88-136 — for undirected baselines) and
    `augment_edge2` (AST + next-token only: stays a DAG, utils2.py:31-79 —
    for DAGNN).

Everything is numpy; graphs become dag.DAGGraph.
"""

from __future__ import annotations

import csv
import gzip
import os.path as osp
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from dagnn_tpu_torch.dag.batch import DAGGraph

UNK = "__UNK__"
EOS = "__EOS__"


# --- vocabulary (ogbg-code/utils.py:32-86) ---

def get_vocab_mapping(seq_list: Sequence[Sequence[str]], num_vocab: int):
    """Top-`num_vocab` tokens by count (stable order of first appearance),
    plus __UNK__ and __EOS__."""
    vocab_cnt: Dict[str, int] = {}
    vocab_list: List[str] = []
    for seq in seq_list:
        for w in seq:
            if w in vocab_cnt:
                vocab_cnt[w] += 1
            else:
                vocab_cnt[w] = 1
                vocab_list.append(w)
    cnt_list = np.array([vocab_cnt[w] for w in vocab_list])
    topvocab = np.argsort(-cnt_list, kind="stable")[:num_vocab]

    vocab2idx = {vocab_list[v]: i for i, v in enumerate(topvocab)}
    idx2vocab = [vocab_list[v] for v in topvocab]
    n = len(vocab2idx)
    vocab2idx[UNK] = n
    idx2vocab.append(UNK)
    vocab2idx[EOS] = n + 1
    idx2vocab.append(EOS)
    for idx, vocab in enumerate(idx2vocab):
        assert idx == vocab2idx[vocab]
    assert vocab2idx[EOS] == len(idx2vocab) - 1
    return vocab2idx, idx2vocab


def encode_seq_to_arr(seq: Sequence[str], vocab2idx: Dict[str, int],
                      max_seq_len: int) -> np.ndarray:
    """Pad/clip to max_seq_len with EOS, map OOV to UNK (utils.py:155-163)."""
    seq = list(seq)[:max_seq_len] + [EOS] * max(0, max_seq_len - len(seq))
    return np.asarray([vocab2idx.get(w, vocab2idx[UNK]) for w in seq],
                      dtype=np.int32)


def decode_arr_to_seq(arr: np.ndarray, idx2vocab: Sequence[str]) -> List[str]:
    """Clip at the first EOS (utils.py:166-179)."""
    arr = np.asarray(arr)
    eos = len(idx2vocab) - 1
    hits = np.flatnonzero(arr == eos)
    if hits.size:
        arr = arr[: hits.min()]
    return [idx2vocab[int(i)] for i in arr]


# --- edge augmentation (utils.py:88-136, utils2.py:31-79) ---

def _next_token_edges(node_is_attributed: np.ndarray):
    idx = np.flatnonzero(np.asarray(node_is_attributed).reshape(-1) == 1)
    return idx[:-1], idx[1:]


def augment_edge(edge_src, edge_dst, node_is_attributed):
    """Baseline (non-DAG) augmentation: AST + inverse-AST + next-token +
    inverse-next-token, edge_attr[:,0]=is-next-token, [:,1]=is-inverse."""
    s, d = np.asarray(edge_src), np.asarray(edge_dst)
    ns, nd = _next_token_edges(node_is_attributed)
    src = np.concatenate([s, d, ns, nd])
    dst = np.concatenate([d, s, nd, ns])
    attr = np.zeros((len(src), 2), np.float32)
    e, t = len(s), len(ns)
    attr[e:2 * e, 1] = 1.0
    attr[2 * e:2 * e + t, 0] = 1.0
    attr[2 * e + t:, :] = 1.0
    return src, dst, attr


def augment_edge2(edge_src, edge_dst, node_is_attributed):
    """DAG-preserving augmentation used by DAGNN: AST + next-token only
    (utils2.py:31-79). Next-token edges follow DFS order, so the graph
    stays acyclic."""
    s, d = np.asarray(edge_src), np.asarray(edge_dst)
    ns, nd = _next_token_edges(node_is_attributed)
    src = np.concatenate([s, ns])
    dst = np.concatenate([d, nd])
    attr = np.zeros((len(src), 2), np.float32)
    attr[len(s):, 0] = 1.0
    return src, dst, attr


# --- raw dataset reading (ogb/io/read_graph_raw.py format) ---

def _read_csv_gz(path, dtype=None):
    """A headerless gzipped CSV as a 2-D array: `dtype` for the numeric
    files, strings (dtype object) for graph-label.csv.gz."""
    with gzip.open(path, "rt", newline="") as f:
        rows = list(csv.reader(f))
    return np.asarray(rows, dtype=object if dtype is None else dtype)


def read_code2_raw(raw_dir: str) -> List[dict]:
    """Read the ogbg-code2 raw directory into per-graph dicts with
    edge_index, node_feat, node_is_attributed, node_dfs_order, node_depth,
    and y (list of subtokens)."""
    edge = _read_csv_gz(osp.join(raw_dir, "edge.csv.gz"), np.int64).T
    num_nodes = _read_csv_gz(osp.join(raw_dir, "num-node-list.csv.gz"), np.int64)[:, 0]
    num_edges = _read_csv_gz(osp.join(raw_dir, "num-edge-list.csv.gz"), np.int64)[:, 0]
    node_feat = _read_csv_gz(osp.join(raw_dir, "node-feat.csv.gz"), np.int64)
    extras = {}
    for name in ("node_is_attributed", "node_dfs_order", "node_depth"):
        extras[name] = _read_csv_gz(osp.join(raw_dir, name + ".csv.gz"), np.int64)
    labels_raw = _read_csv_gz(osp.join(raw_dir, "graph-label.csv.gz"))
    labels = [str(labels_raw[i][0]).split(" ") for i in range(len(labels_raw))]

    graphs = []
    n_off = e_off = 0
    for i, (n, e) in enumerate(zip(num_nodes, num_edges)):
        g = {
            "edge_src": edge[0, e_off:e_off + e] .copy(),
            "edge_dst": edge[1, e_off:e_off + e].copy(),
            "node_feat": node_feat[n_off:n_off + n].copy(),
            "num_nodes": int(n),
            "y": labels[i],
        }
        for k, v in extras.items():
            g[k] = v[n_off:n_off + n, 0].copy()
        graphs.append(g)
        n_off += n
        e_off += e
    return graphs


def read_split(split_dir: str) -> Dict[str, np.ndarray]:
    """split/project/{train,valid,test}.csv.gz graph indices."""
    return {k: _read_csv_gz(osp.join(split_dir, f"{k}.csv.gz"), np.int64)[:, 0]
            for k in ("train", "valid", "test")}


def read_train_subset_idx(path: str) -> np.ndarray:
    """Subset index files (reference ogbg-code/dataset/train{10,15,20}.csv.gz,
    consumed via --train_idx). These are DATASET-LEVEL indices: the
    reference assigns them to split_idx['train'] wholesale
    (main_pyg.py:216-219), it does not index into the existing train list
    (verified: train15 holds 61,196 values in [3, 407,974])."""
    return _read_csv_gz(path, np.int64)[:, 0]


def raw_to_dag(g: dict, vocab2idx, max_seq_len: int, dag_only: bool = True) -> DAGGraph:
    """One raw graph -> DAGGraph with DAGNN's augmentation + targets.

    dag_only=True applies augment_edge2 (DAGNN); False applies the 4-way
    augment_edge (baselines; the result may be cyclic, levels unusable).
    """
    aug = augment_edge2 if dag_only else augment_edge
    src, dst, attr = aug(g["edge_src"], g["edge_dst"], g["node_is_attributed"])
    dag = DAGGraph(
        num_nodes=g["num_nodes"],
        edge_src=src,
        edge_dst=dst,
        x=np.asarray(g["node_feat"], np.int32),
        edge_attr=attr,
        extras={"node_depth": np.asarray(g["node_depth"], np.int32)},
        y={"y_arr": encode_seq_to_arr(g["y"], vocab2idx, max_seq_len)},
    )
    if dag_only:
        dag.ensure_levels()
        dag.y["len_longest_path"] = np.asarray(dag.len_longest_path, np.int32)
    return dag


# --- evaluators (ogb/graphproppred/evaluate.py:220-267) ---

def eval_f1(seq_ref: Sequence[Sequence[str]], seq_pred: Sequence[Sequence[str]]):
    """Per-sample set precision/recall/F1, averaged (evaluate.py:238-267)."""
    ps, rs, fs = [], [], []
    for l, p in zip(seq_ref, seq_pred):
        label, prediction = set(l), set(p)
        tp = len(label & prediction)
        fp = len(prediction - label)
        fn = len(label - prediction)
        precision = tp / (tp + fp) if tp + fp > 0 else 0
        recall = tp / (tp + fn) if tp + fn > 0 else 0
        f1 = (2 * precision * recall / (precision + recall)
              if precision + recall > 0 else 0)
        ps.append(precision); rs.append(recall); fs.append(f1)
    return {"precision": float(np.average(ps)), "recall": float(np.average(rs)),
            "F1": float(np.average(fs))}


def eval_acc(y_true: np.ndarray, y_pred: np.ndarray):
    """Multiclass accuracy (evaluate.py:220-228, used by LP via ogbg-ppa)."""
    y_true = np.asarray(y_true).reshape(-1)
    y_pred = np.asarray(y_pred).reshape(-1)
    return {"acc": float((y_true == y_pred).mean())}

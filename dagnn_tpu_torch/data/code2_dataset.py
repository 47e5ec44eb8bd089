"""ogbg-code2 dataset acquisition + processed cache.

A copy of dagnn_tpu/data/code2_dataset.py (numpy only; the npz cache it
writes is the JAX package's, byte for byte). The original is the
equivalent of the reference OGB dataset layer (reference:
ogb/graphproppred/dataset_pyg.py:106-166 download/extract/process and
ogb/io/read_graph_pyg.py:12-54 conversion): download the official zip,
extract it into the dataset root, convert the raw gzipped CSVs ONCE into a
flat-array npz cache (plus a labels text file), and reload from that cache
on every later run.  Unlike the reference (which pickles ~450k torch
`Data` objects via `collate`), the processed form here is six flat numpy
arrays + per-graph offsets — loading is a single `np.load`, and per-graph
views share the flat arrays with zero copying.

Layout under ``<root>/ogbg_code2/``::

    raw/                 edge.csv.gz num-node-list.csv.gz ... (official)
    split/project/       {train,valid,test}.csv.gz            (official)
    processed/data.npz   flat arrays + offsets (ours)
    processed/labels.txt one space-joined subtoken sequence per line

Without network access `download_and_extract` raises a RuntimeError that
says where to place the zip or the raw dir by hand; the tests drive the
whole path on a locally constructed raw dir and a file:// zip
(tests/test_torch_data.py).
"""

from __future__ import annotations

import os
import os.path as osp
import shutil
from typing import Dict, List, Optional

import numpy as np

from dagnn_tpu_torch.data import code2

META = {
    "ogbg-code2": {
        "url": "https://snap.stanford.edu/ogb/data/graphproppred/code2.zip",
        "download_name": "code2",
        "split": "project",
        "additional_node_files": (
            "node_is_attributed", "node_dfs_order", "node_depth"),
        "eval_metric": "F1",
    },
}

_EXTRAS = META["ogbg-code2"]["additional_node_files"]


def download_and_extract(root: str, name: str = "ogbg-code2") -> str:
    """Download + unzip the official archive (dataset_pyg.py:106-118).

    Returns the dataset dir ``<root>/<name with _>``. Raises RuntimeError
    with download instructions when the network is unreachable.
    """
    import urllib.request
    import zipfile

    meta = META[name]
    ddir = osp.join(root, name.replace("-", "_"))
    zpath = osp.join(root, meta["download_name"] + ".zip")
    os.makedirs(root, exist_ok=True)
    if not osp.exists(zpath):
        try:
            print(f"downloading {meta['url']} ...")
            urllib.request.urlretrieve(meta["url"], zpath + ".part")
            os.replace(zpath + ".part", zpath)
        except Exception as e:  # no network: say where the zip goes
            raise RuntimeError(
                f"could not download {meta['url']} ({e}); place the official "
                f"zip at {zpath} or the extracted raw/ + split/ dirs under "
                f"{ddir}/ manually") from e
    with zipfile.ZipFile(zpath) as z:
        # zip-slip guard: refuse members that would escape the root
        # (absolute paths or ../ traversal in a corrupted/malicious zip)
        rootabs = osp.realpath(root)
        for m in z.namelist():
            dest = osp.realpath(osp.join(root, m))
            if dest != rootabs and not dest.startswith(rootabs + os.sep):
                raise RuntimeError(f"unsafe zip member path: {m!r}")
        z.extractall(root)
    ext = osp.join(root, meta["download_name"])
    if osp.exists(ext) and ext != ddir:
        if osp.exists(ddir):
            shutil.rmtree(ddir)
        shutil.move(ext, ddir)
    return ddir


def process_raw(ddir: str) -> None:
    """raw csv.gz -> processed/{data.npz,labels.txt} flat-array cache."""
    raw = osp.join(ddir, "raw")
    edge = code2._read_csv_gz(osp.join(raw, "edge.csv.gz"), np.int64).T
    num_nodes = code2._read_csv_gz(
        osp.join(raw, "num-node-list.csv.gz"), np.int64)[:, 0]
    num_edges = code2._read_csv_gz(
        osp.join(raw, "num-edge-list.csv.gz"), np.int64)[:, 0]
    node_feat = code2._read_csv_gz(osp.join(raw, "node-feat.csv.gz"), np.int64)
    extras = {k: code2._read_csv_gz(osp.join(raw, k + ".csv.gz"),
                                    np.int64)[:, 0] for k in _EXTRAS}
    labels_raw = code2._read_csv_gz(osp.join(raw, "graph-label.csv.gz"))
    split = code2.read_split(osp.join(ddir, "split",
                                      META["ogbg-code2"]["split"]))

    out = osp.join(ddir, "processed")
    os.makedirs(out, exist_ok=True)
    np.savez_compressed(
        osp.join(out, "data.npz"),
        edge=edge.astype(np.int32),
        num_nodes=num_nodes.astype(np.int32),
        num_edges=num_edges.astype(np.int32),
        node_feat=node_feat.astype(np.int32),
        **{k: v.astype(np.int32) for k, v in extras.items()},
        **{f"split_{k}": v.astype(np.int32) for k, v in split.items()},
    )
    with open(osp.join(out, "labels.txt"), "w") as f:
        for i in range(len(labels_raw)):
            f.write(str(labels_raw[i][0]) + "\n")


class Code2Dataset:
    """Processed ogbg-code2: per-graph dict views over flat cached arrays.

    Mirrors `PygGraphPropPredDataset` behavior (dataset_pyg.py:11-166):
    first construction downloads (if needed) and processes; later
    constructions load the cache only.
    """

    def __init__(self, root: str = "dataset", name: str = "ogbg-code2",
                 download: bool = True):
        self.name = name
        self.dir = osp.join(root, name.replace("-", "_"))
        proc = osp.join(self.dir, "processed", "data.npz")
        if not osp.exists(proc):
            if not osp.exists(osp.join(self.dir, "raw", "edge.csv.gz")):
                if not download:
                    raise FileNotFoundError(
                        f"no raw data under {self.dir}/raw")
                download_and_extract(root, name)
            process_raw(self.dir)
        d = np.load(proc)
        self.edge = d["edge"]
        self.num_nodes = d["num_nodes"]
        self.num_edges = d["num_edges"]
        self.node_feat = d["node_feat"]
        self.extras = {k: d[k] for k in _EXTRAS}
        self.split_idx = {k: d[f"split_{k}"]
                          for k in ("train", "valid", "test")}
        with open(osp.join(self.dir, "processed", "labels.txt")) as f:
            self.labels = [line.rstrip("\n").split(" ") for line in f]
        self._n_off = np.concatenate([[0], np.cumsum(self.num_nodes)])
        self._e_off = np.concatenate([[0], np.cumsum(self.num_edges)])

    def __len__(self) -> int:
        return len(self.num_nodes)

    def __getitem__(self, i: int) -> dict:
        n0, n1 = self._n_off[i], self._n_off[i + 1]
        e0, e1 = self._e_off[i], self._e_off[i + 1]
        g = {
            "edge_src": self.edge[0, e0:e1],
            "edge_dst": self.edge[1, e0:e1],
            "node_feat": self.node_feat[n0:n1],
            "num_nodes": int(n1 - n0),
            "y": self.labels[i],
        }
        for k, v in self.extras.items():
            g[k] = v[n0:n1]
        return g

    def graphs(self, idx: Optional[np.ndarray] = None) -> List[dict]:
        idx = range(len(self)) if idx is None else idx
        return [self[int(i)] for i in idx]

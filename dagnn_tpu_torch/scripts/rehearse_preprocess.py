"""Full-scale ogbg-code2 preprocessing rehearsal, on the port's data path.

Counterpart of scripts/rehearse_preprocess.py: the same synthetic raw tree
at the real corpus's scale (452,741 graphs, lognormal sizes of mean about
110 nodes, trees with the official csv.gz layout; the JAX script's
generator, draw for draw) driven through the port's copies, each stage
timed on the host clock with the process's peak RSS:

  1. raw csv.gz generation (the fixture, not a pipeline stage)
  2. Code2Dataset first construction: process_raw (data/code2.py's gzip +
     csv reader, csv.gz -> npz cache)
  3. Code2Dataset reconstruction: the cache load only
  4. the vocab over the train split
  5. raw_to_dag of every graph (augment_edge2 + the target encoding)
  6. batched topological leveling of the whole corpus, both directions
     (dag/native.py)
  7. the TOK loader's bucket over one epoch of the train split
     (data/dataloader.DAGLoader._ensure_pad at main_tok's defaults: batch
     160, chunk 256; PadConfig.for_graphs on every batch)

Host work only: no device is used. The report goes to --out.

    python -m dagnn_tpu_torch.scripts.rehearse_preprocess [--graphs 452741]
        [--root DIR] [--out results/torch_preprocess_rehearsal/REPORT.md]
"""

from __future__ import annotations

import argparse
import gzip
import os
import os.path as osp
import resource
import shutil
import tempfile
import time

import numpy as np

BATCH = 160     # main_tok's --batch_size and --chunk_size defaults
CHUNK = 256


def rss_gb() -> float:
    """The process's peak resident set so far, GB: /proc/self/status's
    VmHWM where there is one (ru_maxrss, which the JAX script reads, keeps
    the peak of the process image before an exec, so a rehearsal started
    from a large process would report its parent's), else ru_maxrss."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) / 1e6       # kB
    except OSError:
        pass
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def gen_raw(root: str, n_graphs: int, seed: int = 0):
    """The synthetic raw tree in the official csv.gz layout under
    <root>/ogbg_code2/{raw, split/project}: the JAX script's generator
    (the same draws, the same text). Returns (sizes, seconds a file)."""
    from dagnn_tpu_torch.dag.native import native_topo_levels_batch

    rng = np.random.default_rng(seed)
    ddir = osp.join(root, "ogbg_code2")
    raw = osp.join(ddir, "raw")
    split = osp.join(ddir, "split", "project")
    os.makedirs(raw, exist_ok=True)
    os.makedirs(split, exist_ok=True)

    # sizes: lognormal clipped to [4, 30000]
    sizes = np.clip(rng.lognormal(4.35, 0.85, n_graphs), 4, 30000).astype(np.int64)
    n_total = int(sizes.sum())
    offs = np.zeros(n_graphs + 1, np.int64)
    np.cumsum(sizes, out=offs[1:])

    # random trees: parent(local i) uniform in [0, i)
    local = np.arange(n_total, dtype=np.int64) - np.repeat(offs[:-1], sizes)
    parent = (rng.random(n_total) * np.maximum(local, 1)).astype(np.int64)
    root_mask = local == 0
    src_l = parent[~root_mask]
    dst_l = local[~root_mask]
    e_per_g = sizes - 1

    # node depth == the topological level of a tree
    e_offs = np.zeros(n_graphs + 1, np.int64)
    np.cumsum(e_per_g, out=e_offs[1:])
    depth = native_topo_levels_batch(src_l, dst_l, offs, e_offs)
    if depth is None:
        raise RuntimeError("the native dagcore library is unavailable; the "
                           "rehearsal needs it")

    def write_gz(name, arr, fmt="%d"):
        t0 = time.perf_counter()
        with gzip.open(osp.join(raw, name), "wt", compresslevel=1) as f:
            np.savetxt(f, arr, fmt=fmt, delimiter=",")
        return time.perf_counter() - t0

    times = {}
    times["edge.csv.gz"] = write_gz("edge.csv.gz", np.stack([src_l, dst_l], 1))
    times["num-node-list.csv.gz"] = write_gz("num-node-list.csv.gz", sizes[:, None])
    times["num-edge-list.csv.gz"] = write_gz("num-edge-list.csv.gz", e_per_g[:, None])
    feat = np.stack([rng.integers(0, 98, n_total),
                     rng.integers(0, 10030, n_total)], 1)
    times["node-feat.csv.gz"] = write_gz("node-feat.csv.gz", feat)
    times["node_is_attributed.csv.gz"] = write_gz(
        "node_is_attributed.csv.gz", rng.integers(0, 2, n_total)[:, None])
    times["node_dfs_order.csv.gz"] = write_gz("node_dfs_order.csv.gz", local[:, None])
    times["node_depth.csv.gz"] = write_gz("node_depth.csv.gz",
                                          depth.astype(np.int64)[:, None])

    # labels: 1-5 zipf-ish subtokens a graph, ONE csv field of
    # space-separated subtokens (ogb/io/read_graph_raw.py:137-138)
    toks = np.array([f"tok{i}" for i in range(9000)])
    t0 = time.perf_counter()
    nt = rng.integers(1, 6, n_graphs)
    tok_idx = (rng.pareto(1.2, int(nt.sum())) * 37).astype(np.int64) % 9000
    labels, pos = [], 0
    for k in nt:
        labels.append(" ".join(toks[tok_idx[pos:pos + k]]))
        pos += k
    with gzip.open(osp.join(raw, "graph-label.csv.gz"), "wt", compresslevel=1) as f:
        f.write("\n".join(labels) + "\n")
    times["graph-label.csv.gz"] = time.perf_counter() - t0

    # project split about 90 / 4.5 / 5.5, as the real corpus's
    perm = rng.permutation(n_graphs)
    a, b = int(n_graphs * 0.90), int(n_graphs * 0.945)
    for name, idx in (("train", perm[:a]), ("valid", perm[a:b]), ("test", perm[b:])):
        with gzip.open(osp.join(split, f"{name}.csv.gz"), "wt", compresslevel=1) as f:
            np.savetxt(f, np.sort(idx)[:, None], fmt="%d")
    return sizes, times


def rehearse(root: str, n_graphs: int) -> dict:
    """Every stage on a fresh tree under `root`. Returns {"stages": [(name,
    wall s, peak RSS GB)], "notes": [...], "vocab2idx", "levels": (forward,
    reverse) level of every node, "bucket": the epoch's PadConfig}."""
    from dagnn_tpu_torch.dag.native import native_topo_levels_batch
    from dagnn_tpu_torch.data import code2
    from dagnn_tpu_torch.data.code2_dataset import Code2Dataset
    from dagnn_tpu_torch.data.dataloader import DAGLoader

    stages, notes = [], []

    def stage(name, t0):
        stages.append((name, time.perf_counter() - t0, rss_gb()))

    t0 = time.perf_counter()
    sizes, gen_times = gen_raw(root, n_graphs)
    stage("raw fixture generation (not a pipeline stage)", t0)
    notes.append(f"nodes total {int(sizes.sum())}, mean {sizes.mean():.1f}, "
                 f"max {sizes.max()}")
    notes.append("csv.gz write breakdown (fixture): " + ", ".join(
        f"{k} {v:.1f}s" for k, v in gen_times.items()))

    t0 = time.perf_counter()
    Code2Dataset(root)
    stage("Code2Dataset first build (process_raw: gzip + csv reader, csv.gz->npz)", t0)
    t0 = time.perf_counter()
    ds = Code2Dataset(root)
    stage("Code2Dataset reload (npz cache)", t0)

    split = ds.split_idx
    t0 = time.perf_counter()
    vocab2idx, _ = code2.get_vocab_mapping([ds[i]["y"] for i in split["train"]], 5000)
    stage(f"vocab build over {len(split['train'])} train ys", t0)

    t0 = time.perf_counter()
    graphs = [code2.raw_to_dag(ds[i], vocab2idx, 5) for i in range(len(ds))]
    stage(f"raw_to_dag x {len(ds)} (augment_edge2 + y encode)", t0)

    t0 = time.perf_counter()
    n_off = np.zeros(len(graphs) + 1, np.int64)
    np.cumsum([g.num_nodes for g in graphs], out=n_off[1:])
    e_off = np.zeros(len(graphs) + 1, np.int64)
    np.cumsum([g.num_edges for g in graphs], out=e_off[1:])
    src = np.concatenate([g.edge_src for g in graphs])
    dst = np.concatenate([g.edge_dst for g in graphs])
    lv_f = native_topo_levels_batch(src, dst, n_off, e_off)
    lv_r = native_topo_levels_batch(dst, src, n_off, e_off)
    if lv_f is None or lv_r is None:
        raise RuntimeError("the native dagcore library is unavailable")
    stage(f"batched topo leveling, both dirs, {len(src)} edges", t0)

    loader = DAGLoader([graphs[i] for i in split["train"]], BATCH, shuffle=True,
                       seed=0, chunk_size=CHUNK)
    batches = loader._epoch_batches()
    t0 = time.perf_counter()
    pad = loader._ensure_pad(batches)
    stage(f"loader bucket (DAGLoader._ensure_pad) over {len(batches)} train "
          f"batches of {BATCH}, chunk {CHUNK}", t0)
    notes.append(f"bucket: {pad}; {stages[-1][1] / len(batches):.4f} s a batch")
    return {"stages": stages, "notes": notes, "vocab2idx": vocab2idx,
            "levels": (lv_f, lv_r), "bucket": pad}


def report(n_graphs: int, res: dict) -> str:
    lines = [f"# Preprocessing rehearsal (dagnn_tpu_torch) — {n_graphs} graphs", "",
             "| stage | wall s | peak RSS GB |", "|---|---|---|"]
    lines += [f"| {name} | {secs:.1f} | {rss:.2f} |" for name, secs, rss in res["stages"]]
    return "\n".join(lines + [""] + res["notes"]) + "\n"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--graphs", type=int, default=452741)
    ap.add_argument("--root", default=None,
                    help="where the raw tree goes (default: a new temporary directory)")
    ap.add_argument("--out", default="results/torch_preprocess_rehearsal/REPORT.md")
    ap.add_argument("--keep-root", action="store_true")
    args = ap.parse_args(argv)
    root = args.root or tempfile.mkdtemp(prefix="code2_rehearsal_")
    tree = osp.join(root, "ogbg_code2")      # the only thing written under root
    if osp.isdir(tree):
        shutil.rmtree(tree)
    try:
        res = rehearse(root, args.graphs)
    finally:
        if not args.keep_root:
            shutil.rmtree(tree if args.root else root, ignore_errors=True)
    text = report(args.graphs, res)
    os.makedirs(osp.dirname(osp.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(text)
    print(text, end="")
    print("->", args.out)
    return res


if __name__ == "__main__":
    main()

"""The port's copies of the driver's host modules are held to their
originals on the same inputs: data/code2.py (vocab, codecs, both edge
augmentations, raw_to_dag, the raw reader on a constructed tree and on
the repo's data/train*.csv.gz, eval_f1 / eval_acc),
data/code2_dataset.py (npz cache from a raw tree and from a file:// zip,
the zip-slip guard), data/dataloader.py (PadConfigs and batches, bit for
bit, across shuffle seeds, epochs and prefetch), train/metrics.py
(byte-equal CSVs); train/losses.class_loss against the JAX loss (f32
2e-5, pad graphs with non-finite logits included); and the port's own
checkpoint format (weights_only round trip, rotation names)."""

import dataclasses
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dagnn_tpu.data import code2 as jcode2
from dagnn_tpu.data import code2_dataset as jc2d
from dagnn_tpu.data import dataloader as jloader
from dagnn_tpu.data import synthetic as jsyn
from dagnn_tpu.train import checkpoint as jckpt
from dagnn_tpu.train import losses as jlosses
from dagnn_tpu.train import metrics as jmetrics
from dagnn_tpu_torch.data import code2 as tcode2
from dagnn_tpu_torch.data import code2_dataset as tc2d
from dagnn_tpu_torch.data import dataloader as tloader
from dagnn_tpu_torch.data import synthetic as tsyn
from dagnn_tpu_torch.train import checkpoint as tckpt
from dagnn_tpu_torch.train import losses as tlosses
from dagnn_tpu_torch.train import metrics as tmetrics
from test_code2_dataset import make_raw_tree
from test_torch_dag import _same

torch.set_num_threads(1)


def _same_graph(a, b, path):
    for f in ("num_nodes", "edge_src", "edge_dst", "x", "edge_attr", "extras", "y"):
        _same(getattr(a, f), getattr(b, f), f"{path}.{f}")


def _zip_tree(tmp_path, n_graphs, seed):
    """An official-shaped archive code2.zip holding code2/{raw,split}."""
    src = tmp_path / "build" / "code2"
    make_raw_tree(str(src), n_graphs=n_graphs, seed=seed)
    zpath = tmp_path / "build" / "code2_official.zip"
    with zipfile.ZipFile(zpath, "w") as z:
        for dirp, _, files in os.walk(src):
            for f in files:
                full = os.path.join(dirp, f)
                z.write(full, os.path.relpath(full, tmp_path / "build"))
    return zpath


def test_code2_matches_original(tmp_path):
    ddir = str(tmp_path / "ogbg_code2")
    make_raw_tree(ddir, n_graphs=9, seed=4)
    raw = os.path.join(ddir, "raw")
    jr, tr = jcode2.read_code2_raw(raw), tcode2.read_code2_raw(raw)
    _same(jr, tr, "raws")
    split = os.path.join(ddir, "split", "project")
    _same(jcode2.read_split(split), tcode2.read_split(split), "split")
    seqs = [g["y"] for g in jr] + [["a", "b", "a"], ["b", "a", "c"], ["d"]]
    for n in (2, 3, 50):
        assert jcode2.get_vocab_mapping(seqs, n) == tcode2.get_vocab_mapping(seqs, n)
    v2i, i2v = tcode2.get_vocab_mapping(seqs, 4)
    for seq in (["get", "oov", "value"], [], ["a"] * 7):
        for L in (1, 5):
            arr = tcode2.encode_seq_to_arr(seq, v2i, L)
            _same(jcode2.encode_seq_to_arr(seq, v2i, L), arr, "encode")
            assert jcode2.decode_arr_to_seq(arr, i2v) == \
                tcode2.decode_arr_to_seq(arr, i2v)
    for g in jr:
        args = (g["edge_src"], g["edge_dst"], g["node_is_attributed"])
        _same(jcode2.augment_edge(*args), tcode2.augment_edge(*args), "augment_edge")
        _same(jcode2.augment_edge2(*args), tcode2.augment_edge2(*args),
              "augment_edge2")
        for dag_only in (True, False):
            _same_graph(jcode2.raw_to_dag(g, v2i, 5, dag_only),
                        tcode2.raw_to_dag(g, v2i, 5, dag_only), "raw_to_dag")
    for name in ("train10", "train15", "train20"):     # the repo's subsets
        path = os.path.join(os.path.dirname(__file__), "..", "data", f"{name}.csv.gz")
        _same(jcode2.read_train_subset_idx(path), tcode2.read_train_subset_idx(path),
              name)
    refs = [["a", "b"], ["x"], ["x"], ["p", "q", "r"]]
    preds = [["a", "c"], ["x"], [], ["q", "p", "s", "t"]]
    assert jcode2.eval_f1(refs, preds) == tcode2.eval_f1(refs, preds)
    yt, yp = np.array([1, 2, 3, 4]), np.array([1, 2, 4, 4])
    assert jcode2.eval_acc(yt, yp) == tcode2.eval_acc(yt, yp)


@pytest.mark.parametrize("source", ["raw_tree", "file_zip"])
def test_code2_dataset_matches_original(tmp_path, monkeypatch, source):
    """The same npz cache and graph views from a raw tree, and from an
    archive fetched through a file:// URL."""
    out = {}
    for tag, mod in (("jax", jc2d), ("port", tc2d)):
        root = str(tmp_path / tag)
        if source == "raw_tree":
            make_raw_tree(os.path.join(root, "ogbg_code2"), n_graphs=7, seed=2)
            ds = mod.Code2Dataset(root, download=False)
        else:
            zpath = _zip_tree(tmp_path / tag, n_graphs=5, seed=3)
            monkeypatch.setitem(mod.META["ogbg-code2"], "url", "file://" + str(zpath))
            ds = mod.Code2Dataset(root)
        out[tag] = ds
    j, t = out["jax"], out["port"]
    assert len(j) == len(t)
    for k in ("edge", "num_nodes", "num_edges", "node_feat"):
        _same(getattr(j, k), getattr(t, k), k)
    _same(j.extras, t.extras, "extras")
    _same(j.split_idx, t.split_idx, "split_idx")
    assert j.labels == t.labels
    _same(j.graphs(), t.graphs(), "graphs")


def test_code2_dataset_refusals(tmp_path):
    root = tmp_path / "dataset"
    os.makedirs(root)
    with zipfile.ZipFile(root / "code2.zip", "w") as z:
        z.writestr("../evil.txt", "pwn")
    with pytest.raises(RuntimeError, match="unsafe zip member"):
        tc2d.download_and_extract(str(root))
    assert not (tmp_path / "evil.txt").exists()
    with pytest.raises(FileNotFoundError):
        tc2d.Code2Dataset(str(tmp_path / "empty"), download=False)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("prefetch", [0, 2])
def test_dagloader_matches_original(seed, prefetch):
    kw = dict(mean_nodes=20, vocab=20, seq_len=5)
    jg, tg = jsyn.synthetic_ast_batch(7, 40, **kw), tsyn.synthetic_ast_batch(7, 40, **kw)
    for shuffle in (True, False):
        mk = lambda mod, gs: mod.DAGLoader(gs, 8, shuffle=shuffle, seed=seed,
                                           chunk_size=32, prefetch=prefetch)
        jl, tl = mk(jloader, jg), mk(tloader, tg)
        assert len(jl) == len(tl) == 5
        for epoch in range(2):
            jb, tb = list(jl), list(tl)
            assert dataclasses.astuple(jl._pad) == dataclasses.astuple(tl._pad), \
                (shuffle, epoch)
            _same(jb, tb, f"shuffle {shuffle} epoch {epoch}")


def test_dagloader_refusals():
    """n_shards > 1 is taken (no refusal): each batch comes as its
    node-balanced shards stacked on a leading axis
    (tests/test_torch_parallel.py holds them to the original's)."""
    tloader.DAGLoader([], 8, n_shards=2)
    graphs = tsyn.synthetic_ast_batch(7, 16, mean_nodes=20, vocab=20, seq_len=5)
    batches = list(tloader.DAGLoader(graphs, 8, chunk_size=32, n_shards=2))
    assert len(batches) == 2
    assert all(b.graph_mask.shape[0] == 2 and b.x.shape[0] == 2 for b in batches)


def test_dagloader_prefetch_error_raised(monkeypatch):
    """A collation error in the prefetch thread reaches the consumer after
    the batches before it, instead of ending the epoch early."""
    graphs = tsyn.synthetic_ast_batch(7, 24, mean_nodes=20, vocab=20, seq_len=5)
    calls, orig = [], tloader.collate

    def collate(gs, pad):
        calls.append(len(gs))
        if len(calls) == 2:
            raise ValueError("bad batch")
        return orig(gs, pad)

    loader = tloader.DAGLoader(graphs, 8, chunk_size=32, prefetch=2)
    monkeypatch.setattr(tloader, "collate", collate)
    got = []
    with pytest.raises(ValueError, match="bad batch"):
        for b in loader:
            got.append(b)
    assert len(got) == 1


def test_run_logger_csvs_byte_equal(tmp_path):
    for tag, mod in (("jax", jmetrics), ("port", tmetrics)):
        log = mod.RunLogger(str(tmp_path / tag), "m")
        log.log_epoch(1, 1, 8.5, 0.1, 0.2, 0.3, 1.25)
        log.log_epoch(1, 2, 7.25, 0.15, 0.25, 1 / 3, 0.5)
        log.log_fold(1, 2, 0.15, 0.25, 1 / 3)
        log.log_fold(2, 1, 0.1, 0.5, 0.2)
    for fn in ("m_train.csv", "m.csv", "m_times.csv"):
        assert (tmp_path / "jax" / fn).read_bytes() == \
            (tmp_path / "port" / fn).read_bytes(), fn
    times = str(tmp_path / "port" / "m_times.csv")
    assert tmetrics.report_epoch_times(times) == jmetrics.report_epoch_times(times)


def test_class_loss_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(6, 275)).astype(np.float32) * 3
    y = rng.integers(0, 275, 6).astype(np.int32)
    mask = np.array([1, 1, 0, 1, 1, 0], bool)
    logits[2, :] = np.inf           # pad graphs: non-finite logits
    logits[5, 7] = np.nan
    jval, jgrad = jax.value_and_grad(jlosses.class_loss)(
        jnp.asarray(logits), jnp.asarray(y), jnp.asarray(mask))
    t = torch.tensor(logits, requires_grad=True)
    tval = tlosses.class_loss(t, torch.tensor(y), torch.tensor(mask))
    (tgrad,) = torch.autograd.grad(tval, t)
    assert np.isfinite(float(tval.detach())) and torch.isfinite(tgrad).all()
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), rtol=2e-5,
                               atol=2e-5)


def test_checkpoint_roundtrip_and_names(tmp_path):
    params = {"enc.w": torch.arange(12.0).reshape(3, 4),
              "cells.0.w_ih": torch.full((9, 3), 2.0, dtype=torch.bfloat16)}
    state = {"count": torch.tensor(5, dtype=torch.int32),
             "mu": {k: v * 0.5 for k, v in params.items()},
             "nu": {k: v * 0.25 for k, v in params.items()}}
    results = {"best": {"epoch": 5, "train": 0.5, "valid": 0.25, "test": 0.125},
               "patience": 3}
    path = tckpt.checkpoint_name(str(tmp_path), "m", 1, 5)
    assert path == jckpt.checkpoint_name(str(tmp_path), "m", 1, 5)
    tckpt.create_checkpoint(path, 5, params, state, results)
    assert not os.path.exists(path + ".tmp")
    torch.load(path, weights_only=True)            # plain data only
    zeros = lambda tree: {k: zeros(v) if isinstance(v, dict) else torch.zeros_like(v)
                          for k, v in tree.items()}
    res, epoch, p2, s2 = tckpt.load_checkpoint(path, zeros(params), zeros(state))
    assert (res, epoch) == (results, 5)
    assert tckpt.load_checkpoint_results(path) == results
    for k in params:
        assert p2[k].dtype == params[k].dtype and torch.equal(p2[k], params[k])
        assert torch.equal(s2["mu"][k], state["mu"][k])
    assert s2["count"].dtype == torch.int32 and int(s2["count"]) == 5
    bad = dict(zeros(params), **{"enc.w": torch.zeros(4, 3)})
    with pytest.raises(ValueError, match="enc.w"):
        tckpt.load_checkpoint(path, bad, zeros(state))
    with pytest.raises(ValueError, match="keys differ"):
        tckpt.load_checkpoint(path, {"enc.w": params["enc.w"]}, zeros(state))
    # discovery and (fold, epoch) parsing on the JAX tests' names
    for fn in ("m_1_5.ckpt", "m_0_1.ckpt", "m_0_2.ckpt", "m_x_2.ckpt",
               "mm_9_9.ckpt", "m_1_5.ckpt.tmp"):
        (tmp_path / fn).touch()
    for d, name in ((str(tmp_path), "m"), (str(tmp_path), "mm"),
                    (str(tmp_path), "n"), (str(tmp_path / "none"), "m")):
        assert tckpt.find_latest_checkpoint(d, name) == \
            jckpt.find_latest_checkpoint(d, name)
    assert tckpt.find_latest_checkpoint(str(tmp_path), "m").endswith("m_1_5.ckpt")
    for fn in ("m_1_5.ckpt", "dagnn_tok_2_10.ckpt", "a_b_0_1.ckpt"):
        assert tckpt.parse_fold_epoch(fn) == jckpt.parse_fold_epoch(fn)
    tckpt.remove_checkpoint(path)
    tckpt.remove_checkpoint(path)                  # absent: no error
    assert not os.path.exists(path)

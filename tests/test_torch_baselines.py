"""The port's baselines (dagnn_tpu_torch/nn/baselines.py, the unleveled
loader, the driver's model routing, cli/main_basic.py) against the JAX
package on the CPU.

Inputs: small 4-way augmented (cyclic) ASTs made from a seed with numpy,
collated by each package's own collate (schedules off) and checked equal;
weights: the JAX package's mpnn_init, carried over by
convert.params_from_numpy. Tolerances (the JAX package's layout tests,
tests/test_pair.py:105-127): logits within 2e-5 of their own max|JAX|,
every gradient leaf within rtol 5e-4 / atol 5e-5. The trivial baselines,
the loader's PadConfigs and batches, the model configs, main_basic's CSV
rows and a resumed driver run are held bit for bit.

Sizes: emb 8, 3 layers, 4 graphs of 5-12 nodes, head 11 x 3; the driver
runs emb 16 on 60 synthetic ASTs of mean 20 nodes, batch 8. The JAX side
compiles one forward and VJP per configuration (jax.jit, the batch as an
argument).
"""

import argparse
import csv
import dataclasses
import gzip
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dagnn_tpu.cli import main_basic as jmain_basic
from dagnn_tpu.cli import ogb_driver as jdriver
from dagnn_tpu.dag import batch as jbatch_mod
from dagnn_tpu.data import code2 as jcode2
from dagnn_tpu.data import dataloader as jloader
from dagnn_tpu.nn import baselines as jb
from dagnn_tpu.nn import encoders as jenc
from dagnn_tpu_torch import checks, convert
from dagnn_tpu_torch.cli import main_basic as tmain_basic
from dagnn_tpu_torch.cli import main_tok
from dagnn_tpu_torch.cli import ogb_driver as tdriver
from dagnn_tpu_torch.dag import batch as tbatch_mod
from dagnn_tpu_torch.data import code2 as tcode2
from dagnn_tpu_torch.data import dataloader as tloader
from dagnn_tpu_torch.nn import baselines as tb
from dagnn_tpu_torch.nn import encoders as tenc
from dagnn_tpu_torch.train import checkpoint as tckpt
from test_code2_dataset import make_raw_tree
from test_torch_dag import _same

torch.set_num_threads(1)

EMB, VOCAB, SEQ = 8, 11, 3


def graph_data(n_graphs=4, seed=0):
    """Per graph: a random tree on 5-12 nodes with the 4-way augmentation
    (AST, inverse, next-token and its inverse: cycles), AST node ids
    (type < 9, attr < 11), depths, a target sequence."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_graphs):
        n = int(rng.integers(5, 13))
        dst = np.arange(1, n)
        src = np.array([int(rng.integers(0, i)) for i in dst])
        attributed = (rng.random(n) < 0.6).astype(np.int64)
        s, d, a = jcode2.augment_edge(src, dst, attributed)
        ts, td, ta = tcode2.augment_edge(src, dst, attributed)
        assert (np.array_equal(s, ts) and np.array_equal(d, td)
                and np.array_equal(a, ta))
        depth = np.zeros(n, np.int64)
        for i, p in zip(dst, src):
            depth[i] = depth[p] + 1
        out.append(dict(num_nodes=n, edge_src=s, edge_dst=d, edge_attr=a,
                        x=np.stack([rng.integers(0, 9, n), rng.integers(0, 11, n)], 1),
                        extras={"node_depth": depth},
                        y={"y_arr": rng.integers(0, VOCAB, SEQ).astype(np.int32)}))
    return out


def graphs_of(mod, data):
    return [mod.DAGGraph(**{k: (dict(v) if isinstance(v, dict) else v)
                            for k, v in g.items()}) for g in data]


def batches(data=None, pad=None):
    """(JAX's host batch, the port's host batch) of the same graphs,
    unleveled (a count-only PadConfig with pad nodes, edges and a pad graph
    slot), equal field by field."""
    data = data or graph_data()
    pad = pad or dict(max_nodes=sum(g["num_nodes"] for g in data) + 3,
                      max_edges=sum(len(g["edge_src"]) for g in data) + 5,
                      max_graphs=len(data) + 1, max_levels=1,
                      nodes_per_level=1, edges_per_level=1)
    jbt = jbatch_mod.collate(graphs_of(jbatch_mod, data), jbatch_mod.PadConfig(**pad),
                             build_schedules=False)
    tbt = tbatch_mod.collate(graphs_of(tbatch_mod, data), tbatch_mod.PadConfig(**pad),
                             build_schedules=False)
    for f in ("x", "edge_attr", "graph_id", "node_mask", "graph_mask",
              "edge_src_flat", "edge_dst_flat", "edge_mask_flat", "extras", "y"):
        _same(getattr(jbt, f), getattr(tbt, f), f)
    return jbt, tbt


def ast_spec(mod):
    return mod.EncoderSpec("ast", emb_dim=EMB, num_nodetypes=9,
                           num_nodeattributes=11, max_depth=20)


CASES = {
    "gin": dict(gnn_type="gin"),
    "gin-virtual": dict(gnn_type="gin", virtual_node=True),
    "gcn": dict(gnn_type="gcn"),
    "gcn-virtual": dict(gnn_type="gcn", virtual_node=True),
    "gat-heads2": dict(gnn_type="gat", heads=2),
    "ggnn": dict(gnn_type="ggnn", timesteps=2),
    "gin-virtual-jk-sum-residual": dict(gnn_type="gin", virtual_node=True,
                                        jk="sum", residual=True),
    "gin-attention-pool": dict(gnn_type="gin", graph_pooling="attention"),
    "gcn-virtual-class-head-max-pool": dict(gnn_type="gcn", virtual_node=True,
                                            num_class=7, graph_pooling="max"),
    "gat-add-pool-residual": dict(gnn_type="gat", heads=2, residual=True,
                                  graph_pooling="add"),
}


def cfgs(case):
    kw = dict(num_layers=3, emb_dim=EMB, dropout=0.0, num_vocab=VOCAB,
              max_seq_len=SEQ, **CASES[case])
    return (jb.MPNNConfig(encoder=ast_spec(jenc), **kw),
            tb.MPNNConfig(encoder=ast_spec(tenc), **kw))


_JAX = {}


def jax_reference(case, jbt):
    """JAX's logits and every gradient leaf (flat) of sum(logits * ct), ct
    a seeded cotangent; one compile per case."""
    if case not in _JAX:
        jc, _ = cfgs(case)
        params = jb.mpnn_init(jax.random.PRNGKey(3), jc)

        def f(p, b, ct):
            out, vjp = jax.vjp(lambda q: jb.mpnn_forward(q, jc, b), p)
            return out, vjp(ct)[0]

        b = jax.tree.map(jnp.asarray, jbt)
        shape = jax.eval_shape(lambda p: jb.mpnn_forward(p, jc, b), params).shape
        ct = np.random.default_rng(5).normal(size=shape).astype(np.float32)
        out, grads = jax.jit(f)(params, b, jnp.asarray(ct))
        _JAX[case] = (jax.tree.map(np.asarray, params), np.asarray(out), ct,
                      convert.flatten_tree(jax.tree.map(np.asarray, grads)))
    return _JAX[case]


def port_run(params, tc, tbt, ct):
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    out = tb.mpnn_forward(p, tc, convert.batch_to_torch(tbt, "cpu"))
    (out * torch.as_tensor(ct)).sum().backward()
    return out.detach(), {k: torch.zeros_like(v) if v.grad is None else v.grad
                          for k, v in p.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_mpnn_matches_jax(case):
    jbt, tbt = batches()
    jparams, jout, ct, jgrads = jax_reference(case, jbt)
    _, tc = cfgs(case)
    params = convert.params_from_numpy(jparams, "cpu")
    init = tb.mpnn_init(0, tc, device="cpu")
    assert {k: v.shape for k, v in init.items()} == {k: v.shape for k, v in params.items()}
    out, grads = port_run(params, tc, tbt, ct)
    rel = checks.rel_err(out, jout)[0]
    assert rel <= 2e-5, f"{case}: logits {rel:.3g} of max|JAX|"
    assert set(grads) == set(jgrads)
    for k, g in jgrads.items():
        np.testing.assert_allclose(grads[k].numpy(), g, rtol=5e-4, atol=5e-5,
                                   err_msg=f"{case}: grad {k}")


def test_mpnn_dropout_needs_a_generator():
    """Training with dropout draws from a torch.Generator; without one it
    raises. Evaluation ignores dropout."""
    _, tbt = batches()
    _, tc = cfgs("gin-virtual")
    tc = dataclasses.replace(tc, dropout=0.5)
    params = tb.mpnn_init(0, tc, device="cpu")
    b = convert.batch_to_torch(tbt, "cpu")
    with pytest.raises(ValueError, match="Generator"):
        tb.mpnn_forward(params, tc, b, train=True)
    a = tb.mpnn_forward(params, tc, b, rng=torch.Generator().manual_seed(1), train=True)
    c = tb.mpnn_forward(params, tc, b, rng=torch.Generator().manual_seed(1), train=True)
    assert torch.equal(a, c)
    assert not torch.equal(a, tb.mpnn_forward(params, tc, b))


@pytest.mark.parametrize("min_occ", [1, 2])
def test_trivial_baselines_bitwise(min_occ):
    jbt, tbt = batches()
    mapping = {i: (3 * i) % VOCAB for i in range(0, 11, 2)}
    np.testing.assert_array_equal(
        tb.guess_node_one_token(tbt, mapping, VOCAB, SEQ),
        jb.guess_node_one_token(jbt, mapping, VOCAB, SEQ))
    np.testing.assert_array_equal(
        tb.guess_tokens_by_occurrence(tbt, mapping, VOCAB, SEQ, min_occ=min_occ),
        jb.guess_tokens_by_occurrence(jbt, mapping, VOCAB, SEQ, min_occ=min_occ))
    np.testing.assert_array_equal(tb.perfect_model(tbt, VOCAB, SEQ),
                                  jb.perfect_model(jbt, VOCAB, SEQ))


@pytest.mark.parametrize("prefetch", [0, 2])
def test_unleveled_loader_matches_original(prefetch):
    """DAGLoader(schedules=False) on cyclic graphs: the count-only bucket
    and every batch bit for bit, across shuffled epochs."""
    data = graph_data(n_graphs=19, seed=2)
    mk = lambda mod, bm: mod.DAGLoader(graphs_of(bm, data), 4, shuffle=True,
                                       seed=7, chunk_size=32, prefetch=prefetch,
                                       schedules=False)
    jl, tl = mk(jloader, jbatch_mod), mk(tloader, tbatch_mod)
    assert (tl.edge_budget, tl.stagger) == (jl.edge_budget, jl.stagger) == (0, 0)
    for epoch in range(2):
        jbs, tbs = list(jl), list(tl)
        assert dataclasses.astuple(jl._pad) == dataclasses.astuple(tl._pad)
        assert tl._pad.max_levels == 8          # max_levels 1, rounded
        _same(jbs, tbs, f"epoch {epoch}")


GNNS = ["dagnn", "gin", "gin-virtual", "gcn", "gcn-virtual", "ggnns", "ggnn",
        "ggnn-etype", "gat", "dgcnn", "diffpool", "unet", "sagpool", "asap"]


def _cfg_dict(cfg):
    d = dataclasses.asdict(cfg)
    d["encoder"] = dataclasses.asdict(cfg.encoder)
    return type(cfg).__name__, d


@pytest.mark.parametrize("layers", ["2", "4"])
@pytest.mark.parametrize("task", ["tok", "lp"])
@pytest.mark.parametrize("gnn", GNNS)
def test_build_model_cfg_matches_jax(gnn, task, layers):
    argv = ["--gnn", gnn, "--dagnn_layers", layers, "--dagnn_dropout", "0.25",
            "--segment_impl", "dense", "--compute_dtype", "float32"]
    args = {tag: mod.add_common_args(argparse.ArgumentParser()).parse_args(argv)
            for tag, mod in (("jax", jdriver), ("port", tdriver))}
    j = _cfg_dict(jdriver.build_model_cfg(args["jax"], task))
    t = _cfg_dict(tdriver.build_model_cfg(args["port"], task))
    assert t == j


def _write_mapping(path, rows):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with gzip.open(path, "wt", newline="") as f:
        w = csv.writer(f)
        w.writerow(["attr idx", "attr"])
        w.writerows(rows)


def test_attr_mapping_skips_what_pandas_reads_as_missing(tmp_path):
    """The JAX driver reads mapping/attridx2attr.csv.gz with pandas, whose
    default missing-value strings become NaN and never match a vocab word;
    the port reads it with csv and skips the same strings."""
    pd = pytest.importorskip("pandas")
    words = ["get", "null", "nan", "None", "NA", "", "n/a", "value", "idx", "NULL"]
    path = str(tmp_path / "ds" / "ogbg_code2" / "mapping" / "attridx2attr.csv.gz")
    _write_mapping(path, list(enumerate(words)))
    df = pd.read_csv(path)
    want = [(int(i), a) for i, a in zip(df["attr idx"], df["attr"]) if isinstance(a, str)]
    assert tmain_basic.read_attr_mapping(path) == want
    vocab2idx = {w: i for i, w in enumerate(words)}
    args = argparse.Namespace(data_root=str(tmp_path / "ds"))
    assert (tmain_basic.build_attr_map(args, vocab2idx)
            == jmain_basic.build_attr_map(args, vocab2idx))


@pytest.mark.parametrize("source", ["synthetic", "raw"])
def test_main_basic_writes_jax_rows(tmp_path, source):
    rows = {}
    for tag, mod in (("jax", jmain_basic), ("port", tmain_basic)):
        if source == "synthetic":
            flags = ["--synthetic", "60", "--num_vocab", "30"]
        else:
            root = tmp_path / tag / "ds"
            make_raw_tree(str(root / "ogbg_code2"), n_graphs=30, seed=4)
            _write_mapping(str(root / "ogbg_code2" / "mapping" / "attridx2attr.csv.gz"),
                           [(i, w) for i, w in enumerate(
                               ["get", "set", "null", "value", "name", "idx", "nan",
                                "get", "x", "y", "None"])])
            flags = ["--data_root", str(root), "--num_vocab", "10"]
        out = str(tmp_path / tag / "results")
        mod.main(flags + ["--batch_size", "7", "--dir_results", out])
        mod.main(flags + ["--model", "perfect", "--dir_results", out])
        with open(os.path.join(out, "baselines_basic.csv")) as f:
            rows[tag] = f.read()
    assert rows["port"] == rows["jax"]
    lines = rows["port"].splitlines()
    assert lines[0] == "model,split,precision,recall,F1" and len(lines) == 9
    assert all(r.endswith(",1.000000") for r in lines if r.startswith("perfect"))


DRIVER = ["--synthetic", "60", "--synthetic_mean_nodes", "20", "--emb_dim", "16",
          "--num_vocab", "18", "--batch_size", "8", "--folds", "1", "--cpu",
          "--gnn", "gin-virtual", "--dagnn_dropout", "0.1"]


def test_main_tok_gin_virtual_resumes_bitwise(tmp_path):
    """main_tok --gnn gin-virtual --cpu (dropout 0.1, so the generator's
    reseeding is held too): run A trains 1 epoch, run B resumes it to 2,
    run C trains 2 afresh; B's epoch 2 row and its final parameters and
    optimizer state equal C's bit for bit."""
    d = lambda tag: ["--dir_results", str(tmp_path / tag / "r"),
                     "--dir_save", str(tmp_path / tag / "s")]
    main_tok.main(DRIVER + ["--epochs", "1"] + d("A"))
    main_tok.main(DRIVER + ["--epochs", "2"] + d("A"))
    main_tok.main(DRIVER + ["--epochs", "2"] + d("C"))
    def read(tag):
        with open(tmp_path / tag / "r" / "gin-virtual_tok_train.csv") as f:
            return list(csv.reader(f))

    a, c = read("A"), read("C")
    assert a == c and len(a) == 3
    assert all(np.isfinite(float(r[2])) for r in a[1:])
    assert os.listdir(tmp_path / "A" / "s") == ["gin-virtual_tok_1_2.ckpt"]
    pa = tckpt._load(str(tmp_path / "A" / "s" / "gin-virtual_tok_1_2.ckpt"))
    pc = tckpt._load(str(tmp_path / "C" / "s" / "gin-virtual_tok_1_2.ckpt"))
    for k, v in pc["params"].items():
        assert torch.equal(pa["params"][k], v), k
    for k, v in pc["opt_state"]["mu"].items():
        assert torch.equal(pa["opt_state"]["mu"][k], v), k


def test_gin_virtual_driver_matches_jax(tmp_path, monkeypatch):
    """The port's driver against the JAX driver for --gnn gin-virtual (no
    dropout), from the JAX initial weights, one epoch (6 steps; each more
    epoch recompiles the JAX driver's steps for the loader's new bucket):
    the epoch's mean loss at rtol 5e-4 / atol 5e-5, F1 and the fold
    summary equal."""
    def init(cfg, seed, device):
        kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
        kw["encoder"] = jenc.EncoderSpec(**dataclasses.asdict(cfg.encoder))
        tree = jb.mpnn_init(jax.random.PRNGKey(seed), jb.MPNNConfig(**kw))
        return convert.params_from_numpy(jax.tree.map(np.asarray, tree), device=device)

    monkeypatch.setattr(tdriver, "init_params", init)
    argv = DRIVER[:-2] + ["--epochs", "1", "--lr", "5e-3", "--checkpointing", "0"]
    res, rows = {}, {}
    for tag, mod in (("jax", jdriver), ("port", tdriver)):
        args = mod.add_common_args(argparse.ArgumentParser()).parse_args(
            argv + ["--dir_results", str(tmp_path / tag)])
        res[tag] = mod.run(args, "tok")
        with open(tmp_path / tag / "gin-virtual_tok_train.csv") as f:
            rows[tag] = [[float(v) for v in r] for r in list(csv.reader(f))[1:]]
    assert res["port"] == res["jax"]
    assert len(rows["port"]) == len(rows["jax"]) == 1
    for j, t in zip(rows["jax"], rows["port"]):
        assert t[:2] == j[:2]
        np.testing.assert_allclose(t[2], j[2], rtol=5e-4, atol=5e-5)
        assert t[3:] == j[3:]

"""The captured steps (dagnn_tpu_torch/train/graphs.py) of every model the
drivers run but DAGNN, on the CPU, where nothing is captured but every
call stages its inputs into the static buffers and runs the step on them,
writing the state back in place:

- for every --gnn baseline (GIN, GCN ± virtual node, the gnn2.py family,
  the pooling baselines) the driver's staged train step and predict over
  three batches of one loader bucket equal its eager ones bit for bit:
  losses, every parameter and Adam leaf, the predicted ids (dropout on
  where the model has it, so the generator is handed through); one
  capture, three replays;
- a baseline's key: two batches of one bucket share one, batches of two
  buckets do not;
- a two-epoch main_tok run of gin-virtual, staged, equals the run with
  nothing staged (ogb_driver.CAPTURED emptied) bit for bit;
- train_vae --scan-chunk epochs of SVAE_GraphRNN and DVAE_GCN, staged,
  against the JAX driver's step_scan epochs from the same weights
  (noise off; rtol 5e-4 / atol 5e-5, as tests/test_torch_graphs.py);
- ASAP's master query in its fixed-shape forms (no nonzero) against the
  form it replaced (kept here as the oracle), with ties (ReLU zeros,
  repeated rows) and destinations without a source: over candidate
  pairs (the first pool's), forward and gradient bit for bit; over
  blocks of sources (a later pool's), the forward bit for bit and the
  gradient within rtol 5e-4 / atol 5e-5 (the same powers-of-two shares,
  summed in another order), at blocks of one source, of three and of
  all; and the dense ASAP pool against the JAX package's
  _asap_pool_dense at tests/test_torch_pooling_baselines.py's tolerance.

Sizes: emb 16, batches of 6 synthetic ASTs of about 12 nodes; the pooling
baselines at dense_nodes 32; the VAEs at hs 8, nz 4 on 27 ENAS graphs.
"""

import csv
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dagnn_tpu.cli import train_vae as jdriver
from dagnn_tpu.nn import pooling_baselines as jp
from dagnn_tpu.vae import dvae_variants as jvar
from dagnn_tpu.vae import svae as jsv
from dagnn_tpu_torch import convert
from dagnn_tpu_torch.cli import main_tok, ogb_driver
from dagnn_tpu_torch.cli import train_vae as tdriver
from dagnn_tpu_torch.data.dataloader import DAGLoader
from dagnn_tpu_torch.data.synthetic import synthetic_ast_batch
from dagnn_tpu_torch.nn import pooling_baselines as tp
from dagnn_tpu_torch.nn.pooling_baselines import HPoolConfig
from dagnn_tpu_torch.ops.segment import SortedSegments
from dagnn_tpu_torch.train import checkpoint as tckpt
from dagnn_tpu_torch.train import optim
from dagnn_tpu_torch.vae import dvae_variants as tvar
from dagnn_tpu_torch.vae import svae as tsv

torch.set_num_threads(1)

BASELINES = ["gin", "gin-virtual", "gcn", "gcn-virtual", "ggnns", "ggnn-etype",
             "gat", "dgcnn", "diffpool", "unet", "sagpool", "asap"]
VOCAB = 18
RTOL, ATOL = 5e-4, 5e-5


def _cfg(gnn):
    """The driver's config for `gnn` at emb 16 (dropout 0.2), the pooling
    baselines cut to dense_nodes 32."""
    import argparse
    args = ogb_driver.add_common_args(argparse.ArgumentParser()).parse_args(
        ["--gnn", gnn, "--emb_dim", "16", "--num_vocab", str(VOCAB - 2),
         "--max_seq_len", "3", "--dagnn_dropout", "0.2", "--cpu"])
    cfg = ogb_driver.build_model_cfg(args, "tok", num_nodeattributes=40)
    if isinstance(cfg, HPoolConfig):
        cfg = dataclasses.replace(cfg, dense_nodes=32, max_nodes=24, k=10,
                                  hidden=8, asap_hidden=16)
    return cfg


def _batches(seed=0, n=18, mean_nodes=12):
    """One epoch of a baseline loader (unleveled): three batches of 6."""
    graphs = synthetic_ast_batch(seed, n, mean_nodes=mean_nodes, vocab=VOCAB,
                                 seq_len=3, num_attrs=40)
    loader = DAGLoader(graphs, 6, shuffle=True, seed=3, chunk_size=0,
                       prefetch=0, schedules=False)
    return [convert.widen_out_slots(b, loader.out_per_graph) for b in loader]


def _equal(a, b, what):
    fa, fb = convert.flatten_tree(a), convert.flatten_tree(b)
    assert fa.keys() == fb.keys(), what
    for k in fa:
        assert torch.equal(fa[k], fb[k]), f"{what}: {k}"


@pytest.fixture(scope="module")
def bucket():
    batches = _batches()
    assert len(batches) == 3
    return batches


@pytest.mark.parametrize("gnn", BASELINES)
def test_staged_baseline_steps_equal_eager_steps(gnn, bucket):
    cfg = _cfg(gnn)
    assert isinstance(cfg, ogb_driver.CAPTURED)
    opt = optim.make_optimizer(1e-2, 0.25)
    params = ogb_driver.init_params(cfg, 0, "cpu")
    ref = {k: v.clone() for k, v in params.items()}
    steps = {c: ogb_driver.make_step_fns(cfg, opt, "tok", capture=c)
             for c in (True, False)}
    runs = {}
    for c, (train_step, predict) in steps.items():
        p, s = params, opt.init(params)
        gen = torch.Generator().manual_seed(5)
        seen = []
        for b in bucket:
            p, s, loss, finite = train_step(p, s, b, gen)
            assert bool(finite)
            # copies taken now: the staged step's state is overwritten by
            # its next call
            seen.append((float(loss), {k: v.clone() for k, v in p.items()},
                         convert.tree_map(torch.clone, s),
                         predict(p, bucket[0])))
        runs[c] = seen
    for i, (cap, eag) in enumerate(zip(runs[True], runs[False])):
        assert cap[0] == eag[0], f"loss of step {i}"
        _equal(cap[1], eag[1], f"params after step {i}")
        _equal(cap[2], eag[2], f"Adam state after step {i}")
        assert torch.equal(cap[3], eag[3]), f"predict after step {i}"
    train_step, predict = steps[True]
    assert (train_step.captured.captures, train_step.captured.replays) == (1, 3)
    assert (predict.captured.captures, predict.captured.replays) == (1, 3)
    _equal(params, ref, "the initial parameters")


def test_baseline_keys_follow_the_bucket(bucket):
    cfg = _cfg("asap")
    keys = {ogb_driver.step_key("train", cfg, b) for b in bucket}
    assert len(keys) == 1
    # unleveled batches carry no output-slot lists: the drivers' widening
    # leaves them as they are
    assert all(b.out_slots_fwd is None and convert.widen_out_slots(b, 9) is b
               for b in bucket)
    other = _batches(seed=1, n=6, mean_nodes=30)[0]
    assert ogb_driver.step_key("train", cfg, other) not in keys
    assert ogb_driver.step_key("predict", cfg, bucket[0]) not in keys
    # every model of the drivers is captured
    assert set(ogb_driver.CAPTURED) == set(ogb_driver.MODELS)


def test_main_tok_baseline_staged_equals_eager(tmp_path, monkeypatch):
    """main_tok --gnn gin-virtual --cpu (dropout 0.1), two epochs, staged
    against the same run with nothing staged: the CSV rows, the final
    parameters and Adam state bit for bit."""
    argv = ["--synthetic", "60", "--synthetic_mean_nodes", "20", "--emb_dim",
            "16", "--num_vocab", "18", "--batch_size", "8", "--folds", "1",
            "--cpu", "--gnn", "gin-virtual", "--dagnn_dropout", "0.1",
            "--epochs", "2"]
    d = lambda tag: ["--dir_results", str(tmp_path / tag / "r"),
                     "--dir_save", str(tmp_path / tag / "s")]
    main_tok.main(argv + d("staged"))
    monkeypatch.setattr(ogb_driver, "CAPTURED", ())
    main_tok.main(argv + d("eager"))

    def read(tag):
        with open(tmp_path / tag / "r" / "gin-virtual_tok_train.csv") as f:
            return list(csv.reader(f))

    assert read("staged") == read("eager") and len(read("eager")) == 3
    load = lambda tag: tckpt._load(str(tmp_path / tag / "s" /
                                       "gin-virtual_tok_1_2.ckpt"))
    a, b = load("staged"), load("eager")
    _equal(a["params"], b["params"], "parameters")
    _equal(a["opt_state"], b["opt_state"], "Adam state")


# ------------------------------------------------------------- train_vae

VAE_FLAGS = ["--max-count", "27", "--hs", "8", "--nz", "4", "--batch-size",
             "8", "--scan-chunk", "3", "--epochs", "1", "--save-interval",
             "10", "--no-test", "--cpu"]
JAX_VAE = {"SVAE_GraphRNN": (jsv.SVAEConfig, jsv.svae_init),
           "DVAE_GCN": (jvar.DVAEGCNConfig, jvar.dvae_gcn_init)}


def _rows(res_dir):
    with open(os.path.join(res_dir, "train_loss.txt")) as f:
        return [[float(v) for v in r] for r in list(csv.reader(f))[1:]]


@pytest.mark.parametrize("model", list(JAX_VAE))
def test_scan_chunk_epoch_matches_jax_step_scan(model, tmp_path, monkeypatch):
    """24 train graphs in batches of 8: one chunk of 3 full batches, three
    staged steps against JAX's step_scan of 3 (no tail batch), from the
    JAX init carried over, noise off."""
    mu_only = lambda rng, mu, logvar, eps_scale=0.01, training=True: mu
    for m in (jsv, jvar, tsv, tvar):
        monkeypatch.setattr(m, "reparameterize", mu_only)
    # the loss rows are compared, not the latents (one JAX compile fewer)
    for m in (jdriver, tdriver):
        monkeypatch.setattr(m, "save_latent_representations",
                            lambda *a, **k: None)
    jcfg, jinit = JAX_VAE[model]

    def init(self, seed):
        cfg = jcfg(**dataclasses.asdict(self.cfg))
        tree = jinit(jax.random.PRNGKey(seed), cfg)
        return convert.params_from_numpy(jax.tree.map(np.asarray, tree),
                                         self.device)

    monkeypatch.setattr(tdriver.VAEModel, "init", init)
    made = []
    orig = tdriver.make_captured_step
    monkeypatch.setattr(tdriver, "make_captured_step",
                        lambda step: made.append(orig(step)) or made[-1])
    flags = VAE_FLAGS + ["--model", model]
    d = lambda tag: ["--res_dir", str(tmp_path / tag)]
    jdriver.main(flags + d("jax"))
    tdriver.main(flags + d("port"))
    assert made and (made[0].captures, made[0].replays) == (1, 3)
    jrows, trows = _rows(tmp_path / "jax"), _rows(tmp_path / "port")
    assert len(jrows) == len(trows) == 1
    np.testing.assert_allclose(trows[0], jrows[0], rtol=RTOL, atol=ATOL)


# ------------------------------------------------ ASAP's master query

class _NonzeroMasterQuery(torch.autograd.Function):
    """The master query's former form, the oracle: a scatter max over the
    nonzero (g, i, j) of E (by (g, i), then j), then each tied pair's
    power-of-two weight and an ordered sum onto the sources."""

    @staticmethod
    def forward(ctx, h, E):
        G, n, d = h.shape
        g, i, j = E.transpose(1, 2).nonzero(as_tuple=True)
        dest, src = g * n + i, g * n + j
        vals = h.reshape(G * n, d)[src]
        m = torch.full((G * n, d), torch.finfo(h.dtype).min, dtype=h.dtype)
        m = m.scatter_reduce(0, dest[:, None].expand_as(vals), vals, "amax",
                             include_self=True)
        ctx.save_for_backward(h, dest, src, vals, m)
        return m.reshape(G, n, d)

    @staticmethod
    def backward(ctx, gout):
        h, dest, src, vals, m = ctx.saved_tensors
        G, n, d = h.shape
        tie = (vals == m[dest]).to(torch.int32)
        c = torch.cumsum(tie, 0)
        lo = torch.searchsorted(dest, dest)
        hi = torch.searchsorted(dest, dest, right=True)
        cz = torch.cat([torch.zeros((1, d), dtype=c.dtype), c])
        before, after = cz[:-1] - cz[lo], cz[hi] - cz[:-1] - tie
        w = tp._pow2_neg(after + (before > 0).to(torch.int32)) * tie.float()
        contrib = w.to(gout.dtype) * gout.reshape(G * n, d)[dest]
        return SortedSegments(src, G * n).sum(contrib).reshape(G, n, d), None


def _tie_rich(G, n, d, seed):
    rng = np.random.default_rng(seed)
    hv = np.maximum(rng.normal(size=(G, n, d)), 0).astype(np.float32)
    hv[:, 4] = hv[:, 1]                          # whole rows tied
    hv[:, 6, :2] = hv[:, 2, :2]
    Ev = (rng.random((G, n, n)) < 0.35) | np.eye(n, dtype=bool)[None]
    Ev[1, :, 3] = False                          # a destination without sources
    Ev[0, :, 5] = False
    ct = rng.normal(size=(G, n, d)).astype(np.float32)
    return hv, Ev, ct


@pytest.mark.parametrize("block", [1, 3, None], ids=["1", "3", "all"])
@pytest.mark.parametrize("shape", [(3, 17, 5), (2, 40, 7)])
def test_master_query_blocks_match_the_nonzero_form(shape, block, monkeypatch):
    G, n, d = shape
    if block is not None:
        monkeypatch.setattr(tp, "MASTER_QUERY_BLOCK_BYTES", 4 * G * n * d * block)
        assert len(tp._source_blocks(G, n, d)) == -(-n // block)
    hv, Ev, ct = _tie_rich(G, n, d, seed=n)
    ref_h = torch.tensor(hv, requires_grad=True)
    ref = _NonzeroMasterQuery.apply(ref_h, torch.tensor(Ev))
    (ref * torch.tensor(ct)).sum().backward()
    h = torch.tensor(hv, requires_grad=True)
    got = tp._MasterQuery.apply(h, torch.tensor(Ev))
    (got * torch.tensor(ct)).sum().backward()
    assert torch.equal(got, ref)
    assert (got == torch.finfo(torch.float32).min).any()   # no source there
    torch.testing.assert_close(h.grad, ref_h.grad, rtol=RTOL, atol=ATOL)
    # ties split: more than one source of a destination takes a share
    assert ((h.grad != 0).sum(1) > 1).any()


@pytest.mark.parametrize("shape", [(3, 17, 5), (2, 40, 7)])
def test_master_query_pairs_match_the_nonzero_form(shape):
    """The first pool's form over candidate pairs (_PairsMasterQuery):
    E's pairs among them shuffled, some repeated, with invalid entries
    (one out of range) and pairs outside E, against the former form: the
    forward and the gradient bit for bit (the same pairs, products and
    sum order)."""
    G, n, d = shape
    hv, Ev, ct = _tie_rich(G, n, d, seed=n + 1)
    rng = np.random.default_rng(n)
    g, j, i = np.nonzero(Ev)
    perm = rng.permutation(len(g))
    cand = [np.concatenate([a[perm], a[:9], rng.integers(0, hi, 30), [lo]])
            for a, hi, lo in ((g, G, G + 3), (j, n, 0), (i, n, 0))]
    valid = np.ones(len(cand[0]), bool)
    valid[-1] = False
    pairs = tuple(torch.tensor(a) for a in cand) + (torch.tensor(valid),)
    ref_h = torch.tensor(hv, requires_grad=True)
    ref = _NonzeroMasterQuery.apply(ref_h, torch.tensor(Ev))
    (ref * torch.tensor(ct)).sum().backward()
    h = torch.tensor(hv, requires_grad=True)
    got = tp._PairsMasterQuery.apply(h, torch.tensor(Ev), *pairs)
    (got * torch.tensor(ct)).sum().backward()
    assert torch.equal(got, ref)
    assert torch.equal(h.grad, ref_h.grad)


@functools.lru_cache(maxsize=None)
def _jax_asap_pool(G, n, d):
    """JAX's dense ASAP pool (value and gradients) on tie-rich inputs,
    compiled once for the cases below."""
    hv, _, _ = _tie_rich(G, n, d, seed=4)
    rng = np.random.default_rng(5)
    adj = (rng.random((G, n, n)) < 0.3).astype(np.float32)
    keep = np.ones((G, n), bool)
    keep[1, n - 3:] = False
    ct = [rng.normal(size=s).astype(np.float32) for s in ((G, n, d), (G, n, n))]
    cfg = _asap_cfg(jp.HPoolConfig, d, n)
    pp = jp.hpool_init(jax.random.PRNGKey(7), cfg)["pools"][0]

    def fun(pp, h):
        h2, a2, _ = jp._asap_pool_dense(pp, cfg, h, jnp.asarray(adj),
                                        jnp.asarray(keep))
        return (h2 * ct[0]).sum() + (a2 * ct[1]).sum()

    jl, (jgp, jgh) = jax.jit(jax.value_and_grad(fun, argnums=(0, 1)))(
        pp, jnp.asarray(hv))
    return (hv, adj, keep, ct, jax.tree.map(np.asarray, pp), float(jl),
            jax.tree.map(np.asarray, jgp), np.asarray(jgh))


def _asap_cfg(cls, d, n):
    return cls(kind="asap", emb_dim=16, num_vocab=20, max_seq_len=5,
               asap_hidden=d, dense_nodes=n, dropout=0.0)


@pytest.mark.parametrize("block", [1, None], ids=["1", "all"])
def test_asap_pool_matches_jax(block, monkeypatch):
    G, n, d = 2, 12, 5
    if block is not None:
        monkeypatch.setattr(tp, "MASTER_QUERY_BLOCK_BYTES", 4 * G * n * d * block)
    hv, adj, keep, ct, pp, jl, jgp, jgh = _jax_asap_pool(G, n, d)
    tpp = {k: v.requires_grad_(True)
           for k, v in convert.params_from_numpy(pp, "cpu").items()}
    th = torch.tensor(hv, requires_grad=True)
    h2, a2, _ = tp._asap_pool_dense(convert.unflatten_tree(tpp),
                                    _asap_cfg(HPoolConfig, d, n), th,
                                    torch.tensor(adj), torch.tensor(keep))
    tl = (h2 * torch.tensor(ct[0])).sum() + (a2 * torch.tensor(ct[1])).sum()
    tl.backward()
    assert abs(tl.item() - jl) <= 2e-5 * abs(jl)
    np.testing.assert_allclose(th.grad.numpy(), jgh, rtol=RTOL, atol=ATOL)
    for k, g in convert.flatten_tree(jgp).items():
        np.testing.assert_allclose(tpp[k].grad.numpy(), g, rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def test_kernel_name_skips_a_return_type():
    """The census reads a kernel's name from a graph's mangled symbol and
    from the profiler's demangled signature: a signature whose return type
    is not void (a std::enable_if) names the function, not the type."""
    from dagnn_tpu_torch.train.graphs import kernel_name
    assert kernel_name("std::enable_if<!(false), void>::type at::native::"
                       "(anonymous namespace)::kernel<float, 4>(int, float*)"
                       ) == "kernel"
    assert kernel_name("_ZN2at6native12_GLOBAL__N_16kernelIfLi4EEENSt9enable_"
                       "ifIXntLb0EEvE4typeEiPT_") == "kernel"
    assert kernel_name("void at::native::elementwise_kernel<128, 4, at::native"
                       "::AddFunctor<float> >(int, at::native::AddFunctor<float>)"
                       ) == "elementwise_kernel"

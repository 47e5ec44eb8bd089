"""The port's other VAEs (dagnn_tpu_torch/vae/svae.py, dvae_variants.py)
against the JAX package's on the CPU, from the same inputs and weights:
for SVAE, SVAE_oneshot, SVAE_GraphRNN, SVAE_GraphRNN_BFS, DVAE_GCN,
DVAE_fast and DVAE_DeepGMG the loss (training=False) and every gradient
leaf, the encoder's mu; the deterministic decode of the non-GraphRNN
S-VAEs; the string codec and the BFS order bit for bit from one numpy
seed; DeepGMG's padding invariance; the sampled GraphRNN decode's
structure.

Sizes: hs 16, nz 6; the three ENAS rows of tests/test_vae.py (max_n 8,
nvt 8) and seeded dense batches of graphs with 3-6 vertices (max_n 6,
nvt 4; DeepGMG max_n 5), whose padding rows exercise the masks. Inputs come from numpy
seeds; JAX weights are carried over with convert.params_from_numpy. Noise
is off on both sides (training=False), as the two packages' random streams
differ. The JAX side runs under jax.jit. Tolerances: f32 outputs 2e-5 of
their max|ref|; gradient leaves rtol 5e-4 / atol 5e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dagnn_tpu.data.na import parse_enas_row as jparse
from dagnn_tpu.vae import dvae as jd
from dagnn_tpu.vae import dvae_variants as jvar
from dagnn_tpu.vae import svae as jsv
from dagnn_tpu_torch import checks, convert
from dagnn_tpu_torch.data.na import parse_enas_row
from dagnn_tpu_torch.vae import dvae as td
from dagnn_tpu_torch.vae import dvae_variants as tvar
from dagnn_tpu_torch.vae import svae as tsv

torch.set_num_threads(1)

ROWS = [
    "[[4], [0, 1], [3, 1, 0], [3, 0, 1, 1], [1, 1, 1, 1, 1], [2, 1, 1, 0, 1, 1]]",
    "[[2], [2, 0], [4, 1, 0], [0, 1, 0, 0], [2, 1, 0, 0, 1], [3, 1, 0, 0, 0, 0]]",
    "[[1], [5, 1], [0, 0, 1], [2, 1, 1, 1], [4, 0, 1, 0, 0], [1, 0, 0, 1, 1, 0]]",
]
OUT_TOL = 2e-5
RTOL, ATOL = 5e-4, 5e-5
HS, NZ = 16, 6


def _port(tree):
    return convert.params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _close(got, want, what):
    rel = checks.rel_err(got, want)[0]
    assert rel <= OUT_TOL, f"{what}: {rel:.3e} of max|ref|"


def _grads_close(tgrads, jgrads, what):
    jflat = convert.flatten_tree(jax.tree.map(np.asarray, jgrads))
    assert set(jflat) == set(tgrads), what
    for k, ref in jflat.items():
        g = tgrads[k]
        got = np.zeros_like(ref) if g is None else g.detach().numpy()
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what}: {k}")


def _dense_batch(max_n=6, B=3, nvt=4, seed=0):
    """Graphs of 3..max_n vertices, padded: START 0, END 1, a predecessor
    set per vertex (tests/test_dvae_variants.py's generator)."""
    rng = np.random.default_rng(seed)
    types = np.zeros((B, max_n), np.int32)
    adj = np.zeros((B, max_n, max_n), np.float32)
    nv = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rng.integers(3, max_n + 1))
        nv[b] = n
        types[b, n - 1] = 1
        types[b, 1: n - 1] = rng.integers(2, nvt, n - 2)
        for v in range(1, n):
            preds = rng.choice(v, size=max(1, int(rng.integers(1, v + 1))),
                               replace=False)
            adj[b, preds, v] = 1
    return types, adj, nv


def _enas_dense():
    from dagnn_tpu.vae.dagnn_vae import na_dense_views
    return na_dense_views([jparse(r) for r in ROWS], 8)


def _check_model(jloss, tloss, jenc, tenc, jtree, tparams, what):
    """Loss value and every leaf of its gradient, and mu, port against
    JAX, from the same weights."""
    jval, jgrads = jax.jit(jax.value_and_grad(jloss))(jtree)
    p = {k: v.detach().requires_grad_(True) for k, v in tparams.items()}
    tval = tloss(p)
    gs = torch.autograd.grad(tval, list(p.values()), allow_unused=True)
    _close(tval.detach(), float(jval), f"{what} loss")
    _grads_close(dict(zip(p, gs)), jgrads, what)
    _close(tenc(tparams), np.asarray(jax.jit(jenc)(jtree)), f"{what} mu")


# ---------------------------------------------------------------- S-VAEs

SVAE_KINDS = {
    "SVAE": dict(),
    "SVAE_bidirectional": dict(bidirectional=True),
    "SVAE_oneshot": dict(oneshot=True),
    "SVAE_GraphRNN": dict(graphrnn=True),
    "SVAE_GraphRNN_BFS": dict(graphrnn=True, bfs=True),
}


def _svae_cfgs(kw):
    return (jsv.SVAEConfig(max_n=8, nvt=8, hs=HS, nz=NZ, **kw),
            tsv.SVAEConfig(max_n=8, nvt=8, hs=HS, nz=NZ, **kw))


def _strings(cfg, seed=5):
    """The ENAS rows' string tensors from both codecs, one numpy seed each
    (BFS orders drawn from it); equal bit for bit."""
    gj = [jparse(r) for r in ROWS]
    gt = [parse_enas_row(r) for r in ROWS]
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    Gj = np.stack([jsv.graph_to_string_tensor(g, cfg[0], rj) for g in gj])
    Gt = np.stack([tsv.graph_to_string_tensor(g, cfg[1], rt) for g in gt])
    np.testing.assert_array_equal(Gt, Gj)
    return Gj


@pytest.mark.parametrize("kind", list(SVAE_KINDS))
def test_svae_matches_jax(kind):
    jcfg, tcfg = _svae_cfgs(SVAE_KINDS[kind])
    G = _strings((jcfg, tcfg))
    tree = jsv.svae_init(jax.random.PRNGKey(3), jcfg)
    params = _port(tree)
    Gt = torch.as_tensor(G)
    assert set(params) == set(tsv.svae_init(0, tcfg, device="cpu"))
    _check_model(
        lambda p: jsv.svae_loss(p, jcfg, jnp.asarray(G), None, training=False)[0],
        lambda p: tsv.svae_loss(p, tcfg, Gt, None, training=False)[0],
        lambda p: jsv.svae_encode(p, jcfg, jnp.asarray(G))[0],
        lambda p: tsv.svae_encode(p, tcfg, Gt)[0].detach(),
        tree, params, kind)
    if not jcfg.graphrnn:
        # the deterministic decode: argmax types, edges above 0.5
        z = np.random.default_rng(2).normal(size=(4, NZ)).astype(np.float32)
        want = jsv.svae_decode(tree, jcfg, jnp.asarray(z), stochastic=False)
        got = tsv.svae_decode(params, tcfg, torch.as_tensor(z), stochastic=False)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.types, np.asarray(b.types))
            np.testing.assert_array_equal(a.adj, np.asarray(b.adj))


def test_string_codec_and_bfs_order_bit_for_bit():
    """The codec of every S-VAE layout and the random BFS orders, from one
    numpy seed on both sides, over the ENAS rows."""
    gj = [jparse(r) for r in ROWS]
    gt = [parse_enas_row(r) for r in ROWS]
    for kw in SVAE_KINDS.values():
        _strings(_svae_cfgs(kw), seed=11)
    rj, rt = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(5):
        for a, b in zip(gj, gt):
            np.testing.assert_array_equal(
                tsv._random_bfs_order(np.asarray(b.adj), rt),
                jsv._random_bfs_order(np.asarray(a.adj), rj))
    # the port's codec on its own (tests/test_svae.py:14-22)
    t = tsv.graph_to_string_tensor(gt[0], tsv.SVAEConfig(max_n=8, nvt=8))
    assert t.shape == (7, 15) and t[0, 6] == 1 and t[0, 8] == 1 and t[0].sum() == 2
    assert t[6, 1] == 1 and t[6, 8 + 6] == 1


@pytest.mark.parametrize("bfs", [False, True])
def test_graphrnn_sample_builds_dags(bfs):
    """The sampled GraphRNN decode (one generator, every type and edge bit
    drawn on the device) builds upper-triangular graphs of at most max_n
    vertices that start at START and end at END, and the same seed gives
    the same graphs."""
    cfg = tsv.SVAEConfig(max_n=8, nvt=8, hs=HS, nz=NZ, graphrnn=True, bfs=bfs)
    params = tsv.svae_init(1, cfg, device="cpu")
    z = torch.as_tensor(np.random.default_rng(4).normal(size=(6, NZ)),
                        dtype=torch.float32)
    a = tsv.svae_decode(params, cfg, z, torch.Generator().manual_seed(3))
    b = tsv.svae_decode(params, cfg, z, torch.Generator().manual_seed(3))
    for g, h in zip(a, b):
        np.testing.assert_array_equal(g.adj, h.adj)
        assert g.num_nodes <= 8 and g.types[0] == 0 and g.types[-1] == 1
        assert not np.tril(g.adj).any()


# ---------------------------------------------------------- D-VAE variants

def _views(which):
    return _enas_dense() if which == "enas" else _dense_batch()


def _dims(which):
    return (8, 8) if which == "enas" else (6, 4)


@pytest.mark.parametrize("which, bidirectional", [("enas", False),
                                                  ("padded", True)])
def test_dvae_gcn_matches_jax(which, bidirectional):
    max_n, nvt = _dims(which)
    kw = dict(max_n=max_n, nvt=nvt, hs=HS, nz=NZ, bidirectional=bidirectional)
    jcfg, tcfg = jvar.DVAEGCNConfig(**kw), tvar.DVAEGCNConfig(**kw)
    types, adj, nv = _views(which)
    tree = jvar.dvae_gcn_init(jax.random.PRNGKey(1), jcfg)
    params = _port(tree)
    assert set(params) == set(tvar.dvae_gcn_init(0, tcfg, device="cpu"))
    J = [jnp.asarray(a) for a in (types, adj, nv)]
    T = [torch.as_tensor(a) for a in (types, adj, nv)]
    _check_model(
        lambda p: jvar.dvae_gcn_loss(p, jcfg, *J, None, training=False)[0],
        lambda p: tvar.dvae_gcn_loss(p, tcfg, *T, None, training=False)[0],
        lambda p: jvar.dvae_gcn_encode(p, jcfg, *J)[0],
        lambda p: tvar.dvae_gcn_encode(p, tcfg, *T)[0].detach(),
        tree, params, f"DVAE_GCN {which} bidirectional={bidirectional}")


@pytest.mark.parametrize("which", ["enas", "padded"])
def test_dvae_fast_matches_jax(which):
    max_n, nvt = _dims(which)
    kw = dict(max_n=max_n, nvt=nvt, hs=HS, nz=NZ, num_layers=1, vid=True)
    jcfg, tcfg = jd.DVAEConfig(**kw), td.DVAEConfig(**kw)
    types, adj, nv = _views(which)
    tree = jvar.dvae_fast_init(jax.random.PRNGKey(2), jcfg)
    params = _port(tree)
    assert set(params) == set(tvar.dvae_fast_init(0, tcfg, device="cpu"))
    J = [jnp.asarray(a) for a in (types, adj, nv)]
    T = [torch.as_tensor(a) for a in (types, adj, nv)]
    _check_model(
        lambda p: jvar.dvae_fast_loss(p, jcfg, *J, None, training=False)[0],
        lambda p: tvar.dvae_fast_loss(p, tcfg, *T, None, training=False)[0],
        lambda p: jd.dvae_encode_sequential(p, jcfg, *J)[0],
        lambda p: td.dvae_encode_sequential(p, tcfg, *T)[0].detach(),
        tree, params, f"DVAE_fast {which}")


@pytest.mark.parametrize("bidirectional, rounds", [(False, 2), (True, 1)])
def test_deepgmg_matches_jax(bidirectional, rounds):
    kw = dict(max_n=5, nvt=4, hs=HS, nz=NZ, Td=rounds, Te=rounds,
              bidirectional=bidirectional)
    jcfg, tcfg = jvar.DeepGMGConfig(**kw), tvar.DeepGMGConfig(**kw)
    types, adj, nv = _dense_batch(max_n=5, seed=4)
    tree = jvar.deepgmg_init(jax.random.PRNGKey(3), jcfg)
    params = _port(tree)
    assert set(params) == set(tvar.deepgmg_init(0, tcfg, device="cpu"))
    J = [jnp.asarray(a) for a in (types, adj, nv)]
    T = [torch.as_tensor(a) for a in (types, adj, nv)]
    _check_model(
        lambda p: jvar.deepgmg_loss(p, jcfg, *J, None, training=False)[0],
        lambda p: tvar.deepgmg_loss(p, tcfg, *T, None, training=False)[0],
        lambda p: jvar.deepgmg_encode(p, jcfg, *J)[0],
        lambda p: tvar.deepgmg_encode(p, tcfg, *T)[0].detach(),
        tree, params, f"DVAE_DeepGMG bidirectional={bidirectional}")


def test_deepgmg_padding_invariance():
    """Garbage beyond nv (types and edges) does not change the encoding
    (tests/test_dvae_variants.py:126, on the port)."""
    cfg = tvar.DeepGMGConfig(max_n=6, nvt=4, hs=HS, nz=NZ, Td=2, Te=2)
    params = tvar.deepgmg_init(3, cfg, device="cpu")
    types, adj, nv = _dense_batch(seed=4)
    types2, adj2 = types.copy(), adj.copy()
    for b in range(len(nv)):
        types2[b, nv[b]:] = 3
        adj2[b, nv[b]:, :] = 1
    T = lambda *a: [torch.as_tensor(x) for x in a]
    mu, _ = tvar.deepgmg_encode(params, cfg, *T(types, adj, nv))
    mu2, _ = tvar.deepgmg_encode(params, cfg, *T(types2, adj2, nv))
    torch.testing.assert_close(mu2, mu, rtol=1e-5, atol=1e-5)

"""The DAGNN config surface of the port against the JAX package, each
config from the JAX package's dagnn_init carried over by convert.py:
  * the model grid of tests/test_dagnn.py:50-73, its 12 `attn_h` configs
    here (bidirectional or not, recurr=False, w_edge_attr, out_wx, the
    node-space and slot-space readouts, every pool, the token, class and
    regression heads; test_torch_aggregators.py holds its 11 other
    aggregator configs), on the JAX tests' batch: the identity encoder,
    emb/hidden 8, 3 random DAGs of 6, 9 and 4 nodes with 2 edge
    relations, collated without padding. These take the generic branch
    (segment_impl "dense" or "scatter", the port's plain versions
    SEG_PLAIN); the JAX side runs the config's impl, alternating "dense"
    and "scatter" along the grid (one function: the per-level parity of
    test_torch_aggregators.py holds each kind under both).
  * beyond the grid: dagnn_node_states and the node-space forward on the fused
    per-direction branch (the row kernels at one direction, _perm_gather)
    and on the generic branch; the segment-pool readout without out_slots
    on the merged and the per-direction route; the ast2 and bag encoders.
    The JAX side runs "dense" or "scatter", the same function as its
    fused path.

The loss is a fixed random projection of the outputs, so every gradient
leaf is held. Tolerances as ROADMAP sets them: f32 outputs 2e-5, f32 grads
rtol 5e-4 / atol 5e-5. A leaf the port's forward does not read (the
attention pool's weights, whose reference weights are identically 1) has
no port gradient and must have a zero JAX gradient.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dagnn_tpu.dag.batch import PadConfig as JPadConfig
from dagnn_tpu.dag.batch import collate as jcollate
from dagnn_tpu.nn import dagnn as jdagnn
from dagnn_tpu.nn.encoders import EncoderSpec as JEncoderSpec
from dagnn_tpu_torch import convert
from dagnn_tpu_torch.dag.batch import DAGGraph as TDAGGraph
from dagnn_tpu_torch.dag.batch import PadConfig as TPadConfig
from dagnn_tpu_torch.dag.batch import collate as tcollate
from dagnn_tpu_torch.nn import dagnn as tdagnn
from dagnn_tpu_torch.nn.encoders import EncoderSpec as TEncoderSpec
from test_dagnn import CONFIGS, random_dag_graph

torch.set_num_threads(1)


def configs(overrides, **extra):
    """(jax cfg, port cfg) of test_dagnn.py's grid entry `overrides`,
    with the fields `extra` (segment_impl among them) set on both."""
    ov = dict(overrides)
    emb = ov.pop("emb_dim", 8)
    enc = extra.pop("encoder", None)
    kw = dict(num_vocab=ov.pop("num_vocab", 11), max_seq_len=3, emb_dim=emb,
              hidden_dim=ov.pop("hidden_dim", 8), num_rels=2, num_layers=2,
              **ov, **extra)
    jenc = JEncoderSpec(**dataclasses.asdict(enc)) if enc else JEncoderSpec("identity")
    tenc = enc or TEncoderSpec("identity")
    return (jdagnn.DAGNNConfig(encoder=jenc, **kw),
            tdagnn.DAGNNConfig(encoder=tenc, **kw))


def to_port(jgraphs):
    """The same graphs as the port's DAGGraphs."""
    return [TDAGGraph(num_nodes=g.num_nodes, edge_src=g.edge_src,
                      edge_dst=g.edge_dst, x=g.x, edge_attr=g.edge_attr,
                      extras=dict(g.extras)) for g in jgraphs]


def grid_graphs(emb, seed=42):
    rng = np.random.default_rng(seed)
    return [random_dag_graph(rng, n, emb) for n in (6, 9, 4)]


def out_shape(cfg, n_graphs):
    if cfg.num_class > 0:
        return (n_graphs, cfg.num_class)
    if cfg.num_vocab == 1:
        return (n_graphs, 1)
    return (n_graphs, cfg.max_seq_len, cfg.num_vocab)


def jax_run(jcfg, jparams, jb, w):
    """(outputs, {dotted leaf: grad}) of sum(outputs * w), one jit."""
    jb = jax.tree.map(jnp.asarray, jb)

    def loss(p):
        out = jdagnn.dagnn_forward(p, jcfg, jb)
        return jnp.sum(out * w), out
    # XLA's backend optimisations off: a third less compile time, the same
    # f32 arithmetic at these sizes
    fn = jax.jit(jax.value_and_grad(loss, has_aux=True)).lower(jparams).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    (_, out), g = fn(jparams)
    return np.asarray(out), convert.flatten_tree(jax.tree.map(np.asarray, g))


def port_run(tcfg, tparams, tb, w, impl=None):
    """The port's (outputs, {leaf: grad or None}) of the same loss."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in tparams.items()}
    out = tdagnn.dagnn_forward(p, tcfg, tb, impl=impl)
    gs = torch.autograd.grad((out * torch.as_tensor(w)).sum(), list(p.values()),
                             allow_unused=True)
    return out.detach().numpy(), dict(zip(p, gs))


def matches_jax(jcfg, tcfg, jb, tb, seed=0, impl=None, jparams=None):
    """The port's outputs and every gradient leaf against the JAX
    package's, from the JAX init (f32 tolerances)."""
    if jparams is None:
        jparams = jdagnn.dagnn_init(jax.random.PRNGKey(seed), jcfg)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        device="cpu")
    # the heads' widths (out_hidden_dim) agree with the JAX init
    init = tdagnn.dagnn_init(seed, tcfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in init.items()} == \
        {k: tuple(v.shape) for k, v in tparams.items()}
    w = np.random.default_rng(1).normal(
        size=out_shape(jcfg, jb.num_graph_slots)).astype(np.float32)
    want, jg = jax_run(jcfg, jparams, jb, w)
    got, tg = port_run(tcfg, tparams, tb, w, impl)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5, err_msg="outputs")
    assert set(jg) == set(tg)
    for k in jg:
        if tg[k] is None:
            assert not jg[k].any(), f"{k}: the port reads no such weight"
            continue
        np.testing.assert_allclose(tg[k].numpy(), jg[k], rtol=5e-4, atol=5e-5,
                                   err_msg=k)
    return got, tg


def grid_ids(idx):
    return ["-".join(f"{k}={v}" for k, v in CONFIGS[i].items()) for i in idx]


def grid_case(i):
    """Grid entry i on the generic branch, the JAX impl alternating."""
    impl = ("dense", "scatter")[i % 2]
    jcfg, tcfg = configs(CONFIGS[i], segment_impl=impl)
    graphs = grid_graphs(jcfg.emb_dim)
    tb = tcollate(to_port(graphs))
    assert tdagnn._route(tcfg, tb, None)[0] == "generic"
    matches_jax(jcfg, tcfg, jcollate(graphs), tb, impl=tdagnn.SEG_PLAIN)


SURFACE = [i for i, o in enumerate(CONFIGS) if o["agg"] == "attn_h"]


@pytest.mark.parametrize("i", SURFACE, ids=grid_ids(SURFACE))
def test_grid_matches_jax(i):
    grid_case(i)


def node_states_loss(h_dirs, w):
    return sum((h * w[i]).sum() for i, h in enumerate(h_dirs))


@pytest.mark.parametrize("impl", ["fused", "scatter"])
def test_node_states_match_jax(impl):
    """dagnn_node_states (x and every direction's node-space states with
    their gradients) and the node-space forward (out_pool_all): "fused" on
    the per-direction fused branch, the row kernels at one direction read
    out through _perm_gather (whose VJP is the inverse gather), "scatter"
    on the generic branch (h[:, node_slot]); the JAX side "dense"."""
    jcfg, tcfg = configs({"agg": "attn_h"}, segment_impl="dense")
    tcfg = dataclasses.replace(tcfg, segment_impl=impl)
    graphs = grid_graphs(8, seed=4)
    jb, tb = jcollate(graphs), tcollate(to_port(graphs))
    route = tdagnn._route(tcfg, tb, None)[0]
    assert route == ("direction" if impl == "fused" else "generic")
    jparams = jdagnn.dagnn_init(jax.random.PRNGKey(2), jcfg)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        device="cpu")
    n1 = jb.node_mask.shape[0]
    w = np.random.default_rng(5).normal(size=(2, 2, n1, 8)).astype(np.float32)

    def jloss(p):
        x, h_dirs = jdagnn.dagnn_node_states(p, jcfg, jb)
        return node_states_loss(h_dirs, w), (x, h_dirs)
    (_, (jx, jh)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)
    jg = convert.flatten_tree(jax.tree.map(np.asarray, jg))
    p = {k: v.clone().requires_grad_(True) for k, v in tparams.items()}
    tx, th = tdagnn.dagnn_node_states(p, tcfg, tb)
    np.testing.assert_allclose(tx.detach().numpy(), jx, rtol=2e-5, atol=2e-5)
    for d in range(2):
        assert tuple(th[d].shape) == (2, n1, 8)
        np.testing.assert_allclose(th[d].detach().numpy(), jh[d], rtol=2e-5,
                                   atol=2e-5, err_msg=f"h_dirs[{d}]")
    tg = torch.autograd.grad(node_states_loss(th, torch.as_tensor(w)),
                             list(p.values()), allow_unused=True)
    for k, g in zip(p, tg):
        if g is None:
            assert not jg[k].any(), k
            continue
        np.testing.assert_allclose(g.numpy(), jg[k], rtol=5e-4, atol=5e-5,
                                   err_msg=k)
    if impl == "fused":         # the grid holds the generic node-space forward
        matches_jax(jcfg, tcfg, jb, tb, seed=2)


def no_out_slots(b):
    return b._replace(out_slots_fwd=None, out_slots_mask_fwd=None,
                      out_slots_rev=None, out_slots_mask_rev=None)


@pytest.mark.parametrize("route, pool", [("merged", "max"), ("direction", "mean")])
def test_readout_without_out_slots_matches_jax(route, pool):
    """The slot-space readout without out_slots: a segment pool of each
    direction's output nodes over its slots (nn/readout.pool_nodes), on
    the merged wavefront's per-direction view of its buffer (bidirectional;
    the grid's graphs padded so both directions' shapes agree) and on the
    per-direction route (unidirectional), the fused branch's plain
    versions; the JAX side "dense"."""
    graphs = grid_graphs(8, seed=11)
    pad = dict(max_nodes=32, max_edges=96, max_graphs=4, max_levels=10,
               nodes_per_level=8, edges_per_level=24)
    kw = dict(out_pool_all=False, out_pool=pool, bidirectional=route == "merged")
    jcfg, tcfg = configs({"agg": "attn_h"}, segment_impl="dense", **kw)
    tcfg = dataclasses.replace(tcfg, segment_impl="fused")
    jb = no_out_slots(jcollate(graphs, JPadConfig(**pad)))
    tb = no_out_slots(tcollate(to_port(graphs), TPadConfig(**pad)))
    assert tdagnn._route(tcfg, tb, None)[0] == route
    matches_jax(jcfg, tcfg, jb, tb, seed=3)


@pytest.mark.parametrize("kind", ["ast2", "bag"])
def test_encoders_match_jax(kind):
    """The ast2 (type + attr) and bag (a sum over each node's token ids)
    encoders in a unidirectional gated_sum model."""
    rng = np.random.default_rng(6)
    graphs = grid_graphs(8, seed=6)
    for g in graphs:
        g.x = (rng.integers(0, 5, size=(g.num_nodes, 2)) if kind == "ast2"
               else rng.integers(0, 9, size=(g.num_nodes, 3))).astype(np.int32)
    enc = TEncoderSpec(kind, emb_dim=8, num_nodetypes=5, num_nodeattributes=5,
                       vocab_size=9)
    jcfg, tcfg = configs({"agg": "gated_sum", "bidirectional": False},
                         segment_impl="scatter", encoder=enc)
    matches_jax(jcfg, tcfg, jcollate(graphs), tcollate(to_port(graphs)))

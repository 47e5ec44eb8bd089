"""The port's edge-partitioned wavefront (dagnn_tpu_torch/parallel/
edge_partition.py) against the JAX package's, on gloo ranks on the CPU.

* Every plan array bitwise: partition_schedule_sharded's EPSchedule and
  EPStatic, partition_schedule's rechunking, ep_readout_aux, ep_widths_of
  and ep_wire_stats, at D = 2 and 4, on the random DAGs of
  tests/test_edge_partition.py and its layered graphs with and without
  deferred entries.
* The replicated-state forward (scheme 1) against make_ep_forward: f32
  outputs within 2e-5.
* The sharded-state step's raw gradients (scheme 2) at D = 2, 4 (max and
  attn pools) and on the (dp 2, ep 2) mesh: loss within 2e-5, every leaf
  within rtol 5e-4 / atol 5e-5 of JAX's SINGLE-DEVICE gradient and of
  JAX's EP gradient divided by D. (JAX's EP step psums the gradients of
  the whole replicated loss on top of shard_map's transposes, so its
  leaves are D times the single-device gradient; its own test compares
  parameters after one Adam step, which a constant scale does not move.)
  The JAX side reads its raw gradients through an optimizer that returns
  them as its state.

Every port run of this file is one spawn of 4 gloo ranks (module
fixture); the D = 2 cases run on the ep groups of a (2, 2) mesh whose dp
groups are copies.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dagnn_tpu.dag.batch import PadConfig as JPad, collate as jcollate
from dagnn_tpu.nn.dagnn import (DAGNNConfig as JCfg, dagnn_forward as jforward,
                                dagnn_init as jinit, dagnn_node_states as jstates)
from dagnn_tpu.nn.encoders import EncoderSpec as JEnc
from dagnn_tpu.parallel import edge_partition as jep
from dagnn_tpu.parallel.mesh import make_hybrid_mesh as jhybrid, make_mesh as jmesh
from dagnn_tpu.train.losses import tok_loss as jtok_loss
from dagnn_tpu_torch import convert
from dagnn_tpu_torch.dag.batch import DAGGraph as TGraph, PadConfig as TPad
from dagnn_tpu_torch.dag.batch import collate as tcollate
from dagnn_tpu_torch.nn.dagnn import DAGNNConfig as TCfg
from dagnn_tpu_torch.nn.encoders import EncoderSpec as TEnc
from dagnn_tpu_torch.parallel import edge_partition as tep
from dagnn_tpu_torch.parallel import jobs
from dagnn_tpu_torch.parallel.mesh import spawn
from test_dagnn import random_dag_graph
from test_edge_partition import _layered_graph

torch.set_num_threads(1)

GRAD = dict(rtol=5e-4, atol=5e-5)
STEP_CASES = [(2, "max"), (4, "max"), (2, "attn"), (4, "attn")]
PROBE_CASES = [(2, "max"), (4, "attn")]   # both pools, both D


def _tgraph(g):
    return TGraph(num_nodes=g.num_nodes, edge_src=g.edge_src, edge_dst=g.edge_dst,
                  x=g.x, edge_attr=g.edge_attr, extras=dict(g.extras), y=dict(g.y))


def _cfgs(out_pool="max", bidirectional=True):
    kw = dict(num_vocab=7, max_seq_len=2, emb_dim=8, hidden_dim=8, num_rels=2,
              num_layers=2, bidirectional=bidirectional, agg="attn_h",
              out_pool=out_pool)
    return JCfg(encoder=JEnc("identity", emb_dim=8), **kw), \
        TCfg(encoder=TEnc("identity", emb_dim=8), **kw)


def _graphs(rng, sizes=(9, 7, 12, 10)):
    graphs = [random_dag_graph(rng, n, 8) for n in sizes]
    for g in graphs:
        g.y = {"y_arr": rng.integers(0, 7, 2)}
    return graphs


def _batches(graphs, pad_kw):
    """The same graphs collated by both packages into one bucket."""
    jpad = JPad.for_graphs(graphs, **pad_kw)
    tg = [_tgraph(g) for g in graphs]
    tpad = TPad.for_graphs(tg, **pad_kw)
    assert dataclasses.astuple(jpad) == dataclasses.astuple(tpad)
    return jcollate(graphs, jpad), tcollate(tg, tpad)


def _step_setup(n_dev, out_pool):
    """tests/test_edge_partition.py's _ep_setup in both packages."""
    jcfg, tcfg = _cfgs(out_pool)
    graphs = _graphs(np.random.default_rng(3))
    jb, tb = _batches(graphs, dict(chunk_size=2 * n_dev))
    jparams = jinit(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jparams, jb, tb


def _hybrid_setup():
    """tests/test_edge_partition.py's (dp 2, ep 2) groups: one bucket with
    headroom for both."""
    jcfg, tcfg = _cfgs("max")
    rng = np.random.default_rng(5)
    jparams = jinit(jax.random.PRNGKey(0), jcfg)
    groups = [_graphs(rng) for _ in range(2)]
    jpad = JPad.for_graphs(groups[0], chunk_size=4)
    jpad = dataclasses.replace(jpad, max_nodes=jpad.max_nodes + 16,
                               max_edges=jpad.max_edges + 32,
                               max_levels=jpad.max_levels + 4,
                               edges_per_level=jpad.edges_per_level + 16,
                               tgrad_per_level=0)
    tpad = TPad(*dataclasses.astuple(jpad))
    jbs = [jcollate(g, jpad) for g in groups]
    tbs = [tcollate([_tgraph(x) for x in g], tpad) for g in groups]
    return jcfg, tcfg, jparams, jbs, tbs


def _forward_setup(n_dev):
    """tests/test_edge_partition.py's scheme-1 case."""
    jcfg, tcfg = _cfgs(bidirectional=False)
    jcfg = dataclasses.replace(jcfg, num_vocab=5)
    tcfg = dataclasses.replace(tcfg, num_vocab=5)
    rng = np.random.default_rng(0)
    graphs = [random_dag_graph(rng, n, 8) for n in (9, 7, 12)]
    jb, tb = _batches(graphs, dict(chunk_size=8))
    return jcfg, tcfg, jinit(jax.random.PRNGKey(0), jcfg), jb, tb


def _flat(tree):
    return convert.flatten_tree(jax.tree.map(np.asarray, tree))


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """Every port run of this file in one spawn of 4 gloo ranks: rank 0's
    results, keyed by case."""
    todo, keys = [], []
    for n_dev, pool in STEP_CASES:
        _, tcfg, jparams, _, tb = _step_setup(n_dev, pool)
        todo.append((jobs.ep_job, dict(cfg=tcfg, params_np=_flat(jparams),
                                       batches=[tb], mesh_shape=(4 // n_dev, n_dev),
                                       probe=(n_dev, pool) in PROBE_CASES)))
        keys.append(("step", n_dev, pool))
    _, tcfg, jparams, _, tbs = _hybrid_setup()
    todo.append((jobs.ep_job, dict(cfg=tcfg, params_np=_flat(jparams), batches=tbs,
                                   mesh_shape=(2, 2), dp_axis=True)))
    keys.append(("hybrid",))
    for n_dev in (2, 4):
        _, tcfg, jparams, _, tb = _forward_setup(n_dev)
        todo.append((jobs.ep_forward_job, dict(cfg=tcfg, params_np=_flat(jparams),
                                               batch=tb, mesh_shape=(4 // n_dev, n_dev))))
        keys.append(("forward", n_dev))
    res = spawn(jobs.run_jobs, 4, "gloo", "cpu",
                store_dir=str(tmp_path_factory.mktemp("store")), timeout=240,
                args=(todo,))
    return {k: r for k, r in zip(keys, res[0])}, res


def _capture():
    """An optimizer that leaves the parameters and returns the gradients
    as its state: the raw gradients of a JAX step."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _loss_head(logits, y, gmask):
    return jtok_loss(logits, y["y_arr"], gmask)


def _jax_single(jcfg, jparams, jb):
    def loss(p, b):
        return _loss_head(jforward(p, jcfg, b), b.y, b.graph_mask)
    l, g = jax.jit(jax.value_and_grad(loss))(jparams, jb)
    return float(l), _flat(g)


def _jax_ep(jcfg, jparams, jb, n_dev):
    eps_f, st_f = jep.partition_schedule_sharded(jb.fwd, n_dev)
    eps_r, st_r = jep.partition_schedule_sharded(jb.rev, n_dev)
    aux = jep.ep_readout_aux(jb, (eps_f, eps_r), jcfg)
    opt = _capture()
    step = jep.make_ep_train_step(jcfg, jmesh(n_dev, ("ep",)), (st_f, st_r),
                                  _loss_head, opt)
    _, grads, loss = step(jparams, opt.init(jparams), jnp.asarray(jb.x),
                          jnp.asarray(jb.edge_attr),
                          jax.tree.map(jnp.asarray, (eps_f, eps_r)),
                          jax.tree.map(jnp.asarray, aux),
                          jax.tree.map(jnp.asarray, jb.y), jnp.asarray(jb.graph_mask))
    return float(loss), _flat(grads)


def _grads_match(got, want, what):
    assert set(got) == set(want), what
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, err_msg=f"{what}: {k}", **GRAD)


# ------------------------------------------------------------ the plans

def _plan_batches(kind, n_dev):
    if kind == "random":
        return _batches(_graphs(np.random.default_rng(4), (20, 20, 20, 20)),
                        dict(chunk_size=2 * n_dev))
    g = _layered_graph(6, n_dev, 3 if kind == "layered_deferred" else 0)
    return _batches([g], dict(chunk_size=2 * n_dev))


@pytest.mark.parametrize("kind", ["random", "layered", "layered_deferred"])
@pytest.mark.parametrize("n_dev", [2, 4])
def test_plans_bitwise_equal_jax(kind, n_dev):
    jb, tb = _plan_batches(kind, n_dev)
    jcfg, tcfg = _cfgs()
    widths_j, widths_t, plans_j, plans_t = {}, {}, [], []
    for d in ("fwd", "rev"):
        je, js = jep.partition_schedule_sharded(getattr(jb, d), n_dev)
        te, ts = tep.partition_schedule_sharded(getattr(tb, d), n_dev)
        for f in je._fields:
            a, b = getattr(je, f), getattr(te, f)
            assert a.dtype == b.dtype and a.shape == b.shape, (d, f)
            np.testing.assert_array_equal(b, a, err_msg=f"{d} {f}")
        assert dataclasses.asdict(ts) == dataclasses.asdict(js)
        widths_j = jep.ep_widths_of(je, js, widths_j)
        widths_t = tep.ep_widths_of(te, ts, widths_t)
        assert tep.ep_wire_stats(te, 8) == jep.ep_wire_stats(je, 8)
        jp, tp = (jep.partition_schedule(getattr(jb, d), n_dev),
                  tep.partition_schedule(getattr(tb, d), n_dev))
        for f in ("node_ids", "node_mask", "edge_src", "edge_src_slot", "edge_dst",
                  "edge_id", "edge_mask", "node_slot", "num_levels"):
            np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f), err_msg=f)
        plans_j.append(je)
        plans_t.append(te)
    assert widths_t == widths_j
    # the shape-stable rebuild at pinned widths
    te, ts = tep.partition_schedule_sharded(tb.fwd, n_dev, widths=widths_t)
    je, js = jep.partition_schedule_sharded(jb.fwd, n_dev, widths=widths_j)
    for f in je._fields:
        np.testing.assert_array_equal(getattr(te, f), getattr(je, f), err_msg=f)
    ja, ta = jep.ep_readout_aux(jb, plans_j, jcfg), tep.ep_readout_aux(tb, plans_t, tcfg)
    assert set(ja) == set(ta)
    for k in ja:
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    if kind != "random":
        # the layered graphs' lanes: span-1 entries urgent, long skips deferred
        assert ts.has_urgent and int(te.u_send_mask.sum()) > 0
        assert (int(te.d_send_mask.sum()) > 0) == (kind == "layered_deferred")


# -------------------------------------------------------- the ranks' runs

@pytest.mark.parametrize("n_dev,out_pool", PROBE_CASES)
def test_kernel_probe_holds_every_call(port_runs, n_dev, out_pool):
    """ep_job's probe pass (checks.KernelProbe: each K6 / K5 call also run
    through its plain version) computes the counted pass's gradients bit
    for bit and holds every call the plan derives: per row of each
    direction K6 forward twice a layer (the pass and the replay), K6
    backward once a layer, K5 three times, and under the attn pool one K5
    sum for each pooled tensor (out_pool_all: x and every direction's
    layers). On the CPU each wrapper runs its plain version, so every
    error is 0."""
    got = port_runs[0][("step", n_dev, out_pool)]
    pr, rows, nl = got["probe"], sum(got["rows"]), 2
    assert pr["grads_digest"] == got["grads_digest"]
    pools = 0 if out_pool == "max" else 1 + 2 * nl
    want = {"segment_attn_forward": 2 * nl * rows, "segment_attn_backward": nl * rows,
            "tg_accumulate": 3 * rows + pools}
    assert {k: pr[k]["calls"] for k in want} == want
    for k in want:
        assert pr[k]["rel"] == 0.0 and pr[k]["max_abs_err"] == 0.0, (k, pr[k])
        assert pr[k]["scale"] > 0, (k, pr[k])


@pytest.mark.parametrize("n_dev,out_pool", STEP_CASES)
def test_sharded_step_grads_equal_single_device(port_runs, n_dev, out_pool):
    jcfg, _, jparams, jb, _ = _step_setup(n_dev, out_pool)
    got = port_runs[0][("step", n_dev, out_pool)]
    l1, g1 = _jax_single(jcfg, jparams, jb)
    lep, gep = _jax_ep(jcfg, jparams, jb, n_dev)
    np.testing.assert_allclose(got["loss"], l1, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got["loss"], lep, rtol=2e-5, atol=2e-5)
    _grads_match(got["grads"], g1, "port vs JAX single device")
    _grads_match(got["grads"], {k: v / n_dev for k, v in gep.items()},
                 "port vs JAX EP / D")
    # the reference's factor: JAX's EP gradient is D times its own
    # single-device gradient (within the same tolerances)
    _grads_match({k: v / n_dev for k, v in gep.items()}, g1, "JAX EP / D vs JAX")
    assert got["route"] == "host"


def test_hybrid_mesh_grads_equal_mean_of_groups(port_runs):
    jcfg, _, jparams, jbs, _ = _hybrid_setup()
    got = port_runs[0][("hybrid",)]
    singles = [_jax_single(jcfg, jparams, b) for b in jbs]
    want_l = float(np.mean([l for l, _ in singles]))
    want_g = {k: (singles[0][1][k] + singles[1][1][k]) / 2 for k in singles[0][1]}
    # JAX's (dp 2, ep 2) step at pinned widths, as its own test builds it
    widths = {}
    for b in jbs:
        for d in ("fwd", "rev"):
            widths = jep.ep_widths_of(*jep.partition_schedule_sharded(getattr(b, d), 2),
                                      widths)
    plans = [[jep.partition_schedule_sharded(getattr(b, d), 2, widths=widths)
              for d in ("fwd", "rev")] for b in jbs]
    stk = lambda xs: jax.tree.map(lambda *a: np.stack(a), *xs)
    eps = stk([(p[0][0], p[1][0]) for p in plans])
    aux = stk([jep.ep_readout_aux(b, (p[0][0], p[1][0]), jcfg) for b, p in zip(jbs, plans)])
    opt = _capture()
    step = jep.make_ep_train_step(jcfg, jhybrid(dp=2, ep=2),
                                  (plans[0][0][1], plans[0][1][1]), _loss_head, opt,
                                  axis="ep", dp_axis="dp")
    _, gep, lep = step(jparams, opt.init(jparams),
                       jnp.asarray(np.stack([b.x for b in jbs])),
                       jnp.asarray(np.stack([b.edge_attr for b in jbs])),
                       jax.tree.map(jnp.asarray, eps), jax.tree.map(jnp.asarray, aux),
                       jax.tree.map(jnp.asarray, stk([b.y for b in jbs])),
                       jnp.asarray(np.stack([b.graph_mask for b in jbs])))
    np.testing.assert_allclose(got["loss"], want_l, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got["loss"], float(lep), rtol=2e-5, atol=2e-5)
    _grads_match(got["grads"], want_g, "port vs mean of JAX single device")
    _grads_match(got["grads"], {k: v / 2 for k, v in _flat(gep).items()},
                 "port vs JAX (dp, ep) / D_ep")
    # every rank of the world holds the same averaged gradients
    assert all(r[4]["grads_digest"] == got["grads_digest"] for r in port_runs[1])


@pytest.mark.parametrize("n_dev", [2, 4])
def test_replicated_state_forward_matches_jax(port_runs, n_dev):
    jcfg, _, jparams, jb, _ = _forward_setup(n_dev)
    x, h_ref = jstates(jparams, jcfg, jb)
    fwd = jep.make_ep_forward(jcfg, jmesh(n_dev, ("ep",)))
    pdir = {"aggr": jparams["aggr"][0], "cells": jparams["cells"][0]}
    h_ep = fwd(pdir, jnp.asarray(x), jnp.asarray(jb.edge_attr),
               jax.tree.map(jnp.asarray, jep.partition_schedule(jb.fwd, n_dev)))
    got = port_runs[0][("forward", n_dev)]["states"]
    np.testing.assert_allclose(got, np.asarray(h_ep), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(h_ref[0]), rtol=2e-5, atol=2e-5)

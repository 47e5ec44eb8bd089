"""The aggregator kinds of the port against the JAX package:
  * aggregate_level for each of the six kinds against the JAX package's
    under every impl name ("dense", "scatter", "pallas"; its Pallas kernel
    in interpret mode; the port's computes one function for all), on one level with masked edges, an empty slot, a slot
    whose edges are all masked, the pad slot as a real segment, edge
    embeddings and, under `max`, a tie: the output and the gradients of
    values, keys, queries, edge embeddings and weights;
  * the segment ops the kinds run (segment_max with a tie and a fully
    masked segment in float32 and bfloat16, merged_segment_sum: K5's
    contract), the readout's pool_nodes for every pool, the encoders;
  * dagnn_init's shared add/max aggregator: one initial value under every
    (direction, layer) leaf, in separate tensors;
  * dropout: the identity at train=False, the keep rate and the 1/keep
    scaling, the same masks for the same generator seed.

The kinds inside the model are test_torch_aggregator_models.py's.
Tolerances as ROADMAP sets them: f32 outputs 2e-5, f32 grads rtol 5e-4 /
atol 5e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dagnn_tpu.nn import aggregators as jagg
from dagnn_tpu.nn import encoders as jenc
from dagnn_tpu.nn import readout as jreadout
from dagnn_tpu.ops import segment as jseg
from dagnn_tpu_torch import convert
from dagnn_tpu_torch.dag.batch import collate as tcollate
from dagnn_tpu_torch.nn import aggregators as tagg
from dagnn_tpu_torch.nn import dagnn as tdagnn
from dagnn_tpu_torch.nn import encoders as tenc
from dagnn_tpu_torch.nn import readout as treadout
from dagnn_tpu_torch.ops import row_step
from dagnn_tpu_torch.ops import segment as tseg
from test_torch_config_surface import configs, grid_graphs, to_port

torch.set_num_threads(1)

KN, KE, H, A, DQ, R = 8, 40, 6, 5, 7, 2


def close(a, b, grad=False, name=""):
    tol = dict(rtol=5e-4, atol=5e-5) if grad else dict(rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), err_msg=name, **tol)


def level_inputs(seed, kind):
    """One level: KE edges over KN slots plus the pad slot KN (a real
    segment), sorted by slot; slot 2 empty, slot 5's edges all masked,
    about a fifth of the others masked, and under `max` edges 0 and 1 on
    one slot with equal values (a tie)."""
    rng = np.random.default_rng(seed)
    dst = np.sort(rng.choice([0, 1, 3, 4, 5, 6, 7, KN], KE))
    mask = rng.random(KE) > 0.2
    mask[dst == 5] = False
    n = lambda *s: rng.normal(size=s).astype(np.float32)
    x = dict(value_src=n(KE, H), key_src=n(KE, A), query=n(KN, DQ),
             edge_emb=n(KE, A if kind in ("attn", "self_attn", "mattn") else H),
             edge_dst=dst.astype(np.int32), edge_mask=mask)
    if kind == "max":
        dst[:2] = 3
        mask[:2] = True
        x["value_src"][1] = x["value_src"][0]
        x["edge_dst"] = np.sort(dst).astype(np.int32)
    return x


SPECS = {
    "add": jagg.AggregatorSpec("add", H, num_rels=R),
    "max": jagg.AggregatorSpec("max", H, num_rels=R),
    "gated_sum": jagg.AggregatorSpec("gated_sum", H, num_rels=R, out_dim=H + 2),
    "self_attn": jagg.AggregatorSpec("self_attn", H, key_dim=A, num_rels=R),
    "attn": jagg.AggregatorSpec("attn", H, key_dim=A, query_dim=DQ, num_rels=R),
    "mattn": jagg.AggregatorSpec("mattn", H, key_dim=A, query_dim=DQ, num_rels=R),
}


@pytest.mark.parametrize("impl", ["dense", "scatter", "pallas"])
@pytest.mark.parametrize("kind", list(SPECS))
def test_aggregate_level_matches_jax(kind, impl):
    jspec = SPECS[kind]
    tspec = tagg.AggregatorSpec(**dataclasses.asdict(jspec))
    params = jagg.aggregator_init(jax.random.PRNGKey(3), jspec)
    inp = level_inputs(4, kind)
    attn = kind in ("attn", "self_attn", "mattn")
    names = ["value_src", "edge_emb"] + (["key_src", "query"] if attn else [])
    ints = dict(edge_dst=inp["edge_dst"], edge_mask=inp["edge_mask"])

    def jf(p, *fl):
        kw = dict(zip(names, fl))
        return jagg.aggregate_level(p, jspec, kw.pop("value_src"),
                                    jnp.asarray(ints["edge_dst"]),
                                    jnp.asarray(ints["edge_mask"]), KN + 1,
                                    impl=impl, **kw)
    want, vjp = jax.vjp(jf, params, *[jnp.asarray(inp[k]) for k in names])
    # the pad slot's row is cut off by every caller ([:Kn]): its cotangent
    # is 0 (a live pad edge's query reads row Kn-1; JAX's clamped gather
    # drops that read's gradient, ROADMAP queue 3)
    g = np.random.default_rng(5).normal(size=want.shape).astype(np.float32)
    g[KN] = 0.0
    jg = vjp(jnp.asarray(g))

    tp = convert.params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    fl = [torch.tensor(inp[k]).requires_grad_(True) for k in names]
    kw = dict(zip(names, fl))
    # the port's aggregate_level computes one function for every impl name
    got = tagg.aggregate_level(convert.unflatten_tree(tp), tspec,
                               kw.pop("value_src"), torch.tensor(ints["edge_dst"]),
                               torch.tensor(ints["edge_mask"]), KN + 1, **kw)
    assert tuple(got.shape) == tuple(want.shape)
    close(got.detach(), want, name="out")
    assert not got[2].any() and not got[5].any()      # empty, all masked
    tg = torch.autograd.grad(got, list(tp.values()) + fl, torch.tensor(g),
                             allow_unused=True)
    # the edge encoder is applied by the caller (edge_emb): no grad here
    jleaves = convert.flatten_tree(jax.tree.map(np.asarray, jg[0]))
    zero = lambda t, j: np.zeros(j.shape) if t is None else t
    for (k, _), t in zip(tp.items(), tg):
        close(zero(t, jleaves[k]), jleaves[k], grad=True, name=k)
    for k, t, j in zip(names, tg[len(tp):], jg[1:]):
        close(zero(t, j), j, grad=True, name=k)


def test_unknown_impl_raises():
    """The config's segment_impl name is checked where the forward routes
    the batch."""
    _, tcfg = configs({"agg": "add"}, segment_impl="onehot")
    tb = tcollate(to_port(grid_graphs(8, seed=3)))
    p = tdagnn.dagnn_init(0, tcfg, device="cpu")
    with pytest.raises(ValueError, match="segment_impl"):
        tdagnn.dagnn_forward(p, tcfg, tb)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_max_tie_and_masks(dtype):
    """Rows [1, 2], [0, 2], [1, 1] into segment 0: column 0's max ties rows
    0 and 2, column 1's rows 0 and 1, and each tie splits its gradient
    evenly, as JAX's does; segment 1 holds only a masked row (0, with a
    zero gradient) and segment 2 none (0)."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    v = np.array([[1.0, 2.0], [0.0, 2.0], [1.0, 1.0], [5.0, 5.0]], np.float32)
    ids = np.array([0, 0, 0, 1], np.int32)
    mask = np.array([True, True, True, False])
    want, vjp = jax.vjp(lambda a: jseg.segment_max(a, jnp.asarray(ids), 3,
                                                   jnp.asarray(mask)),
                        jnp.asarray(v, jdt))
    jg = vjp(jnp.ones(want.shape, jdt))[0]
    tv = torch.tensor(v).to(tdt).requires_grad_(True)
    got = tseg.segment_max(tv, torch.tensor(ids), 3, torch.tensor(mask))
    assert got.dtype == tdt
    (tg,) = torch.autograd.grad(got, tv, torch.ones_like(got))
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(want, np.float32))
    np.testing.assert_array_equal(tg.float().numpy(), np.asarray(jg, np.float32))
    np.testing.assert_array_equal(tg.float().numpy(),
                                  [[0.5, 0.5], [0, 0.5], [0.5, 0], [0, 0]])
    assert not got[1:].any()


@pytest.mark.parametrize("merge", ["kernel", "plain"])
def test_merged_segment_sum_matches_jax(merge):
    """K5's contract as a differentiable segment sum: ids out of range and
    masked rows drop, the pad segment is real; the backward gathers the
    cotangent at each valid row's id."""
    rng = np.random.default_rng(7)
    v = rng.normal(size=(30, 13)).astype(np.float32)
    ids = rng.integers(-1, 7, 30).astype(np.int32)        # -1 and 6 drop
    mask = rng.random(30) > 0.3
    g = rng.normal(size=(6, 13)).astype(np.float32)
    want, vjp = jax.vjp(lambda a: jseg.segment_sum(
        a, jnp.asarray(np.where(ids < 0, 99, ids)), 6, jnp.asarray(mask)),
        jnp.asarray(v))
    tv = torch.tensor(v).requires_grad_(True)
    fn = row_step.tg_accumulate if merge == "kernel" else row_step.tg_accumulate_plain
    got = tseg.merged_segment_sum(tv, torch.tensor(ids), 6, torch.tensor(mask), fn)
    close(got.detach(), want, name="out")
    (tg,) = torch.autograd.grad(got, tv, torch.tensor(g))
    close(tg, vjp(jnp.asarray(g))[0], grad=True, name="d_values")


@pytest.mark.parametrize("kind", ["add", "sum", "max", "mean", "attn"])
def test_pool_nodes_matches_jax(kind):
    """Masked nodes, pad nodes (graph id 4) and an empty graph; attn is
    the JAX package's attn_compat form (weights identically 1)."""
    rng = np.random.default_rng(8)
    h = rng.normal(size=(20, 5)).astype(np.float32)
    gid = np.sort(rng.integers(0, 4, 20)).astype(np.int32)
    gid[-3:] = 4                                           # pad nodes
    gid[gid == 2] = 1                                      # graph 2 empty
    mask = rng.random(20) > 0.25
    ap = {"w": rng.normal(size=(1, 5)).astype(np.float32),
          "b": rng.normal(size=(1,)).astype(np.float32)}
    g = rng.normal(size=(4, 5)).astype(np.float32)
    want, vjp = jax.vjp(lambda a: jreadout.pool_nodes(
        a, jnp.asarray(gid), 4, kind, jnp.asarray(mask),
        jax.tree.map(jnp.asarray, ap)), jnp.asarray(h))
    th = torch.tensor(h).requires_grad_(True)
    got = treadout.pool_nodes(th, torch.tensor(gid), 4, kind, torch.tensor(mask))
    close(got.detach(), want, name="out")
    (tg,) = torch.autograd.grad(got, th, torch.tensor(g))
    close(tg, vjp(jnp.asarray(g))[0], grad=True, name="d_h")


@pytest.mark.parametrize("kind", ["identity", "ast", "ast2", "bag"])
def test_encoders_match_jax(kind):
    rng = np.random.default_rng(9)
    spec = dict(kind=kind, emb_dim=6, num_nodetypes=5, num_nodeattributes=7,
                max_depth=3, vocab_size=11)
    params = jenc.encoder_init(jax.random.PRNGKey(1), jenc.EncoderSpec(**spec))
    x = {"identity": rng.normal(size=(9, 6)).astype(np.float32),
         "bag": rng.integers(0, 11, (9, 4))}.get(
        kind, np.stack([rng.integers(0, 5, 9), rng.integers(0, 7, 9)], 1))
    depth = rng.integers(0, 6, 9)
    want = jenc.encode(params, jenc.EncoderSpec(**spec), jnp.asarray(x),
                       jnp.asarray(depth))
    tp = {k: torch.tensor(np.asarray(v)) for k, v in params.items()}
    got = tenc.encode(tp, tenc.EncoderSpec(**spec), torch.tensor(x),
                      torch.tensor(depth))
    close(got, want, name=kind)
    assert set(tenc.encoder_init(torch.Generator().manual_seed(0),
                                 tenc.EncoderSpec(**spec))) == set(params)


def test_shared_aggregator_leaves_are_separate():
    """add / max: JAX puts one initial aggregator under every (direction,
    layer) leaf; the port's leaves are equal at init and separate tensors,
    so an update of one leaves the others as they were."""
    _, tcfg = configs({"agg": "add"})
    p = tdagnn.dagnn_init(0, tcfg, device="cpu")
    keys = [f"aggr.{d}.{l}.edge_encoder.w" for d in (0, 1) for l in (0, 1)]
    for k in keys[1:]:
        assert torch.equal(p[k], p[keys[0]])
        assert p[k].data_ptr() != p[keys[0]].data_ptr()
    p[keys[0]].add_(1.0)
    assert not torch.equal(p[keys[1]], p[keys[0]])


def test_dropout():
    """Dropout on the pooled readout: the identity at train=False or rate
    0; the same masks from the same generator seed; a generator is
    required to train with dropout. Then, on a [400, 50] readout through
    an identity head, at rate 0.25 each element kept with probability 0.75
    (20,000 draws: 0.75 within 0.02) and scaled by exactly 1/0.75."""
    _, tcfg = configs({"agg": "gated_sum", "bidirectional": False},
                      segment_impl="scatter", dropout=0.25)
    tb = tcollate(to_port(grid_graphs(8, seed=14)))
    p = tdagnn.dagnn_init(1, tcfg, device="cpu")
    gen = lambda s: torch.Generator().manual_seed(s)
    base = tdagnn.dagnn_forward(p, tcfg, tb)
    assert torch.equal(tdagnn.dagnn_forward(p, tcfg, tb, train=False, rng=gen(0)), base)
    assert torch.equal(tdagnn.dagnn_forward(
        p, dataclasses.replace(tcfg, dropout=0.0), tb, train=True, rng=gen(0)), base)
    a = tdagnn.dagnn_forward(p, tcfg, tb, train=True, rng=gen(7))
    b = tdagnn.dagnn_forward(p, tcfg, tb, train=True, rng=gen(7))
    c = tdagnn.dagnn_forward(p, tcfg, tb, train=True, rng=gen(8))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="Generator"):
        tdagnn.dagnn_forward(p, tcfg, tb, train=True)

    cfg = dataclasses.replace(tcfg, num_class=50)
    head = {"head.w": torch.eye(50), "head.b": torch.zeros(50)}
    x = torch.rand(400, 50, generator=gen(1)) + 0.5
    y = tdagnn._apply_head(head, cfg, x, gen(2), train=True)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.02
    assert torch.equal(y[kept], x[kept] / 0.75)

"""The per-direction wavefront's kernels, plain versions against the JAX
package's Pallas kernels (interpret mode on the CPU):
  * K6, the edge-softmax aggregate: forward and the gradients of its
    autograd Function (scores, values) against pallas_edge_softmax_aggregate
    and its custom VJP, with masked edges, an edge whose slot lies out of
    range, the pad slot as a real segment, empty and fully masked slots;
    and with dst in permuted order, 70 edges on one slot and a negative id;
  * K5, the transpose-grad accumulate, against _tg_accumulate;
  * K2's split form, row_backward_plain(merge_tg=False) at one direction,
    against fused_row_backward(merge_tg=False);
and the segment ops of ops/segment.py against dagnn_tpu/ops/segment.py.

Tolerances as in tests/test_pallas_kernel.py and test_torch_row_step.py:
f32 outputs atol 1e-5 / rtol 1e-4, f32 grads atol 1e-4 / rtol 1e-3 (sums
in another order); bf16 3e-2 of the output's own max|jax| (one bf16
rounding step taken at a different point). K2's weight grads as in
test_torch_row_step.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dagnn_tpu.nn import aggregators as jagg
from dagnn_tpu.ops import segment as jseg
from dagnn_tpu.ops.pallas import row_step as jrs
from dagnn_tpu.ops.pallas.segment_attn import pallas_edge_softmax_aggregate as jesa
from dagnn_tpu_torch import checks
from dagnn_tpu_torch.convert import flatten_tree as checks_flat
from dagnn_tpu_torch.convert import unflatten_tree as unflatten
from dagnn_tpu_torch.nn import aggregators
from dagnn_tpu_torch.ops import row_step as trs
from dagnn_tpu_torch.ops import segment as tseg
from dagnn_tpu_torch.ops import segment_attn as tsa
from test_torch_row_step import BF16_TOL, DTYPES, NOISE_TOL, _close, _map, _tnp

torch.set_num_threads(1)

KE, S, H = 40, 9, 16          # 8 slots + the pad slot


def _k6_inputs(seed, in_range=False):
    """Sorted slots in [0, S] (S itself out of range unless in_range), ~25%
    masked edges, slot 2 empty and slot 5's edges all masked."""
    rng = np.random.default_rng(seed)
    dst = np.sort(rng.choice([0, 1, 3, 4, 5, 6, 7, 8] + [8 if in_range else 9], KE))
    mask = rng.random(KE) > 0.25
    mask[dst == 5] = False
    return dict(scores=rng.normal(size=KE).astype(np.float32),
                values=rng.normal(size=(KE, H)).astype(np.float32),
                dst=dst.astype(np.int32), mask=mask,
                g=rng.normal(size=(S, H)).astype(np.float32))


def _f32_close(a, b, grad, name):
    tol = dict(rtol=1e-3, atol=1e-4) if grad else dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(a, b, err_msg=name, **tol)


def _k6_close(a, b, dtype, grad, name):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape, name
    if dtype == "bfloat16":
        rel, err, scale = checks.rel_err(a, b)
        assert rel <= BF16_TOL, f"{name}: {err:.3g} of {scale:.3g} = {rel:.3g}"
    else:
        _f32_close(a, b, grad, name)


def _k6_against_pallas(inp, dtype, fn):
    """inp through pallas_edge_softmax_aggregate (fn "kernels") or its plain
    twin and through the JAX function in interpret mode with its VJP; the
    output and both grads held to the file's tolerances. Returns them."""
    jdt, tdt = DTYPES[dtype]
    js, jv = jnp.asarray(inp["scores"], jdt), jnp.asarray(inp["values"], jdt)
    jg = jnp.asarray(inp["g"], jdt)
    want, vjp = jax.vjp(lambda s, v: jesa(s, v, jnp.asarray(inp["dst"]),
                                         jnp.asarray(inp["mask"]), S, True),
                        js, jv)
    wds, wdv = vjp(jg)
    ts = torch.tensor(inp["scores"]).to(tdt).requires_grad_(True)
    tv = torch.tensor(inp["values"]).to(tdt).requires_grad_(True)
    agg = (tsa.pallas_edge_softmax_aggregate if fn == "kernels"
           else tsa.plain_edge_softmax_aggregate)
    got = agg(ts, tv, torch.tensor(inp["dst"]),
              torch.tensor(inp["mask"]).float(), S)
    assert got.dtype == tdt and tuple(got.shape) == (S, H)
    gds, gdv = torch.autograd.grad(got, (ts, tv), torch.tensor(inp["g"]).to(tdt))
    assert gds.dtype == tdt and gdv.dtype == tdt
    _k6_close(_tnp(got.detach()), want, dtype, False, "out")
    _k6_close(_tnp(gds), wds, dtype, True, "d_scores")
    _k6_close(_tnp(gdv), wdv, dtype, True, "d_values")
    return got, gds, gdv


@pytest.mark.parametrize("fn", ["kernels", "plain"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_edge_softmax_aggregate_matches_pallas(dtype, fn):
    inp = _k6_inputs(0)
    got, gds, gdv = _k6_against_pallas(inp, dtype, fn)
    # empty, fully masked and out-of-range: zero out, zero grads
    assert not got[2].any() and not got[5].any()
    dead = ~torch.tensor(inp["mask"]) | (torch.tensor(inp["dst"]) >= S)
    assert not gds[dead].any() and not gdv[dead].any()


KE2 = 128                     # with one slot of 70 edges


def _k6_inputs_unsorted(seed):
    """KE2 edges in permuted order: 70 on slot 3 (more than a 32-edge
    round), the rest over the other slots and S (out of range), one id -1
    with its mask set, ~20% of the others masked."""
    rng = np.random.default_rng(seed)
    dst = np.concatenate([np.full(70, 3),
                          rng.choice([0, 1, 2, 4, 5, 6, 7, 8, 9], KE2 - 71), [-1]])
    mask = rng.random(KE2) > 0.2
    mask[70:][dst[70:] == 5] = False
    mask[dst == 3] = True
    mask[-1] = True
    perm = rng.permutation(KE2)
    return dict(scores=rng.normal(size=KE2).astype(np.float32),
                values=rng.normal(size=(KE2, H)).astype(np.float32),
                dst=dst[perm].astype(np.int32), mask=mask[perm],
                g=rng.normal(size=(S, H)).astype(np.float32))


@pytest.mark.parametrize("fn", ["kernels", "plain"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_edge_softmax_aggregate_unsorted_matches_pallas(dtype, fn):
    """The cases the card kernels branch on: dst in no order, a slot with
    more edges than a warp has lanes, a negative id."""
    inp = _k6_inputs_unsorted(3)
    assert (inp["dst"] == 3).sum() == 70 and (np.diff(inp["dst"]) < 0).any()
    got, gds, gdv = _k6_against_pallas(inp, dtype, fn)
    # slots without a valid edge (slot 5's are all masked) aggregate to 0;
    # the dead edges' grads are 0
    dst, mask = torch.tensor(inp["dst"]), torch.tensor(inp["mask"])
    dead = ~mask | (dst < 0) | (dst >= S)
    deg = torch.bincount(dst[~dead].long(), minlength=S)
    assert deg[5] == 0 and not got[deg == 0].any()
    assert not gds[dead].any() and not gdv[dead].any()


def test_segment_ops_match_jax():
    """Slots in range: the only ids the wavefront gives them (JAX's
    segment_softmax weighs an out-of-range id by a clamped slot's sums)."""
    inp = _k6_inputs(1, in_range=True)
    s, v, m = inp["scores"], inp["values"], inp["mask"]
    d = inp["dst"]
    jm, td, tm = jnp.asarray(m), torch.tensor(d), torch.tensor(m)
    _f32_close(tseg.segment_sum(torch.tensor(v), td, S, tm).numpy(),
               jseg.segment_sum(jnp.asarray(v), jnp.asarray(d), S, jm),
               False, "segment_sum")
    _f32_close(tseg.segment_softmax(torch.tensor(s), td, S, tm).numpy(),
               jseg.segment_softmax(jnp.asarray(s), jnp.asarray(d), S, jm),
               False, "segment_softmax")
    _f32_close(tseg.edge_softmax_aggregate(torch.tensor(s), torch.tensor(v),
                                           td, S, tm).numpy(),
               jseg.edge_softmax_aggregate(jnp.asarray(s), jnp.asarray(v),
                                           jnp.asarray(d), S, jm),
               False, "edge_softmax_aggregate")


KN, KT, C = 8, 24, 32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tg_accumulate_matches_pallas(dtype):
    rng = np.random.default_rng(2)
    jdt, tdt = DTYPES[dtype]
    g = rng.normal(size=(KN, C)).astype(np.float32)
    tg = rng.normal(size=(KT, C)).astype(np.float32)
    tdst = rng.integers(0, KN + 1, KT).astype(np.int32)   # KN: pad
    tmask = rng.random(KT) > 0.3
    want = jrs._tg_accumulate(True, jnp.asarray(g, jdt), jnp.asarray(tg, jdt),
                              jnp.asarray(tdst), jnp.asarray(tmask), KN)
    got = trs.tg_accumulate(torch.tensor(g).to(tdt), torch.tensor(tg).to(tdt),
                            torch.tensor(tdst), torch.tensor(tmask).float())
    assert got.dtype == tdt
    _k6_close(_tnp(got), want, dtype, False, "tg_accumulate")


EMB, HID, NL, R, KE1 = 12, 16, 2, 2, 16


def _row_inputs(seed):
    """One direction's row (ndirs=1) with its unstacked weights."""
    rng = np.random.default_rng(seed)
    u = lambda *s: rng.uniform(-0.5, 0.5, size=s).astype(np.float32)
    n = lambda *s: rng.normal(size=s).astype(np.float32)
    qdims = [EMB] + [HID] * (NL - 1)
    aggr = [{"attn_lin": {"w": u(1, qdims[l] + HID), "b": u(1)},
             "edge_encoder": {"w": u(HID, R), "b": u(HID)}} for l in range(NL)]
    cells = [{"w_ih": u(3 * HID, qdims[l]), "w_hh": u(3 * HID, HID),
              "b_ih": u(3 * HID), "b_hh": u(3 * HID)} for l in range(NL)]
    edst = np.sort(rng.integers(0, KN, KE1))
    emask = rng.random(KE1) > 0.2
    edst[~emask] = KN
    ea = np.zeros((KE1, R), np.float32)
    ea[np.arange(KE1), rng.integers(0, R, KE1)] = 1.0
    x = dict(xin=n(KN, EMB), vals=0.5 * n(KE1, NL * HID), ea=ea,
             edst=edst.astype(np.int32), emask=emask,
             nmask=rng.random(KN) > 0.1, g=n(KN, NL * HID),
             tg=n(KT, NL * HID),
             tdst=rng.integers(0, KN + 1, KT).astype(np.int32),
             tmask=rng.random(KT) > 0.3)
    return qdims, aggr, cells, x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_row_backward_matches_pallas(dtype):
    """K2 with merge_tg=False at ndirs=1 (K5 first, then K2 without a
    transpose list) against the JAX two-call form. bf16 readings here: at
    most 9.4e-3 on dx/dvals/dea and 2.1e-2 on the weight grads. Over
    input seeds 0-9 the edge encoder's weight grad, at one direction a
    cancelling sum of about 8 bf16-rounded terms per edge type, read up to
    0.26 between the packages in the split and the merged form alike (each
    2-10% off the float32 gradient), dea up to 4.9e-2."""
    qdims, aggr, cells, x = _row_inputs(0)
    jdt, tdt = DTYPES[dtype]
    jconv = lambda a: jnp.asarray(a, jdt)
    tconv = lambda a: torch.tensor(a).to(tdt)
    jw = jrs.flatten_row_weights(_map(aggr, jconv), _map(cells, jconv), qdims, True)
    tw = trs.flatten_row_weights(_map(aggr, tconv), _map(cells, tconv), qdims, True)
    jx = {k: jnp.asarray(v, jdt) if v.dtype == np.float32 else jnp.asarray(v)
          for k, v in x.items()}
    tx = {k: torch.tensor(v).to(tdt) if v.dtype == np.float32 else torch.tensor(v)
          for k, v in x.items()}
    st = (True, HID, NL)
    fa = ("xin", "vals", "ea", "edst", "emask", "nmask")
    _, a32, nres = jrs.fused_row_forward(st, True, *[jx[k] for k in fa], jw,
                                         emit_res=True)
    want = jrs.fused_row_backward(st, True, *[jx[k] for k in fa], jw, jx["g"],
                                  jx["tg"], jx["tdst"], jx["tmask"],
                                  merge_tg=False, res=(a32, nres))
    tres = (torch.tensor(np.asarray(a32)),
            torch.tensor(np.asarray(nres, np.float32)).to(tdt))
    targs = [tx[k] for k in fa] + [tw, tx["g"], tx["tg"], tx["tdst"], tx["tmask"],
                                   tres]
    got = trs.row_backward(st, *targs, merge_tg=False)
    for name, a, b in zip(("dx", "dvals", "dea"), got[:3], want[:3]):
        _close(_tnp(a), b, dtype, grad=True, name=name)
    assert set(got[3]) == set(want[3])
    # f32: the split form is the merged form's arithmetic (K5's f32 sum is
    # the one K2 takes inside)
    merged = trs.row_backward_plain(st, *targs)
    if dtype == "float32":
        for k in want[3]:
            _close(_tnp(got[3][k]), want[3][k], dtype, grad=True, name=f"dw[{k}]")
            torch.testing.assert_close(got[3][k], merged[3][k], rtol=1e-5, atol=1e-6)
        return
    fx, fw = checks.to_f32(tx), checks.to_f32(tw)
    f32args = [fx[k] for k in fa] + [fw]
    t32 = trs.row_forward_plain(st, *f32args, emit_res=True)[1:]
    truth = trs.row_backward_plain(st, *f32args, fx["g"], fx["tg"], fx["tdst"],
                                   fx["tmask"], t32)[3]
    tmax = checks.tree_max(truth)
    for k in want[3]:
        rel, err, scale, noise = checks.grad_err(got[3][k], want[3][k],
                                                 truth[k], tmax)
        assert rel <= BF16_TOL, f"dw[{k}]: {err:.3g} of {scale:.3g} = {rel:.3g}"
        assert noise <= NOISE_TOL, f"dw[{k}]: noise {noise:.3g}"


def test_split_is_single_direction_and_unported_aggregates_raise():
    qdims, aggr, cells, x = _row_inputs(4)
    w = trs.stack_row_weights([trs.flatten_row_weights(
        _map(aggr, torch.tensor), _map(cells, torch.tensor), qdims, True)] * 2)
    two = lambda k: torch.tensor(np.concatenate([x[k], x[k]]))
    with pytest.raises(ValueError, match="single-direction"):
        trs.row_backward_plain((True, HID, NL), two("xin"), two("vals"), two("ea"),
                               two("edst"), two("emask"), two("nmask"), w, two("g"),
                               two("tg"), two("tdst"), two("tmask"), None,
                               ndirs=2, merge_tg=False)
    # the aggregates this test once held to a raise run now on K6's
    # contract (its plain version on the CPU) and match the JAX package's
    # aggregate_level (mattn's query gather clamps pad slot KN explicitly;
    # the pad slot's output row, which callers cut off, has a zero
    # cotangent)
    rng = np.random.default_rng(5)
    n = lambda *s: rng.normal(size=s).astype(np.float32)
    edst = np.sort(rng.integers(0, KN + 1, KE1)).astype(np.int32)
    emask = rng.random(KE1) > 0.2
    v, k, q, g = n(KE1, HID), n(KE1, HID), n(KN, EMB), n(KN + 1, HID)
    g[KN] = 0.0
    for spec, impl in ((aggregators.AggregatorSpec("mattn", HID, HID, EMB), "pallas"),
                       (aggregators.AggregatorSpec("self_attn", HID, HID), "pallas"),
                       (aggregators.AggregatorSpec("attn", HID, HID, EMB), "dense"),
                       (aggregators.AggregatorSpec("attn", HID, HID, EMB), "scatter")):
        jspec = jagg.AggregatorSpec(**dataclasses.asdict(spec))
        params = jagg.aggregator_init(jax.random.PRNGKey(1), jspec)
        want, vjp = jax.vjp(lambda p, a, b, c: jagg.aggregate_level(
            p, jspec, a, jnp.asarray(edst), jnp.asarray(emask), KN + 1,
            key_src=b, query=c, impl=impl), params, *map(jnp.asarray, (v, k, q)))
        jgrads = vjp(jnp.asarray(g))
        tp = {kk: torch.tensor(np.asarray(x)).requires_grad_(True)
              for kk, x in checks_flat(params).items()}
        ts = [torch.tensor(a).requires_grad_(True) for a in (v, k, q)]
        got = aggregators.aggregate_level(
            unflatten(tp), spec, ts[0], torch.tensor(edst),
            torch.tensor(emask).float(), KN + 1, key_src=ts[1], query=ts[2])
        _f32_close(got.detach().numpy(), want, False, f"{spec.kind} {impl}")
        tgr = torch.autograd.grad(got, list(tp.values()) + ts, torch.tensor(g),
                                  allow_unused=True)     # self_attn: no query
        jflat = checks_flat(jgrads[0])
        for (kk, _), t in zip(tp.items(), tgr):
            _f32_close(t.numpy(), jflat[kk], True, f"{spec.kind} {impl} {kk}")
        for name, t, j in zip(("values", "keys", "query"), tgr[len(tp):], jgrads[1:]):
            t = np.zeros(j.shape) if t is None else t.numpy()
            _f32_close(t, j, True, f"{spec.kind} {impl} d_{name}")

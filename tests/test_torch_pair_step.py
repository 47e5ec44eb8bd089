"""Pair kernels K3/K4: the port's plain versions against the JAX package's
Pallas kernels (interpret mode on the CPU), on a real pair step: the shrunk
flagship batch of test_torch_dagnn (synthetic ASTs, chunk 8, edge budget
16; 6 graphs, so that pair=1 and pair=2 give different plans) collated
with a pair plan, at the pair step with the most intra-pair edges that also
has A-row and far edges. 2 layers, H=16, emb=12, R=2; vals, g and tg
random from a seed.

Tolerances as in test_torch_row_step (ROADMAP): f32 outputs 2e-5, f32
grads rtol 5e-4 / atol 5e-5; bf16 outputs: max|port - jax| <= 3e-2 of the
output's own max|jax| (dagnn_tpu_torch.checks; readings at most 4.6e-3).
bf16 grads are held on their own scale with the elements that are zero in
exact arithmetic (told apart by the port's float32 plain backward on the
same bf16 inputs) held to a noise bound instead: the port's noise may be
at most 8 times the JAX kernel's (readings at most 3.1). A destination
with one edge has a score grad that is zero in exact arithmetic, so dea
holds such elements too. dx / dvals / dea: 3e-2 (readings at most 6.5e-3).
Weight grads: 1e-1. The JAX kernel rounds each block's weight grads to
bf16 and sums the two blocks of a direction in bf16, the port keeps
float32; on the attention key and edge-encoder weights, cancelling sums
over the edges, each package is 3-9% off the float32 gradient on its own,
and they differ by up to 5.3e-2 (a1_wk); every other leaf reads below
1.6e-2.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dagnn_tpu.ops.pallas import pair_step as jps
from dagnn_tpu.ops.pallas import row_step as jrs
from dagnn_tpu_torch import checks, flagship
from dagnn_tpu_torch.dag.batch import collate
from dagnn_tpu_torch.data.synthetic import synthetic_ast_batch
from dagnn_tpu_torch.ops import pair_step as tps
from dagnn_tpu_torch.ops import row_step as trs
from test_torch_row_step import (BF16_TOL, DTYPES, EMB, H, NL, NOISE_TOL, R,
                                 _close, _map, _params, _tnp)

torch.set_num_threads(1)

BF16_DW_TOL = 1e-1
# 6 graphs: the smallest seed-0 batch whose pair=1 and pair=2 plans differ
N_GRAPHS = 6


@functools.lru_cache(maxsize=None)
def _pair_step(pair):
    """(plan arrays of one pair step, its blocks, Kn) of the shrunk
    flagship batch collated with `pair`: the step with the most intra-pair
    edges among those whose A rows and B far region have edges too (the
    first step's A row holds only leaves)."""
    graphs = synthetic_ast_batch(0, N_GRAPHS, mean_nodes=14, vocab=20, seq_len=3)
    b = collate(graphs, flagship.pad_for(graphs, chunk=8, edge_budget=16,
                                         pair=pair))
    plan, kn = b.pair, b.fwd.node_ids.shape[1]
    w = plan.widths
    ka = w["keA"][0] + w["keA"][1]
    intra = (plan.nsrc < kn).sum(1)
    far = (plan.emask[:, ka:] & (plan.nsrc[:, ka:] >= kn)).sum(1)
    score = np.where((plan.emask[:, :ka].sum(1) > 0) & (far > 0), intra, -1)
    p = int(np.argmax(score))
    assert score[p] > 0
    arrays = {k: getattr(plan, k)[p] for k in
              ("edst", "emask", "nsrc", "tdst", "tmask", "node_mask")}
    return arrays, plan.blocks, kn


def _inputs(seed, pair, has_ea):
    arrays, blocks, kn = _pair_step(pair)
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.normal(size=s).astype(np.float32)
    w, u, t = (arrays["edst"].shape[0], sum(b[3] for b in blocks),
               arrays["tdst"].shape[0])
    ea = np.zeros((w, R), np.float32)
    ea[np.arange(w), rng.integers(0, R, w)] = 1.0
    qdims, dirs = _params(rng)
    d = dict(xin=n(4 * kn, EMB), vals=0.5 * n(u, NL * H), ea=ea,
             edst=arrays["edst"], emask=arrays["emask"], nsrc=arrays["nsrc"],
             nmask=arrays["node_mask"], g=n(4 * kn, NL * H),
             tg=n(t, NL * H), tdst=arrays["tdst"], tmask=arrays["tmask"])
    return d, (qdims, dirs), blocks, (has_ea, H, NL)


def _weights(mod, params, conv, has_ea):
    qdims, dirs = params
    return mod.stack_row_weights([
        mod.flatten_row_weights(_map(a, conv), _map(c, conv), qdims, has_ea)
        for a, c in dirs])


def _both(d, params, dtype, has_ea):
    jdt, tdt = DTYPES[dtype]
    jx = {k: jnp.asarray(v, jdt) if v.dtype == np.float32 else jnp.asarray(v)
          for k, v in d.items()}
    tx = {k: torch.tensor(v).to(tdt) if v.dtype == np.float32 else torch.tensor(v)
          for k, v in d.items()}
    if not has_ea:
        jx["ea"] = tx["ea"] = None
    jw = _weights(jrs, params, lambda a: jnp.asarray(a, jdt), has_ea)
    tw = _weights(trs, params, lambda a: torch.tensor(a).to(tdt), has_ea)
    return jx, jw, tx, tw


def _args(x, w):
    return (x["xin"], x["vals"], x["ea"], x["edst"], x["emask"], x["nmask"],
            x["nsrc"], w)


@pytest.mark.parametrize("has_ea", [True, False], ids=["ea", "noea"])
@pytest.mark.parametrize("emit_res", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pair_forward_matches_pallas(dtype, emit_res, has_ea):
    d, params, blocks, st = _inputs(0, 2, has_ea)
    jx, jw, tx, tw = _both(d, params, dtype, has_ea)
    want = jps.fused_pair_forward(st, True, *_args(jx, jw), blocks,
                                  emit_res=emit_res)
    got = tps.pair_forward(st, *_args(tx, tw), blocks, emit_res=emit_res)
    if not emit_res:
        want, got = (want,), (got,)
    for name, a, b in zip(("out", "alpha32", "nres"), got, want):
        _close(_tnp(a), b, dtype, name=name)


@pytest.mark.parametrize("dtype,pair", [("float32", 1), ("float32", 2),
                                        ("bfloat16", 2)])
def test_pair_backward_matches_pallas(dtype, pair):
    d, params, blocks, st = _inputs(1, pair, True)
    jx, jw, tx, tw = _both(d, params, dtype, True)
    _, a32, nres = jps.fused_pair_forward(st, True, *_args(jx, jw), blocks,
                                          emit_res=True)
    want = jps.fused_pair_backward(st, True, *_args(jx, jw), jx["g"], jx["tg"],
                                   jx["tdst"], jx["tmask"], (a32, nres), blocks)
    tres = (torch.tensor(np.asarray(a32)),
            torch.tensor(np.asarray(nres, np.float32)).to(DTYPES[dtype][1]))
    got = tps.pair_backward(st, *_args(tx, tw), tx["g"], tx["tg"], tx["tdst"],
                            tx["tmask"], tres, blocks)
    assert set(got[3]) == set(want[3])
    for k in want[3]:
        assert got[3][k].dtype == torch.float32
    if dtype == "float32":
        for name, a, b in zip(("dx", "dvals", "dea"), got[:3], want[:3]):
            _close(_tnp(a), b, dtype, grad=True, name=name)
        for k in want[3]:
            _close(_tnp(got[3][k]), want[3][k], dtype, grad=True, name=f"dw[{k}]")
        return
    # bf16: the float32 plain backward on the same (bf16) inputs marks the
    # elements that are zero in exact arithmetic
    fx, fw = checks.to_f32(tx), checks.to_f32(tw)
    _, t32, tn = tps.pair_forward_plain(st, *_args(fx, fw), blocks, emit_res=True)
    truth = tps.pair_backward_plain(st, *_args(fx, fw), fx["g"], fx["tg"],
                                    fx["tdst"], fx["tmask"], (t32, tn), blocks)
    leaves = [(name, a, b, t, checks.tree_max({name: t}), BF16_TOL)
              for name, a, b, t in zip(("dx", "dvals", "dea"), got[:3], want[:3],
                                       truth[:3])]
    tmax = checks.tree_max(truth[3])
    leaves += [(f"dw[{k}]", got[3][k], want[3][k], truth[3][k], tmax, BF16_DW_TOL)
               for k in want[3]]
    for name, a, b, t, scale_max, tol in leaves:
        rel, err, scale, noise = checks.grad_err(a, b, t, scale_max)
        assert rel <= tol, \
            f"{name}: {err:.3g} of max|ref| {scale:.3g} = {rel:.3g} > {tol}"
        assert noise <= NOISE_TOL, f"{name}: noise {noise:.3g} x the reference's"


def test_pair_backward_accumulates_into_dw():
    """dw_acc: the pair's weight grads are added into the given buffers,
    and a pad-free check that no-ea runs end to end."""
    d, params, blocks, st = _inputs(2, 2, False)
    _, _, tx, tw = _both(d, params, "float32", False)
    _, a32, nres = tps.pair_forward(st, *_args(tx, tw), blocks, emit_res=True)
    args = _args(tx, tw) + (tx["g"], tx["tg"], tx["tdst"], tx["tmask"],
                            (a32, nres), blocks)
    dx, dvals, dea, once = tps.pair_backward(st, *args)
    assert dea is None and torch.isfinite(dx).all() and torch.isfinite(dvals).all()
    acc = {k: torch.ones_like(v) for k, v in once.items()}
    twice = tps.pair_backward(st, *args, dw_acc=acc)[3]
    assert twice is acc
    for k in once:
        torch.testing.assert_close(twice[k], once[k] + 1.0)

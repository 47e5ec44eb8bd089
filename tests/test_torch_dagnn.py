"""The port's dagnn_forward against the JAX package's, with the same weights
(carried over by convert.py), on the flagship TOK config shrunk to emb 12 /
hidden 16 / vocab 20 / seq 3: AST encoder, bidirectional attn_h with edge
attributes, max pool over out_slots, 4 synthetic ASTs collated with stagger
packing and edge-budget row splitting (several wavefront rows) on the
merged path, and 6 collated with a pair plan (pair=1/2/3) on the pair path.

The JAX side runs its fused Pallas row kernels in interpret mode
(segment_impl="fused", as tests/test_compute_modes.py does) and, for the
f32 check, also its dense XLA path. Tolerances as in test_torch_row_step:
f32 outputs 2e-5, f32 grads rtol 5e-4 / atol 5e-5; bf16 outputs 3e-2 of
their own max|jax| (dagnn_tpu_torch.checks).

bf16 grads: 1e-1 of each leaf's own max|jax|. Both packages are within
about 3-5% of the float32 gradient on their own: the JAX merged backward
rounds each row's weight grads to bf16 and sums them in bf16, the port
sums them in float32. Their difference reads at most 7.1e-2 here, on the
score weights of the last layer, whose gradient is a cancelling sum over
each destination's edges. Every leaf here is below 0.3, so this is tighter
than the former 3e-2 of max(1, max|ref|). Elements that are zero in exact
arithmetic (checks.ZERO, told apart by the port's float32 gradient with
the same bf16-rounded weights) hold rounding noise in both packages: the
port's may be at most 8 times the JAX package's (readings at most 4.5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from dagnn_tpu.dag.batch import collate as jcollate
from dagnn_tpu.data.synthetic import synthetic_ast_batch as jsynth
from dagnn_tpu.nn import dagnn as jdagnn
from dagnn_tpu.train.losses import tok_loss as jtok_loss
from dagnn_tpu_torch import checks, convert, flagship
from dagnn_tpu_torch.dag.batch import collate as tcollate
from dagnn_tpu_torch.data.synthetic import synthetic_ast_batch as tsynth
from dagnn_tpu_torch.nn import dagnn as tdagnn
from dagnn_tpu_torch.train.losses import tok_loss as ttok_loss

torch.set_num_threads(1)

EMB, HID, VOCAB, SEQ = 12, 16, 20, 3
BF16_TOL, BF16_GRAD_TOL, NOISE_TOL = 3e-2, 1e-1, 8.0


def small_setup(dtype="float32", seed=0, n_graphs=4, pair=0, nearfar=0,
                out_wx=False):
    """(jax cfg, port cfg, jax params, port params, jax batch, port batch)
    of the shrunk flagship; both batches collated from the same graphs,
    with a pair plan when pair > 0 (the JAX bench's rounding of max_levels
    to even, bench.py:151-152), in a near/far layout when nearfar is set
    (PadConfig.nearfar); out_wx puts each direction's input rows beside
    the pooled states (a wider head)."""
    kw = dict(mean_nodes=14, vocab=VOCAB, seq_len=SEQ)
    jg, tg = jsynth(seed, n_graphs, **kw), tsynth(seed, n_graphs, **kw)
    jpad = dataclasses.replace(ge._pad_for(jg, chunk=8, edge_budget=16),
                               nearfar=nearfar)
    if pair:
        jpad = dataclasses.replace(
            jpad, pair=pair, max_levels=jpad.max_levels + jpad.max_levels % 2)
    tpad = dataclasses.replace(
        flagship.pad_for(tg, chunk=8, edge_budget=16, pair=pair), nearfar=nearfar)
    tcfg = flagship.flagship_cfg(emb=EMB, hidden=HID, vocab=VOCAB, seq=SEQ,
                                 compute_dtype=dtype)
    jcfg = dataclasses.replace(ge._flagship_cfg(emb=EMB, hidden=HID),
                               num_vocab=VOCAB, max_seq_len=SEQ,
                               compute_dtype=dtype, segment_impl="fused")
    tcfg = dataclasses.replace(tcfg, out_wx=out_wx)
    jcfg = dataclasses.replace(jcfg, out_wx=out_wx)
    jparams = jdagnn.dagnn_init(jax.random.PRNGKey(seed), jcfg)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        device="cpu")
    return (jcfg, tcfg, jparams, tparams, jcollate(jg, jpad),
            tcollate(tg, tpad))


def jax_run(jcfg, jparams, jb):
    """(logits, loss, grads) of the JAX package, in one jitted forward."""
    def loss(p, b):
        logits = jdagnn.dagnn_forward(p, jcfg, b)
        return jtok_loss(logits, b.y["y_arr"], b.graph_mask), logits
    (val, logits), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jparams, jb)
    return (np.asarray(logits), float(val),
            convert.flatten_tree(jax.tree.map(np.asarray, g)))


def port_loss_and_grads(tcfg, tparams, tb, impl=None):
    p = {k: v.detach().clone().requires_grad_(True) for k, v in tparams.items()}
    loss = ttok_loss(tdagnn.dagnn_forward(p, tcfg, tb, impl=impl),
                     torch.as_tensor(tb.y["y_arr"]),
                     torch.as_tensor(tb.graph_mask))
    gs = torch.autograd.grad(loss, list(p.values()))
    return float(loss.detach()), {k: g.numpy() for k, g in zip(p, gs)}


def close(a, b, dtype, grad=False, name=""):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape, name
    if dtype == "bfloat16":
        rel, err, scale = checks.rel_err(a, b)
        assert rel <= BF16_TOL, \
            f"{name}: {err:.3g} of max|ref| {scale:.3g} = {rel:.3g} > {BF16_TOL}"
    elif grad:
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-5, err_msg=name)
    else:
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5, err_msg=name)


def close_bf16_grads(got, want, tcfg, tparams, tb, impl=None,
                     group=lambda grads: grads):
    """bf16 grads leaf by leaf on their own scale; the port's float32
    gradient with the same bf16-rounded weights marks the elements that
    are zero in exact arithmetic. `group` maps each of the three gradient
    dicts to the leaves that are checked."""
    p32 = {k: v.to(torch.bfloat16).float() for k, v in tparams.items()}
    _, truth = port_loss_and_grads(
        dataclasses.replace(tcfg, compute_dtype="float32"), p32, tb, impl)
    got, want, truth = group(got), group(want), group(truth)
    tmax = checks.tree_max(truth)
    for k in want:
        rel, err, scale, noise = checks.grad_err(got[k], want[k], truth[k], tmax)
        assert rel <= BF16_GRAD_TOL, \
            f"{k}: {err:.3g} of max|ref| {scale:.3g} = {rel:.3g} > {BF16_GRAD_TOL}"
        assert noise <= NOISE_TOL, f"{k}: noise {noise:.3g} x the reference's"


def test_params_round_trip():
    """convert: the JAX pytree -> the port's dotted-key dict -> the same
    nested pytree (lists stay lists), bit for bit."""
    jcfg = dataclasses.replace(ge._flagship_cfg(emb=EMB, hidden=HID),
                               num_vocab=VOCAB, max_seq_len=SEQ)
    tree = jax.tree.map(np.asarray, jdagnn.dagnn_init(jax.random.PRNGKey(5), jcfg))
    tparams = convert.params_from_numpy(tree, device="cpu")
    assert "aggr.1.0.attn_lin.w" in tparams and "cells.0.1.w_ih" in tparams
    back = convert.params_to_numpy(tparams)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_grads_match_jax_fused(dtype):
    jcfg, tcfg, jparams, tparams, jb, tb = small_setup(dtype)
    assert tb.fwd.node_ids.shape[0] > 4          # a real multi-row wavefront
    want, jl, jg = jax_run(jcfg, jparams, jb)
    with torch.no_grad():
        got = tdagnn.dagnn_forward(tparams, tcfg, tb).float().numpy()
    close(got, want, dtype, name="logits")
    tl, tg = port_loss_and_grads(tcfg, tparams, tb)
    close(tl, jl, dtype, name="loss")
    assert set(jg) == set(tg)
    if dtype == "bfloat16":
        close_bf16_grads(tg, jg, tcfg, tparams, tb)
        return
    for k in jg:
        close(tg[k], jg[k], dtype, grad=True, name=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_out_wx_matches_jax(dtype):
    """out_wx=True (the reference's default; the flagship turns it off): the
    readout concatenates each direction's input rows at the output slots
    before the pooled states, on the merged wavefront."""
    jcfg, tcfg, jparams, tparams, jb, tb = small_setup(dtype, seed=3,
                                                       out_wx=True)
    assert tcfg.out_wx and tcfg.out_hidden_dim == 2 * (EMB + 2 * HID)
    assert tdagnn._route(tcfg, tb, None)[0] == "merged"
    want, jl, jg = jax_run(jcfg, jparams, jb)
    with torch.no_grad():
        got = tdagnn.dagnn_forward(tparams, tcfg, tb).float().numpy()
    close(got, want, dtype, name="logits")
    tl, tg = port_loss_and_grads(tcfg, tparams, tb)
    close(tl, jl, dtype, name="loss")
    assert set(jg) == set(tg)
    if dtype == "bfloat16":
        close_bf16_grads(tg, jg, tcfg, tparams, tb)
        return
    for k in jg:
        close(tg[k], jg[k], dtype, grad=True, name=k)


def test_forward_and_grads_match_jax_dense():
    jcfg, tcfg, jparams, tparams, jb, tb = small_setup("float32", seed=1)
    jcfg = dataclasses.replace(jcfg, segment_impl="dense")
    want, jl, jg = jax_run(jcfg, jparams, jb)
    with torch.no_grad():
        got = tdagnn.dagnn_forward(tparams, tcfg, tb).numpy()
    close(got, want, "float32", name="logits")
    tl, tg = port_loss_and_grads(tcfg, tparams, tb)
    close(tl, jl, "float32", name="loss")
    for k in jg:
        close(tg[k], jg[k], "float32", grad=True, name=k)


# 6 graphs: the smallest seed-0 batch whose pair=1, 2 and 3 plans differ
PAIR_GRAPHS = 6


@pytest.mark.parametrize("dtype,pair", [("float32", 1), ("float32", 2),
                                        ("float32", 3), ("bfloat16", 2)])
def test_pair_forward_and_grads_match_jax(dtype, pair):
    """A batch with a pair plan: the port's pair wavefront against the JAX
    package's pair_pass (fused pair kernels in interpret mode), as
    tests/test_pair.py:96-112 runs pair=1/2/3 against the merged path."""
    jcfg, tcfg, jparams, tparams, jb, tb = small_setup(
        dtype, seed=0, n_graphs=PAIR_GRAPHS, pair=pair)
    assert tb.pair is not None and tdagnn.pair_applicable(tcfg, tb)
    assert jdagnn.pair_applicable(jcfg, jb)
    want, jl, jg = jax_run(jcfg, jparams, jb)
    with torch.no_grad():
        got = tdagnn.dagnn_forward(tparams, tcfg, tb).float().numpy()
    close(got, want, dtype, name="logits")
    tl, tg = port_loss_and_grads(tcfg, tparams, tb)
    close(tl, jl, dtype, name="loss")
    assert set(jg) == set(tg)
    if dtype == "bfloat16":
        close_bf16_grads(tg, jg, tcfg, tparams, tb)
        return
    for k in jg:
        close(tg[k], jg[k], dtype, grad=True, name=k)


def test_pair_matches_merged():
    """The port's pair path at pair=1 (pair plan on the merged packing)
    against its merged path on the same graphs, f32: pairing only changes
    the execution layout."""
    _, tcfg, _, tparams, _, tb1 = small_setup("float32", seed=1,
                                              n_graphs=PAIR_GRAPHS, pair=1)
    tb0 = tb1._replace(pair=None)
    with torch.no_grad():
        o1 = tdagnn.dagnn_forward(tparams, tcfg, tb1).numpy()
        o0 = tdagnn.dagnn_forward(tparams, tcfg, tb0).numpy()
    close(o1, o0, "float32", name="logits")
    l1, g1 = port_loss_and_grads(tcfg, tparams, tb1)
    l0, g0 = port_loss_and_grads(tcfg, tparams, tb0)
    close(l1, l0, "float32", name="loss")
    for k in g0:
        close(g1[k], g0[k], "float32", grad=True, name=k)
    with pytest.raises(ValueError, match="impl"):
        tdagnn.dagnn_forward(tparams, tcfg, tb1, impl=tdagnn.PLAIN)


def test_other_paths_raise():
    """No silent fallback. The configs this test once held to a raise
    (segment_impl dense / scatter, self_attn_h on "fused", mattn_h on
    "pallas", the node-space readout out_pool_all on the fused
    per-direction branch) run now and match the JAX package from the same
    weights (f32 outputs 2e-5, grads rtol 5e-4 / atol 5e-5); the JAX side
    runs each config as given, out_pool_all on "dense" (the same function
    as its fused path, without Pallas interpret mode). The split
    transpose-grad form (SPLIT_KERNELS, merge_tg False) still raises on a
    near/far batch, whose near grads need K2's own merge (the JAX kernel
    asserts merge_tg there)."""
    jcfg0, tcfg, _, _, jb, tb = small_setup("float32", seed=2)
    for kw, route in ((dict(segment_impl="dense"), "generic"),
                      (dict(segment_impl="scatter"), "generic"),
                      (dict(agg="self_attn_h"), "generic"),
                      (dict(agg="mattn_h", segment_impl="pallas"), "generic"),
                      (dict(out_pool_all=True), "direction")):
        cfg = dataclasses.replace(tcfg, **kw)
        assert tdagnn._route(cfg, tb, None)[0] == route
        jcfg = dataclasses.replace(jcfg0, **kw)
        if jcfg.out_pool_all:
            jcfg = dataclasses.replace(jcfg, segment_impl="dense")
        jparams = jdagnn.dagnn_init(jax.random.PRNGKey(2), jcfg)
        tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                            device="cpu")
        want, jl, jg = jax_run(jcfg, jparams, jb)
        with torch.no_grad():
            got = tdagnn.dagnn_forward(tparams, cfg, tb).numpy()
        close(got, want, "float32", name=f"{kw} logits")
        tl, tg = port_loss_and_grads(cfg, tparams, tb)
        close(tl, jl, "float32", name=f"{kw} loss")
        assert set(jg) == set(tg)
        for k in jg:
            close(tg[k], jg[k], "float32", grad=True, name=f"{kw} {k}")
    nearfar = small_setup("float32", seed=2, nearfar="regions")[5]
    assert nearfar.fwd.edge_nsrc is not None
    for cfg in (tcfg, dataclasses.replace(tcfg, bidirectional=False)):
        with pytest.raises(ValueError, match="near/far"):
            tdagnn.dagnn_forward(tparams, cfg, nearfar,
                                 impl=tdagnn.SPLIT_KERNELS)

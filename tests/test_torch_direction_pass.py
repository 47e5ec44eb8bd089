"""The per-direction wavefront against the JAX package, with the same weights
on the same batch: the shrunk flagship of test_torch_dagnn.py (emb 12,
hidden 16, vocab 20, seq 3, 4 synthetic ASTs, several wavefront rows)
  * with segment_impl="pallas": the generic branch, whose aggregate is the
    edge-softmax aggregate K6 (the JAX side runs its Pallas kernel in
    interpret mode), with the transpose schedule and in its scatter-add
    form without one;
  * unidirectional (bidirectional=False) on the fused row kernels at one
    direction (the JAX side's fused Pallas kernels in interpret mode), with
    the transpose edge grads merged in K2 and split into K5 + K2
    (SPLIT_PLAIN, against the JAX package's DAGNN_TPU_SPLIT_TG form).
And, within the port in float32, the bidirectional fused model run per
direction against the merged path on the same batch, and the generic
branch on a near/far schedule against the plain layout.

Tolerances as ROADMAP sets them and test_torch_dagnn.py applies them: f32
outputs 2e-5, f32 grads rtol 5e-4 / atol 5e-5; bf16 outputs 3e-2 of their
own max|jax|, bf16 grads 1e-1 of each leaf's own max|jax| with the elements
that are zero in exact arithmetic held to 8 times the JAX package's noise.
On the generic branch the JAX package sums each level's weight grads in
bf16, the port in float32 (ROADMAP queue 3).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from dagnn_tpu.nn import dagnn as jdagnn
from dagnn_tpu_torch import checks, convert, flagship
from dagnn_tpu_torch.dag.batch import collate
from dagnn_tpu_torch.data.synthetic import synthetic_ast_batch
from dagnn_tpu_torch.nn import dagnn as tdagnn
from test_torch_dagnn import (close, close_bf16_grads, jax_run,
                              port_loss_and_grads, small_setup)

torch.set_num_threads(1)


def variant(dtype, seed, **kw):
    """small_setup's batch and configs with the fields `kw` replaced on
    both sides, and fresh weights for that config (the JAX init, carried
    over)."""
    jcfg, tcfg, _, _, jb, tb = small_setup(dtype, seed=seed)
    jcfg, tcfg = dataclasses.replace(jcfg, **kw), dataclasses.replace(tcfg, **kw)
    jparams = jdagnn.dagnn_init(jax.random.PRNGKey(seed), jcfg)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        device="cpu")
    return jcfg, tcfg, jparams, tparams, jb, tb


def no_transpose(b):
    """The batch without its transpose schedules (tgrad_*)."""
    drop = dict(tgrad_eslot=None, tgrad_dst=None, tgrad_mask=None)
    return b._replace(fwd=b.fwd._replace(**drop), rev=b.rev._replace(**drop))


def matches_jax(setup, dtype, impl=None, group=lambda grads: grads):
    jcfg, tcfg, jparams, tparams, jb, tb = setup
    want, jl, jg = jax_run(jcfg, jparams, jb)
    with torch.no_grad():
        got = tdagnn.dagnn_forward(tparams, tcfg, tb, impl=impl).float().numpy()
    close(got, want, dtype, name="logits")
    tl, tg = port_loss_and_grads(tcfg, tparams, tb, impl)
    close(tl, jl, dtype, name="loss")
    assert set(jg) == set(tg)
    if dtype == "bfloat16":
        close_bf16_grads(tg, jg, tcfg, tparams, tb, impl, group)
        return
    for k in jg:
        close(tg[k], jg[k], dtype, grad=True, name=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pallas_path_matches_jax(dtype):
    setup = variant(dtype, 5, segment_impl="pallas")
    tcfg, tb = setup[1], setup[5]
    assert tdagnn._route(tcfg, tb, None) == ("generic", tdagnn.SEG_KERNELS)
    assert tb.fwd.node_ids.shape[0] > 4          # a real multi-row wavefront
    matches_jax(setup, dtype, group=checks.score_linears)


def test_pallas_path_scatter_add_form_matches_jax():
    """Without a transpose schedule the generic backward scatter-adds each
    level's value grads into the state cotangent (JAX's acc.at[].add)."""
    jcfg, tcfg, jparams, tparams, jb, tb = variant("float32", 6,
                                                   segment_impl="pallas")
    matches_jax((jcfg, tcfg, jparams, tparams, no_transpose(jb),
                 no_transpose(tb)), "float32")
    # the fused branch's backward needs the transpose schedule, as in JAX
    uni = dataclasses.replace(tcfg, segment_impl="fused", bidirectional=False)
    p = {k: v.requires_grad_(True)
         for k, v in tdagnn.dagnn_init(0, uni, device="cpu").items()}
    out = tdagnn.dagnn_forward(p, uni, no_transpose(tb))
    with pytest.raises(NotImplementedError, match="transpose schedule"):
        out.float().sum().backward()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unidirectional_fused_matches_jax(dtype):
    setup = variant(dtype, 7, bidirectional=False)
    tcfg, tparams, tb = setup[1], setup[3], setup[5]
    assert not any(k.startswith(("aggr.1.", "cells.1.")) for k in tparams)
    assert tdagnn._route(tcfg, tb, None) == ("direction", tdagnn.KERNELS)
    matches_jax(setup, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unidirectional_split_matches_jax(dtype, monkeypatch):
    """SPLIT_PLAIN (K5, then K2 with merge_tg=False) against the JAX
    package's two-call form, which its DAGNN_TPU_SPLIT_TG knob selects, on
    the inputs of the merged-tg test above."""
    monkeypatch.setenv("DAGNN_TPU_SPLIT_TG", "1")
    matches_jax(variant(dtype, 7, bidirectional=False), dtype,
                impl=tdagnn.SPLIT_PLAIN)


def test_per_direction_matches_merged():
    """The bidirectional fused model run per direction (two
    _direction_pass calls, the row kernels at ndirs=1, K5 + K2) against the
    merged path on the same batch, float32."""
    _, tcfg, _, tparams, _, tb = small_setup("float32", seed=9)
    assert tdagnn._route(tcfg, tb, tdagnn.SPLIT_PLAIN)[0] == "direction"
    assert tdagnn._route(tcfg, tb, None)[0] == "merged"
    with torch.no_grad():
        o1 = tdagnn.dagnn_forward(tparams, tcfg, tb, impl=tdagnn.SPLIT_PLAIN)
        o0 = tdagnn.dagnn_forward(tparams, tcfg, tb)
    close(o1.numpy(), o0.numpy(), "float32", name="logits")
    l1, g1 = port_loss_and_grads(tcfg, tparams, tb, tdagnn.SPLIT_PLAIN)
    l0, g0 = port_loss_and_grads(tcfg, tparams, tb)
    close(l1, l0, "float32", name="loss")
    for k in g0:
        close(g1[k], g0[k], "float32", grad=True, name=k)
    # a merged-only or generic-only choice is refused per direction
    uni = dataclasses.replace(tcfg, bidirectional=False)
    for cfg, impl in ((uni, tdagnn.PAIR_KERNELS), (uni, tdagnn.SEG_KERNELS),
                      (dataclasses.replace(tcfg, segment_impl="pallas"),
                       tdagnn.KERNELS)):
        with pytest.raises(ValueError, match="impl"):
            tdagnn.dagnn_forward(tparams, cfg, tb, impl=impl)


def test_pallas_path_takes_nearfar_layouts():
    """A near/far schedule (PadConfig.nearfar) on the generic branch: its
    transpose covers far edges only, so the backward scatter-adds (as the
    JAX package's does, tests/test_compute_modes.py:100-144); the result is
    the plain layout's (f32: outputs 2e-5, grads rtol 5e-4 / atol 5e-5).
    The fused paths take it in their near/far modes (K7,
    test_torch_nearfar.py), but not in the split transpose-grad form."""
    _, tcfg, _, tparams, _, _ = variant("float32", 10, segment_impl="pallas")
    graphs = synthetic_ast_batch(10, 4, mean_nodes=14, vocab=20, seq_len=3)
    pad = flagship.pad_for(graphs, chunk=8, edge_budget=16)
    b0 = collate(graphs, pad)
    b1 = collate(graphs, dataclasses.replace(pad, nearfar="regions"))
    assert b1.fwd.edge_nsrc is not None
    with torch.no_grad():
        o1 = tdagnn.dagnn_forward(tparams, tcfg, b1)
        o0 = tdagnn.dagnn_forward(tparams, tcfg, b0)
    close(o1.numpy(), o0.numpy(), "float32", name="logits")
    l1, g1 = port_loss_and_grads(tcfg, tparams, b1)
    l0, g0 = port_loss_and_grads(tcfg, tparams, b0)
    close(l1, l0, "float32", name="loss")
    for k in g0:
        close(g1[k], g0[k], "float32", grad=True, name=k)
    with pytest.raises(ValueError, match="near/far"):
        tdagnn.dagnn_forward(tparams, dataclasses.replace(tcfg, segment_impl="fused"),
                             b1, impl=tdagnn.SPLIT_PLAIN)

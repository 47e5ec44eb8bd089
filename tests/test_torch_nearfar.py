"""The near/far layouts (K7) and the row backward without residual streams
(K2r), on the CPU against the JAX package and within the port.

Kernel level: row_forward_plain / row_backward_plain with nf against the
JAX package's fused_row_forward / fused_row_backward(nf=...) in interpret
mode, at ndirs 1 and 2 with the modes "r" (regions: far-only vals, near
rows from prev_out), "t" (tgonly) and "p" mixed in one merged row and
ragged per-direction widths; H 16, emb 12, 2 layers, Kn 8, edge attributes.
Model level: dagnn_forward and its grads on the shrunk flagship of
test_torch_dagnn.py collated with PadConfig.nearfar "regions", "tgonly"
and ("regions", "tgonly"), on the merged (bidirectional) and the
per-direction (unidirectional) wavefront, as tests/test_compute_modes.py:
100-144 runs the JAX package; the merged path with DAGNN_NO_RES_STREAM's
module flags set in both packages (K2r); and, within the port, the near/far
layouts against the plain layout and K2r against the residual streams.

Tolerances as ROADMAP sets them (test_torch_row_step.py,
test_torch_dagnn.py): f32 outputs 2e-5, f32 grads rtol 5e-4 / atol 5e-5;
bf16 outputs 3e-2 of their own max|jax|; bf16 weight grads 3e-2 of each
leaf's own max|jax| for one row and 1e-1 for the whole model, the elements
that are zero in exact arithmetic held to 8 times the JAX package's noise.
One row's edge-encoder weight grads (a*_we) are held to 1e-1, as a pair's
weight grads are (test_torch_pair_step.py): their two relation columns sum
to zero in exact arithmetic, the JAX kernel rounds them to bf16, and here
both packages are 4-16% off the float32 gradient on them (port against JAX
at most 8.7e-2; every other weight grad at most 1.9e-2).
The layout change and K2r are exact rewrites of the same arithmetic: K2r is
held bitwise, the layouts in f32 to the f32 tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dagnn_tpu.nn import dagnn as jdagnn
from dagnn_tpu.ops.pallas import row_step as jrs
from dagnn_tpu_torch import checks, convert, flagship
from dagnn_tpu_torch.dag.batch import collate as tcollate
from dagnn_tpu_torch.data.synthetic import synthetic_ast_batch as tsynth
from dagnn_tpu_torch.nn import dagnn as tdagnn
from dagnn_tpu_torch.ops import row_step as trs
from test_torch_dagnn import (EMB as M_EMB, HID, SEQ, VOCAB, close,
                              close_bf16_grads, jax_run, port_loss_and_grads,
                              small_setup)

torch.set_num_threads(1)

H, EMB, NL, R, KN, KT = 16, 12, 2, 2, 8, 10
ROW_BF16_TOL, WE_BF16_TOL, NOISE_TOL = 3e-2, 1e-1, 8.0
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
LAYOUTS = ["regions", "tgonly", ("regions", "tgonly")]


# ------------------------------------------------------------ kernel level

def _row_inputs(nf, seed):
    """One row of len(nf) direction blocks, schedule-like: per block sorted
    destination slots; under "r" far edges first, then near edges whose
    nsrc is a previous-row slot (pad edges: edst and nsrc = Kn, mask 0);
    under "t" a random third of the valid edges near; "p" none."""
    rng = np.random.default_rng(seed)
    nd = len(nf)
    n = lambda *s: rng.normal(size=s).astype(np.float32)
    edst, emask, nsrc = [], [], []
    for mode, ke, kf in nf:
        parts = [(0, kf), (kf, ke)] if mode == "r" else [(0, ke)]
        e = np.concatenate([np.sort(rng.integers(0, KN, b - a)) for a, b in parts])
        m = rng.random(ke) > 0.2
        e[~m] = KN
        ns = np.full(ke, KN)
        near = np.zeros(ke, bool)
        if mode == "r":
            near[kf:] = True
        elif mode == "t":
            near = rng.random(ke) < 0.35
        near &= m
        ns[near] = rng.integers(0, KN, int(near.sum()))
        edst.append(e)
        emask.append(m)
        nsrc.append(ns)
    W = sum(e[1] for e in nf)
    U = sum(kf if m == "r" else ke for m, ke, kf in nf)
    ea = np.zeros((W, R), np.float32)
    ea[np.arange(W), rng.integers(0, R, W)] = 1.0
    tdst = rng.integers(0, KN + 1, nd * KT)
    qd = [EMB] + [H] * (NL - 1)
    u = lambda *s: rng.uniform(-0.5, 0.5, size=s).astype(np.float32)
    params = [([{"attn_lin": {"w": u(1, qd[l] + H), "b": u(1)},
                 "edge_encoder": {"w": u(H, R), "b": u(H)}} for l in range(NL)],
               [{"w_ih": u(3 * H, qd[l]), "w_hh": u(3 * H, H),
                 "b_ih": u(3 * H), "b_hh": u(3 * H)} for l in range(NL)])
              for _ in range(nd)]
    arrays = dict(
        xin=n(nd * KN, EMB), vals=0.5 * n(U, NL * H), ea=ea,
        edst=np.concatenate(edst).astype(np.int32), emask=np.concatenate(emask),
        nsrc=np.concatenate(nsrc).astype(np.int32),
        nmask=rng.random(nd * KN) > 0.1, prev_out=0.5 * n(nd * KN, NL * H),
        near_g=n(nd * KN, NL * H), g=n(nd * KN, NL * H), tg=n(nd * KT, NL * H),
        tdst=tdst.astype(np.int32), tmask=rng.random(nd * KT) > 0.3)
    return arrays, params


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _both(arrays, params, dtype):
    """The inputs for both packages: float arrays in dtype (the masks as
    the kernels take them), weights flattened (stacked for two blocks)."""
    jdt, tdt = DTYPES[dtype]
    jx = {k: jnp.asarray(v, jdt) if v.dtype == np.float32 else jnp.asarray(v)
          for k, v in arrays.items()}
    tx = {k: torch.tensor(v).to(tdt) if v.dtype == np.float32 else torch.tensor(v)
          for k, v in arrays.items()}
    qd = [EMB] + [H] * (NL - 1)
    ws = []
    for mod, conv in ((jrs, lambda a: jnp.asarray(a, jdt)),
                      (trs, lambda a: torch.tensor(a).to(tdt))):
        flat = [mod.flatten_row_weights(_map(a, conv), _map(c, conv), qd, True)
                for a, c in params]
        ws.append(mod.stack_row_weights(flat) if len(flat) > 1 else flat[0])
    return jx, ws[0], tx, ws[1]


def _fargs(x, w):
    return (x["xin"], x["vals"], x["ea"], x["edst"], x["emask"], x["nmask"], w)


def _close_row(a, b, dtype, grad=False, name=""):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape, name
    if dtype == "bfloat16":
        rel, err, scale = checks.rel_err(a, b)
        assert rel <= ROW_BF16_TOL, f"{name}: {err:.3g} of {scale:.3g} = {rel:.3g}"
    elif grad:
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-5, err_msg=name)
    else:
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5, err_msg=name)


NF_CASES = {
    "r": (("r", 13, 8),),
    "t": (("t", 14, 14),),
    "r+t": (("r", 14, 9), ("t", 11, 11)),
    "p+r": (("p", 12, 12), ("r", 15, 7)),
}


@pytest.mark.parametrize("case,dtype", [
    ("r", "float32"), ("t", "float32"),
    ("r+t", "float32"), ("r+t", "bfloat16"), ("p+r", "float32"),
    ("p+r", "bfloat16")])
def test_nf_row_kernels_match_pallas(case, dtype):
    """K7 forward (with residual streams) and backward against the JAX
    kernels in interpret mode, on the same inputs and residuals."""
    nf = NF_CASES[case]
    nd = len(nf)
    arrays, params = _row_inputs(nf, seed=len(case) + 3 * nd)
    jx, jw, tx, tw = _both(arrays, params, dtype)
    st = (True, H, NL)
    kw = dict(ndirs=nd, nf=nf)
    want = jrs.fused_row_forward(st, True, *_fargs(jx, jw), emit_res=True,
                                 nsrc=jx["nsrc"], prev_out=jx["prev_out"], **kw)
    got = trs.row_forward_plain(st, *_fargs(tx, tw), emit_res=True,
                                nsrc=tx["nsrc"], prev_out=tx["prev_out"], **kw)
    for name, a, b in zip(("out", "alpha32", "nres"), got, want):
        _close_row(a.float().numpy(), b, dtype, name=name)
    jres = (want[1], want[2])
    tres = (torch.tensor(np.asarray(want[1])),
            torch.tensor(np.asarray(want[2], np.float32)).to(DTYPES[dtype][1]))
    bw = lambda x: (x["g"], x["tg"], x["tdst"], x["tmask"])
    want = jrs.fused_row_backward(st, True, *_fargs(jx, jw), *bw(jx), res=jres,
                                  nsrc=jx["nsrc"], prev_out=jx["prev_out"],
                                  near_g=jx["near_g"], **kw)
    got = trs.row_backward_plain(st, *_fargs(tx, tw), *bw(tx), tres,
                                 nsrc=tx["nsrc"], prev_out=tx["prev_out"],
                                 near_g=tx["near_g"], **kw)
    assert len(got) == 5 and got[4].dtype == tx["g"].dtype
    for name, i in (("dx", 0), ("dvals", 1), ("dea", 2), ("near_g_out", 4)):
        _close_row(got[i].float().numpy(), want[i], dtype, grad=True, name=name)
    assert set(got[3]) == set(want[3])
    if dtype == "float32":
        for k in want[3]:
            _close_row(got[3][k].numpy(), want[3][k], dtype, grad=True,
                       name=f"dw[{k}]")
        return
    # bf16 weight grads: the float32 plain backward on the same (bf16)
    # inputs marks the elements that are zero in exact arithmetic
    fx, fw = checks.to_f32(tx), checks.to_f32(tw)
    nkw = dict(nsrc=fx["nsrc"], prev_out=fx["prev_out"], **kw)
    fres = trs.row_forward_plain(st, *_fargs(fx, fw), emit_res=True, **nkw)[1:]
    truth = trs.row_backward_plain(st, *_fargs(fx, fw), *bw(fx), fres,
                                   near_g=fx["near_g"], **nkw)[3]
    tmax = checks.tree_max(truth)
    for k in want[3]:
        rel, err, scale, noise = checks.grad_err(got[3][k], want[3][k],
                                                 truth[k], tmax)
        tol = WE_BF16_TOL if k.endswith("_we") else ROW_BF16_TOL
        assert rel <= tol, f"dw[{k}]: {err:.3g} of {scale:.3g} = {rel:.3g}"
        assert noise <= NOISE_TOL, f"dw[{k}]: noise {noise:.3g}"


def _full_vals(arrays, nf):
    """Full-width vals [W, L*H] of a near/far row: each block's vals rows
    at its edge offset, an "r" block's near rows routed from prev_out
    (what the state-buffer gather of every edge gives)."""
    rows, vo, eo = [], 0, 0
    for d, (mode, ke, kf) in enumerate(nf):
        kv = kf if mode == "r" else ke
        rows.append(arrays["vals"][vo:vo + kv])
        if mode == "r":
            ns = arrays["nsrc"][eo + kf:eo + ke]
            prev = arrays["prev_out"][d * KN:(d + 1) * KN]
            rows.append(np.where((ns < KN)[:, None],
                                 prev[np.minimum(ns, KN - 1)], 0.0))
        vo, eo = vo + kv, eo + ke
    return np.concatenate(rows).astype(np.float32)


@pytest.mark.parametrize("case", ["plain", "r+t", "p+r"])
def test_recompute_backward_is_bitwise_res_stream(case):
    """K2r: row_backward_plain(res=None) recomputes the forward from
    full-width vals and is bitwise the residual-stream backward fed by
    row_forward_plain on the same inputs (f32 and bf16), as the JAX
    package's own check (tests/test_pallas_kernel.py:101-130); with nf its
    dvals are the far rows and its near_g_out the same."""
    nf = None if case == "plain" else NF_CASES[case]
    blocks = nf or (("p", 12, 12), ("p", 12, 12))
    arrays, params = _row_inputs(blocks, seed=11)
    arrays["full"] = _full_vals(arrays, blocks)
    st = (True, H, NL)
    for dtype in DTYPES:
        _, _, tx, tw = _both(arrays, params, dtype)
        kw = dict(ndirs=2, nf=nf)
        if nf is not None:
            kw["nsrc"] = tx["nsrc"]
        bw = (tx["g"], tx["tg"], tx["tdst"], tx["tmask"])
        fa = _fargs(tx, tw)
        res = trs.row_forward_plain(st, *fa, emit_res=True,
                                    prev_out=tx["prev_out"], **kw)[1:]
        if nf is not None:
            kw["near_g"] = tx["near_g"]
        with_res = trs.row_backward_plain(st, *fa, *bw, res,
                                          prev_out=tx["prev_out"], **kw)
        rec = trs.row_backward_plain(st, fa[0], tx["full"], *fa[2:], *bw, None,
                                     **kw)
        for i, (a, b) in enumerate(zip(rec, with_res)):
            if i == 3:
                assert all(torch.equal(a[k], b[k]) for k in b), dtype
            else:
                assert torch.equal(a, b), (dtype, i)


# ------------------------------------------------------------- model level

def _nf_setup(dtype, seed, nearfar, **cfg_kw):
    """small_setup in a near/far layout, with the config fields cfg_kw
    replaced on both sides and fresh weights for that config."""
    jcfg, tcfg, jparams, tparams, jb, tb = small_setup(dtype, seed=seed,
                                                       nearfar=nearfar)
    assert tb.fwd.edge_nsrc is not None and jb.fwd.edge_nsrc is not None
    if cfg_kw:
        jcfg = dataclasses.replace(jcfg, **cfg_kw)
        tcfg = dataclasses.replace(tcfg, **cfg_kw)
        jparams = jdagnn.dagnn_init(jax.random.PRNGKey(seed), jcfg)
        tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                            device="cpu")
    return jcfg, tcfg, jparams, tparams, jb, tb


def _matches_jax(setup, dtype):
    jcfg, tcfg, jparams, tparams, jb, tb = setup
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


@pytest.mark.parametrize("dtype,nearfar", [
    ("float32", "regions"), ("float32", "tgonly"),
    ("bfloat16", ("regions", "tgonly"))])
def test_merged_nearfar_matches_jax(dtype, nearfar):
    """The merged wavefront on each layout (the mixed one in f32 also in
    test_merged_no_res_stream_matches_jax, whose K2r steps are bitwise the
    residual-stream steps: test_nearfar_layouts_match_plain_layout)."""
    setup = _nf_setup(dtype, 3, nearfar)
    tcfg, tb = setup[1], setup[5]
    assert tdagnn._route(tcfg, tb, None) == ("merged", tdagnn.KERNELS)
    assert tb.fwd.node_ids.shape[0] > 4          # a real multi-row wavefront
    _matches_jax(setup, dtype)


@pytest.mark.parametrize("dtype,nearfar", [
    ("float32", "regions"), ("float32", "tgonly"), ("bfloat16", "regions")])
def test_unidirectional_nearfar_matches_jax(dtype, nearfar):
    """One direction (the forward schedule: ("regions", "tgonly") runs it
    as "regions")."""
    setup = _nf_setup(dtype, 4, nearfar, bidirectional=False)
    assert tdagnn._route(setup[1], setup[5], None) == ("direction",
                                                       tdagnn.KERNELS)
    _matches_jax(setup, dtype)


def test_merged_no_res_stream_matches_jax(monkeypatch):
    """Both packages' _NO_RES_STREAM flags set (DAGNN_NO_RES_STREAM), on a
    ("regions", "tgonly") batch: the merged backward recomputes each row
    (K2r) from full-width values, and a pair plan is not taken."""
    monkeypatch.setattr(jdagnn, "_NO_RES_STREAM", True)
    monkeypatch.setattr(tdagnn, "_NO_RES_STREAM", True)
    setup = _nf_setup("float32", 5, ("regions", "tgonly"))
    _matches_jax(setup, "float32")
    pair = small_setup("float32", seed=0, n_graphs=6, pair=1)[5]
    assert not tdagnn.pair_applicable(setup[1], pair)
    assert tdagnn._route(setup[1], pair, None)[0] == "merged"


def _port_setup(seed, nearfar=0, **cfg_kw):
    """The port's side of small_setup alone: (cfg, params, batch)."""
    graphs = tsynth(seed, 4, mean_nodes=14, vocab=VOCAB, seq_len=SEQ)
    pad = dataclasses.replace(flagship.pad_for(graphs, chunk=8, edge_budget=16),
                              nearfar=nearfar)
    cfg = flagship.flagship_cfg(emb=M_EMB, hidden=HID, vocab=VOCAB, seq=SEQ,
                                compute_dtype="float32", **cfg_kw)
    return cfg, tdagnn.dagnn_init(seed, cfg, device="cpu"), tcollate(graphs, pad)


@pytest.mark.parametrize("bidirectional", [True, False])
def test_nearfar_layouts_match_plain_layout(bidirectional):
    """Within the port, f32: every near/far layout against the plain
    layout of the same graphs (a pure layout change), and with the
    residual streams off (K2r) bitwise the residual-stream step."""
    tcfg, tparams, tb0 = _port_setup(6, bidirectional=bidirectional)
    l0, g0 = port_loss_and_grads(tcfg, tparams, tb0)
    for nearfar in LAYOUTS:
        tb = _port_setup(6, nearfar)[2]
        with torch.no_grad():
            o1 = tdagnn.dagnn_forward(tparams, tcfg, tb).numpy()
            o0 = tdagnn.dagnn_forward(tparams, tcfg, tb0).numpy()
        close(o1, o0, "float32", name=f"{nearfar} logits")
        l1, g1 = port_loss_and_grads(tcfg, tparams, tb)
        close(l1, l0, "float32", name=f"{nearfar} loss")
        for k in g0:
            close(g1[k], g0[k], "float32", grad=True, name=f"{nearfar} {k}")
        if bidirectional:
            tdagnn._NO_RES_STREAM = True
            try:
                l2, g2 = port_loss_and_grads(tcfg, tparams, tb)
            finally:
                tdagnn._NO_RES_STREAM = False
            assert l2 == l1
            assert all(np.array_equal(g2[k], g1[k]) for k in g1)


def test_tgonly_dead_entries_are_never_read(monkeypatch):
    """Under "tgonly" the near edges' rows of the edge-grad buffer are
    written but the transpose schedule never reads them (their grads ride
    near_g): zeroing them in every row's dvals changes no gradient."""
    tcfg, tparams, tb = _port_setup(7, "tgonly")
    nsrc = torch.cat([torch.as_tensor(tb.fwd.edge_nsrc),
                      torch.as_tensor(tb.rev.edge_nsrc)], dim=1)
    kn = tb.fwd.node_ids.shape[1]
    assert bool((nsrc < kn).any())

    def backward(*args, **kw):
        out = trs.row_backward_plain(*args, **kw)
        dvals = out[1].clone()
        dvals[kw["nsrc"] < kn] = 0
        return (out[0], dvals, *out[2:])

    zeroed = tdagnn.StepImpl(trs.row_forward_plain, backward)
    l0, g0 = port_loss_and_grads(tcfg, tparams, tb)
    monkeypatch.setattr(tdagnn, "PLAIN", zeroed)     # an impl the route takes
    l1, g1 = port_loss_and_grads(tcfg, tparams, tb, impl=zeroed)
    assert l1 == l0
    assert all(np.array_equal(g1[k], g0[k]) for k in g0)

"""The port's gnn2.py family (dagnn_tpu_torch/nn/gnn2_models.py) and
pooling baselines (nn/pooling_baselines.py) against the JAX package on
the CPU, and utils/profiling.

Inputs: small random DAGs with 0/1 edge attributes, made from a seed with
numpy and collated by each package (schedules off); weights: the JAX
package's gnn2_init / hpool_init, carried over by
convert.params_from_numpy. One JAX compile (forward and VJP) per model.

Tolerances: logits within 2e-5 of their own max|JAX|; every gradient leaf
within rtol 5e-4 / atol 5e-5, except DiffPool's (below). Top-k and sort
pooling are discontinuous, so first the keep sets and sort orders each
model's forward produced are held equal to JAX's (every topk / lexsort /
argsort, in call order), then the values.

DiffPool: each leaf within 1e-4 of its own max|JAX|. Readings: the port's
float32 leaves lie up to 2.1e-5 of their max from the same step in
float64, JAX's up to 5.0e-6; elementwise rtol 5e-4 / atol 5e-5 fails on
a few small elements of leaves of max 16-24 (the three BatchNorms over the
flattened [G * dense_nodes, c] batch sum in another order). The float64
step holds the port's float32 leaves to the same 1e-4.

Sizes: emb 16, 3 layers, 4 graphs of 5-19 nodes, head 20 x 5, dense_nodes
32, k 10, DGCNN hidden 8.
"""

import dataclasses
import gzip
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dagnn_tpu.dag import batch as jbatch_mod
from dagnn_tpu.nn import encoders as jenc
from dagnn_tpu.nn import gnn2_models as jg
from dagnn_tpu.nn import pooling_baselines as jp
from dagnn_tpu_torch import checks, convert
from dagnn_tpu_torch.dag import batch as tbatch_mod
from dagnn_tpu_torch.nn import encoders as tenc
from dagnn_tpu_torch.nn import gnn2_models as tg
from dagnn_tpu_torch.nn import pooling_baselines as tp
from dagnn_tpu_torch.utils import profiling

torch.set_num_threads(1)


def graph_data(n_graphs=4, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_graphs):
        n = int(rng.integers(5, 20))
        src, dst = [], []
        for a in range(n):
            for b in range(a + 1, n):
                if rng.random() < 0.25:
                    src.append(a), dst.append(b)
        if not src:
            src, dst = [0], [1]
        e = len(src)
        out.append(dict(
            num_nodes=n, edge_src=np.array(src), edge_dst=np.array(dst),
            x=np.stack([rng.integers(0, 9, n), rng.integers(0, 11, n)], 1),
            edge_attr=rng.integers(0, 2, (e, 2)).astype(np.float32),
            extras={"node_depth": rng.integers(0, 5, n)},
            y={"y_arr": rng.integers(0, 20, 5).astype(np.int32)}))
    return out


def collated(mod, data):
    pad = mod.PadConfig(max_nodes=sum(g["num_nodes"] for g in data) + 4,
                        max_edges=sum(len(g["edge_src"]) for g in data) + 6,
                        max_graphs=len(data) + 1, max_levels=1,
                        nodes_per_level=1, edges_per_level=1)
    gs = [mod.DAGGraph(**{k: (dict(v) if isinstance(v, dict) else v)
                          for k, v in g.items()}) for g in data]
    return mod.collate(gs, pad, build_schedules=False)


def spec(mod):
    return mod.EncoderSpec("ast", emb_dim=16, num_nodetypes=9,
                           num_nodeattributes=11, max_depth=20)


HPOOL = ["dgcnn", "unet", "diffpool", "sagpool", "asap"]
GNN2 = ["ggnn_simple", "ggnn", "gat"]


def cfgs(kind):
    """(JAX config, port config, JAX module, port module, init name,
    forward name) of a model kind."""
    if kind in HPOOL:
        kw = dict(kind=kind, emb_dim=16, num_vocab=20, max_seq_len=5, num_rels=2,
                  dropout=0.0, k=10, hidden=8, num_layers=3, max_nodes=24,
                  asap_hidden=16, dense_nodes=32)
        return (jp.HPoolConfig(encoder=spec(jenc), **kw),
                tp.HPoolConfig(encoder=spec(tenc), **kw), jp, tp,
                "hpool_init", "hpool_forward")
    kw = dict(kind=kind, emb_dim=16, num_vocab=20, max_seq_len=5, num_layers=3,
              heads=2, layer_timesteps=(2,), ggnn_timesteps=(1, 2, 1),
              ggnn_residuals=((), (0,), (0, 1)))
    return (jg.GNN2Config(encoder=spec(jenc), **kw),
            tg.GNN2Config(encoder=spec(tenc), **kw), jg, tg,
            "gnn2_init", "gnn2_forward")


class Recorder:
    """Every keep mask (topk_mask, _dense_topk) and sort order (lexsort /
    argsort; the port's _stable_order) a forward computes, in call order."""

    def __init__(self, monkeypatch, jax_side):
        self.out = []
        if jax_side:
            for name in ("topk_mask", "_dense_topk"):
                monkeypatch.setattr(jp, name, self.wrap(getattr(jp, name), "keep"))
            for name in ("lexsort", "argsort"):
                monkeypatch.setattr(jnp, name, self.wrap(getattr(jnp, name), "order"))
        else:
            for name in ("topk_mask", "_dense_topk"):
                monkeypatch.setattr(tp, name, self.wrap(getattr(tp, name), "keep"))
            monkeypatch.setattr(tp, "_stable_order", self.wrap(tp._stable_order, "order"))

    def wrap(self, fn, what):
        def rec(*a, **k):
            r = fn(*a, **k)
            self.out.append((what, r))
            return r
        return rec


_JAX = {}


def jax_reference(kind, monkeypatch):
    """JAX's logits, flat gradient of sum(logits * ct) and the keep sets and
    sort orders of its forward; one compile per kind."""
    if kind not in _JAX:
        jc, _, jm, _, init, fwd = cfgs(kind)
        params = getattr(jm, init)(jax.random.PRNGKey(2), jc)
        b = jax.tree.map(jnp.asarray, collated(jbatch_mod, graph_data()))
        with monkeypatch.context() as m:
            rec = Recorder(m, jax_side=True)

            def f(p, b, ct):
                def fw(q):
                    rec.out.clear()
                    return getattr(jm, fwd)(q, jc, b), [r for _, r in rec.out]
                out, vjp, recs = jax.vjp(fw, p, has_aux=True)
                return out, vjp(ct)[0], recs

            shape = jax.eval_shape(lambda p: getattr(jm, fwd)(p, jc, b), params).shape
            ct = np.random.default_rng(5).normal(size=shape).astype(np.float32)
            out, grads, recs = jax.jit(f)(params, b, jnp.asarray(ct))
            kinds = [w for w, _ in rec.out]
        _JAX[kind] = (jax.tree.map(np.asarray, params), np.asarray(out), ct,
                      convert.flatten_tree(jax.tree.map(np.asarray, grads)),
                      list(zip(kinds, [np.asarray(r) for r in recs])))
    return _JAX[kind]


def port_step(tc, fwd, params, tb, ct, dtype=torch.float32):
    p = {k: v.to(dtype).clone().requires_grad_(True) for k, v in params.items()}
    out = fwd(p, tc, tb)
    (out * torch.as_tensor(ct).to(dtype)).sum().backward()
    return out.detach(), {k: torch.zeros_like(v) if v.grad is None else v.grad
                          for k, v in p.items()}


@pytest.mark.parametrize("kind", GNN2 + HPOOL)
def test_matches_jax(kind, monkeypatch):
    jparams, jout, ct, jgrads, jrecs = jax_reference(kind, monkeypatch)
    _, tc, _, tm, init, fwd = cfgs(kind)
    params = convert.params_from_numpy(jparams, "cpu")
    fresh = getattr(tm, init)(0, tc, device="cpu")
    assert {k: v.shape for k, v in fresh.items()} == {k: v.shape for k, v in params.items()}
    tb = convert.batch_to_torch(collated(tbatch_mod, graph_data()), "cpu")
    rec = Recorder(monkeypatch, jax_side=False)
    out, grads = port_step(tc, getattr(tm, fwd), params, tb, ct)
    trecs = [(w, r.numpy()) for w, r in rec.out]
    # the discontinuous parts first: the same keep sets and sort orders
    assert [w for w, _ in trecs] == [w for w, _ in jrecs]
    for i, ((w, t), (_, j)) in enumerate(zip(trecs, jrecs)):
        assert t.shape == j.shape, (i, w)
        assert np.array_equal(t, j), f"{kind}: {w} {i} differs at {np.argwhere(t != j)[:4]}"
    if kind == "sagpool":
        assert [w for w, _ in trecs].count("keep") == 3
    rel = checks.rel_err(out, jout)[0]
    assert rel <= 2e-5, f"{kind}: logits {rel:.3g} of max|JAX|"
    assert set(grads) == set(jgrads)
    if kind != "diffpool":
        for k, g in jgrads.items():
            np.testing.assert_allclose(grads[k].numpy(), g, rtol=5e-4, atol=5e-5,
                                       err_msg=f"{kind}: grad {k}")
        return
    _, g64 = port_step(tc, getattr(tm, fwd), params, tb, ct, torch.float64)
    for k, g in jgrads.items():
        assert checks.rel_err(grads[k], g)[0] <= 1e-4, f"diffpool: grad {k}"
        assert checks.rel_err(grads[k], g64[k])[0] <= 1e-4, f"diffpool: grad {k} (f64)"


@pytest.mark.parametrize("kind", GNN2 + HPOOL)
def test_pad_rows_do_not_leak(kind):
    """Garbage in the pad node rows (ids, depths), the pad edges' attributes
    and the garbage edge row leaves every real output as it was."""
    _, tc, _, tm, init, fwd = cfgs(kind)
    params = getattr(tm, init)(1, tc, device="cpu")
    host = collated(tbatch_mod, graph_data(seed=3))
    n, e = int(host.n_node), int(host.n_edge)
    rng = np.random.default_rng(9)
    x, ea, depth = host.x.copy(), host.edge_attr.copy(), host.extras["node_depth"].copy()
    x[n:] = np.stack([rng.integers(0, 9, len(x) - n), rng.integers(0, 11, len(x) - n)], 1)
    depth[n:] = rng.integers(0, 30, len(depth) - n)
    ea[e:] = rng.normal(size=ea[e:].shape) * 1e3
    noisy = host._replace(x=x, edge_attr=ea, extras={"node_depth": depth})
    f = lambda b: getattr(tm, fwd)(params, tc, convert.batch_to_torch(b, "cpu"))
    g = int(host.n_graph)
    with torch.no_grad():
        assert torch.equal(f(host)[:g], f(noisy)[:g])


def test_topk_and_sort_orders_with_ties_match_jax():
    """The stable orders on constructed ties (repeated scores, +0.0 and
    -0.0, dropped rows): ranks, top-k keep masks, the sort pool's rows and
    the dense top-k, bit for bit against JAX's."""
    gid = np.array([0, 0, 0, 0, 0, 1, 1, 1, 2, 2, 2, 2, 3], np.int32)   # 3 = pad
    nmask = gid < 3
    score = np.array([0.5, -0.0, 0.5, 0.0, 0.25, 1.0, 1.0, -2.0,
                      0.0, -0.0, 0.0, 3.0, 9.0], np.float32)
    keep = nmask.copy()
    keep[2] = False
    h = np.arange(13 * 3, dtype=np.float32).reshape(13, 3)
    J = lambda a: jnp.asarray(a)
    T = lambda a: torch.as_tensor(a)
    for ratio in (0.5, 0.7):
        jr, jo = jp._ranks_by_score(J(score), J(gid), 3, J(keep))
        tr, to = tp._ranks_by_score(T(score), T(gid).long(), 3, T(keep))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        np.testing.assert_array_equal(
            tp.topk_mask(T(score), T(gid).long(), 3, ratio, T(keep)).numpy(),
            np.asarray(jp.topk_mask(J(score), J(gid), 3, ratio, J(keep))))
    np.testing.assert_array_equal(
        tp._sort_pool(T(h), T(score), T(gid).long(), 3, T(nmask), 4).numpy(),
        np.asarray(jp._sort_pool(J(h), J(score), J(gid), 3, J(nmask), 4)))
    dscore = np.array([[0.0, -0.0, 1.0, 1.0, 0.0, 5.0],
                       [-1.0, -1.0, -0.0, 0.0, 2.0, 2.0]], np.float32)
    dmask = np.array([[1, 1, 1, 1, 1, 0], [1, 1, 1, 1, 1, 1]], bool)
    for ratio in (0.5, 0.8):
        np.testing.assert_array_equal(
            tp._dense_topk(T(dscore), T(dmask), ratio).numpy(),
            np.asarray(jp._dense_topk(J(dscore), J(dmask), ratio)))


def test_asap_master_query_tie_gradient():
    """ASAP's master query is a running maximum over the sources in order,
    whose gradient halves at each tie as jnp.maximum's does: three tied
    sources of one destination take 1/4, 1/4, 1/2 (an even split, amax's,
    would give 1/3 each). Then on inputs full of ties (ReLU zeros, repeated
    rows) against JAX's scan, the gradient within 1e-6 (sums of a few
    powers-of-two multiples), and the whole dense ASAP pool against JAX's,
    forward and gradient."""
    h = torch.full((1, 4, 1), 2.0, requires_grad=True)
    E = torch.zeros((1, 4, 4), dtype=torch.bool)
    E[0, :3, 0] = True                           # sources 0, 1, 2 into node 0
    xq = tp.master_query(h, E)
    assert xq[0, 0, 0].item() == 2.0 and xq[0, 1:].abs().sum().item() == 0.0
    xq[0, 0, 0].backward()
    assert h.grad[0, :, 0].tolist() == [0.25, 0.25, 0.5, 0.0]

    # on tie-rich inputs, against the scan of the JAX package's
    # _asap_pool_dense (pooling_baselines.py:611-621), verbatim
    rng = np.random.default_rng(3)
    G, n, d = 3, 10, 6
    hv = np.maximum(rng.normal(size=(G, n, d)), 0).astype(np.float32)
    hv[:, 4] = hv[:, 1]
    Ev = (rng.random((G, n, n)) < 0.4) | np.eye(n, dtype=bool)[None]
    Ev[2, :, 7] = False                          # a destination without sources
    ct = rng.normal(size=(G, n, d)).astype(np.float32)

    def jscan(h):
        neg = jnp.finfo(h.dtype).min
        E = jnp.asarray(Ev)

        def _mm_body(carry, ji):
            Ej, hj = ji
            cand = jnp.where(Ej[..., None], hj[:, None, :], neg)
            return jnp.maximum(carry, cand), None

        xq0 = jnp.full((G, n, d), neg, h.dtype)
        xq, _ = jax.lax.scan(_mm_body, xq0, (E.transpose(1, 0, 2), h.transpose(1, 0, 2)))
        return (jnp.where(E.any(1)[..., None], xq, 0.0) * ct).sum()

    jh = jax.grad(jscan)(jnp.asarray(hv))
    th = torch.tensor(hv, requires_grad=True)
    (tp.master_query(th, torch.tensor(Ev)) * torch.tensor(ct)).sum().backward()
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jh), rtol=1e-6, atol=1e-7)

    G, n, d = 2, 12, 5
    rng = np.random.default_rng(4)
    hv = np.maximum(rng.normal(size=(G, n, d)), 0).astype(np.float32)
    hv[:, 5] = hv[:, 2]                          # whole rows tied
    hv[:, 7, :2] = hv[:, 3, :2]
    adj = (rng.random((G, n, n)) < 0.3).astype(np.float32)
    keep = np.ones((G, n), bool)
    keep[1, 9:] = False
    cfg_j, cfg_t = cfgs("asap")[:2]
    cfg_j = dataclasses.replace(cfg_j, asap_hidden=d, dense_nodes=n)
    cfg_t = dataclasses.replace(cfg_t, asap_hidden=d, dense_nodes=n)
    pp = jp.hpool_init(jax.random.PRNGKey(7), cfg_j)["pools"][0]
    ct = [rng.normal(size=s).astype(np.float32) for s in ((G, n, d), (G, n, n))]

    def jfun(pp, h):
        h2, a2, _ = jp._asap_pool_dense(pp, cfg_j, h, jnp.asarray(adj), jnp.asarray(keep))
        return (h2 * ct[0]).sum() + (a2 * ct[1]).sum()

    jl, (jgp, jgh) = jax.jit(jax.value_and_grad(jfun, argnums=(0, 1)))(
        pp, jnp.asarray(hv))
    tpp = convert.params_from_numpy(jax.tree.map(np.asarray, pp), "cpu")
    tpp = {k: v.requires_grad_(True) for k, v in tpp.items()}
    th = torch.tensor(hv, requires_grad=True)
    h2, a2, k2 = tp._asap_pool_dense(convert.unflatten_tree(tpp), cfg_t, th,
                                     torch.tensor(adj), torch.tensor(keep))
    tl = (h2 * torch.tensor(ct[0])).sum() + (a2 * torch.tensor(ct[1])).sum()
    tl.backward()
    assert abs(tl.item() - float(jl)) <= 2e-5 * abs(float(jl))
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgh), rtol=5e-4, atol=5e-5)
    for k, g in convert.flatten_tree(jax.tree.map(np.asarray, jgp)).items():
        np.testing.assert_allclose(tpp[k].grad.numpy(), g, rtol=5e-4, atol=5e-5,
                                   err_msg=k)


def test_profiling_summarizes_a_cpu_step(tmp_path):
    """profile_step on a small SAGPool train pass on the CPU: the trace has
    no device events, and its host operators rank by summed time."""
    _, tc, _, tm, init, fwd = cfgs("sagpool")
    params = {k: v.requires_grad_(True)
              for k, v in getattr(tm, init)(0, tc, device="cpu").items()}
    tb = convert.batch_to_torch(collated(tbatch_mod, graph_data()), "cpu")
    step = lambda: getattr(tm, fwd)(params, tc, tb).sum().backward()
    step()
    path = profiling.profile_step(step, iters=2, logdir=str(tmp_path))
    assert profiling.summarize_trace(path) == []
    rows = profiling.summarize_trace(path, top=1000, iters=2, categories=("cpu_op",))
    names = [r["name"] for r in rows]
    assert "aten::segment_reduce" in names
    totals = [r["total_us"] for r in rows]
    assert totals == sorted(totals, reverse=True) and totals[0] > 0
    assert all(r["category"] == "cpu_op" for r in rows)


def test_summarize_trace_ranks_device_kernels(tmp_path, capsys):
    """summarize_trace on a constructed chrome trace: device events only,
    keyed by the kernel's short name, divided by iters; also gzipped and
    through the CLI."""
    events = [
        {"ph": "X", "cat": "kernel", "name": "void ns::k1<float, 4>(float*, int)",
         "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "void ns::k1<float, 8>(float*, int)",
         "dur": 14.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)",
         "dur": 5.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 999.0},
        {"ph": "i", "cat": "kernel", "name": "instant", "dur": 50.0},
    ]
    path = tmp_path / "x.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)
    rows = profiling.summarize_trace(str(path), top=10, iters=2)
    assert [r["name"] for r in rows] == ["ns::k1", "Memcpy HtoD "]
    assert rows[0]["total_us"] == 12.0 and rows[0]["count"] == 1
    assert rows[0]["mean_us"] == 12.0 and rows[0]["category"] == "kernel"
    assert rows[0]["example"] == "void ns::k1<float, 4>(float*, int)"
    profiling.main([str(path), "--top", "1"])
    out = capsys.readouterr().out
    assert "ns::k1" in out and "Memcpy" not in out

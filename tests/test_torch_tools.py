"""The port's tools (dagnn_tpu_torch/scripts/) against the JAX package's
scripts/ on the CPU.

- ep_decompose: the sharded-state plan statistics for D = 1, 2, 4, 8 equal
  those of the JAX planners (dagnn_tpu.parallel.edge_partition) on the
  same graphs.
- rehearse_preprocess at 300 graphs: the fixture's files hold the bytes the
  JAX script's generator writes for the same seed, decompressed (a gzip
  header holds its write time); the vocab, the level arrays and the
  loader's bucket equal the JAX package's on the same raw tree.
- bn_ceiling: its features equal the JAX script's exactly on the same BN
  graphs (each package's synthetic rows, scores equal too); one fit at M
  20 on the columns that vary gives JAX's test RMSE within
  tests/test_torch_sparse_gp.py's tolerance for the predictive mean (1e-4
  of max|ref|).
- the microbenches: their input builders give the JAX scripts' shapes (the
  row builder the same values, one seeded stream in one order, with the
  weights at 1/sqrt(fan-in)), and the row, pair and merged calls run
  through the plain versions at H 16.

The JAX scripts are loaded by file path and left as they are.
"""

import dataclasses
import gzip
import importlib.util
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as sps
import torch

import __graft_entry__ as ge
from dagnn_tpu.dag.batch import collate as jcollate
from dagnn_tpu_torch.data.synthetic import synthetic_ast_batch
from dagnn_tpu_torch.scripts import (bn_ceiling, ep_decompose, microbench_pair_kernel,
                                     microbench_row_kernel, rehearse_preprocess)

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]


def _script(name):
    """scripts/<name>.py of the JAX package, loaded by path."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  REPO / "scripts" / f"{name}.py")
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


def test_ep_plan_stats_match_jax_planners():
    from dagnn_tpu.parallel.edge_partition import partition_schedule_sharded
    graphs = synthetic_ast_batch(0, ep_decompose.GRAPHS, mean_nodes=ep_decompose.MEAN_NODES)
    got = ep_decompose.plan_stats(graphs)
    assert sorted(got) == [1, 2, 4, 8]
    for d in (1, 2, 4, 8):     # scripts/ep_decompose.py:64-78
        chunk = max(64, 64 * d)
        pad1 = dataclasses.replace(ge._pad_for(graphs, n_shards=1, chunk=chunk),
                                   nodes_per_level=chunk)
        eps_f, st_f = partition_schedule_sharded(jcollate(graphs, pad1).fwd, d)
        want = dict(rows=int(st_f.rows), own_w=int(st_f.own_w), halo=int(st_f.halo),
                    ke_per_dev=int(eps_f.e_dst.shape[-1]),
                    tgrad_per_dev=int(eps_f.t_mask.shape[-1]),
                    boundary_w=int(eps_f.x_send_col.shape[-1]),
                    deferred_w=int(eps_f.d_send_col.shape[-1]),
                    urgent_w=int(eps_f.u_send_col.shape[-1]))
        assert got[d] == want, d


def test_ep_decompose_categories_cover_every_event():
    ev = lambda name, cat="kernel": {"name": name, "cat": cat}
    want = {
        "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)":
            "collective",
        "void sa_fwd_kernel<float>(int)": "k6_k5",
        "void seg_merge_kernel<__nv_bfloat16, true>(int)": "k6_k5",
        "void gemm_nn_kernel<true>(int)": "k1_k2",
        "void at::native::index_elementwise_kernel<128, 4>(long)": "gather_scatter",
        "void at::native::(anonymous namespace)::indexing_backward_kernel<float>(long)":
            "gather_scatter",
        "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64": "gemm",
        "void at::native::vectorized_elementwise_kernel<4, at::native::AddFunctor>(int)":
            "elementwise",
        "void at::native::reduce_kernel<512, 1>(float)": "reduce",
        "Memcpy DtoH (Device -> Pageable)": "copy",
        "void at::native::(anonymous namespace)::CatArrayBatchedCopy<int>(int)": "other",
    }
    for name, cat in want.items():
        c = "gpu_memcpy" if name.startswith("Memcpy") else "kernel"
        assert ep_decompose.category(ev(name, c)) == cat, name


def _gz_text(path):
    with gzip.open(path, "rb") as f:
        return f.read()


def test_rehearse_preprocess_matches_jax(tmp_path):
    jscript = _script("rehearse_preprocess")
    root_t, root_j = tmp_path / "t", tmp_path / "j"
    res = rehearse_preprocess.main(["--graphs", "300", "--root", str(root_t),
                                    "--keep-root", "--out", str(tmp_path / "R.md")])
    jscript.gen_raw(str(root_j), 300)
    files = sorted(p.relative_to(root_j) for p in root_j.rglob("*.csv.gz"))
    assert len(files) == 11
    for f in files:
        assert _gz_text(root_t / f) == _gz_text(root_j / f), f
    # the JAX package's pipeline on its own tree
    from dagnn_tpu.dag.native import native_topo_levels_batch
    from dagnn_tpu.data import code2
    from dagnn_tpu.data.code2_dataset import Code2Dataset
    from dagnn_tpu.data.dataloader import DAGLoader
    ds = Code2Dataset(str(root_j))
    vocab2idx, _ = code2.get_vocab_mapping([ds[i]["y"] for i in ds.split_idx["train"]],
                                           5000)
    assert res["vocab2idx"] == vocab2idx
    graphs = [code2.raw_to_dag(ds[i], vocab2idx, 5) for i in range(len(ds))]
    n_off = np.concatenate([[0], np.cumsum([g.num_nodes for g in graphs])])
    e_off = np.concatenate([[0], np.cumsum([g.num_edges for g in graphs])])
    src = np.concatenate([g.edge_src for g in graphs])
    dst = np.concatenate([g.edge_dst for g in graphs])
    for got, want in zip(res["levels"], (native_topo_levels_batch(src, dst, n_off, e_off),
                                         native_topo_levels_batch(dst, src, n_off, e_off))):
        np.testing.assert_array_equal(got, want)
    jl = DAGLoader([graphs[i] for i in ds.split_idx["train"]], 160, shuffle=True,
                   seed=0, chunk_size=256)
    assert dataclasses.astuple(res["bucket"]) == dataclasses.astuple(
        jl._ensure_pad(jl._epoch_batches()))
    text = (tmp_path / "R.md").read_text()
    assert len([ln for ln in text.splitlines() if ln.startswith("| ")]) == 8
    assert "loader bucket" in text and (root_t / "ogbg_code2").is_dir()


def test_bn_ceiling_features_and_fit_match_jax():
    from dagnn_tpu.data import na as jna
    from dagnn_tpu.vae import sparse_gp as J
    from dagnn_tpu_torch.data import na
    jscript = _script("bn_ceiling")
    tr, te, _ = na.synthetic_bn_corpus(120)
    jg = []
    for r in jna.synthetic_bn_rows(120):
        row, y = r.rsplit(", ", 1)      # "[[t, flags...], ...], y"
        g = jna.parse_bn_row(row)
        g.y = float(y)
        jg.append(g)
    assert [g.y for g in tr + te] == [g.y for g in jg]
    X_t = bn_ceiling.features(tr + te)
    X_j = jscript.features(jg)
    assert X_t.dtype == X_j.dtype == np.float64 and np.array_equal(X_t, X_j)
    assert X_t.shape == (120, 200)
    # one fit at M 20, 5 iterations: scripts/bn_ceiling.py:58-75's protocol
    # on the columns that vary over the train split. A constant column's
    # inducing coordinates and length scale have a gradient that is zero
    # in exact arithmetic; Adam turns its float32 rounding noise into full
    # lr steps, in either package, so two fits part there after one step.
    Xtr, Xte = bn_ceiling.features(tr), bn_ceiling.features(te)
    live = Xtr.std(0) > 0
    Xtr, Xte = Xtr[:, live], Xte[:, live]
    ytr = -np.array([g.y for g in tr]).reshape(-1, 1)
    yte = -np.array([g.y for g in te]).reshape(-1, 1)
    m, s = float(np.mean(ytr)), float(np.std(ytr))
    ytr, yte = (ytr - m) / s, (yte - m) / s
    got = bn_ceiling.fit_scores(Xtr, ytr, Xte, yte, 0, "cpu", m=20, iters=5)
    gp = J.fit_sparse_gp(Xtr, ytr, M=20, iters=5, lr=bn_ceiling.LR, seed=0)
    pred, var = (np.asarray(a, np.float64) for a in J.predict(gp, jnp.asarray(Xte)))
    rmse = float(np.sqrt(np.mean((pred - yte.reshape(-1)) ** 2)))
    assert abs(got["rmse"] - rmse) <= 1e-4 * np.abs(pred).max()
    assert got["pearson_r"] == pytest.approx(
        sps.pearsonr(pred, yte.reshape(-1))[0], abs=1e-3)
    assert np.isfinite(got["ll"]) and not got["refit_f64"]


def test_row_microbench_inputs_are_the_jax_scripts():
    jscript = _script("microbench_row_kernel")
    kn, ke, kt, r, nl, nd = (microbench_row_kernel.KN, microbench_row_kernel.KE,
                             microbench_row_kernel.KT, microbench_row_kernel.R,
                             microbench_row_kernel.NL, microbench_row_kernel.NDIRS)
    assert (kn, ke, kt, r, nl, nd, microbench_row_kernel.ROWS) == (256, 512, 576, 8, 2, 2, 82)
    assert [h for _, h in microbench_row_kernel.WIDTHS] == [300, 384, 256]
    st, d, w = microbench_row_kernel.make_inputs(16, 16)
    (jst, xin, vals, ea, edst, emask, nmask, jw, g, tg, tdst, tmask) = \
        jscript.make_inputs(16, 16, kn, ke, kt, r, nl, nd, jnp.bfloat16)
    assert st == jst
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))
    for k, a in dict(xin=xin, vals=vals, ea=ea, edst=edst, emask=emask, nmask=nmask,
                     g=g, tg=tg, tdst=tdst, tmask=tmask).items():
        assert tuple(d[k].shape) == a.shape, k
        np.testing.assert_array_equal(d[k].float().numpy(), f32(a), err_msg=k)
    # the weights: the JAX script's draws at 1/sqrt(fan-in) (compared in f32)
    _, _, w32 = microbench_row_kernel.make_inputs(16, 16, dtype=torch.float32)
    jw32 = jscript.make_inputs(16, 16, kn, ke, kt, r, nl, nd, jnp.float32)[7]
    assert sorted(w) == sorted(jw) == sorted(w32)
    fan = lambda k: r if k.endswith(("_we", "_be")) else (32 if k.startswith("a") else 16)
    for k in jw:
        assert tuple(w[k].shape) == jw[k].shape, k
        np.testing.assert_allclose(w32[k].numpy(), f32(jw32[k]) / np.sqrt(fan(k)),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    fwd, bwd = microbench_row_kernel.calls(st, d, w, plain=True)
    out, a32, nres = fwd()
    assert out.shape == (nd * kn, nl * 16) and torch.isfinite(out.float()).all()
    dx, dvals, dea, dw = bwd()
    assert dx.shape == d["xin"].shape and dvals.shape == d["vals"].shape
    assert all(torch.isfinite(v).all() for v in dw.values())
    wf, _ = microbench_row_kernel.calls(st, d, w)      # the wrapper, CPU tensors
    assert torch.equal(wf()[0], out)


def test_pair_microbench_inputs_have_the_jax_scripts_shapes():
    from dagnn_tpu.nn.dagnn import _build_streams_merged, _build_streams_pair, dagnn_init
    from dagnn_tpu.nn.encoders import encode
    from dagnn_tpu_torch import flagship
    graphs = synthetic_ast_batch(1, 14, mean_nodes=24)
    got = microbench_pair_kernel.make_inputs(
        2, "cpu", graphs=graphs, cfg=flagship.flagship_cfg(emb=16, hidden=16))
    # scripts/microbench_pair_kernel.py:51-112 at emb/hidden 16
    cfg = dataclasses.replace(ge._flagship_cfg(emb=16, hidden=16), compute_dtype="bfloat16")
    pad = ge._pad_for(graphs)
    padp = dataclasses.replace(pad, pair=2, max_levels=pad.max_levels + pad.max_levels % 2)
    b = jcollate(graphs, padp)
    params = dagnn_init(jax.random.PRNGKey(0), cfg)
    x = encode(params["encoder"], cfg.encoder, b.x, b.extras.get("node_depth"))
    x = jnp.where(jnp.asarray(b.node_mask)[:, None], x, 0)
    _, fxs, ixs, (P, kn, blocks, U) = _build_streams_pair(params, cfg, x, b.edge_attr, b)
    i = P // 2
    lh = 2 * 16
    want = {"xin": fxs["x"][i].shape, "vals": (U, lh), "ea": fxs["ea"][i].shape,
            "g": (4 * kn, lh), "tg": (ixs["teslot"].shape[1], lh),
            **{k: ixs[k][i].shape for k in ("edst", "emask", "nmask", "nsrc", "tdst",
                                            "tmask")}}
    st, d, w, tblocks, tP, ti = got["pair"]
    assert (tP, ti, tblocks) == (P, i, blocks)
    assert {k: tuple(v.shape) for k, v in d.items()} == want
    bm = jcollate(graphs, pad)
    _, fxm, ixm, (L, kn2, _) = _build_streams_merged(params, cfg, x, bm.edge_attr,
                                                     bm.fwd, bm.rev)
    r = L // 2
    want_m = {"xin": fxm["x"][r].shape, "ea": fxm["ea"][r].shape,
              "vals": (ixm["eslot"].shape[1], lh), "g": (kn2, lh),
              "tg": (ixm["teslot"].shape[1], lh),
              **{k: ixm[k][r].shape for k in ("edst", "emask", "nmask", "tdst", "tmask")}}
    stm, dm, wm, tL, tr = got["merged"]
    assert (tL, tr) == (L, r)
    assert {k: tuple(v.shape) for k, v in dm.items()} == want_m
    # both through the plain versions
    fwd, bwd = microbench_pair_kernel.pair_calls(st, d, w, tblocks, plain=True)
    assert torch.isfinite(fwd()[0].float()).all()
    assert all(torch.isfinite(v).all() for v in bwd()[3].values())
    fwd, bwd = microbench_row_kernel.calls(stm, dm, wm, plain=True)
    assert torch.isfinite(fwd()[0].float()).all()
    assert all(torch.isfinite(v).all() for v in bwd()[3].values())


def test_tools_need_a_card_unless_given_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    for main in (microbench_row_kernel.main, microbench_pair_kernel.main,
                 lambda a: bn_ceiling.main(a + ["--seeds", "0", "--out", os.devnull])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([])

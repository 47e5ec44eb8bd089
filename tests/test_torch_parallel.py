"""The port's data-parallel layer (dagnn_tpu_torch/parallel/dp.py, mesh.py,
comm.py) against the JAX package's, on gloo ranks on the CPU.

* split_by_nodes, collate_sharded (stack_batches), flagship.pad_for's
  n_shards headroom and the sharded loader (DAGLoader(n_shards=2)) bit
  for bit equal to the JAX package's (__graft_entry__._pad_for,
  parallel/dp.py, data/dataloader.py).
* The DP step at 2 ranks against JAX's make_dp_train_step on the virtual
  CPU mesh, the shrunk flagship in float32 from the same weights: loss
  within 2e-5, the raw averaged gradients within rtol 5e-4 / atol 5e-5
  (JAX's read through an optimizer that returns them as its state), and
  both ranks holding the same gradients and parameters after two Adam
  steps. The mesh's axis groups (ep consecutive, dp strided) and the
  collectives' transposes.
* cli.bench_scaling --devices 2 --cpu at a small size: its JSON line,
  with no scaling efficiency (the ranks share one device).
* The dry run, `cli.dryrun --ranks 4 --cpu`: the JAX dry run's three
  checks (a finite DP loss, the scheme-1 states within 1e-3, the (dp 2,
  ep 2) loss within 1e-3 of the groups' mean).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as ge
from dagnn_tpu.data import dataloader as jloader
from dagnn_tpu.data.synthetic import synthetic_ast_batch as jsynth
from dagnn_tpu.nn.dagnn import dagnn_forward as jforward, dagnn_init as jinit
from dagnn_tpu.parallel import dp as jdp
from dagnn_tpu.parallel.mesh import make_mesh as jmesh
from dagnn_tpu.train.losses import tok_loss as jtok_loss
from dagnn_tpu_torch import convert, flagship
from dagnn_tpu_torch.cli import bench_scaling, dryrun
from dagnn_tpu_torch.data import dataloader as tloader
from dagnn_tpu_torch.data.synthetic import synthetic_ast_batch as tsynth
from dagnn_tpu_torch.parallel import comm
from dagnn_tpu_torch.parallel import dp as tdp
from dagnn_tpu_torch.parallel import jobs
from dagnn_tpu_torch.parallel.mesh import init_distributed, spawn
from test_torch_dag import _same
from test_torch_dagnn import EMB, HID, SEQ, VOCAB

torch.set_num_threads(1)

KW = dict(mean_nodes=14, vocab=VOCAB, seq_len=SEQ)


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
def test_split_by_nodes_matches_jax(n_shards):
    jg, tg = jsynth(2, 13, **KW), tsynth(2, 13, **KW)
    js, ts = jdp.split_by_nodes(jg, n_shards), tdp.split_by_nodes(tg, n_shards)
    assert [[g.num_nodes for g in s] for s in ts] == \
        [[g.num_nodes for g in s] for s in js]
    for a, b in zip(js, ts):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y.edge_src, x.edge_src)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_pad_for_and_collate_sharded_match_jax(n_shards):
    jg, tg = jsynth(3, 16, **KW), tsynth(3, 16, **KW)
    jpad, tpad = ge._pad_for(jg, n_shards=n_shards), flagship.pad_for(tg, n_shards=n_shards)
    assert dataclasses.astuple(tpad) == dataclasses.astuple(jpad)
    jb = jdp.collate_sharded(jg, n_shards, jpad)
    tb = tdp.collate_sharded(tg, n_shards, tpad)
    _same(jax.tree.map(np.asarray, jb), tb, "stacked")
    for i in range(n_shards):
        _same(jax.tree.map(lambda a: np.asarray(a[i]), jb), tdp.shard_of(tb, i),
              f"shard {i}")


@pytest.mark.parametrize("n_shards", [2, 3])
def test_sharded_loader_matches_jax(n_shards):
    jg, tg = jsynth(7, 40, **KW), tsynth(7, 40, **KW)
    mk = lambda mod, gs: mod.DAGLoader(gs, 8, shuffle=True, seed=1, chunk_size=32,
                                       n_shards=n_shards, prefetch=2)
    jl, tl = mk(jloader, jg), mk(tloader, tg)
    for epoch in range(2):
        jb, tb = list(jl), list(tl)
        assert dataclasses.astuple(jl._pad) == dataclasses.astuple(tl._pad), epoch
        assert all(b.graph_mask.shape[0] == n_shards for b in tb)
        _same(jb, tb, f"epoch {epoch}")


def _dp_setup():
    """The shrunk flagship in float32, 8 graphs split over 2 shards with
    pad_for's headroom; JAX on its dense segment path (the same function),
    the port on its merged wavefront."""
    jg, tg = jsynth(5, 8, **KW), tsynth(5, 8, **KW)
    jcfg = dataclasses.replace(ge._flagship_cfg(emb=EMB, hidden=HID), num_vocab=VOCAB,
                               max_seq_len=SEQ, compute_dtype="float32",
                               segment_impl="dense")
    tcfg = flagship.flagship_cfg(emb=EMB, hidden=HID, vocab=VOCAB, seq=SEQ,
                                 compute_dtype="float32")
    jparams = jinit(jax.random.PRNGKey(1), jcfg)
    jb = jdp.collate_sharded(jg, 2, ge._pad_for(jg, n_shards=2))
    tb = tdp.collate_sharded(tg, 2, flagship.pad_for(tg, n_shards=2))
    return jcfg, tcfg, jparams, jb, tb


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    _, tcfg, jparams, _, tb = _dp_setup()
    pnp = convert.flatten_tree(jax.tree.map(np.asarray, jparams))
    return spawn(jobs.dp_job, 2, "gloo", "cpu",
                 store_dir=str(tmp_path_factory.mktemp("store")), timeout=240,
                 args=(tcfg, pnp, tb, 2))


def test_dp_step_matches_jax(dp_runs):
    jcfg, _, jparams, jb, _ = _dp_setup()

    def loss_fn(p, b, rng):
        return jtok_loss(jforward(p, jcfg, b), b.y["y_arr"], b.graph_mask)

    capture = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))
    step, shard = jdp.make_dp_train_step(loss_fn, capture, jmesh(2, ("dp",)),
                                         donate=False)
    _, grads, loss = step(jparams, capture.init(jparams), shard(jb),
                          jax.random.PRNGKey(0))
    want = convert.flatten_tree(jax.tree.map(np.asarray, grads))
    got = dp_runs[0]
    np.testing.assert_allclose(got["loss"], float(loss), rtol=2e-5, atol=2e-5)
    assert set(got["grads"]) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got["grads"][k], v, rtol=5e-4, atol=5e-5, err_msg=k)
    # the mean of the per-shard mean losses (not the batch mean)
    per_shard = [float(loss_fn(jparams, jax.tree.map(lambda a: a[i], jb), None))
                 for i in range(2)]
    np.testing.assert_allclose(got["loss"], np.mean(per_shard), rtol=2e-5, atol=2e-5)


def test_dp_ranks_agree(dp_runs):
    """Both ranks reduce to the same bits, and the same Adam steps from
    them keep the parameters equal."""
    a, b = dp_runs
    assert a["rank"] == 0 and b["rank"] == 1 and a["route"] == "host"
    assert a["losses"] == b["losses"] and a["losses"][1] < a["losses"][0]
    assert b["grads"] is None and a["grads_digest"] == b["grads_digest"]
    assert a["params_digest"] == b["params_digest"]


def test_mesh_groups_and_collective_transposes(tmp_path):
    """On a (dp 2, ep 2) mesh of 4 ranks: ep groups {0,1}, {2,3}, dp
    groups {0,2}, {1,3}; the sum's backward sums the cotangents over the
    group (3 from each of 2 ranks), the gather's gives each rank the sum
    of the cotangents of its slot; exchange swaps per-peer blocks (bf16
    bytes on gloo)."""
    res = spawn(jobs.mesh_probe_job, 4, "gloo", "cpu", store_dir=str(tmp_path),
                timeout=120, args=((2, 2),))
    for r, out in enumerate(res):
        assert out["coords"] == {"dp": r // 2, "ep": r % 2}
        ep_peers = [r - r % 2 + i for i in range(2)]
        assert out["sum"] == sum(p + 1 for p in ep_peers)
        slot = r // 2                       # this rank's index in its dp group
        assert out["grad"] == 2 * 3.0 + 2 * (1.0 if slot == 0 else 10.0)
        assert out["gathered"] == [float(r % 2 + 1), float(r % 2 + 3)]
        want = [10.0 * p + j for p in ep_peers for j in range(3)]
        assert out["exchange"] == want


def test_spawn_and_init_run_on_the_card_by_default(monkeypatch, tmp_path):
    """Ranks run on the CUDA device unless the caller asks for the CPU:
    without a card, spawn and init_distributed raise before any rank or
    group starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spawn(jobs.mesh_probe_job, 2, store_dir=str(tmp_path), args=((1, 2),))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_distributed("gloo", f"file://{tmp_path}/store", 0, 1)
    assert not torch.distributed.is_initialized()


def test_world_size_one_issues_the_sum(tmp_path):
    """At group size 1 exchange and all_gather_stack are the identity and
    issue nothing; all_reduce_sum still hands its buffer to the backend
    (so a one-rank NCCL group runs the device route), bit for bit the
    tensor it was given."""
    init_distributed("gloo", f"file://{tmp_path}/store", 0, 1, device="cpu")
    try:
        g = torch.distributed.group.WORLD
        comm.reset_issued()
        t = torch.randn(5, 3, generator=torch.Generator().manual_seed(0))
        blk = t.reshape(1, 1, 5, 3).to(torch.bfloat16)
        assert comm.exchange(blk, g) is blk
        assert torch.equal(comm.all_gather_stack(t, g), t[None])
        assert comm.issued == {"device": 0, "host": 0}
        s = comm.all_reduce_sum(t, g)
        assert torch.equal(s, t) and s.data_ptr() != t.data_ptr()
        assert torch.equal(comm.all_reduce_mean(t, g), t)
        assert comm.issued == {"device": 0, "host": 2}
    finally:
        torch.distributed.destroy_process_group()


def test_bench_scaling_cpu(capsys):
    out = bench_scaling.main(["--devices", "2", "--cpu", "--graphs", "6",
                              "--mean-nodes", "16", "--emb", "16", "--iters", "1"])
    text = capsys.readouterr().out
    line = json.loads(text.strip().splitlines()[-1])
    assert set(line) == {"dp_1", "dp_2", "ep_1", "ep_2", "ep_wire_boundary_mb",
                         "ep_wire_allgather_mb"}
    assert all(np.isfinite(v) and v > 0 for k, v in out.items() if "wire" not in k)
    assert text.count("ranks share one device") == 2


def test_dryrun_four_ranks_cpu():
    out = dryrun.main(["--ranks", "4", "--cpu", "--timeout", "240"])
    assert out["backend"] == "gloo" and out["route"] == "host"
    assert np.isfinite(out["dp_loss"])
    assert out["ep_forward_err"] < 1e-3 and out["dp_ep_err"] < 1e-3

"""The EP step's overlapped deferred exchange (dagnn_tpu_torch/parallel/
edge_partition.py) against its synchronous order, and the port's
ep_overlap_report against the JAX package's plan arrays, on gloo ranks on
the CPU.

* Both orders write bit for bit equal forward buffers (each direction's
  whole buffer: own slots, halo, garbage row) and give bit for bit equal
  losses and gradients, and issue the same collectives by route, at D = 2
  and 4 on the plans of tests/test_torch_edge_partition.py (its step
  batch, its random graphs, its layered graphs with deferred entries) and
  on the JAX report's batch padded for D = 8. Every one of these plans
  has rows that read a deferred entry at its delivery row (asserted).
* The asynchronous exchange at group size 1 issues nothing and returns its
  block.
* The report's trace section on the CPU ranks: every wait sits where its
  order puts it (after the row's outputs unless the plan flags the row).
* The report's plan section: its counts equal a count made here, row by
  row, from the JAX package's partition_schedule_sharded arrays (d_recv_
  hidx, d_recv_mask, e_src_lslot) on the JAX script's batch at D = 8.

Every rank-side run of this file is one spawn of 4 gloo ranks (module
fixture); the D = 2 cases run on the ep groups of a (2, 2) mesh whose dp
groups are copies.
"""

import numpy as np
import pytest
import torch

from dagnn_tpu.dag.batch import PadConfig as JPad, collate as jcollate
from dagnn_tpu.data.synthetic import synthetic_ast_batch as jsynthetic
from dagnn_tpu.parallel import edge_partition as jep
from dagnn_tpu_torch.dag.batch import PadConfig as TPad, collate as tcollate
from dagnn_tpu_torch.nn.dagnn import dagnn_init
from dagnn_tpu_torch.parallel import comm, jobs
from dagnn_tpu_torch.parallel import edge_partition as tep
from dagnn_tpu_torch.parallel.mesh import init_distributed, spawn
from dagnn_tpu_torch.scripts import ep_overlap_report as report
from test_edge_partition import _layered_graph
from test_torch_edge_partition import _cfgs, _graphs, _tgraph

torch.set_num_threads(1)

KINDS = ["step", "random", "layered_deferred", "report"]


def _batch(kind, n_dev):
    """A port batch and its config: the kinds of test_torch_edge_partition
    (chunk 2 x D), and the JAX report's batch padded for D = 8 (chunk 16)."""
    if kind == "report":
        return report.report_batch(8)
    _, tcfg = _cfgs("attn" if n_dev == 4 else "max")
    if kind == "step":
        graphs = _graphs(np.random.default_rng(3))
    elif kind == "random":
        graphs = _graphs(np.random.default_rng(4), (20, 20, 20, 20))
    else:
        graphs = [_layered_graph(6, n_dev, 3)]
    tg = [_tgraph(g) for g in graphs]
    return tcfg, tcollate(tg, TPad.for_graphs(tg, chunk_size=2 * n_dev))


def _params(cfg):
    return {k: v.detach().numpy() for k, v in dagnn_init(0, cfg, device="cpu").items()}


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """Every rank-side run of this file in one spawn of 4 gloo ranks: each
    rank's results, keyed by case."""
    todo, keys = [], []
    for kind in KINDS:
        for n_dev in (2, 4):
            cfg, b = _batch(kind, n_dev)
            todo.append((jobs.ep_job, dict(cfg=cfg, params_np=_params(cfg), batches=[b],
                                           mesh_shape=(4 // n_dev, n_dev), orders=True,
                                           turns=int(kind == "step"))))
            keys.append((kind, n_dev))
    cfg, b = _batch("step", 2)
    for backward in (True, False):
        todo.append((report.trace_job, dict(cfg=cfg, params_np=_params(cfg), batch=b,
                                            mesh_shape=(2, 2), turns=int(backward),
                                            warmup=backward, backward=backward)))
        keys.append(("trace", backward))
    res = spawn(jobs.run_jobs, 4, "gloo", "cpu",
                store_dir=str(tmp_path_factory.mktemp("store")), timeout=240,
                args=(todo,))
    return {k: [r[i] for r in res] for i, k in enumerate(keys)}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n_dev", [2, 4])
def test_orders_bitwise_equal(port_runs, kind, n_dev):
    """The overlapped order and the synchronous one: every rank's forward
    buffers, loss and gradients bit for bit, the same collectives by route;
    the rows that wait before their gather are the plan's."""
    cfg, b = _batch(kind, n_dev)
    plans = [tep.partition_schedule_sharded(s, n_dev) for s in (b.fwd, b.rev)]
    want_rows = [int(tep.deferred_reads(e).any(axis=(0, 2, 3)).sum()) for e, _ in plans]
    for r in port_runs[(kind, n_dev)]:
        o, s = r["orders"]["overlap"], r["orders"]["sync"]
        assert o["buffers_digest"] == s["buffers_digest"]
        assert o["loss"] == s["loss"] and np.isfinite(o["loss"])
        assert o["grads_digest"] == s["grads_digest"]
        assert o["issued"] == s["issued"] and o["issued"]["host"] > 0
        assert r["read_rows"] == want_rows
        assert r["route"] == "host"
    assert sum(want_rows) > 0, "no row of this case reads an entry at its delivery"


def test_orders_step_times(port_runs):
    got = port_runs[("step", 2)][0]["orders"]
    assert len(got["overlap"]["step_s"]) == len(got["sync"]["step_s"]) == 2
    assert all(t > 0 for o in ("overlap", "sync") for t in got[o]["step_s"])


def test_async_exchange_at_group_size_one(tmp_path):
    """exchange_async at group size 1 issues nothing; wait() returns the
    block itself, again on a second call."""
    init_distributed("gloo", f"file://{tmp_path}/store", 0, 1, device="cpu")
    try:
        g = torch.distributed.group.WORLD
        comm.reset_issued()
        blk = torch.randn(2, 1, 5, 3).to(torch.bfloat16)
        h = comm.exchange_async(blk, g)
        assert h.wait() is blk and h.wait() is blk
        assert comm.issued == {"device": 0, "host": 0}
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("backward", [True, False])
def test_trace_waits_where_the_order_puts_them(port_runs, backward):
    """The report's trace section on the CPU ranks, of a forward and
    backward pass or (chip_smoke.py's form) of a forward pass alone: in
    the synchronous order every deferred exchange is waited on before its
    row's gather; in the overlapped order after the row's outputs, except
    in the rows the plan flags; no device time is read on the CPU."""
    res = port_runs[("trace", backward)]
    assert report.check_trace(res) == []
    cfg, b = _batch("step", 2)
    flagged = [np.flatnonzero(tep.deferred_reads(
        tep.partition_schedule_sharded(s, 2)[0]).any(axis=(0, 2, 3))).tolist()
        for s in (b.fwd, b.rev)]
    for r in res:
        assert r["wait_rows"] == flagged
        s = report.trace_summary(r)
        n = s["sync"]["exchanges"]
        assert n > 0 and s["overlap"]["exchanges"] == n
        assert s["sync"]["before"] == n and s["sync"]["after"] == 0
        assert s["overlap"]["before"] == sum(map(len, flagged)) > 0
        assert s["overlap"]["after"] == n - s["overlap"]["before"] > 0
        assert s["overlap"]["compute_in_window_us"] is None
        assert len(s["overlap"]["step_s"]) == 2 * int(backward)
        assert (s["overlap"]["grad_us"] is not None) == backward
        if not backward:
            assert r["overlap"]["buffers_digest"] == r["sync"]["buffers_digest"]
    lines = "\n".join(report.trace_lines(res, "the CPU"))
    assert "| 0 | overlap |" in lines and "| 3 | sync |" in lines


def _jax_report_batch(n_dev):
    """The JAX script's batch, collated by the JAX package."""
    graphs = jsynthetic(3, 48, mean_nodes=40, vocab=11, seq_len=2)
    return jcollate(graphs, JPad.for_graphs(graphs, chunk_size=2 * n_dev))


def _count(eps):
    """Deferred entries, those read by the row they are delivered at, and
    those rows, by a loop over receivers and rows of the JAX plan."""
    D, R, w = eps.node_ids.shape
    entries, rows = 0, []
    for r in range(R):
        hit = 0
        for d in range(D):
            reads = set(np.asarray(eps.e_src_lslot[d, r]).tolist())
            for p, j in zip(*np.nonzero(np.asarray(eps.d_recv_mask[d, r]))):
                hit += R * w + int(eps.d_recv_hidx[d, r, p, j]) in reads
        entries += hit
        if hit:
            rows.append(r)
    return int(np.asarray(eps.d_send_mask).sum()), entries, rows


def test_plan_section_counts_equal_jax_plan(tmp_path):
    """--plan-only writes REPORT.md; per direction its deferred entries,
    entries read at their delivery row and flagged rows equal the count
    from JAX's arrays: 1,508 deferred, 10 read at delivery in 7 rows
    (forward); 1,740, 3 in 3 (reverse)."""
    out = report.main(["--plan-only", "--out", str(tmp_path)])
    text = (tmp_path / "REPORT.md").read_text()
    jb = _jax_report_batch(8)
    want = {"fwd": (1508, 10, 7), "rev": (1740, 3, 3)}
    for d in ("fwd", "rev"):
        eps, _ = jep.partition_schedule_sharded(getattr(jb, d), 8)
        deferred, entries, rows = _count(eps)
        got = out["plan"][8][d]
        assert (got["deferred"], got["read_at_delivery"], got["wait_rows"]) == \
            (deferred, entries, rows)
        assert (deferred, entries, len(rows)) == want[d]
        assert got["overlapped"] == got["exchanges"] - len(rows)
        assert f"| {d} | {got['rows']} | {deferred:,} | {entries:,} | {len(rows)} |" in text

"""EP boundary-exchange overlap: which rows may run the deferred exchange
under their compute, and a trace of where each exchange is issued and
waited on.

Counterpart of scripts/ep_overlap_report.py. The JAX script compiles the
sharded-state EP step on an 8-device CPU mesh and reads XLA's while body:
the deferred all-to-all's direct consumers, and where the collectives sit.
The port has no compiled graph to read; it takes the same evidence from
the plan and from a profiler trace:

1. Plan (numpy; --plan-only runs only this): ep_wire_stats, and per
   direction the deferred entries, those delivered at the row that reads
   them (edge_partition.deferred_reads: the planner may stage an entry at
   the row just before its first reader, so it arrives at that reader's
   row), the rows that must wait for the exchange before their gather
   against the rows that let it run under their compute, and the urgent
   entries a row.
2. Trace (--ranks N ranks, on the card unless --cpu): on each rank one EP
   forward and backward in each order (edge_partition's overlapped order
   and its synchronous one, overlap=False) under torch.profiler, after a
   warm-up step of each and the step times of both orders taken in turns
   a b b a. For each deferred exchange: the interval from its issue to its
   wait(), the compute kernels' device time inside that interval, and
   where the wait sits against its row's compute. N ranks on one card
   share it over gloo (each collective staged on the host); with a card a
   rank they run NCCL, and the NCCL kernels' device intervals are set
   against the compute kernels' running beside them.

The default batch is the JAX script's (48 synthetic ASTs, seed 3, mean 40
nodes, vocab 11, widths 16, scan rows 2 x D wide); --flagship takes the
flagship's (160 ASTs, seed 0, mean 125 nodes, emb/hidden 300, bf16,
segment_impl "pallas", scan rows 64 x D wide, as chip_smoke.py phase 23).
Writes REPORT.md under --out.

    python -m dagnn_tpu_torch.scripts.ep_overlap_report --plan-only
    python -m dagnn_tpu_torch.scripts.ep_overlap_report --ranks 2          # the card
    python -m dagnn_tpu_torch.scripts.ep_overlap_report --ranks 2 --cpu    # gloo on the CPU
    python -m dagnn_tpu_torch.scripts.ep_overlap_report --flagship --ranks 4
"""

from __future__ import annotations

import argparse
import bisect
import dataclasses
import json
import os
import re
import sys
import tempfile
import time

import numpy as np
import torch

# the JAX script's batch and model
GRAPHS, SEED, MEAN_NODES, VOCAB, SEQ, WIDTH = 48, 3, 40, 11, 2, 16

# the plan's marks in a trace (edge_partition._EPPlan._mark)
_MARK = re.compile(r"^ep(\d+)\.(row|urgent|issue|wait|grad)\.(\d+)$")


def report_batch(n_dev: int, flagship: bool = False):
    """(config, host batch) of the report at D = n_dev."""
    from dagnn_tpu_torch.dag.batch import PadConfig, collate
    from dagnn_tpu_torch.data.synthetic import synthetic_ast_batch
    if flagship:
        from dagnn_tpu_torch import flagship as fl
        graphs = synthetic_ast_batch(0, 160, mean_nodes=125)
        chunk = 64 * n_dev
        pad = dataclasses.replace(fl.pad_for(graphs, chunk=chunk), nodes_per_level=chunk)
        return fl.flagship_cfg(segment_impl="pallas"), collate(graphs, pad)
    from dagnn_tpu_torch.nn.dagnn import DAGNNConfig
    from dagnn_tpu_torch.nn.encoders import EncoderSpec
    cfg = DAGNNConfig(num_vocab=VOCAB, max_seq_len=SEQ, emb_dim=WIDTH, hidden_dim=WIDTH,
                      num_layers=2, bidirectional=True, agg="attn_h", out_pool="max",
                      out_pool_all=False, out_wx=False,
                      encoder=EncoderSpec("identity", emb_dim=WIDTH))
    rng = np.random.default_rng(5)
    graphs = synthetic_ast_batch(SEED, GRAPHS, mean_nodes=MEAN_NODES, vocab=VOCAB,
                                 seq_len=SEQ)
    for g in graphs:
        g.x = rng.normal(size=(g.num_nodes, WIDTH)).astype(np.float32)
        g.edge_attr = g.edge_attr[:, :2]
    return cfg, collate(graphs, PadConfig.for_graphs(graphs, chunk_size=2 * n_dev))


# ---------------------------------------------------------------- the plan

def direction_stats(eps, st) -> dict:
    """One direction's deferred and urgent entries, from its whole plan."""
    from dagnn_tpu_torch.parallel.edge_partition import deferred_reads
    hit = deferred_reads(eps)
    wait = hit.any(axis=(0, 2, 3))
    urgent = eps.u_send_mask.sum(axis=(0, 2, 3))
    exchanges = st.rows - 1 if st.has_deferred else 0       # rows 1 .. R-1
    return {"rows": st.rows, "deferred": int(eps.d_send_mask.sum()),
            "read_at_delivery": int(hit.sum()), "wait_rows": np.flatnonzero(wait).tolist(),
            "exchanges": exchanges, "overlapped": exchanges - int(wait.sum()),
            "urgent": int(urgent.sum()), "urgent_per_row_max": int(urgent.max(initial=0))}


def plan_section(plans, hidden: int, dtype_bytes: int = 2) -> dict:
    """The plan section of one D: plans is ((EPSchedule, EPStatic) forward,
    reverse), every rank's shards."""
    from dagnn_tpu_torch.parallel.edge_partition import ep_wire_stats
    return {"D": int(plans[0][0].node_ids.shape[0]),
            "wire": ep_wire_stats(plans[0][0], hidden, dtype_bytes),
            "fwd": direction_stats(*plans[0]), "rev": direction_stats(*plans[1])}


def plan_lines(sec: dict) -> list:
    w = sec["wire"]
    out = [f"### D = {sec['D']}", "",
           f"- boundary bytes real {w['boundary_bytes_real']:,} against a full-row "
           f"all_gather's {w['allgather_bytes_per_step']:,} a sweep (forward); deferred "
           f"fraction {w['deferred_frac']:.2f}", ""]
    out += ["| direction | rows | deferred entries | read at their delivery row | "
            "rows that wait before the gather | rows that overlap the exchange | "
            "urgent entries (max a row) |", "| --- | --- | --- | --- | --- | --- | --- |"]
    for d in ("fwd", "rev"):
        s = sec[d]
        out.append(f"| {d} | {s['rows']} | {s['deferred']:,} | {s['read_at_delivery']:,} | "
                   f"{len(s['wait_rows'])} | {s['overlapped']} of {s['exchanges']} | "
                   f"{s['urgent']:,} ({s['urgent_per_row_max']}) |")
    out.append("")
    for d in ("fwd", "rev"):
        rows = sec[d]["wait_rows"]
        out.append(f"- {d}: the rows that must wait for the deferred exchange before "
                   f"their gather: {rows if rows else 'none'}")
    return out + [""]


# --------------------------------------------------------------- the trace

class _Busy:
    """Device intervals (start, end), µs: their summed time inside a window."""

    def __init__(self, spans):
        self.spans = sorted(spans)
        self.starts = [a for a, _ in self.spans]
        self.longest = max((b - a for a, b in self.spans), default=0.0)

    def within(self, w0, w1) -> float:
        lo = bisect.bisect_left(self.starts, w0 - self.longest)
        hi = bisect.bisect_left(self.starts, w1)
        return sum(max(0.0, min(b, w1) - max(a, w0)) for a, b in self.spans[lo:hi])


def read_trace(path: str, read_rows) -> dict:
    """One profiled EP pass: each deferred exchange (direction, the row it
    delivers to) with its issue-to-wait window (µs, the host timeline),
    the compute kernels' device time inside it (None without device
    events), the issue's and the wait's own host time, and where the wait
    sits against its row's compute ("before" the gather, "after" the
    outputs, or "inside"); the urgent and backward exchanges' host time;
    NCCL kernels' device time and the compute kernels' device time beside
    them."""
    from dagnn_tpu_torch.utils import profiling
    events = profiling.load_events(path)
    marks = {}
    for e in events:
        m = _MARK.match(e.get("name", ""))
        if m and e.get("cat") == "user_annotation":
            marks[(int(m.group(1)), m.group(2), int(m.group(3)))] = (e["ts"], e["ts"] + e["dur"])
    kernels = [(e["ts"], e["ts"] + e["dur"], "nccl" in e["name"].lower())
               for e in events if e.get("cat") == "kernel"]
    compute = _Busy((a, b) for a, b, nc in kernels if not nc)
    nccl = [(a, b) for a, b, nc in kernels if nc]
    rows = []
    for (tag, what, r), (i0, i1) in sorted(marks.items()):
        if what != "issue" or (tag, "wait", r) not in marks:
            continue
        w0, w1 = marks[(tag, "wait", r)]
        c0, c1 = marks[(tag, "row", r)]
        where = "before" if w1 <= c0 else "after" if w0 >= c1 else "inside"
        rows.append({"dir": tag, "row": r, "window_us": w0 - i1,
                     "compute_us": compute.within(i1, w0) if kernels else None,
                     "issue_us": i1 - i0, "wait_us": w1 - w0, "where": where,
                     "wait_first": bool(read_rows[tag][r])})

    def host(what):
        spans = [b - a for (t, w, r), (a, b) in marks.items() if w == what]
        return sum(spans) if spans else None

    return {"exchanges": rows, "urgent_us": host("urgent"), "grad_us": host("grad"),
            "nccl_us": sum(b - a for a, b in nccl) if kernels else None,
            "compute_beside_nccl_us": (sum(compute.within(n0, n1) for n0, n1 in nccl)
                                       if kernels else None)}


def trace_job(dev, cfg, params_np, batch, mesh_shape, turns: int = 1,
              warmup: bool = True, backward: bool = True):
    """One rank's trace section: both orders' EP steps on the (dp, ep) mesh
    `mesh_shape` (each dp group a copy), one warm-up step each (warmup:
    a caller that ran the same shapes in this process may skip it), their
    step times in `turns` turns a b b a with each order's loss, gradient
    digest and collectives (jobs.ep_orders), then one profiled pass of
    each order, read by read_trace: the forward and backward
    (step.grads), or with backward=False the forward alone
    (step.forward_buffers, the part that holds the deferred exchange; a
    shorter trace), whose buffers' digest it also returns."""
    from torch.profiler import ProfilerActivity, profile
    from dagnn_tpu_torch.parallel import comm, jobs
    from dagnn_tpu_torch.parallel import edge_partition as ep
    from dagnn_tpu_torch.parallel.mesh import make_hybrid_mesh
    from dagnn_tpu_torch.train.optim import make_optimizer
    mesh = make_hybrid_mesh(*mesh_shape)
    plans, _, _ = jobs.ep_plans(batch, mesh_shape[1])
    aux = ep.ep_readout_aux(batch, [e for e, _ in plans], cfg)
    opt = make_optimizer()
    # the eager steps: the profiler marks are issued from Python, which a
    # replay of a captured step does not run
    steps = {o: jobs.ep_step(cfg, mesh, opt, overlap=o == "overlap", capture=False)
             for o in ("overlap", "sync")}
    inputs = steps["overlap"].shard(batch, plans, aux, dev)
    params = jobs._params(params_np, dev)
    out = {"rank": comm.rank(mesh.group), "route": comm.route(mesh.groups["ep"]),
           "wait_rows": [np.flatnonzero(r).tolist() for r in inputs.wait_rows()]}
    for s in steps.values() if warmup else ():
        s(params, opt.init(params), inputs)
    orders = jobs.ep_orders(steps["overlap"], steps["sync"], params, opt, inputs, turns,
                            dev, buffers=False)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with tempfile.TemporaryDirectory(prefix="ep_overlap_") as tmp:
        for name, step in steps.items():
            jobs._sync(dev)
            t0 = time.perf_counter()
            with profile(activities=acts) as prof:
                res = (step.grads if backward else step.forward_buffers)(params, inputs)
                jobs._sync(dev)
            pass_s = time.perf_counter() - t0
            path = os.path.join(tmp, f"{name}.json")
            prof.export_chrome_trace(path)
            out[name] = {**read_trace(path, inputs.wait_rows()), **orders[name],
                         "profiled_pass_s": pass_s}
            if not backward:
                out[name]["buffers_digest"] = jobs.digest(
                    {str(i): b for i, b in enumerate(res)})
    return out


def _sum(xs):
    return sum(xs) if all(x is not None for x in xs) else None


def trace_summary(res: dict) -> dict:
    """A rank's trace (trace_job) in numbers: per order the exchanges, how
    many waited before their row's gather and after its outputs, those
    whose wait sits where the order does not put it (`misplaced`: the
    synchronous order waits before every gather, the overlapped one only
    in the rows deferred_reads flags), the window and the compute device
    time inside it, the exposed host time (issue + wait) of the deferred
    exchanges, and the other exchanges' host time."""
    out = {}
    for name in ("overlap", "sync"):
        t, rows = res[name], res[name]["exchanges"]
        first = lambda x: x["wait_first"] or name == "sync"
        out[name] = {
            "exchanges": len(rows),
            "before": sum(x["where"] == "before" for x in rows),
            "after": sum(x["where"] == "after" for x in rows),
            "misplaced": [(x["dir"], x["row"], x["where"]) for x in rows
                          if x["where"] != ("before" if first(x) else "after")],
            "window_us": sum(x["window_us"] for x in rows),
            "compute_in_window_us": _sum([x["compute_us"] for x in rows]),
            "exposed_us": sum(x["issue_us"] + x["wait_us"] for x in rows),
            "urgent_us": t["urgent_us"], "grad_us": t["grad_us"],
            "nccl_us": t["nccl_us"], "compute_beside_nccl_us": t["compute_beside_nccl_us"],
            "step_s": t["step_s"], "profiled_pass_s": t["profiled_pass_s"]}
    out["wait_rows"] = [len(r) for r in res["wait_rows"]]
    return out


def _us(x):
    return "not measured" if x is None else f"{x:,.0f}"


def trace_lines(results: list, where: str) -> list:
    out = [f"Ranks: {len(results)} ({results[0]['route']} route), {where}. Rows that wait "
           f"before their gather (the plan's, by direction): "
           f"{trace_summary(results[0])['wait_rows']}.", "",
           "| rank | order | deferred exchanges | waits before the gather / after the "
           "outputs | misplaced | issue-to-wait window µs | compute device µs inside it | "
           "exposed µs (issue + wait) | urgent µs | backward µs | NCCL kernels µs | "
           "compute µs beside them | step s (turns) |",
           "| --- | --- | --- | --- | --- | --- | --- | --- | --- | --- | --- | --- | --- |"]
    for res in results:
        s = trace_summary(res)
        for name in ("overlap", "sync"):
            o = s[name]
            out.append(
                f"| {res['rank']} | {name} | {o['exchanges']} | {o['before']} / {o['after']} | "
                f"{len(o['misplaced'])} | {o['window_us']:,.0f} | "
                f"{_us(o['compute_in_window_us'])} | {o['exposed_us']:,.0f} | "
                f"{_us(o['urgent_us'])} | {_us(o['grad_us'])} | {_us(o['nccl_us'])} | "
                f"{_us(o['compute_beside_nccl_us'])} | "
                f"{' / '.join(f'{x:.4f}' for x in o['step_s'])} |")
    return out + [""]


def check_trace(results: list) -> list:
    """Every misplaced wait of every rank, (rank, order, dir, row, where)."""
    return [(res["rank"], name, *m) for res in results
            for name in ("overlap", "sync") for m in trace_summary(res)[name]["misplaced"]]


# ---------------------------------------------------------------- the CLI

def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=8, help="D of the plan section")
    ap.add_argument("--ranks", type=int, default=2, help="ranks of the trace section")
    ap.add_argument("--flagship", action="store_true", help="the flagship's batch")
    ap.add_argument("--plan-only", action="store_true", help="the plan section only")
    ap.add_argument("--cpu", action="store_true", help="trace gloo ranks on the CPU")
    ap.add_argument("--turns", type=int, default=2, help="timed turns a b b a")
    ap.add_argument("--out", default="results/torch_ep_overlap")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    Ds = [args.devices] + ([args.ranks] if not args.plan_only and args.ranks != args.devices
                           else [])
    from dagnn_tpu_torch.parallel.jobs import ep_plans
    rep = ["# EP boundary-exchange overlap (the port)", "",
           f"Batch: {'the flagship' if args.flagship else 'the JAX report'}'s "
           f"(`dagnn_tpu_torch/scripts/ep_overlap_report.py`). A deferred entry staged at "
           f"row q is delivered at row q + 1; the planner stages it at a row up to the "
           f"one before its first reader, so an entry staged there is read by the row it "
           f"arrives at. Those rows wait for the deferred exchange before their gather; "
           f"every other row runs it under its compute and waits after its outputs.", "",
           "## Plan", ""]
    out = {"plan": {}}
    for D in Ds:
        cfg, batch = report_batch(D, args.flagship)
        plans, _, _ = ep_plans(batch, D)
        sec = plan_section(plans, cfg.hidden_dim,
                           2 if cfg.compute_dtype == "bfloat16" else 4)
        out["plan"][D] = sec
        rep += plan_lines(sec)
    print(json.dumps({"plan": {D: {d: {k: v for k, v in s[d].items() if k != "wait_rows"}
                                   for d in ("fwd", "rev")} for D, s in out["plan"].items()}}))
    if not args.plan_only:
        from dagnn_tpu_torch import resolve_device
        from dagnn_tpu_torch.parallel.mesh import default_backend, spawn
        dev = resolve_device("cpu" if args.cpu else "cuda")
        if dev.type == "cuda":
            from dagnn_tpu_torch.ops import build
            build.build_all(["segment_attn", "wavefront"])
            where = (f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
                     f"card(s)")
        else:
            where = "the CPU (no device time)"
        from dagnn_tpu_torch.nn.dagnn import dagnn_init
        cfg, batch = report_batch(args.ranks, args.flagship)
        params = {k: v.detach().cpu().numpy()
                  for k, v in dagnn_init(0, cfg, device="cpu").items()}
        res = spawn(trace_job, args.ranks, default_backend(args.ranks, dev.type), dev.type,
                    timeout=1800, args=(cfg, params, batch, (1, args.ranks), args.turns))
        out["trace"] = [trace_summary(r) for r in res]
        out["misplaced"] = check_trace(res)
        out["bitwise"] = all(r["overlap"][k] == r["sync"][k] for r in res
                             for k in ("loss", "grads_digest", "issued"))
        rep += ["## Trace", ""] + trace_lines(res, where)
        rep.append(f"Waits where the order does not put them: {out['misplaced'] or 'none'}. "
                   f"Both orders' loss, gradients (bit for bit) and collectives equal on "
                   f"every rank: {out['bitwise']}.")
        print(json.dumps({"trace": out["trace"], "misplaced": out["misplaced"],
                          "bitwise": out["bitwise"]}))
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "REPORT.md"), "w") as f:
        f.write("\n".join(rep) + "\n")
    print(f"... report at {args.out}/REPORT.md")
    if out.get("misplaced") or out.get("bitwise") is False:
        raise SystemExit(f"waits out of place: {out['misplaced']}; both orders "
                         f"bitwise: {out['bitwise']}")
    return out


if __name__ == "__main__":
    main()

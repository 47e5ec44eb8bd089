"""Scaling harness: edges/s at 1 and N ranks, data-parallel and
edge-partitioned (the JAX package's cli/bench_scaling.py, its flags and
its JSON line).

Measures the fwd+bwd training-step edge throughput of the flagship DAGNN
(at --emb width) at 1 rank and at N ranks under (a) data parallelism (the
batch split by node count, gradients averaged) and (b) edge partitioning
(one batched DAG split across the ranks, scan rows 64 x N wide), and,
when every rank has a device of its own, the scaling efficiency
throughput_N / (N * throughput_1). Ranks that share a device (N ranks on
one card, or gloo ranks on the CPU) measure how the code path behaves,
not how it scales: their lines say `ranks share one device`, and no
efficiency is computed for them.

Each step runs in its default form, which each line names: over NCCL one
CUDA graph replay a step (the capture is the warm-up step), over gloo
eager ("eager (gloo: staged on the host)"). With --eager the NCCL runs
also time the eager steps, in turns with the captured ones in the same
ranks, after holding both forms' parameters to each other bit for bit.

    python -m dagnn_tpu_torch.cli.bench_scaling --devices 2          # the card(s)
    python -m dagnn_tpu_torch.cli.bench_scaling --devices 4 --eager  # four cards, both forms
    python -m dagnn_tpu_torch.cli.bench_scaling --devices 2 --cpu    # gloo ranks
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--devices", type=int, default=0,
                   help="ranks (0 = every CUDA device; 8 with --cpu)")
    p.add_argument("--graphs", type=int, default=64)
    p.add_argument("--mean-nodes", type=int, default=80)
    p.add_argument("--emb", type=int, default=128)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--eager", action="store_true",
                   help="also the eager steps, timed in turns with the captured ones "
                        "(a b b a) in the same ranks, after both forms' first "
                        "FORM_STEPS steps are held to each other bit for bit")
    p.add_argument("--cpu", action="store_true")
    return p.parse_args(argv)


# steps of each form from the same weights whose parameters --eager holds
# to each other bit for bit
FORM_STEPS = 3


def _chained(step, params, opt, inputs):
    """One step a call, each from the state the call before returned."""
    state = [params, opt.init(params)]

    def call():
        state[0], state[1], loss = step(state[0], state[1], inputs)
        return loss

    return call


def _time_steps(step, params, opt, inputs, iters, dev):
    """Seconds a step: one step to warm up (a captured step's capture),
    then `iters` steps, the device synchronised before and after."""
    call = _chained(step, params, opt, inputs)
    call()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        loss = call()
    float(loss)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) / iters


def dp_setup(dev, cfg, graphs, opt):
    """The DP train step over the world's ranks and this rank's shard of
    `graphs` (split by node count, one bucket for every shard), on `dev`:
    (make, batch, route), make(capture=None) building the step
    (make_dp_train_step's rule: captured over NCCL)."""
    from dagnn_tpu_torch import flagship
    from dagnn_tpu_torch.parallel import comm
    from dagnn_tpu_torch.parallel.dp import collate_sharded, make_dp_train_step
    from dagnn_tpu_torch.parallel.jobs import dp_loss
    from dagnn_tpu_torch.parallel.mesh import make_mesh
    d = torch.distributed.get_world_size()
    group = make_mesh(None, ("dp",)).groups["dp"]
    make = lambda capture=None: make_dp_train_step(dp_loss(cfg), opt, group, capture)
    batch = make(False).shard(collate_sharded(graphs, d, flagship.pad_for(graphs, n_shards=d)),
                              dev)
    return make, batch, comm.route(group)


def ep_setup(dev, cfg, graphs, opt):
    """The EP train step over the world's ranks (one batch of `graphs`,
    scan rows 64 x D wide) and this rank's inputs on `dev`: (make, inputs,
    {plan_s, greedy_s, wire, rows: each direction's plan rows}),
    make(capture=None, **kw) building the step (make_ep_train_step's rule;
    kw: overlap)."""
    from dagnn_tpu_torch import flagship
    from dagnn_tpu_torch.dag.batch import collate
    from dagnn_tpu_torch.parallel import edge_partition as ep
    from dagnn_tpu_torch.parallel.jobs import ep_plans, ep_step
    from dagnn_tpu_torch.parallel.mesh import make_mesh
    d = torch.distributed.get_world_size()
    chunk = max(64, 64 * d)
    pad1 = dataclasses.replace(flagship.pad_for(graphs, chunk=chunk),
                               nodes_per_level=chunk)
    batch = collate(graphs, pad1)
    info = {}
    plans, info["plan_s"], info["greedy_s"] = ep_plans(batch, d)
    info["wire"] = ep.ep_wire_stats(plans[0][0], cfg.hidden_dim)
    info["rows"] = [st.rows for _, st in plans]
    ep_mesh = make_mesh(None, ("ep",))
    make = lambda capture=None, **kw: ep_step(cfg, ep_mesh, opt, capture=capture, **kw)
    inputs = make(False).shard(batch, plans,
                               ep.ep_readout_aux(batch, [e for e, _ in plans], cfg), dev)
    return make, inputs, info


def _forms(make, params, opt, inputs, iters, dev, eager, orders=False):
    """One kind's part of bench_job: the default step's form and seconds a
    step; with `eager` and a captured default, the captured and eager
    steps' first FORM_STEPS steps from the same weights (jobs.run_forms;
    with `orders` also the captured synchronous order: their parameters'
    digests), the captured and eager steps' seconds a step in turns a b b
    a (iters steps each, after one warm-up step each: the capture), and
    one replay profiled: its NCCL kernels (the collectives in the graph)
    and the device's busy share. (Not the graph's nodes: a graph kept in
    debug mode for graphs.graph_nodes that holds NCCL kernels kept the
    ranks' process-group destroy from returning on four H100s.)"""
    from dagnn_tpu_torch.parallel.jobs import run_forms, timed_turns
    from dagnn_tpu_torch.utils import profiling
    step = make()
    out = {"form": step.form}
    if not (eager and step.captured is not None):
        out["s"] = _time_steps(step, params, opt, inputs, iters, dev)
        return out
    steps = {"captured": step, "eager": make(False)}
    if orders:
        steps["captured sync"] = make(overlap=False)
    runs = run_forms(steps, params, opt, inputs, FORM_STEPS)
    out["digests"] = {f: r["params"][-1] for f, r in runs.items()}
    out["losses"] = {f: r["losses"] for f, r in runs.items()}
    calls = [_chained(steps[f], params, opt, inputs) for f in ("captured", "eager")]
    for c in calls:
        c()
    secs, _ = timed_turns(calls, max(1, iters // 2), dev)
    out["s"], out["eager_s"] = (float(np.mean(x)) for x in secs)
    out["turns_ms"] = [[1e3 * x for x in xs] for xs in secs]
    with tempfile.TemporaryDirectory(prefix="bench_scaling_") as tmp:
        events = profiling.device_events(
            profiling.profile_step(calls[0], iters=1, logdir=tmp, name="replay.json"))
    out["nccl_kernels"] = sum("nccl" in e["name"].lower() for e in events
                              if e.get("cat") == "kernel")
    busy = profiling.device_busy(events)       # None on the CPU
    out["busy_share"] = busy and busy["share"]
    return out


def bench_job(dev, cfg, params_np, graphs, iters, eager=False):
    """One rank's part: the DP step on its shard and the EP step on its
    slice of the one batch, each timed (seconds a step) in the step's
    default form (captured over NCCL, eager over gloo), with `eager` also
    the eager form (_forms), and the EP plan's seconds and wire
    accounting."""
    from dagnn_tpu_torch.train.optim import make_optimizer
    params = {k: torch.as_tensor(v).to(dev) for k, v in params_np.items()}
    opt = make_optimizer()
    make, batch, route = dp_setup(dev, cfg, graphs, opt)
    out = {"dp": _forms(make, params, opt, batch, iters, dev, eager), "route": route}
    make, inputs, info = ep_setup(dev, cfg, graphs, opt)
    out.update(plan_s=info["plan_s"], greedy_s=info["greedy_s"], wire=info["wire"])
    out["ep"] = _forms(make, params, opt, inputs, iters, dev, eager, orders=True)
    return out


def workload(args):
    """(cfg, the graphs, their raw edges, the initial parameters as numpy)
    of the flags' workload."""
    from dagnn_tpu_torch import flagship
    from dagnn_tpu_torch.data.synthetic import synthetic_ast_batch
    from dagnn_tpu_torch.nn.dagnn import dagnn_init
    cfg = flagship.flagship_cfg(emb=args.emb, hidden=args.emb)
    graphs = synthetic_ast_batch(0, args.graphs, mean_nodes=args.mean_nodes)
    pnp = {k: v.numpy() for k, v in dagnn_init(0, cfg, device="cpu").items()}
    return cfg, graphs, sum(g.num_edges for g in graphs), pnp


def report(runs, n_edges: int, n_dev: int, device: str) -> dict:
    """The lines and the JSON line of the runs {ranks: every rank's
    bench_job result}, at 1 rank and n_dev; returns the JSON's numbers."""
    from dagnn_tpu_torch.parallel.mesh import default_backend
    cpu = device == "cpu"
    shared = lambda d: d > 1 and (cpu or d > torch.cuda.device_count())
    note = lambda d: " (ranks share one device)" if shared(d) else ""
    results = {}
    for kind in ("dp", "ep"):
        for d in sorted({1, n_dev}):
            r = runs[d][0]
            if kind == "ep" and d > 1:
                wire = r["wire"]
                print(f"EP x{d} plan {r['plan_s'] * 1e3:.0f} ms (greedy stage rows "
                      f"{r['greedy_s'] * 1e3:.0f} ms); wire/step: boundary "
                      f"{wire['boundary_bytes_real'] / 1e6:.2f} MB real "
                      f"({wire['boundary_bytes_padded'] / 1e6:.2f} padded, deferred "
                      f"{wire['deferred_frac']:.0%}) vs full-row all_gather "
                      f"{wire['allgather_bytes_per_step'] / 1e6:.2f} MB")
                results["ep_wire_boundary_mb"] = wire["boundary_bytes_real"] / 1e6
                results["ep_wire_allgather_mb"] = wire["allgather_bytes_per_step"] / 1e6
            f = r[kind]
            dt = f["s"]
            results[f"{kind}_{d}"] = n_edges / dt
            print(f"{kind.upper()} x{d} ({default_backend(d, device)}, {r['route']}, "
                  f"{f['form']}): {n_edges / dt:,.0f} edges/s ({dt * 1e3:.1f} ms/step)"
                  f"{note(d)}")
            if "eager_s" in f:
                same = [len(set(q[kind]["digests"].values())) == 1
                        and len({tuple(x) for x in q[kind]["losses"].values()}) == 1
                        for q in runs[d]]
                ranks = len({q[kind]["digests"]["captured"] for q in runs[d]}) == 1
                ms = f["turns_ms"]
                results[f"{kind}_{d}_eager"] = n_edges / f["eager_s"]
                print(f"{kind.upper()} x{d} eager, in turns with the captured step "
                      f"({' / '.join(f'{x:.1f}' for x in ms[1])} against "
                      f"{' / '.join(f'{x:.1f}' for x in ms[0])} ms): "
                      f"{n_edges / f['eager_s']:,.0f} edges/s ({f['eager_s'] * 1e3:.1f} "
                      f"ms/step); eager / captured {f['eager_s'] / dt:.2f}x; after "
                      f"{FORM_STEPS} steps the captured parameters bitwise the eager "
                      f"ones{' and the synchronous order' * (kind == 'ep')} on every "
                      f"rank: {all(same)}, every rank's alike: {ranks}; a profiled "
                      f"replay's NCCL kernels by rank "
                      f"{[q[kind]['nccl_kernels'] for q in runs[d]]}, its device busy "
                      f"{f['busy_share'] and round(100 * f['busy_share'], 1)}% (rank 0)")
                if not (all(same) and ranks):
                    raise RuntimeError(f"{kind.upper()} x{d}: the captured step differs "
                                       f"from the eager one or across the ranks")
        if n_dev > 1 and not shared(n_dev):
            eff = results[f"{kind}_{n_dev}"] / (n_dev * results[f"{kind}_1"])
            results[f"{kind}_scaling_efficiency"] = eff
            print(f"{kind.upper()} scaling efficiency at {n_dev} devices: {eff:.1%}")

    print(json.dumps({k: round(v, 1) for k, v in results.items()}))
    return results


def main(argv=None, spawn=None) -> dict:
    """The scaling runs as the command line asks for them, the most ranks
    first. `spawn` starts each run's ranks: parallel.mesh.spawn, or a
    function with its signature (a caller that runs these jobs beside its
    own in one world of ranks)."""
    args = parse_args(argv)
    from dagnn_tpu_torch import resolve_device
    from dagnn_tpu_torch.parallel import mesh
    from dagnn_tpu_torch.parallel.mesh import default_backend

    spawn = spawn or mesh.spawn
    device = "cpu" if args.cpu else "cuda"
    dev = resolve_device(device)
    n_dev = args.devices or (8 if args.cpu else torch.cuda.device_count())
    if dev.type == "cuda":
        from dagnn_tpu_torch.ops import build
        build.build_all(["wavefront", "segment_attn"])   # once, before the ranks
    cfg, graphs, n_edges, pnp = workload(args)
    runs = {d: spawn(bench_job, d, default_backend(d, device), device, timeout=3600.0,
                     args=(cfg, pnp, graphs, args.iters, args.eager))
            for d in sorted({1, n_dev}, reverse=True)}
    return report(runs, n_edges, n_dev, device)


if __name__ == "__main__":
    main(sys.argv[1:])

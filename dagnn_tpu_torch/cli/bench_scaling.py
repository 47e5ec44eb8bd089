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

    python -m dagnn_tpu_torch.cli.bench_scaling --devices 2          # the card(s)
    python -m dagnn_tpu_torch.cli.bench_scaling --devices 2 --cpu    # gloo ranks
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
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
    p.add_argument("--cpu", action="store_true")
    return p.parse_args(argv)


def _time_steps(step, params, opt, inputs, iters, dev):
    """Seconds a step: one step to warm up, then `iters` steps, the device
    synchronised before and after."""
    state = opt.init(params)
    step(params, state, inputs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = step(params, state, inputs)
    float(out[2])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) / iters


def dp_setup(dev, cfg, graphs, opt):
    """The DP train step over the world's ranks and this rank's shard of
    `graphs` (split by node count, one bucket for every shard), on `dev`:
    (step, batch, route)."""
    from dagnn_tpu_torch import flagship
    from dagnn_tpu_torch.nn.dagnn import dagnn_forward
    from dagnn_tpu_torch.parallel import comm
    from dagnn_tpu_torch.parallel.dp import collate_sharded, make_dp_train_step
    from dagnn_tpu_torch.parallel.jobs import loss_of
    from dagnn_tpu_torch.parallel.mesh import make_mesh
    d, head = torch.distributed.get_world_size(), loss_of("tok")

    def loss_fn(p, b, rng):
        return head(dagnn_forward(p, cfg, b),
                    {k: torch.as_tensor(v, device=dev) for k, v in b.y.items()},
                    torch.as_tensor(b.graph_mask, device=dev))

    dp_mesh = make_mesh(None, ("dp",))
    step = make_dp_train_step(loss_fn, opt, dp_mesh.groups["dp"])
    batch = step.shard(collate_sharded(graphs, d, flagship.pad_for(graphs, n_shards=d)), dev)
    return step, batch, comm.route(dp_mesh.groups["dp"])


def ep_setup(dev, cfg, graphs, opt):
    """The EP train step over the world's ranks (one batch of `graphs`,
    scan rows 64 x D wide) and this rank's inputs on `dev`: (step,
    inputs, {plan_s, greedy_s, wire, rows: each direction's plan rows})."""
    from dagnn_tpu_torch import flagship
    from dagnn_tpu_torch.dag.batch import collate
    from dagnn_tpu_torch.parallel import edge_partition as ep
    from dagnn_tpu_torch.parallel.jobs import ep_plans, loss_of
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
    estep = ep.make_ep_train_step(cfg, ep_mesh, loss_of("tok"), opt)
    inputs = estep.shard(batch, plans, ep.ep_readout_aux(batch, [e for e, _ in plans], cfg),
                         dev)
    return estep, inputs, info


def bench_job(dev, cfg, params_np, graphs, iters):
    """One rank's part: the DP step on its shard and the EP step on its
    slice of the one batch, each timed (seconds a step), with the EP
    plan's seconds and wire accounting."""
    from dagnn_tpu_torch.train.optim import make_optimizer
    params = {k: torch.as_tensor(v).to(dev) for k, v in params_np.items()}
    opt = make_optimizer()
    step, batch, route = dp_setup(dev, cfg, graphs, opt)
    out = {"dp_s": _time_steps(step, params, opt, batch, iters, dev), "route": route}
    estep, inputs, info = ep_setup(dev, cfg, graphs, opt)
    out.update(plan_s=info["plan_s"], greedy_s=info["greedy_s"], wire=info["wire"])
    out["ep_s"] = _time_steps(estep, params, opt, inputs, iters, dev)
    return out


def main(argv=None) -> dict:
    args = parse_args(argv)
    from dagnn_tpu_torch import flagship, resolve_device
    from dagnn_tpu_torch.data.synthetic import synthetic_ast_batch
    from dagnn_tpu_torch.nn.dagnn import dagnn_init
    from dagnn_tpu_torch.parallel.mesh import default_backend, spawn

    device = "cpu" if args.cpu else "cuda"
    dev = resolve_device(device)
    n_dev = args.devices or (8 if args.cpu else torch.cuda.device_count())
    if dev.type == "cuda":
        from dagnn_tpu_torch.ops import build
        build.build_all(["wavefront", "segment_attn"])   # once, before the ranks
    cfg = flagship.flagship_cfg(emb=args.emb, hidden=args.emb)
    graphs = synthetic_ast_batch(0, args.graphs, mean_nodes=args.mean_nodes)
    n_edges = sum(g.num_edges for g in graphs)
    pnp = {k: v.numpy() for k, v in dagnn_init(0, cfg, device="cpu").items()}
    shared = lambda d: d > 1 and (args.cpu or d > torch.cuda.device_count())
    note = lambda d: " (ranks share one device)" if shared(d) else ""
    results, runs = {}, {}
    for d in sorted({1, n_dev}):
        backend = default_backend(d, device)
        runs[d] = spawn(bench_job, d, backend, device, timeout=3600.0,
                        args=(cfg, pnp, graphs, args.iters))[0]
        dt = runs[d]["dp_s"]
        results[f"dp_{d}"] = n_edges / dt
        print(f"DP x{d} ({backend}, {runs[d]['route']}): {n_edges / dt:,.0f} edges/s "
              f"({dt * 1e3:.1f} ms/step){note(d)}")
    if n_dev > 1 and not shared(n_dev):
        eff = results[f"dp_{n_dev}"] / (n_dev * results["dp_1"])
        results["dp_scaling_efficiency"] = eff
        print(f"DP scaling efficiency at {n_dev} devices: {eff:.1%}")

    for d in sorted({1, n_dev}):
        r = runs[d]
        if d > 1:
            wire = r["wire"]
            print(f"EP x{d} plan {r['plan_s'] * 1e3:.0f} ms (greedy stage rows "
                  f"{r['greedy_s'] * 1e3:.0f} ms); wire/step: boundary "
                  f"{wire['boundary_bytes_real'] / 1e6:.2f} MB real "
                  f"({wire['boundary_bytes_padded'] / 1e6:.2f} padded, deferred "
                  f"{wire['deferred_frac']:.0%}) vs full-row all_gather "
                  f"{wire['allgather_bytes_per_step'] / 1e6:.2f} MB")
            results["ep_wire_boundary_mb"] = wire["boundary_bytes_real"] / 1e6
            results["ep_wire_allgather_mb"] = wire["allgather_bytes_per_step"] / 1e6
        dt = r["ep_s"]
        results[f"ep_{d}"] = n_edges / dt
        print(f"EP x{d}: {n_edges / dt:,.0f} edges/s ({dt * 1e3:.1f} ms/step){note(d)}")
    if n_dev > 1 and not shared(n_dev):
        eff = results[f"ep_{n_dev}"] / (n_dev * results["ep_1"])
        results["ep_scaling_efficiency"] = eff
        print(f"EP scaling efficiency at {n_dev} devices: {eff:.1%}")

    print(json.dumps({k: round(v, 1) for k, v in results.items()}))
    return results


if __name__ == "__main__":
    main(sys.argv[1:])

"""Multi-rank dry run: the port's counterpart of the JAX package's
`__graft_entry__.dryrun_multichip` / `_dryrun_dp_ep`.

Starts N ranks (parallel/mesh.spawn; NCCL when each rank has a card of
its own, else gloo) and runs three checks on the shrunk flagship (emb and
hidden 16, float32: it checks the sharding against exact references, not
the bf16 production dtype), each with the JAX dry run's assertion:

  1. one data-parallel train step over all N ranks (4N synthetic ASTs
     split by node count, flagship.pad_for(n_shards=N)): a finite loss;
  2. the edge-partitioned forward, replicated-state scheme (one batch,
     scan rows 8N wide): direction 0's states within 1e-3 of the
     single-rank states;
  3. at N >= 4 (even), the (dp 2, ep N/2) sharded-state train step, each
     dp group on its own batch: its loss within 1e-3 of the mean of the
     two batches' single-rank losses, and one step of it with the same
     loss on every rank.

The train steps of 1 and 3 run in their default form, which the lines
name: captured over NCCL (one CUDA graph per key), eager over gloo
("eager (gloo: staged on the host)").

    python -m dagnn_tpu_torch.cli.dryrun --ranks 4          # on the card
    python -m dagnn_tpu_torch.cli.dryrun --ranks 4 --cpu    # gloo on the CPU
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ranks", type=int, default=0,
                   help="ranks to start (0 = one a CUDA device)")
    p.add_argument("--cpu", action="store_true", help="gloo ranks on the CPU")
    p.add_argument("--timeout", type=float, default=600.0,
                   help="seconds for the whole run and for each collective")
    return p.parse_args(argv)


def _cfg():
    from dagnn_tpu_torch import flagship
    return flagship.flagship_cfg(emb=16, hidden=16, compute_dtype="float32")


def plan(n: int, device: str):
    """The dry run at n ranks: (the jobs every rank runs, jobs.run_jobs's
    list, and what check() needs), so that a caller can run them in a
    spawn of its own beside other jobs."""
    from dagnn_tpu_torch import flagship, resolve_device
    from dagnn_tpu_torch.dag.batch import collate
    from dagnn_tpu_torch.data.synthetic import synthetic_ast_batch
    from dagnn_tpu_torch.nn.dagnn import dagnn_init
    from dagnn_tpu_torch.parallel import jobs
    from dagnn_tpu_torch.parallel.dp import collate_sharded
    dev = resolve_device(device)
    cfg = _cfg()
    params = dagnn_init(0, cfg, device=dev)
    pnp = {k: v.cpu().numpy() for k, v in params.items()}

    graphs = synthetic_ast_batch(1, 4 * n, mean_nodes=12)
    stacked = collate_sharded(graphs, n, flagship.pad_for(graphs, n_shards=n))
    pad1 = dataclasses.replace(flagship.pad_for(graphs, chunk=8 * n),
                               nodes_per_level=8 * n)
    todo = [(jobs.dp_job, dict(cfg=cfg, params_np=pnp, stacked=stacked, steps=1)),
            (jobs.ep_forward_job, dict(cfg=cfg, params_np=pnp,
                                       batch=collate(graphs, pad1), mesh_shape=(1, n)))]
    groups = []
    if n >= 4 and n % 2 == 0:
        n_ep = n // 2
        pad = None
        for gi in range(2):
            g = synthetic_ast_batch(10 + gi, 4, mean_nodes=12)
            if pad is None:
                pad = flagship.pad_for(g, chunk=2 * n_ep)
                pad = dataclasses.replace(pad, nodes_per_level=2 * n_ep,
                                          max_nodes=pad.max_nodes + 32,
                                          max_edges=pad.max_edges + 32,
                                          max_levels=pad.max_levels + 4)
            groups.append(collate(g, pad))
        todo.append((jobs.ep_job, dict(cfg=cfg, params_np=pnp, batches=groups,
                                       mesh_shape=(2, n_ep), dp_axis=True, steps=1)))
    return todo, dict(n=n, cfg=cfg, params=params, graphs=graphs, pad1=pad1,
                      groups=groups, dev=dev)


def check(ctx, backend: str, res) -> dict:
    """The JAX dry run's assertions on the ranks' results of plan()'s jobs
    (res[rank] = that rank's results of those jobs, in order); prints a
    line a check and returns the numbers."""
    from dagnn_tpu_torch.dag.batch import collate
    from dagnn_tpu_torch.nn.dagnn import dagnn_forward, dagnn_node_states
    n, cfg, params, dev = ctx["n"], ctx["cfg"], ctx["params"], ctx["dev"]
    out = {"ranks": n, "backend": backend, "route": res[0][0]["route"]}

    losses = [r[0]["losses"][0] for r in res]
    loss = losses[0]
    assert np.isfinite(loss), f"dryrun loss not finite: {loss}"
    assert all(l == loss for l in losses), f"ranks disagree on the loss: {losses}"
    print(f"dryrun({n}, {backend}): one DP train step ok ({res[0][0]['form']}), "
          f"loss={loss:.4f}")
    out["dp_form"] = res[0][0]["form"]
    out["dp_loss"] = loss

    with torch.no_grad():
        _, h_ref = dagnn_node_states(params, cfg, collate(ctx["graphs"], ctx["pad1"]))
    err = float(np.max(np.abs(res[0][1]["states"] - h_ref[0].float().cpu().numpy())))
    assert err < 1e-3, f"edge-partitioned mismatch: {err}"
    print(f"dryrun({n}, {backend}): edge-partitioned pass ok (max dev {err:.2e})")
    out["ep_forward_err"] = err

    if ctx["groups"]:
        from dagnn_tpu_torch.parallel.jobs import loss_of
        head = loss_of("tok")
        with torch.no_grad():
            ref = float(np.mean([
                float(head(dagnn_forward(params, cfg, b),
                           {k: torch.as_tensor(v, device=dev) for k, v in b.y.items()},
                           torch.as_tensor(b.graph_mask, device=dev)))
                for b in ctx["groups"]]))
        got = res[0][2]["loss"]
        err = abs(got - ref)
        assert err < 1e-3, f"dp-ep loss mismatch: {got} vs {ref}"
        stepped = [r[2]["losses"][0] for r in res]
        assert all(l == got for l in stepped), \
            f"the (dp, ep) step's loss {stepped} differs from its gradient pass's {got}"
        form = res[0][2]["form"]
        print(f"dryrun: (dp=2, ep={n // 2}) sharded-state EP train step ok ({form}), "
              f"loss={got:.4f} (ref dev {err:.1e})")
        out["dp_ep_loss"], out["dp_ep_err"], out["dp_ep_form"] = got, err, form
    return out


def main(argv=None) -> dict:
    args = parse_args(argv)
    from dagnn_tpu_torch import resolve_device
    from dagnn_tpu_torch.parallel import jobs
    from dagnn_tpu_torch.parallel.mesh import default_backend, spawn

    device = "cpu" if args.cpu else "cuda"
    n = args.ranks or torch.cuda.device_count()
    if resolve_device(device).type == "cuda":
        from dagnn_tpu_torch.ops import build
        build.build_all(["wavefront", "segment_attn"])   # once, before the ranks
    todo, ctx = plan(n, device)
    backend = default_backend(n, device)
    res = spawn(jobs.run_jobs, n, backend, device, timeout=args.timeout,
                args=(todo,))
    return check(ctx, backend, res)


if __name__ == "__main__":
    main(sys.argv[1:])

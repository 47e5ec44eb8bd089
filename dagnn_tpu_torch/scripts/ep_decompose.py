"""EP cost decomposition: where an edge-partitioned step's time goes,
against a data-parallel step of the same graphs.

Counterpart of scripts/ep_decompose.py, on the port's planners and steps.

1. --plan-only: the sharded-state plan's statistics for D = 1, 2, 4, 8
   (parallel/edge_partition.partition_schedule_sharded on the forward
   schedule at scan rows 64 x D wide): rows, own slots a row (own_w), halo
   slots, edges and transpose edges a row a device, and the widths of the
   full, deferred and urgent exchange blocks. These are the inputs of a
   scaling model: the own slice shrinks about 1/D while the plan's widths
   stay roughly constant a device.
2. Otherwise also the eager DP x1 and EP x1 steps (make(False): the
   launches issued one by one that a capture folds into one replay) at
   cli/bench_scaling's workload (64
   synthetic ASTs of mean 80 nodes, emb/hidden 128; one rank, a
   world-size-1 process group in this process: NCCL on the card, gloo with
   --cpu): 5 steps each on the host clock after a warm-up, the kernel
   launches of those steps, and one torch.profiler window of 3 steps whose
   device time is split into categories (`CATEGORIES`, every device event
   in exactly one), with the device's busy share and the edges/s.

    python -m dagnn_tpu_torch.scripts.ep_decompose --plan-only
    python -m dagnn_tpu_torch.scripts.ep_decompose          # the card
    python -m dagnn_tpu_torch.scripts.ep_decompose --cpu    # gloo, no device time
"""

from __future__ import annotations

import dataclasses
import json
import sys
import tempfile
import time

import torch

# cli/bench_scaling's defaults; the CPU tests set them small
GRAPHS = 64
MEAN_NODES = 80
WIDTH = 128
DEVICES = (1, 2, 4, 8)
STEPS = 5
PROFILE_STEPS = 3

# device-time categories, tested in this order on the kernel's short name
# (utils/profiling.short_name, lowercased; the whole signature where the
# short name is a template's return type); copies and sets by the trace's
# category; what matches none is "other"
ROW_KERNELS = ("attn_fwd", "gru_fwd", "rebuild", "gemm_nn", "attn_bwd",
               "gru_bwd_elem", "wgrad", "small_reduce")
CATEGORIES = (
    ("collective", ("nccl",)),                          # all_reduce, all_to_all
    ("k6_k5", ("sa_fwd", "sa_bwd", "seg_merge")),       # segment_attn.cu, K5
    ("k1_k2", ROW_KERNELS),                             # the row kernels' launches
    ("gather_scatter", ("index", "scatter", "gather")),  # halo writes, plan gathers
    ("gemm", ("gemm", "gemv", "cutlass", "xmma", "sm90_", "nvjet", "cublas", "splitk")),
    ("elementwise", ("elementwise", "foreach", "multi_tensor")),
    ("reduce", ("reduce",)),
)


def plan_stats(graphs, devices=DEVICES) -> dict:
    """The forward schedule's sharded-state plan statistics at each D."""
    from dagnn_tpu_torch import flagship
    from dagnn_tpu_torch.dag.batch import collate
    from dagnn_tpu_torch.parallel.edge_partition import partition_schedule_sharded
    plans = {}
    for d in devices:
        chunk = max(64, 64 * d)
        pad1 = dataclasses.replace(flagship.pad_for(graphs, n_shards=1, chunk=chunk),
                                   nodes_per_level=chunk)
        b = collate(graphs, pad1)
        eps_f, st_f = partition_schedule_sharded(b.fwd, d)
        plans[d] = dict(
            rows=int(st_f.rows), own_w=int(st_f.own_w), halo=int(st_f.halo),
            ke_per_dev=int(eps_f.e_dst.shape[-1]),
            tgrad_per_dev=int(eps_f.t_mask.shape[-1]),
            boundary_w=int(eps_f.x_send_col.shape[-1]),
            deferred_w=int(eps_f.d_send_col.shape[-1]),
            urgent_w=int(eps_f.u_send_col.shape[-1]))
    return plans


def category(event) -> str:
    """The category of one device event of a trace."""
    from dagnn_tpu_torch.utils.profiling import short_name
    if event.get("cat") in ("gpu_memcpy", "gpu_memset"):
        return "copy"
    nm = short_name(event["name"]).lower()
    if nm.startswith("std::"):
        nm = event["name"].lower()
    for cat, keys in CATEGORIES:
        if any(k in nm for k in keys):
            return cat
    return "other"


def decompose(path, iters) -> dict:
    """A trace's device time split by `category`, µs a step: each
    category's total and its three largest kernels, the total of every
    device event, the busy share of the window's span and the device
    events a step. None without device events (a CPU run: no device time
    is measured)."""
    import collections
    from dagnn_tpu_torch.utils import profiling
    events = profiling.device_events(path)
    if not events:
        return None
    by = collections.defaultdict(collections.Counter)
    for e in events:
        by[category(e)][profiling.short_name(e["name"])] += e.get("dur", 0) / iters
    names = [c for c, _ in CATEGORIES] + ["copy", "other"]
    return {"categories_us": {c: sum(by[c].values()) for c in names},
            "top_us": {c: dict(by[c].most_common(3)) for c in names if by[c]},
            "total_us": sum(e.get("dur", 0) for e in events) / iters,
            "busy_share": profiling.device_busy(events)["share"],
            "events_per_step": len(events) / iters}


def _measure(tag, step, params, opt, inputs, n_edges, dev, out):
    """STEPS timed steps after a warm-up (host clock, the device
    synchronised), their kernel launches, and a profiled window."""
    from dagnn_tpu_torch.ops import read_launch_counts
    from dagnn_tpu_torch.utils import profiling
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    state = opt.init(params)
    step(params, state, inputs)
    sync()
    before = read_launch_counts()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        res = step(params, state, inputs)
    float(res[2])
    sync()
    ms = (time.perf_counter() - t0) / STEPS * 1e3
    after = read_launch_counts()
    with tempfile.TemporaryDirectory(prefix="ep_decompose_") as tmp:
        path = profiling.profile_step(lambda: step(params, state, inputs),
                                      iters=PROFILE_STEPS, logdir=tmp,
                                      name=f"{tag}_trace.json")
        prof = decompose(path, PROFILE_STEPS)
    out[f"{tag}_ms"] = ms
    out[f"{tag}_edges_per_s"] = n_edges / ms * 1e3
    out[f"{tag}_launches"] = {k: after[k] - before[k] for k in after
                              if after[k] != before[k]}
    out[f"{tag}_profile"] = prof


def measure(dev, graphs, cfg) -> dict:
    """DP x1 and EP x1 on `dev` in a world-size-1 process group."""
    import torch.distributed as dist
    from dagnn_tpu_torch.cli.bench_scaling import dp_setup, ep_setup
    from dagnn_tpu_torch.nn.dagnn import dagnn_init
    from dagnn_tpu_torch.train.optim import make_optimizer
    params = dagnn_init(0, cfg, device=dev)
    n_edges = sum(g.num_edges for g in graphs)
    out = {"edges": n_edges, "steps": STEPS, "profile_steps": PROFILE_STEPS}
    with tempfile.TemporaryDirectory(prefix="ep_decompose_store_") as store:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"file://{store}/store", rank=0,
                                world_size=1)
        try:
            opt = make_optimizer()
            # the eager steps: their launches and host time are what
            # this decomposes
            make, batch, out["dp_route"] = dp_setup(dev, cfg, graphs, opt)
            _measure("dp1", make(False), params, opt, batch, n_edges, dev, out)
            make, inputs, info = ep_setup(dev, cfg, graphs, opt)
            out["ep1_rows"] = info["rows"]
            _measure("ep1", make(False), params, opt, inputs, n_edges, dev, out)
        finally:
            dist.destroy_process_group()
    return out


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    from dagnn_tpu_torch import flagship, resolve_device
    from dagnn_tpu_torch.data.synthetic import synthetic_ast_batch
    graphs = synthetic_ast_batch(0, GRAPHS, mean_nodes=MEAN_NODES)
    out = {"plan_by_D": plan_stats(graphs)}
    print(json.dumps(out))
    if "--plan-only" in argv:
        return out
    dev = resolve_device("cpu" if "--cpu" in argv else "cuda")
    if dev.type == "cuda":
        from dagnn_tpu_torch.ops import build
        build.build_all(["wavefront", "segment_attn"])
    cfg = flagship.flagship_cfg(emb=WIDTH, hidden=WIDTH)
    m = measure(dev, graphs, cfg)
    m["device"] = "cpu" if dev.type == "cpu" else torch.cuda.get_device_name(dev)
    print(json.dumps(m, indent=1))
    out.update(m)
    return out


if __name__ == "__main__":
    main()

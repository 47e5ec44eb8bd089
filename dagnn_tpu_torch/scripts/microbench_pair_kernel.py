"""Microbenchmark: the pair kernels K3 (forward) and K4 (backward) alone at
the bench plan's shapes, beside two merged rows (K1/K2) of the same work.

Counterpart of scripts/microbench_pair_kernel.py: the bench's 160
synthetic ASTs at the flagship config, collated with a pair plan of PAIR
(env, default 2); the pair step in the middle of the schedule (P // 2),
its node inputs from the encoder of seeded weights and its plan's own
indices, masks and block table, random value rows, cotangents and
transpose grads (np.random.default_rng(0), (1), (2)); then the middle row
(L // 2) of the merged layout of the same graphs, whose two rows a pair
step does. Timing as the row microbench: calls replayed from one CUDA
graph, and per eager call beside (utils/timing.timings, 50 calls).

    python -m dagnn_tpu_torch.scripts.microbench_pair_kernel          # the card
    PAIR=3 python -m dagnn_tpu_torch.scripts.microbench_pair_kernel
    python -m dagnn_tpu_torch.scripts.microbench_pair_kernel --cpu    # plain, host clock
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

# the bench's workload (dagnn_tpu_torch/bench.py); the CPU tests set them small
GRAPHS = 160
MEAN_NODES = 125
WIDTH = 300
REPS = 50


def _normal(seed, shape, dt, dev):
    return torch.as_tensor(np.random.default_rng(seed).normal(size=shape)
                           .astype(np.float32)).to(dt).to(dev)


def _step(fxs, ixs, s, keys):
    """Step s of a fused plan's streams as the kernels' named inputs."""
    d = {"xin": fxs["x"][s], "ea": fxs["ea"][s]}
    d.update({k: ixs[k][s] for k in keys})
    return d


def make_inputs(pm=2, device="cpu", graphs=None, cfg=None):
    """{"pair": (static, inputs, weights, blocks, P, step), "merged":
    (static, inputs, weights, L, row)} at the bench's workload (or the
    given graphs and config): the pair step P // 2 of a plan of pm and
    the merged row L // 2 of the same graphs."""
    from dagnn_tpu_torch import convert, flagship
    from dagnn_tpu_torch.dag.batch import collate
    from dagnn_tpu_torch.data.synthetic import synthetic_ast_batch
    from dagnn_tpu_torch.nn import dagnn as dg
    dev = torch.device(device)
    cfg = cfg or flagship.flagship_cfg(emb=WIDTH, hidden=WIDTH)
    graphs = graphs or synthetic_ast_batch(0, GRAPHS, mean_nodes=MEAN_NODES)
    params = dg.dagnn_init(torch.Generator().manual_seed(0), cfg, device=dev)
    dt = dg._DTYPES[cfg.compute_dtype]
    lh = cfg.num_layers * cfg.hidden_dim
    out = {}

    b = convert.batch_to_torch(collate(graphs, flagship.pad_for(graphs, pair=pm)), dev)
    x = dg._encode(params, cfg, b, dev)
    fxs, ixs = dg._build_streams_pair(cfg, x, b.edge_attr, b.pair, dev)
    plan = dg._Plan(cfg, fxs, ixs, dg.PAIR_KERNELS, tail=(b.pair.blocks,))
    w = plan.weights([params[k] for k in plan.keys])
    P, kn4 = fxs["x"].shape[:2]
    i = P // 2
    d = _step(fxs, ixs, i, ("edst", "emask", "nmask", "nsrc", "tdst", "tmask"))
    U, T = b.pair.acc_unit, ixs["teslot"].shape[1]
    d["vals"] = _normal(0, (U, lh), dt, dev)
    d["g"] = _normal(1, (kn4, lh), dt, dev)
    d["tg"] = _normal(2, (T, lh), dt, dev)
    out["pair"] = (plan.static, d, w, b.pair.blocks, P, i)

    bm = convert.batch_to_torch(collate(graphs, flagship.pad_for(graphs)), dev)
    xm = dg._encode(params, cfg, bm, dev)
    fxm, ixm, (L, kn2), _ = dg._build_streams_merged(cfg, xm, bm.edge_attr,
                                                     bm.fwd, bm.rev, dev)
    plan_m = dg._Plan(cfg, fxm, ixm, dg.KERNELS, kw={"ndirs": 2})
    wm = plan_m.weights([params[k] for k in plan_m.keys])
    r = L // 2
    dm = _step(fxm, ixm, r, ("edst", "emask", "nmask", "tdst", "tmask"))
    ke2, kt2 = ixm["eslot"].shape[1], ixm["teslot"].shape[1]
    vals = d["vals"]
    dm["vals"] = vals[:ke2] if ke2 <= U else torch.cat([vals, vals[: ke2 - U]])
    dm["g"] = d["g"][:kn2]
    dm["tg"] = _normal(3, (kt2, lh), dt, dev)
    out["merged"] = (plan_m.static, dm, wm, L, r)
    return out


def pair_calls(static, d, w, blocks, plain=False):
    """(forward, backward) of the pair step as zero-argument calls (K3/K4,
    or the plain versions); the backward reads one forward's residuals."""
    from dagnn_tpu_torch.ops import pair_step as ps
    f, b = ((ps.pair_forward_plain, ps.pair_backward_plain) if plain
            else (ps.pair_forward, ps.pair_backward))
    fargs = (static, d["xin"], d["vals"], d["ea"], d["edst"], d["emask"],
             d["nmask"], d["nsrc"], w)
    res = f(*fargs, blocks, emit_res=True)[1:]
    return (lambda: f(*fargs, blocks, emit_res=True),
            lambda: b(*fargs, d["g"], d["tg"], d["tdst"], d["tmask"], res, blocks))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    from dagnn_tpu_torch import resolve_device, roofline
    from dagnn_tpu_torch.scripts.microbench_row_kernel import calls, host_ms
    from dagnn_tpu_torch.utils.timing import timings
    dev = resolve_device("cpu" if "--cpu" in argv else "cuda")
    pm = int(os.environ.get("PAIR", "2"))
    name = "cpu" if dev.type == "cpu" else torch.cuda.get_device_name(dev)
    inp = make_inputs(pm, dev)
    st, d, w, blocks, P, i = inp["pair"]
    stm, dm, wm, L, r = inp["merged"]
    runs = {"pair": pair_calls(st, d, w, blocks), "merged": calls(stm, dm, wm)}
    costs = {"pair": roofline.kernel_costs(st, d, w, d["xin"].dtype),
             "merged": roofline.kernel_costs(stm, dm, wm, dm["xin"].dtype)}
    print(f"device: {name}; pair step {i} of {P} (PAIR={pm}, U={d['vals'].shape[0]}, "
          f"W={d['edst'].shape[0]}, T={d['tdst'].shape[0]}); merged row {r} of {L} "
          f"(Ke={dm['edst'].shape[0]}, Kt={dm['tdst'].shape[0]}): a pair step does "
          f"the work of 2 merged rows")
    out = {"pair_step": i, "P": P, "row": r, "L": L, "device": name}
    for tag, (fwd, bwd) in runs.items():
        fb, fo, bb, bo = costs[tag]
        unit = "pair" if tag == "pair" else "row"
        rec = dict(fwd_ops=fo, bwd_ops=bo,
                   fwd_bound_ms=roofline.bound_ms(fb, fo, torch.bfloat16)[0],
                   bwd_bound_ms=roofline.bound_ms(bb, bo, torch.bfloat16)[0])
        if dev.type == "cpu":
            rec.update(fwd_host_ms=host_ms(fwd), bwd_host_ms=host_ms(bwd))
            print(f"  {tag}: cpu, plain versions: fwd {rec['fwd_host_ms']:.2f} ms, "
                  f"bwd {rec['bwd_host_ms']:.2f} ms a {unit} (host clock)")
        else:
            tf, tb = timings(fwd, REPS), timings(bwd, REPS)
            rec.update(fwd_ms=tf["ms"], bwd_ms=tb["ms"], fwd_call_ms=tf["call_ms"],
                       bwd_call_ms=tb["call_ms"])
            print(f"  {tag}: fwd {tf['ms'] * 1e3:8.1f} us/{unit}  bwd "
                  f"{tb['ms'] * 1e3:8.1f} us/{unit} (CUDA graph of {REPS}); eager fwd "
                  f"{tf['call_ms'] * 1e3:8.1f} bwd {tb['call_ms'] * 1e3:8.1f} us/call; "
                  f"bounds {rec['fwd_bound_ms'] * 1e3:.2f} / "
                  f"{rec['bwd_bound_ms'] * 1e3:.2f} us")
        out[tag] = rec
    if dev.type == "cuda":
        p, m = out["pair"], out["merged"]
        print(f"  a pair step against two merged rows: fwd "
              f"{p['fwd_ms'] / (2 * m['fwd_ms']):.3f}x, bwd "
              f"{p['bwd_ms'] / (2 * m['bwd_ms']):.3f}x")
    return out


if __name__ == "__main__":
    main()

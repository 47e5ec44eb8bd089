"""Rank-side procedures that mesh.spawn runs: a data-parallel or an
edge-partitioned step on host data, returning numpy.

Each job takes the rank's device first (spawn passes it), then host
inputs: a config, the parameters as a flat dict of numpy arrays (the
port's dotted keys), collated host batches. It builds its mesh from the
default process group, moves its share of the batch to its device, and
returns a dict of numpy arrays and numbers: the loss and the raw
gradients of the step's averaged or summed reduction (rank 0's; every
rank's digest of them), the kernel launch counts of the gradient pass,
and, when asked for steps, the losses, the step times and a digest of the
parameters after them. The steps are the train steps' default form (a
CUDA graph per key over NCCL, eager over gloo: `form` in the result);
forms_job runs the captured form against the eager one. cli/dryrun.py,
cli/bench_scaling.py, chip_smoke.py and the CPU tests run them.
"""

from __future__ import annotations

import hashlib
import time

import numpy as np
import torch

from dagnn_tpu_torch.convert import flatten_tree
from dagnn_tpu_torch.ops import read_launch_counts as read_counts
from dagnn_tpu_torch.ops import reset_launch_counts as reset_counts
from dagnn_tpu_torch.parallel import comm
from dagnn_tpu_torch.parallel.dp import apply_updates
from dagnn_tpu_torch.parallel.mesh import make_hybrid_mesh, make_mesh


def _params(params_np, dev):
    return {k: torch.as_tensor(np.asarray(v)).to(dev) for k, v in params_np.items()}


def _np(tree: dict) -> dict:
    return {k: v.detach().float().cpu().numpy() for k, v in tree.items()}


def digest(tree: dict) -> str:
    """A hash of a dict of tensors' bits (key order and values): ranks
    compare it instead of sending the tensors."""
    h = hashlib.sha256()
    for k, v in tree.items():
        h.update(k.encode())
        h.update(v.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _grads_out(grads: dict, rank: int) -> dict:
    """Rank 0's gradients as numpy; every rank's digest of them."""
    return {"grads": _np(grads) if rank == 0 else None, "grads_digest": digest(grads)}


def grads_optimizer():
    """An optimizer that leaves the parameters as they are and returns
    the gradients it was given as its state: a train step's raw gradients
    (the JAX tests read theirs through such an optax transformation)."""
    from dagnn_tpu_torch.train.optim import Optimizer

    def update(grads, state):
        return {k: torch.zeros_like(g) for k, g in grads.items()}, dict(grads)

    return Optimizer(lambda params: {k: torch.zeros_like(v) for k, v in params.items()},
                     update)


def loss_of(task: str):
    """loss_head(logits, y, graph_mask) of the TOK or LP task."""
    from dagnn_tpu_torch.train.losses import class_loss, tok_loss
    if task == "tok":
        return lambda logits, y, gm: tok_loss(logits, y["y_arr"], gm)
    return lambda logits, y, gm: class_loss(logits, y["len_longest_path"], gm)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed_turns(fns, turns: int, dev) -> tuple:
    """Two functions called in turns a b b a, `turns` times: (each one's
    seconds, each one's first result). CUDA events on a card, the host
    clock on the CPU."""
    secs, firsts = [[], []], [None, None]
    for _ in range(turns):
        for i in (0, 1, 1, 0):
            if dev.type == "cuda":
                t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                t0.record()
                res = fns[i]()
                t1.record()
                t1.synchronize()
                secs[i].append(t0.elapsed_time(t1) / 1e3)
            else:
                t0 = time.perf_counter()
                res = fns[i]()
                secs[i].append(time.perf_counter() - t0)
            if firsts[i] is None:
                firsts[i] = res
    return secs, firsts


def ep_orders(step, sync_step, params, opt, inputs, turns: int, dev, first=None,
              buffers: bool = True) -> dict:
    """The overlapped EP step against the synchronous order on the same
    inputs: per order the loss, gradient digest and comm.issued counts of
    one train step (the step's gradient pass and its optimizer update,
    whose result is dropped), the seconds of each step in `turns` turns
    a b b a (step_s; the first step of each order gives the digests), and
    with buffers the digest of the forward buffers. With no turns, one
    step of each order, or for the overlapped order `first`, a (loss,
    grads, issued) the caller already has."""
    state = opt.init(params)

    def run(s):
        comm.reset_issued()
        loss, grads = s.grads(params, inputs)
        apply_updates(opt, params, grads, state)
        return float(loss), grads, dict(comm.issued)

    fns = [lambda s=s: run(s) for s in (step, sync_step)]
    if turns:
        secs, firsts = timed_turns(fns, turns, dev)
    else:
        secs, firsts = [[], []], [first or fns[0](), fns[1]()]
    res = {}
    for name, s, sec, (loss, grads, issued) in zip(("overlap", "sync"), (step, sync_step),
                                                     secs, firsts):
        res[name] = {"loss": loss, "grads_digest": digest(grads), "issued": issued,
                     "step_s": sec}
        if buffers:
            bufs = s.forward_buffers(params, inputs)
            res[name]["buffers_digest"] = digest({str(i): b for i, b in enumerate(bufs)})
    return res


def dp_loss(cfg):
    """loss_fn(params, shard, rng) of the DP step: the TOK loss of
    dagnn_forward (dropout drawn from rng when cfg.dropout is set)."""
    from dagnn_tpu_torch.nn.dagnn import dagnn_forward
    head = loss_of("tok")

    def loss_fn(p, b, rng):
        logits = dagnn_forward(p, cfg, b, rng=rng, train=cfg.dropout > 0)
        dv = logits.device
        return head(logits, {k: torch.as_tensor(v, device=dv) for k, v in b.y.items()},
                    torch.as_tensor(b.graph_mask, device=dv))

    return loss_fn


def ep_step(cfg, mesh, opt, dp_axis: bool = False, **kw):
    """make_ep_train_step with the TOK loss over the mesh's 'ep' axis (and
    its 'dp' axis with dp_axis); kw: fns, overlap, capture."""
    from dagnn_tpu_torch.parallel import edge_partition as ep
    return ep.make_ep_train_step(cfg, mesh, loss_of("tok"), opt, "ep",
                                 "dp" if dp_axis else None, **kw)


def run_forms(steps: dict, params, opt, inputs, n: int, first: bool = False,
              seeded: bool = False) -> dict:
    """`n` steps of each step of `steps` (name -> step) from the same
    weights on the same inputs, one step after the other (with seeded,
    step i draws its dropout from seed i, DPStep's seed): per name the
    loss of each step, a digest of the parameters and of the optimizer
    state after each, and the collectives its n steps issued
    (comm.issued); with first, the state after the first step as numpy.
    A captured step's state is its own buffers, so each is read before
    the next step overwrites it."""
    out = {}
    for name, step in steps.items():
        p, s = params, opt.init(params)
        comm.reset_issued()
        res = {"losses": [], "params": [], "state": []}
        for i in range(n):
            p, s, loss = step(p, s, inputs, **({"seed": i} if seeded else {}))
            res["losses"].append(float(loss))
            res["params"].append(digest(p))
            res["state"].append(digest(flatten_tree(s)))
            if first and i == 0:
                res["first_state"] = _np(flatten_tree(s))
        res["issued"] = dict(comm.issued)
        out[name] = res
    return out


def forms_job(dev, kind: str, cfg, params_np, batch, mesh_shape=None, steps: int = 3,
              optimizer: str = "adam"):
    """A train step's captured form against its eager form on this rank:
    run_forms over `steps` steps from the same weights. kind "dp":
    make_dp_train_step's DPStep over every rank on its shard of the
    stacked host batch `batch`; kind "ep": make_ep_train_step's EPStep on
    the (1, D) mesh `mesh_shape` over one host batch, in both orders
    ("captured" / "eager" overlapped, "captured sync" / "eager sync"),
    then the captured step once more on the same arrays with every row
    waiting before its gather (other read_rows: a key of its own). The
    captured form is the step built with capture=True: over NCCL a CUDA
    graph per key; on CPU ranks over gloo the staging alone (CapturedStep
    on CPU tensors captures nothing), the CPU tests' view of it.
    optimizer "grads" (grads_optimizer): each step's state is its raw
    gradients, and rank 0's of the first captured step come back."""
    from dagnn_tpu_torch.nn.aggregators import SEG_KERNELS
    from dagnn_tpu_torch.parallel import edge_partition as ep
    from dagnn_tpu_torch.parallel.dp import DPStep
    from dagnn_tpu_torch.train.optim import make_optimizer
    opt = grads_optimizer() if optimizer == "grads" else make_optimizer()
    params = _params(params_np, dev)
    if kind == "dp":
        mesh = make_mesh(None, ("dp",))
        group = mesh.groups["dp"]
        todo = {f: DPStep(dp_loss(cfg), opt, group, capture=f == "captured")
                for f in ("captured", "eager")}
        inputs = todo["eager"].shard(batch, dev)
    else:
        mesh = make_hybrid_mesh(*mesh_shape)
        group = mesh.groups["ep"]
        todo = {f"{f}{'' if o else ' sync'}": ep.EPStep(
                    cfg, mesh, loss_of("tok"), opt, "ep", None, SEG_KERNELS, o,
                    capture=f == "captured")
                for o in (True, False) for f in ("captured", "eager")}
        plans, _, _ = ep_plans(batch, mesh_shape[1])
        inputs = todo["eager"].shard(batch, plans,
                                     ep.ep_readout_aux(batch, [e for e, _ in plans], cfg),
                                     dev)
    rank = comm.rank(mesh.group)
    runs = run_forms(todo, params, opt, inputs, steps, first=optimizer == "grads",
                     seeded=kind == "dp")
    cap = todo["captured"]
    out = {"forms": runs, "form": cap.form, "eager_form": todo["eager"].form,
           "route": comm.route(group), "rank": rank}
    if kind == "ep":
        out["read_rows"] = [int(r.sum()) for r in inputs.wait_rows()]
        out["rows"] = [st.rows for st in inputs.statics]
        every = inputs._replace(read_rows=tuple(np.ones(st.rows, bool).tobytes()
                                                for st in inputs.statics))
        before = cap.captured.captures
        cap(params, opt.init(params), every)
        out["new_rows_captures"] = cap.captured.captures - before
        out["keys_differ"] = cap.key(every) != cap.key(inputs)
    out.update(captures=cap.captured.captures, replays=cap.captured.replays)
    for name, r in runs.items():
        first = r.pop("first_state", None)
        if first is not None and name == "captured" and rank == 0:
            out["raw"] = {"loss": r["losses"][0], "grads": first}
    return out


def _run_steps(step, params, opt, inputs, steps, dev):
    """`steps` optimizer steps; (params, losses, seconds of each step)."""
    state, losses, secs = opt.init(params), [], []
    for _ in range(steps):
        _sync(dev)
        t0 = time.perf_counter()
        params, state, loss = step(params, state, inputs)
        _sync(dev)
        secs.append(time.perf_counter() - t0)
        losses.append(float(loss))
    return params, losses, secs


def dp_job(dev, cfg, params_np, stacked, steps: int = 0):
    """make_dp_train_step (the TOK loss, the drivers' Adam) over every
    rank, on this rank's shard of the stacked host batch: the averaged
    (loss, grads) and the launches of that pass (eager); then `steps`
    steps of the step's default form."""
    from dagnn_tpu_torch.parallel.dp import make_dp_train_step
    from dagnn_tpu_torch.train.optim import make_optimizer
    mesh = make_mesh(None, ("dp",))
    opt = make_optimizer()
    step = make_dp_train_step(dp_loss(cfg), opt, mesh.groups["dp"])
    batch = step.shard(stacked, dev)
    params = _params(params_np, dev)
    reset_counts()
    loss, grads = step.grads(params, batch)
    _sync(dev)
    rank = comm.rank(mesh.group)
    out = {"loss": float(loss), **_grads_out(grads, rank), "counts": read_counts(),
           "rows": int(batch.fwd.node_ids.shape[0]), "rank": rank,
           "route": comm.route(mesh.groups["dp"]), "form": step.form}
    if steps:
        params, out["losses"], out["step_s"] = _run_steps(
            step, params, opt, batch, steps, dev)
        out["params_digest"] = digest(params)
    return out


def ep_plans(batch, n_ep: int):
    """Both directions' sharded-state plans of a host batch, with the
    seconds they took and those of the deferred entries' greedy stage-row
    loop among them."""
    from dagnn_tpu_torch.parallel import edge_partition as ep
    times = {"stage_rows_s": 0.0}
    t0 = time.perf_counter()
    plans = (ep.partition_schedule_sharded(batch.fwd, n_ep, times=times),
             ep.partition_schedule_sharded(batch.rev, n_ep, times=times))
    return plans, time.perf_counter() - t0, times["stage_rows_s"]


def ep_job(dev, cfg, params_np, batches, mesh_shape, dp_axis: bool = False,
           steps: int = 0, probe: bool = False, orders: bool = False, turns: int = 0):
    """make_ep_train_step on the (dp, ep) mesh `mesh_shape`: dp group i
    trains batches[i] (one host batch for every group when dp_axis is
    False: then each dp group is an independent copy of one ep run and
    nothing is averaged over dp), edge-partitioned over ep. Returns the
    (loss, grads) of the step's reduction (the TOK loss, the drivers'
    Adam), the launches of that pass, the plan's seconds and wire
    accounting, the collectives it issued by route and each direction's
    rows that wait for the deferred exchange before their gather. With
    probe, one more pass through a checks.KernelProbe holds every K6 / K5
    call of the rank against its plain version (after the launches are
    read); with orders, the synchronous order against the overlapped one
    (ep_orders, `turns` timed turns); then `steps` steps."""
    from dagnn_tpu_torch.checks import KernelProbe
    from dagnn_tpu_torch.parallel import edge_partition as ep
    from dagnn_tpu_torch.train.optim import make_optimizer
    n_dp, n_ep = mesh_shape
    mesh = make_hybrid_mesh(n_dp, n_ep)
    batch = batches[mesh.coords["dp"]] if dp_axis else batches[0]
    plans, plan_s, greedy_s = ep_plans(batch, n_ep)
    aux = ep.ep_readout_aux(batch, [e for e, _ in plans], cfg)
    opt = make_optimizer()
    step = ep_step(cfg, mesh, opt, dp_axis)
    inputs = step.shard(batch, plans, aux, dev)
    params = _params(params_np, dev)
    reset_counts()
    comm.reset_issued()
    loss, grads = step.grads(params, inputs)
    _sync(dev)
    eps_f, st_f = plans[0]
    rank = comm.rank(mesh.group)
    out = {"loss": float(loss), **_grads_out(grads, rank), "counts": read_counts(),
           "rows": [st.rows for _, st in plans], "plan_s": plan_s,
           "greedy_s": greedy_s, "deferred": int(eps_f.d_send_mask.sum()),
           "wire": ep.ep_wire_stats(eps_f, cfg.hidden_dim,
                                    2 if cfg.compute_dtype == "bfloat16" else 4),
           "statics": [dict(vars(st)) for _, st in plans],
           "issued": dict(comm.issued),
           "read_rows": [int(r.sum()) for r in inputs.wait_rows()],
           "route": comm.route(mesh.groups["ep"]), "rank": rank, "form": step.form}
    if probe:
        kp = KernelProbe()
        _, pg = ep_step(cfg, mesh, opt, dp_axis, fns=kp.impl()).grads(params, inputs)
        out["probe"] = {**kp.report(), "grads_digest": digest(pg)}
    if orders:
        sync_step = ep_step(cfg, mesh, opt, dp_axis, overlap=False)
        out["orders"] = ep_orders(step, sync_step, params, opt, inputs, turns, dev,
                                  first=(out["loss"], grads, out["issued"]))
    if steps:
        params, out["losses"], out["step_s"] = _run_steps(
            step, params, opt, inputs, steps, dev)
        out["params_digest"] = digest(params)
    return out


def ep_forward_job(dev, cfg, params_np, batch, mesh_shape):
    """Scheme 1 (replicated states) over the 'ep' groups of the (dp, ep)
    mesh `mesh_shape` (each dp group a copy): direction 0's node states
    [nl, N+1, H] of the host batch."""
    from dagnn_tpu_torch.nn.dagnn import _encode
    from dagnn_tpu_torch.parallel import edge_partition as ep
    mesh = make_hybrid_mesh(*mesh_shape)
    params = _params(params_np, dev)
    fwd = ep.make_ep_forward(cfg, mesh.groups["ep"])
    with torch.no_grad():
        x = _encode(params, cfg, batch, dev)
        h = fwd(params, x, batch.edge_attr,
                ep.partition_schedule(batch.fwd, mesh_shape[1]))
    return {"states": h.float().cpu().numpy(), "route": comm.route(mesh.groups["ep"])}


def mesh_probe_job(dev, mesh_shape):
    """The (dp, ep) mesh's coordinates and its collectives on small
    tensors: a sum over ep and a gather over dp of x = rank + 1 with their
    backward through 3 * sum + <gathered, (1, 10)>, and an exchange of
    per-peer bf16 blocks [1, Dp, 3, 1] holding 10 * rank + j."""
    mesh = make_hybrid_mesh(*mesh_shape)
    me = torch.distributed.get_rank()
    x = torch.tensor([float(me + 1)], device=dev, requires_grad=True)
    s = comm.sum_over_ranks(x * 1.0, mesh.groups["ep"])
    gathered = comm.gather_over_ranks(x * 1.0, mesh.groups["dp"])
    w = torch.tensor([[1.0], [10.0]], device=dev)[:mesh_shape[0]]
    (s * 3.0 + (gathered * w).sum()).backward()
    n_ep = mesh_shape[1]
    blk = (torch.arange(n_ep * 3, device=dev, dtype=torch.float32).reshape(1, n_ep, 3, 1)
           % 3 + 10 * me).to(torch.bfloat16)
    return {"coords": mesh.coords, "sum": float(s), "grad": float(x.grad),
            "gathered": gathered.detach().reshape(-1).tolist(),
            "exchange": comm.exchange(blk, mesh.groups["ep"]).float().reshape(-1).tolist(),
            "route": comm.route(mesh.groups["ep"])}


def run_jobs(dev, jobs):
    """Several jobs in one process group, in order: [(fn, kwargs), ...]."""
    return [fn(dev, **kw) for fn, kw in jobs]

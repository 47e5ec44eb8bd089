"""Edge-partitioned wavefront execution across ranks.

Counterpart of dagnn_tpu/parallel/edge_partition.py: ONE batched DAG's
edge set split across D ranks of an 'ep' group, so a batch larger than a
card, or one latency-critical batch, runs on several. The host planners
(partition_schedule, partition_schedule_sharded and their helpers,
EPSchedule, EPStatic, ep_widths_of, ep_wire_stats, ep_readout_aux) are
copies of the JAX package's, array for array; what runs on the ranks is
torch over torch.distributed (parallel/comm.py) where JAX has shard_map:

1. `partition_schedule` + `make_ep_forward`: replicated states, sharded
   work. Every rank holds the whole state buffer; per row it runs its
   w = Kn/D slots (nn/dagnn._step_outs, the generic branch: on the card
   K6 for the attention kinds) and all_gathers the row. Forward only, the
   cross-check path.

2. `partition_schedule_sharded` + `ep_node_states` / `make_ep_train_step`:
   SHARDED states + halo. Rank d owns a contiguous w-slot slice of every
   row; its buffer [R*w own | Hs halo | 1 garbage] holds its own slices
   and the remote slots its edges read. Per row (_EPPlan.forward): the
   row's outputs; the URGENT (span-1) entries exchanged; the DEFERRED
   entries staged one row earlier delivered through the recv plan shifted
   by one row; the next deferred block staged from the buffer and its
   exchange issued (comm.exchange_async), so it runs under the next row's
   compute. Where a row reads a deferred entry at the row it is delivered
   (deferred_reads: the planner may stage an entry at the row just before
   its first reader), that row waits for the exchange before its gather
   instead. Each exchange is an all_to_all of per-peer blocks. The
   backward (_EPWavefront, write-once replay: only the final buffer is
   kept) walks the rows in reverse, replays each row under
   torch.autograd.grad, and does the three segment sums of the JAX
   backward's one-hot einsums (which existed for the TPU's MXU) with K5
   (ops/row_step.tg_accumulate: own-source edges into own columns,
   remote-source edges into halo blocks, returned blocks into own
   columns), then returns the halo grads over the mirrored plan.

Gradients: the loss is replicated over 'ep' (every rank pools through a
collective and runs the head). Each rank backpropagates its 1/D share of
it; the pooling collectives' backward sums the cotangents over the ranks
(comm.sum_over_ranks, gather_over_ranks); so the gradients summed over
'ep' are the single-device gradient. (The JAX step psums the gradients of
the whole loss on top of shard_map's transposes, which makes every leaf
D times the single-device gradient; Adam's update does not see a
constant scale, the gradient norm does.)

The train step's inputs (EPInputs) are its device arrays (EPArrays: the
batch's, its plan shard's and its readout indices, which a captured step
stages into its buffers) and the host values the row loop bakes into its
launches and collectives (each direction's EPStatic and the rows that
wait first), which with the order key the step's CUDA graph over NCCL
(EPStep.key; JAX jits the step for its statics). Over gloo the step runs
eager (parallel/comm.py capture_rule).

Every rank issues the same collectives in the same order: the static
flags (EPStatic.has_urgent, has_deferred), the rows that wait before
their gather and the block widths come from the whole plan, which every
rank builds from the same batch. The padding
entries of a halo write all land on the garbage row with zero values, so
an index write that repeats an index stays deterministic.
"""

from __future__ import annotations

import dataclasses
import time
from contextlib import nullcontext
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from dagnn_tpu_torch import convert
from dagnn_tpu_torch.convert import unflatten_tree
from dagnn_tpu_torch.dag.batch import DAGBatch
from dagnn_tpu_torch.dag.schedule import LevelSchedule
from dagnn_tpu_torch.nn.aggregators import SEG_KERNELS, AggImpl
from dagnn_tpu_torch.nn.dagnn import (_DTYPES, DAGNNConfig, _apply_head,
                                      _dir_keys, _step_outs)
from dagnn_tpu_torch.nn.encoders import encode
from dagnn_tpu_torch.nn.readout import pool_nodes
from dagnn_tpu_torch.ops import segment
from dagnn_tpu_torch.parallel import comm
from dagnn_tpu_torch.parallel.dp import apply_updates, reduce_flat
from dagnn_tpu_torch.train import graphs


# ======================================================================
# Scheme 1: replicated states (cross-check path, forward only)
# ======================================================================

def partition_schedule(sched: LevelSchedule, n_dev: int) -> LevelSchedule:
    """Re-chunk a schedule for D-way edge partitioning.

    Returns a schedule pytree whose per-row arrays carry a leading device
    axis: node_ids [D, R, w], edge_* [D, R, Ke_d]. Edges are grouped by the
    device owning their target slot (edge_dst // w); per-device edge rows
    are padded to the max across devices.
    """
    R, Kn = sched.node_ids.shape
    if Kn % n_dev != 0:
        raise ValueError(f"row width {Kn} not divisible by {n_dev} devices")
    w = Kn // n_dev
    Ke = sched.edge_src.shape[1]

    node_ids = sched.node_ids.reshape(R, n_dev, w).transpose(1, 0, 2)
    node_mask = sched.node_mask.reshape(R, n_dev, w).transpose(1, 0, 2)

    rr, kk, dev, pos, ke_d = _group_edges_by_device(sched, w, n_dev)

    flat_pad = R * Kn
    e_src = np.full((n_dev, R, ke_d), _node_pad(sched), np.int32)
    e_slot = np.full((n_dev, R, ke_d), flat_pad, np.int32)
    e_dst = np.full((n_dev, R, ke_d), w, np.int32)
    e_id = np.full((n_dev, R, ke_d), _edge_pad(sched), np.int32)
    e_mask = np.zeros((n_dev, R, ke_d), bool)
    e_src[dev, rr, pos] = sched.edge_src[rr, kk]
    e_slot[dev, rr, pos] = sched.edge_src_slot[rr, kk]
    e_dst[dev, rr, pos] = sched.edge_dst[rr, kk] - dev * w  # device-local
    e_id[dev, rr, pos] = sched.edge_id[rr, kk]
    e_mask[dev, rr, pos] = True

    return LevelSchedule(
        node_ids=node_ids, node_mask=node_mask,
        edge_src=e_src, edge_src_slot=e_slot, edge_dst=e_dst,
        edge_id=e_id, edge_mask=e_mask,
        # tiled so every leaf carries the leading device axis
        node_slot=np.tile(sched.node_slot[None], (n_dev, 1)),
        num_levels=np.tile(np.asarray(sched.num_levels)[None], (n_dev,)),
    )


def _group_edges_by_device(sched: LevelSchedule, w: int, n_dev: int,
                           min_ke: int = 1):
    """Vectorized (row, slot) -> (device, row, position) edge regrouping.

    Returns (rr, kk, dev, pos, ke_d): for every real edge at [rr, kk] of
    the base schedule, the owning device of its target (edge_dst // w) and
    its rank within that device's row-r list; ke_d is the padded width.
    """
    R = sched.node_ids.shape[0]
    rr, kk = np.nonzero(sched.edge_mask)
    dev = (sched.edge_dst[rr, kk] // w).astype(np.int64)
    key = dev * R + rr
    order = np.lexsort((kk, key))
    rr, kk, dev, key = rr[order], kk[order], dev[order], key[order]
    counts = np.bincount(key, minlength=n_dev * R)
    ke_d = max(int(counts.max()) if counts.size else 0, min_ke)
    starts = np.zeros(n_dev * R + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    pos = np.arange(len(rr)) - starts[key]
    return rr, kk, dev, pos, ke_d


def _node_pad(sched: LevelSchedule) -> int:
    return int(sched.node_slot.shape[0] - 1)


def _edge_pad(sched: LevelSchedule) -> int:
    return int(sched.edge_id.max(initial=0))


def _params_dir(keys, values, dt):
    """One direction's {"aggr": [...], "cells": [...]} from its dotted keys
    (nn/dagnn._dir_keys) and tensors, cast to the compute dtype inside the
    graph, so weight grads come back in float32."""
    return unflatten_tree({".".join(k.split(".")[:1] + k.split(".")[2:]): v.to(dt)
                           for k, v in zip(keys, values)})


def ep_direction_pass(params, cfg: DAGNNConfig, x, edge_attr,
                      psched: LevelSchedule, group, d: int = 0,
                      fns: AggImpl = SEG_KERNELS):
    """Rank-local wavefront pass of direction d (replicated-state scheme).
    psched holds this rank's shard (partition_schedule's leading axis
    indexed away), x [N+1, emb] and params are replicated. Returns the
    node-space states [num_layers, N+1, H] like the single-device pass."""
    dev, dt = x.device, _DTYPES[cfg.compute_dtype]
    t = lambda a: torch.as_tensor(a, device=dev)
    D = comm.size(group)
    R, w = psched.node_ids.shape
    kn, nl, H = w * D, cfg.num_layers, cfg.hidden_dim
    xd = x.to(dt)
    node_ids = t(psched.node_ids).long()
    fxs = {"x": xd[node_ids]}
    if cfg.w_edge_attr and edge_attr is not None and cfg.num_rels > 1:
        fxs["ea"] = t(edge_attr)[t(psched.edge_id).long()].to(dt)
    if cfg.agg_x or cfg.agg_attn_x:
        fxs["xsrc"] = xd[t(psched.edge_src).long()]
    if cfg.vid_dim > 0:
        vids = torch.nn.functional.one_hot(
            torch.arange(x.shape[0], device=dev) % cfg.vid_dim, cfg.vid_dim).to(dt)
        fxs["vsrc"] = vids[t(psched.edge_src).long()]
        fxs["vnode"] = vids[node_ids]
    ixs = {"eslot": t(psched.edge_src_slot).long(),
           "edst": t(psched.edge_dst).to(torch.int32),
           "nmask": t(psched.node_mask).to(torch.float32),
           "emask": t(psched.edge_mask).to(torch.float32)}
    keys = _dir_keys(params, d)
    pdir = _params_dir(keys, [params[k] for k in keys], dt)
    specs = [cfg.aggregator_spec(l) for l in range(nl)]
    h = torch.zeros((nl, R * kn + 1, H), dtype=dt, device=dev)
    for r in range(R):
        vals = None if cfg.agg_x else h[:, ixs["eslot"][r]]
        outs = _step_outs(cfg, pdir, specs, vals,
                          {k: v[r] for k, v in fxs.items()},
                          {k: v[r] for k, v in ixs.items()}, fns)   # [nl, w, H]
        # boundary exchange: every rank's slice of this row
        full = comm.all_gather_stack(outs, group)                     # [D, nl, w, H]
        h[:, r * kn:(r + 1) * kn] = full.movedim(0, 1).reshape(nl, kn, H)
    return h[:, t(psched.node_slot).long()]


def make_ep_forward(cfg: DAGNNConfig, group, fns: AggImpl = SEG_KERNELS):
    """The edge-partitioned node-states function (replicated-state scheme,
    the cross-check path): fwd(params, x, edge_attr, psched) takes
    partition_schedule's output (leading device axis; this rank takes its
    own shard) and returns direction 0's [num_layers, N+1, H]."""
    def fwd(params, x, edge_attr, psched):
        local = LevelSchedule(*[None if a is None else np.asarray(a)[comm.rank(group)]
                                for a in psched])
        return ep_direction_pass(params, cfg, x, edge_attr, local, group, 0, fns)

    return fwd


# ======================================================================
# Scheme 2: SHARDED states + halo (training path)
# ======================================================================

class EPSchedule(NamedTuple):
    """Per-direction sharded-state execution plan (arrays only — a pure
    pytree; static sizes travel in EPStatic). Leading device axis [D, ...]
    on every array; each rank takes its own shard (ep_local).

    Sizes: R rows, w = Kn/D own slots/row, Ke_d edges/row/device, Hs halo
    slots/device, Kt_d transpose width, Dp = mesh-axis size, B* exchange
    block widths.

    Local state buffer layout per device: [R*w own | Hs halo | 1 garbage].

    Exchange plans are ALIGNED pairs: the block device d sends to peer p at
    row r (gathered by `*_send_col[d, r, p]` from d's own row outputs) is
    written by p at halo indices `*_recv_hidx[p, r, d]` — both sides are
    filled from the same host-sorted entry list, so position j on the send
    side is position j on the receive side. `u_*` covers URGENT entries
    (first read exactly one row after their source row — exchanged
    synchronously), `d_*` covers DEFERRED entries (first read >= 2 rows
    later — staged at a row between their source row and the one before
    their first reader, delivered one row after it; the collective runs
    under the delivery row's compute unless that row reads the entry,
    deferred_reads). The
    full plan `x_*` (urgent + deferred) drives the backward's mirrored
    grad return. `d_recv_*` arrays are PRE-SHIFTED by one row (row r holds
    row r-1's plan) so the scan consumes them with its own row index.
    """

    node_ids: np.ndarray       # [D, R, w] global node id of own slots
    node_mask: np.ndarray      # [D, R, w]
    e_src_lslot: np.ndarray    # [D, R, Ke_d] LOCAL buffer index of source
    e_dst: np.ndarray          # [D, R, Ke_d] own-local target slot in [0, w]
    e_id: np.ndarray           # [D, R, Ke_d] original edge id (ea gather)
    e_mask: np.ndarray         # [D, R, Ke_d]
    # full exchange plan (backward grad return; Bf wide)
    x_send_col: np.ndarray     # [D, R, Dp, Bf] own col in [0,w) (pad 0)
    x_send_mask: np.ndarray    # [D, R, Dp, Bf]
    x_recv_hidx: np.ndarray    # [D, R, Dp, Bf] halo index (pad Hs)
    # urgent subset (span-1, synchronous; Bu wide)
    u_send_col: np.ndarray     # [D, R, Dp, Bu]
    u_send_mask: np.ndarray    # [D, R, Dp, Bu]
    u_recv_hidx: np.ndarray    # [D, R, Dp, Bu]
    # deferred subset (span>=2, pipelined; Bd wide; recv side shifted +1)
    d_send_col: np.ndarray     # [D, R, Dp, Bd] FLAT own idx (pad garbage)
    d_send_mask: np.ndarray    # [D, R, Dp, Bd]
    d_recv_hidx: np.ndarray    # [D, R, Dp, Bd] row r holds row r-1's plan
    d_recv_mask: np.ndarray    # [D, R, Dp, Bd]
    # transpose plan (edges grouped by SOURCE row, for the backward)
    t_eslot: np.ndarray        # [D, R, Kt_d] flat edge slot (r*Ke_d+k)
    t_lcol: np.ndarray         # [D, R, Kt_d] own-local source col, w if remote/pad
    t_blk: np.ndarray          # [D, R, Kt_d] p*Bf+j into the full plan, Dp*Bf if own/pad
    t_mask: np.ndarray         # [D, R, Kt_d]


@dataclasses.dataclass(frozen=True)
class EPStatic:
    rows: int
    own_w: int
    halo: int
    has_urgent: bool = True
    has_deferred: bool = True


def _fill_plan(entries, n_dev, R, Dp, B, Hs, col_pad=0):
    """Fill aligned send/recv plan arrays from a flat entry table.

    entries: dict of 1-D arrays {recv_d, send_d, row, col, hidx} — one
    element per (receiver, halo-entry) exchanged at `row` (the source
    row on the send side; for the REBALANCED deferred plan `row` is the
    stage row and `col` a flat own-buffer index — see
    partition_schedule_sharded). Returns (send_col, send_mask, recv_hidx,
    recv_mask, blk_of_entry) where blk_of_entry[i] = peer*B + j is entry
    i's position in the RECEIVER's block layout.
    """
    send_col = np.full((n_dev, R, Dp, B), col_pad, np.int32)
    send_mask = np.zeros((n_dev, R, Dp, B), bool)
    recv_hidx = np.full((n_dev, R, Dp, B), Hs, np.int32)
    recv_mask = np.zeros((n_dev, R, Dp, B), bool)
    rd, sd, row, col, hidx = (entries[k] for k in
                              ("recv_d", "send_d", "row", "col", "hidx"))
    # canonical order: group by (sender, row, receiver), sort by col
    key = (sd * R + row) * n_dev + rd
    order = np.lexsort((col, key))
    rd, sd, row, col, hidx = (a[order] for a in (rd, sd, row, col, hidx))
    key = key[order]
    counts = np.bincount(key, minlength=n_dev * R * n_dev)
    starts = np.zeros(counts.size + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    j = np.arange(len(rd)) - starts[key]
    if len(rd) and int(j.max()) >= B:
        raise ValueError(f"exchange block {int(j.max()) + 1} > width {B}")
    send_col[sd, row, rd, j] = col
    send_mask[sd, row, rd, j] = True
    recv_hidx[rd, row, sd, j] = hidx
    recv_mask[rd, row, sd, j] = True
    blk = np.empty(len(rd), np.int64)
    blk[:] = sd * B + j
    inv = np.empty(len(order), np.int64)
    inv[order] = np.arange(len(order))
    return send_col, send_mask, recv_hidx, recv_mask, blk[inv]


def _stage_rows(defer, e_arr, n_dev, R):
    """The deferred entries' stage rows (partition_schedule_sharded): for
    each entry, the least-loaded row of its (sender, receiver) pair within
    [its source row, its last stage row e_arr], taken in order of pair,
    deadline and source row. One Python iteration an entry."""
    q_arr = defer["row"].copy()
    if len(q_arr):
        pair_key = defer["send_d"] * n_dev + defer["recv_d"]
        order = np.lexsort((defer["row"], e_arr, pair_key))
        loads = np.zeros((n_dev * n_dev, R), np.int64)
        for i in order:
            p, s0, e0 = int(pair_key[i]), int(defer["row"][i]), int(e_arr[i])
            win = loads[p, s0:e0 + 1]
            q = s0 + int(np.argmin(win))
            q_arr[i] = q
            loads[p, q] += 1
    return q_arr


def partition_schedule_sharded(
        sched: LevelSchedule, n_dev: int, widths: Optional[dict] = None,
        times: Optional[dict] = None) -> Tuple[EPSchedule, EPStatic]:
    """Build the sharded-state plan from a base LevelSchedule.

    Fully vectorized (lexsort/bincount passes — no per-(device, row)
    Python loops; a bench-sized batch plans in tens of milliseconds).

    widths: optional static width targets {"ke_d", "halo", "kt", "bf",
    "bu", "bd"} so different batches compile to one program (analog of
    PadConfig); each defaults to this schedule's exact maximum.

    times: optional dict; its "stage_rows_s" gains the seconds of the
    deferred entries' greedy stage-row loop (_stage_rows)."""
    widths = widths or {}
    R, Kn = sched.node_ids.shape
    if Kn % n_dev != 0:
        raise ValueError(f"row width {Kn} not divisible by {n_dev} devices")
    w = Kn // n_dev
    flat_pad_g = R * Kn

    # --- per-device edge lists grouped by row (targets owned by d) ---
    rr, kk, dev, pos, ke_d = _group_edges_by_device(sched, w, n_dev)
    ke_d = max(ke_d, widths.get("ke_d", 0))
    if ke_d > widths.get("ke_d", ke_d):
        raise ValueError(f"ke_d {ke_d} exceeds width target")

    e_src_g = np.full((n_dev, R, ke_d), flat_pad_g, np.int64)  # global src slot
    e_dst = np.full((n_dev, R, ke_d), w, np.int32)
    e_id = np.full((n_dev, R, ke_d), _edge_pad(sched), np.int32)
    e_mask = np.zeros((n_dev, R, ke_d), bool)
    e_src_g[dev, rr, pos] = sched.edge_src_slot[rr, kk]
    e_dst[dev, rr, pos] = sched.edge_dst[rr, kk] - dev * w
    e_id[dev, rr, pos] = sched.edge_id[rr, kk]
    e_mask[dev, rr, pos] = True

    # --- halo: unique remote source slots each device reads, and the
    # first row that reads each (urgent/deferred classification) ---
    src_g = sched.edge_src_slot[rr, kk].astype(np.int64)   # per real edge
    src_col = src_g % Kn
    remote = (src_col // w != dev) & (src_g < flat_pad_g)
    pair = dev[remote] * (flat_pad_g + 1) + src_g[remote]  # (reader dev, slot)
    upair, uinv = np.unique(pair, return_inverse=True)
    first_use = np.full(len(upair), R, np.int64)
    np.minimum.at(first_use, uinv, rr[remote])             # reader's row
    h_dev = upair // (flat_pad_g + 1)
    h_slot = upair % (flat_pad_g + 1)
    h_row = h_slot // Kn                                    # source row
    h_col = h_slot % Kn
    h_cnt = np.bincount(h_dev, minlength=n_dev)
    Hs = max(int(h_cnt.max()) if len(h_cnt) else 0, 1, widths.get("halo", 0))
    if int(h_cnt.max() if len(h_cnt) else 0) > Hs:
        raise ValueError("halo exceeds width target")
    h_starts = np.zeros(n_dev + 1, np.int64)
    np.cumsum(h_cnt, out=h_starts[1:])
    h_idx = np.arange(len(upair)) - h_starts[h_dev]        # halo index per entry

    # --- remap global source slots to local buffer indices ---
    garbage = R * w + Hs
    lut = np.full((n_dev, flat_pad_g + 1), garbage, np.int64)
    own_g = (np.arange(R)[:, None] * Kn + np.arange(w)[None, :])  # [R, w]
    for d in range(n_dev):                    # D iterations, vector body
        lut[d, (own_g + d * w).ravel()] = np.arange(R * w)
    lut[h_dev, h_slot] = R * w + h_idx
    e_src_l = np.take_along_axis(
        lut, e_src_g.reshape(n_dev, -1), axis=1).reshape(
            n_dev, R, ke_d).astype(np.int32)

    # --- exchange plans: full / urgent (span 1) / deferred (span >= 2) ---
    ent = dict(recv_d=h_dev, send_d=h_col // w, row=h_row, col=h_col % w,
               hidx=h_idx)
    span1 = first_use <= h_row + 1
    sel = lambda m: {k: v[m] for k, v in ent.items()}
    bw = lambda e, floor: max(
        int(np.bincount(((e["send_d"] * R + e["row"]) * n_dev
                         + e["recv_d"]),
                        minlength=1).max()) if len(e["row"]) else 0, floor)
    Bf = max(bw(ent, 1), widths.get("bf", 0))
    Bu = max(bw(sel(span1), 1), widths.get("bu", 0))
    x_sc, x_sm, x_rh, _, blk_full = _fill_plan(ent, n_dev, R, n_dev, Bf, Hs)
    u_sc, u_sm, u_rh, _, _ = _fill_plan(sel(span1), n_dev, R, n_dev, Bu, Hs)

    # DEFERRED plan, rebalanced: an entry produced at row s and first read
    # at row f >= s+2 may be exchanged at ANY stage row q in [s, f-1]
    # (staged from the state buffer by flat own index, delivered at q+1
    # <= f before the reader's gather). Spreading entries over their
    # windows levels the per-(pair, row) block counts, so Bd tracks the
    # MEAN load instead of the max — the previous source-row-only plan
    # padded blocks ~14x the real payload on the bench batch. Greedy:
    # earliest deadline first, least-loaded feasible row.
    defer = sel(~span1)
    d_flat = defer["row"] * w + defer["col"]               # flat own index
    t0 = time.perf_counter()
    q_arr = _stage_rows(defer, first_use[~span1] - 1, n_dev, R)
    if times is not None:
        times["stage_rows_s"] = times.get("stage_rows_s", 0.0) + time.perf_counter() - t0
    defer = dict(defer, row=q_arr, col=d_flat)
    Bd = max(bw(defer, 1), widths.get("bd", 0))
    d_sc, d_sm, d_rh0, d_rm0, _ = _fill_plan(defer, n_dev, R, n_dev,
                                             Bd, Hs, col_pad=garbage)
    # recv side of the deferred plan shifted one row later (pipelined)
    d_rh = np.concatenate([np.full_like(d_rh0[:, :1], Hs), d_rh0[:, :-1]], 1)
    d_rm = np.concatenate([np.zeros_like(d_rm0[:, :1]), d_rm0[:, :-1]], 1)

    # --- transpose plan: this device's edges grouped by SOURCE ROW ---
    # blk position of each remote edge's halo entry in the full plan
    blk_lut = np.full((n_dev, Hs), n_dev * Bf, np.int64)
    blk_lut[h_dev, h_idx] = blk_full
    erow = np.repeat(np.arange(R)[None, :], n_dev, 0)[..., None]  # [D,R,1]
    src_row_e = np.where(e_mask, e_src_g // Kn, R).astype(np.int64)
    src_col_e = np.where(e_mask, e_src_g % Kn, 0).astype(np.int64)
    own_e = e_mask & (src_col_e // w == np.arange(n_dev)[:, None, None])
    dd, tr, tk = np.nonzero(e_mask)
    srow = src_row_e[dd, tr, tk]
    scol = src_col_e[dd, tr, tk]
    fslot = tr * ke_d + tk
    own_f = own_e[dd, tr, tk]
    # local col for own sources; block position for remote ones
    lcol = np.where(own_f, scol - dd * w, w)
    hloc = lut[dd, np.where(own_f, 0, e_src_g[dd, tr, tk])] - R * w
    blk = np.where(own_f, n_dev * Bf,
                   blk_lut[dd, np.clip(hloc, 0, Hs - 1)])
    key = dd * R + srow
    order = np.lexsort((fslot, scol, key))
    dd, srow, lcol, blk, fslot = (a[order] for a in
                                  (dd, srow, lcol, blk, fslot))
    key = key[order]
    counts = np.bincount(key, minlength=n_dev * R)
    kt = max(int(counts.max()) if counts.size else 0, 1,
             widths.get("kt", 0))
    starts = np.zeros(counts.size + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    tpos = np.arange(len(dd)) - starts[key]
    eflat_pad = R * ke_d
    t_eslot = np.full((n_dev, R, kt), eflat_pad, np.int32)
    t_lcol = np.full((n_dev, R, kt), w, np.int32)
    t_blk = np.full((n_dev, R, kt), n_dev * Bf, np.int32)
    t_mask = np.zeros((n_dev, R, kt), bool)
    t_eslot[dd, srow, tpos] = fslot
    t_lcol[dd, srow, tpos] = lcol
    t_blk[dd, srow, tpos] = blk
    t_mask[dd, srow, tpos] = True

    node_ids = sched.node_ids.reshape(R, n_dev, w).transpose(1, 0, 2)
    node_mask = sched.node_mask.reshape(R, n_dev, w).transpose(1, 0, 2)
    eps = EPSchedule(
        node_ids=node_ids.astype(np.int32), node_mask=node_mask,
        e_src_lslot=e_src_l, e_dst=e_dst, e_id=e_id, e_mask=e_mask,
        x_send_col=x_sc, x_send_mask=x_sm, x_recv_hidx=x_rh,
        u_send_col=u_sc, u_send_mask=u_sm, u_recv_hidx=u_rh,
        d_send_col=d_sc, d_send_mask=d_sm, d_recv_hidx=d_rh,
        d_recv_mask=d_rm,
        t_eslot=t_eslot, t_lcol=t_lcol, t_blk=t_blk, t_mask=t_mask,
    )
    st = EPStatic(rows=R, own_w=w, halo=Hs,
                  has_urgent=bool(span1.any() or widths.get("bu", 0)),
                  has_deferred=bool((~span1).any() or widths.get("bd", 0)))
    return eps, st


def ep_widths_of(eps: EPSchedule, st: EPStatic,
                 acc: Optional[dict] = None) -> dict:
    """Merge this plan's static widths into `acc` (for shape-stable
    multi-batch compilation: measure every batch, then rebuild with the
    max — the EP analog of PadConfig)."""
    acc = dict(acc or {})
    mine = {"ke_d": eps.e_dst.shape[-1], "kt": eps.t_mask.shape[-1],
            "halo": st.halo, "bf": eps.x_send_col.shape[-1],
            "bu": eps.u_send_col.shape[-1], "bd": eps.d_send_col.shape[-1]}
    for k, v in mine.items():
        acc[k] = max(acc.get(k, 0), int(v))
    return acc


def ep_wire_stats(eps: EPSchedule, hidden: int, dtype_bytes: int = 2) -> dict:
    """Boundary-exchange wire accounting vs the old full-row all_gather."""
    D, R, w = eps.node_ids.shape
    Kn = D * w
    real = int(eps.x_send_mask.sum())
    padded = int(np.prod(eps.x_send_mask.shape))
    deferred = int(eps.d_send_mask.sum())
    return {
        "allgather_bytes_per_step": R * Kn * hidden * dtype_bytes * (D - 1) // max(D, 1) * D,
        "boundary_bytes_real": real * hidden * dtype_bytes,
        "boundary_bytes_padded": padded * hidden * dtype_bytes,
        "deferred_frac": round(deferred / real, 4) if real else 0.0,
    }


def ep_local(eps: EPSchedule, d: int) -> EPSchedule:
    """Rank d's shard of a plan (the leading device axis indexed away)."""
    return EPSchedule(*[np.asarray(a)[d] for a in eps])


def deferred_reads(eps: EPSchedule) -> np.ndarray:
    """[D, R, Dp, Bd] bool: deferred entry (d, r, p, j), delivered to rank
    d at row r, is read by row r's own gather there: its buffer index
    R*w + d_recv_hidx is among e_src_lslot[d, r]. The planner may stage an
    entry at any row up to the one before its first reader
    (partition_schedule_sharded), so such an entry arrives at the row that
    reads it. The rows where any rank has one (.any(axis=(0, 2, 3))) wait
    for the deferred exchange before their gather; every other row lets it
    run under its compute. Host arrays only."""
    D, R, w = eps.node_ids.shape
    slot = R * w + eps.d_recv_hidx.astype(np.int64)                  # [D, R, Dp, Bd]
    n = int(max(slot.max(initial=0), eps.e_src_lslot.max(initial=0))) + 1
    row = np.arange(D * R, dtype=np.int64).reshape(D, R)
    reads = (row[..., None] * n + eps.e_src_lslot).ravel()
    got = np.isin((row[..., None, None] * n + slot).ravel(), reads)
    return got.reshape(slot.shape) & eps.d_recv_mask


def _ep_streams(cfg: DAGNNConfig, x, edge_attr, eps: EPSchedule):
    """This rank's per-row streams from its shard (tensors on x's device:
    EPStep.shard), on x's device: the inputs in the compute dtype, the
    gather indices as int64, K5's segment ids (tlcol, tblk, xsc) as int32
    and its masks as float32, the exchange send masks as bool."""
    dev, dt = x.device, _DTYPES[cfg.compute_dtype]
    t = lambda a: torch.as_tensor(a, device=dev)
    R, dp, bf = eps.x_send_col.shape[:3]
    fxs = {"x": x.to(dt)[t(eps.node_ids).long()]}                # [R, w, emb]
    if cfg.w_edge_attr and edge_attr is not None and cfg.num_rels > 1:
        fxs["ea"] = t(edge_attr)[t(eps.e_id).long()].to(dt)
    ixs = {"nmask": t(eps.node_mask).to(torch.float32),
           "eslot": t(eps.e_src_lslot).long(),
           "edst": t(eps.e_dst).to(torch.int32),
           "emask": t(eps.e_mask).to(torch.float32),
           "usc": t(eps.u_send_col).long(), "usm": t(eps.u_send_mask),
           "urh": t(eps.u_recv_hidx).long().reshape(R, -1),
           "dsc": t(eps.d_send_col).long(), "dsm": t(eps.d_send_mask),
           "drh": t(eps.d_recv_hidx).long().reshape(R, -1),
           "xsc": t(eps.x_send_col).to(torch.int32).reshape(R, dp * bf),
           "xsm": t(eps.x_send_mask).to(torch.float32).reshape(R, dp * bf),
           "teslot": t(eps.t_eslot).long(),
           "tlcol": t(eps.t_lcol).to(torch.int32),
           "tblk": t(eps.t_blk).to(torch.int32),
           "tmask": t(eps.t_mask).to(torch.float32)}
    return fxs, ixs


class _EPPlan:
    """One direction's sharded-state wavefront on this rank: R rows of w
    own slots, halo Hs, exchange blocks [nl, Dp, B, H] over `group`.
    read_rows ([R] bool as bytes: deferred_reads of the whole plan): the
    rows that read a deferred entry at its delivery. With overlap, only
    those rows wait for the deferred exchange before their gather, and
    every other row after its outputs; with overlap=False every row waits
    before its gather (the synchronous order). Both write the same buffer bit for bit. The
    forward marks each row's compute and each exchange's issue and wait
    (torch.profiler.record_function, "ep{tag}.{row|urgent|issue|wait}.{r}",
    r the row the exchange delivers to) when a profiler is on."""

    def __init__(self, cfg, fxs, ixs, st: EPStatic, group, fns: AggImpl, keys,
                 read_rows, overlap: bool = True, tag: int = 0):
        self.cfg, self.ixs, self.st, self.group = cfg, ixs, st, group
        self.fns, self.keys, self.tag = fns, keys, tag
        self.wait_first = (np.frombuffer(read_rows, bool) if overlap
                           else np.ones(st.rows, bool))
        self.side = {k: fxs[k] for k in ("ea",) if k in fxs}
        self.dt = _DTYPES[cfg.compute_dtype]
        self.specs = [cfg.aggregator_spec(l) for l in range(cfg.num_layers)]
        self.ke = ixs["eslot"].shape[1]
        self.dp = comm.size(group)
        self.bf = ixs["xsc"].shape[1] // self.dp

    def _level(self, r, x, vals, pdir):
        fx = {k: v[r] for k, v in self.side.items()}
        fx["x"] = x
        ix = {k: self.ixs[k][r] for k in ("nmask", "edst", "emask")}
        return _step_outs(self.cfg, pdir, self.specs, vals, fx, ix, self.fns)

    def _halo_write(self, buf, hidx, recv):
        """Write received blocks [nl, Dp, B, H] at halo indices; padding
        entries (index Hs) carry zeros onto the garbage row."""
        base = self.st.rows * self.st.own_w
        buf[:, base + hidx] = recv.reshape(buf.shape[0], -1, buf.shape[2])

    @staticmethod
    def _block(src, col, mask):
        """The per-peer block [nl, Dp, B, H] gathered from src at col; the
        padding entries are +0.0 (selected, not multiplied: a product
        keeps a negative value's sign), so the garbage row every padding
        entry lands on holds the same bits whichever write comes last."""
        return torch.where(mask[None, ..., None], src[:, col], 0.0)

    def _mark(self, what, r):
        if not torch._C._autograd._profiler_enabled():
            return nullcontext()
        return torch.profiler.record_function(f"ep{self.tag}.{what}.{r}")

    def _deliver(self, buf, r, pend):
        """Wait for the deferred exchange and write its entries (the recv
        plan of row r: the block staged at row r-1)."""
        with self._mark("wait", r):
            self._halo_write(buf, self.ixs["drh"][r], pend.wait())

    def forward(self, xs, wparams):
        cfg, st, ix = self.cfg, self.st, self.ixs
        R, w = st.rows, st.own_w
        pdir = _params_dir(self.keys, wparams, self.dt)
        buf = torch.zeros((cfg.num_layers, R * w + st.halo + 1, cfg.hidden_dim),
                          dtype=self.dt, device=xs.device)
        pend = None          # the deferred exchange issued at the previous row
        for r in range(R):
            if pend is not None and self.wait_first[r]:
                self._deliver(buf, r, pend)
                pend = None
            with self._mark("row", r):
                outs = self._level(r, xs[r], buf[:, ix["eslot"][r]], pdir)  # [nl, w, H]
                buf[:, r * w:(r + 1) * w] = outs
            # URGENT entries (first read at the next row), exchanged now
            if st.has_urgent:
                with self._mark("urgent", r + 1):
                    blk = self._block(outs, ix["usc"][r], ix["usm"][r])
                    self._halo_write(buf, ix["urh"][r], comm.exchange(blk, self.group))
            if pend is not None:
                self._deliver(buf, r, pend)
            # the next deferred block, staged from the buffer by flat own
            # index and issued (the last row stages nothing: no later row
            # reads it)
            if st.has_deferred and r < R - 1:
                with self._mark("issue", r + 1):
                    pend = comm.exchange_async(
                        self._block(buf, ix["dsc"][r], ix["dsm"][r]), self.group)
        return buf

    def backward(self, xs, buf, wparams, g):
        """Reverse replay. g [nl, R*w, H]: the cotangent of the own region.
        Per row the three segment sums run in K5 (fns.merge) over the
        layers side by side [K, nl*H]: own-source edge grads (with g's
        row) into own columns, remote-source edge grads into the per-peer
        halo blocks, and the blocks the peers return into own columns."""
        cfg, st, ix, merge = self.cfg, self.st, self.ixs, self.fns.merge
        R, w, nl, H = st.rows, st.own_w, cfg.num_layers, cfg.hidden_dim
        dp, bf, ke = self.dp, self.bf, self.ke
        acc = torch.zeros((nl, R * ke + 1, H), dtype=g.dtype, device=g.device)
        dws = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in wparams]
        dxs = torch.zeros_like(xs)
        zero_blk = torch.zeros((dp * bf, nl * H), dtype=g.dtype, device=g.device)
        side = lambda a: a.movedim(0, -2).reshape(a.shape[1], nl * H)  # [nl,K,H] -> [K,nl*H]
        for r in range(R - 1, -1, -1):
            tg = side(acc[:, ix["teslot"][r]])
            mine = merge(side(g[:, r * w:(r + 1) * w]), tg, ix["tlcol"][r],
                         ix["tmask"][r])
            blk = merge(zero_blk, tg, ix["tblk"][r], ix["tmask"][r])
            with self._mark("grad", r):
                recv = comm.exchange(blk.view(dp, bf, nl, H).permute(2, 0, 1, 3),
                                     self.group)                 # grads for MY cols
            mine = merge(mine, side(recv.reshape(nl, dp * bf, H)), ix["xsc"][r],
                         ix["xsm"][r])
            g_out = mine.view(w, nl, H).movedim(1, 0)
            with torch.enable_grad():
                wl = [p.detach().requires_grad_(True) for p in wparams]
                xin = xs[r].detach().requires_grad_(True)
                vin = buf[:, ix["eslot"][r]].detach().requires_grad_(True)
                outs = self._level(r, xin, vin, _params_dir(self.keys, wl, self.dt))
                grads = torch.autograd.grad(outs, wl + [xin, vin], g_out,
                                            allow_unused=True)
            for dw, gw in zip(dws, grads[:len(wl)]):
                if gw is not None:
                    dw.add_(gw)
            if grads[-2] is not None:
                dxs[r] = grads[-2]
            if grads[-1] is not None:
                acc[:, r * ke:(r + 1) * ke] = grads[-1]
        return dxs, [dw.to(p.dtype) for dw, p in zip(dws, wparams)]


class _EPWavefront(torch.autograd.Function):
    """The sharded-state wavefront of one direction: returns this rank's
    OWN slices [nl, R*w, H]. The halo region (copies of other ranks'
    slots) never escapes; the gradients of halo reads go back to their
    owners in the backward. Saves only the final buffer."""

    @staticmethod
    def forward(ctx, plan, xs, *wparams):
        buf = plan.forward(xs, wparams)
        ctx.plan = plan
        ctx.save_for_backward(xs, buf, *wparams)
        return buf[:, :plan.st.rows * plan.st.own_w]

    @staticmethod
    def backward(ctx, g):
        xs, buf, *wparams = ctx.saved_tensors
        dxs, dws = ctx.plan.backward(xs, buf, wparams, g.contiguous())
        return (None, dxs, *dws)


def _ep_plans(params, cfg: DAGNNConfig, x, edge_attr, eps_dirs, statics, read_rows,
              group, fns: AggImpl, overlap: bool):
    """Each direction's (_EPPlan, x stream [R, w, emb], parameter keys)."""
    if cfg.agg_x or cfg.vid_dim > 0:
        raise ValueError("the sharded-state scheme takes no agg_x or vid_dim "
                         "(as in the JAX package: its streams carry x and ea)")
    out = []
    for di, d in enumerate(cfg.dirs):
        fxs, ixs = _ep_streams(cfg, x, edge_attr, eps_dirs[di])
        if d == 1 and cfg.reverse_agg_noop:
            # shared-AggConv quirk (DAGNNConfig.ref_shared_agg_quirk): the
            # reverse pass aggregates nothing upstream
            ixs["emask"] = torch.zeros_like(ixs["emask"])
            ixs["tmask"] = torch.zeros_like(ixs["tmask"])
        keys = _dir_keys(params, d)
        out.append((_EPPlan(cfg, fxs, ixs, statics[di], group, fns, keys, read_rows[di],
                            overlap, di), fxs["x"], keys))
    return out


def ep_node_states(params, cfg: DAGNNConfig, x, edge_attr, eps_dirs, statics,
                   read_rows, group, fns: AggImpl = SEG_KERNELS, overlap: bool = True):
    """Every direction pass, sharded-state scheme, on this rank: eps_dirs
    are its shards (ep_local) of each direction's plan, read_rows each
    whole plan's rows that wait before their gather (deferred_reads, [R]
    bool as bytes; with overlap=False every row does). Returns (h_own per
    direction [nl, R*w, H], x_own per direction [R*w, emb])."""
    h_dirs, x_dirs = [], []
    for plan, xs, keys in _ep_plans(params, cfg, x, edge_attr, eps_dirs, statics,
                                    read_rows, group, fns, overlap):
        h_dirs.append(_EPWavefront.apply(plan, xs, *[params[k] for k in keys]))
        x_dirs.append(xs.reshape(plan.st.rows * plan.st.own_w, -1))
    return h_dirs, x_dirs


def ep_readout_aux(batch: DAGBatch, eps_dirs, cfg: DAGNNConfig):
    """Host-side per-device readout indices: per direction, the graph id
    and pool mask of each OWN slot (final-node or all-node per cfg)."""
    gids, masks = [], []
    omasks = [batch.out_mask_fwd, batch.out_mask_rev]
    for di, eps in enumerate(eps_dirs):
        D, R, w = eps.node_ids.shape
        nid = eps.node_ids.reshape(D, R * w)
        gids.append(batch.graph_id[nid].astype(np.int32))
        m = (batch.node_mask if cfg.out_pool_all
             else (omasks[di] & batch.node_mask))[nid]
        masks.append(m)
    D = eps_dirs[0].node_ids.shape[0]
    aux = {"gid": np.stack(gids, axis=1),        # [D, nd, R*w]
           "mask": np.stack(masks, axis=1),      # [D, nd, R*w]
           # replicated per device (stacked so every leaf has the D axis)
           "node_mask": np.tile(batch.node_mask[None], (D, 1))}
    if "node_depth" in batch.extras:
        aux["node_depth"] = np.tile(batch.extras["node_depth"][None],
                                    (D,) + (1,) * batch.extras["node_depth"].ndim)
    return aux


class EPArrays(NamedTuple):
    """One rank's device arrays of an edge-partitioned step: the replicated
    batch arrays and its shard of each direction's plan (EPSchedule of
    tensors) and readout indices. A captured step stages them into its
    static buffers (convert.batch_to_torch(out=))."""

    x: torch.Tensor
    edge_attr: Optional[torch.Tensor]
    node_mask: torch.Tensor
    node_depth: Optional[torch.Tensor]
    eps_dirs: tuple
    gid: torch.Tensor            # [nd, R*w] graph id of each own slot
    mask: torch.Tensor           # [nd, R*w] pool mask of each own slot
    y: dict
    graph_mask: torch.Tensor


class EPInputs(NamedTuple):
    """One rank's inputs to an edge-partitioned step: its device arrays
    and the host values the step's loop bakes into its launches and
    collectives (each direction's EPStatic: rows, own width, halo, whether
    it exchanges urgent and deferred entries; and the rows that wait for
    the deferred exchange before their gather), which key a captured
    step."""

    arrays: EPArrays
    statics: tuple
    read_rows: tuple             # per direction [R] bool (deferred_reads), as bytes

    def wait_rows(self):
        """Each direction's read_rows as a [R] bool array."""
        return [np.frombuffer(r, bool) for r in self.read_rows]


def _max_over_ranks(h, gid, m, G, group):
    """The max pool across ranks: each rank's per-graph max of its own
    slots, finfo.min where it holds none (a rank without nodes of graph g
    must not win with pool_nodes' empty fill of 0), gathered and maxed
    (ties, within a rank and across ranks, share the gradient evenly, as
    JAX's max does); a graph with no node anywhere pools to 0."""
    neg = torch.finfo(h.dtype).min
    hm = torch.where(m[:, None], h, torch.full((), neg, dtype=h.dtype, device=h.device))
    part = torch.full((G + 1, h.shape[1]), neg, dtype=h.dtype, device=h.device)
    part = part.scatter_reduce(0, gid.long()[:, None].expand_as(hm), hm, "amax",
                               include_self=True)[:G]
    pooled = comm.gather_over_ranks(part, group).amax(dim=0)
    return torch.where(pooled <= neg, torch.zeros((), dtype=h.dtype, device=h.device),
                       pooled)


class EPStep:
    """The sharded-state edge-partitioned train step of make_ep_train_step."""

    def __init__(self, cfg: DAGNNConfig, mesh, loss_head, optimizer,
                 axis: str = "ep", dp_axis: Optional[str] = None,
                 fns: AggImpl = SEG_KERNELS, overlap: bool = True,
                 capture: bool = False):
        self.cfg, self.loss_head, self.optimizer, self.fns = cfg, loss_head, optimizer, fns
        self.overlap = overlap
        self.group = mesh.groups[axis]
        self.dp_group = None if dp_axis is None else mesh.groups[dp_axis]
        self.rank, self.size = comm.rank(self.group), comm.size(self.group)
        self.captured = (graphs.CapturedStep(self._fn)
                         if capture else None)
        self.form = comm.form_of([self.group, self.dp_group], capture)

    def shard(self, batch: DAGBatch, plans, aux, device) -> EPInputs:
        """This rank's inputs from one host batch, its plans ((EPSchedule,
        EPStatic) per direction, every rank's shards) and ep_readout_aux:
        its arrays on `device`, the plans' host values beside them."""
        t = lambda a: None if a is None else torch.as_tensor(a, device=device)
        d = self.rank
        return EPInputs(
            EPArrays(
                x=t(batch.x), edge_attr=t(batch.edge_attr),
                node_mask=t(batch.node_mask).bool(),
                node_depth=t(batch.extras.get("node_depth")),
                eps_dirs=tuple(EPSchedule(*[t(a) for a in ep_local(e, d)]) for e, _ in plans),
                gid=t(aux["gid"][d]).long(), mask=t(aux["mask"][d]).bool(),
                y={k: t(v) for k, v in batch.y.items()},
                graph_mask=t(batch.graph_mask).bool()),
            statics=tuple(s for _, s in plans),
            read_rows=tuple(deferred_reads(e).any(axis=(0, 2, 3)).tobytes()
                            for e, _ in plans))

    def key(self, inp: EPInputs):
        """The captured step's key: the order, the route, each direction's
        EPStatic and read_rows, and the arrays' shapes: a batch whose plan
        waits in other rows gets a graph of its own."""
        return ("ep", self.overlap, comm.route(self.group), inp.statics, inp.read_rows,
                convert.batch_key(inp.arrays))

    def _encode(self, params, a: EPArrays):
        enc = {k[len("encoder."):]: v for k, v in params.items()
               if k.startswith("encoder.")}
        x = encode(enc, self.cfg.encoder, a.x, a.node_depth)
        return torch.where(a.node_mask[:, None], x, 0.0)

    def forward_buffers(self, params, inp: EPInputs):
        """Each direction's whole forward state buffer [nl, R*w + Hs + 1,
        H] (own slots, halo, garbage row) on this rank, without gradients:
        what the overlapped and synchronous orders must write alike."""
        a = inp.arrays
        with torch.no_grad():
            return [plan.forward(xs, [params[k] for k in keys])
                    for plan, xs, keys in _ep_plans(
                        params, self.cfg, self._encode(params, a), a.edge_attr,
                        a.eps_dirs, inp.statics, inp.read_rows, self.group,
                        self.fns, self.overlap)]

    def loss(self, params, inp: EPInputs):
        """The loss of this rank's ep group's batch (replicated over ep)."""
        cfg, group, a = self.cfg, self.group, inp.arrays
        h_dirs, x_dirs = ep_node_states(params, cfg, self._encode(params, a),
                                        a.edge_attr, a.eps_dirs, inp.statics,
                                        inp.read_rows, group, self.fns, self.overlap)
        G = a.graph_mask.shape[0]
        kind = "add" if cfg.out_pool in ("add", "sum", "mean", "attn") else cfg.out_pool

        def pool(h, di):
            gid, m = a.gid[di], a.mask[di]
            if cfg.out_pool == "max":
                return _max_over_ranks(h, gid, m, G, group)
            pooled = pool_nodes(h, gid, G, kind, m, self.fns.merge)
            pooled = comm.sum_over_ranks(pooled.float(), group).to(pooled.dtype)
            if cfg.out_pool == "mean":
                cnt = comm.all_reduce_sum(segment.segment_count(gid, G + 1, m)[:G], group)
                pooled = pooled / torch.clamp(cnt, min=1.0)[:, None].to(pooled.dtype)
            return pooled

        # segment pooling commutes with the feature concat, so each tensor is
        # pooled in ITS OWN direction's slot layout; the feature order
        # mirrors the single-device readout's
        if cfg.out_pool_all or not cfg.bidirectional:
            parts = [pool(x_dirs[0], 0)] if cfg.out_wx else []
            for di in range(len(cfg.dirs)):
                for l in range(cfg.num_layers):
                    parts.append(pool(h_dirs[di][l], di))
        else:
            parts = []
            for di in range(len(cfg.dirs)):
                sub = [x_dirs[di]] if cfg.out_wx else []
                sub += [h_dirs[di][l] for l in range(cfg.num_layers)]
                parts.append(pool(torch.cat(sub, dim=-1), di))
        out = torch.cat(parts, dim=-1)
        logits = _apply_head(params, cfg, out.float(), None, False)
        return self.loss_head(logits, a.y, a.graph_mask)

    def grads(self, params, inp: EPInputs):
        """(loss, grads): the gradient of this ep group's loss, equal to the
        single-device gradient (each rank backpropagates its 1/D share,
        summed over ep), then averaged over dp when the mesh has it."""
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = self.loss(p, inp)
        share = loss / self.size
        gs = torch.autograd.grad(share, list(p.values()), allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(p.items(), gs)}

        def reduce(flat):
            flat = comm.all_reduce_sum(flat, self.group)
            return flat if self.dp_group is None else comm.all_reduce_mean(flat, self.dp_group)

        return reduce_flat(share, grads, reduce)

    def _fn(self, state, inp: EPInputs):
        params, opt_state = state
        loss, grads = self.grads(params, inp)
        return apply_updates(self.optimizer, params, grads, opt_state), loss

    def __call__(self, params, opt_state, inp: EPInputs):
        """(params, opt_state, loss) after one step. Captured (DPStep's
        rules): the state is written in place into buffers the step owns."""
        if self.captured is None:
            (params, opt_state), loss = self._fn((params, opt_state), inp)
            return params, opt_state, loss
        (params, opt_state), loss = self.captured(self.key(inp), (params, opt_state), inp)
        return params, opt_state, loss


def make_ep_train_step(cfg: DAGNNConfig, mesh, loss_head, optimizer,
                       axis: str = "ep", dp_axis: Optional[str] = None,
                       fns: AggImpl = SEG_KERNELS, overlap: bool = True,
                       capture: Optional[bool] = None) -> EPStep:
    """The sharded-state EP train step on this rank (the JAX package's
    make_ep_train_step). loss_head(logits, y, graph_mask) -> scalar, given
    the head's outputs over the pooled readout. Every out_pool: add, sum,
    mean and attn pool through a sum over the ranks (the reference's attn
    pool softmaxes a length-1 axis, so it is the add pool with weights
    1.0, and its score linear gets a zero gradient), max through a gather
    of each rank's per-graph max. With dp_axis (make_hybrid_mesh), each dp
    group trains its own batch edge-partitioned over `axis`, and loss and
    gradients are averaged over dp_axis as well: the reference's
    DataParallel composed with the intra-batch sharding it never had.
    Unlike JAX's, the statics travel with each batch's plans (step.shard):
    there is no trace to pin them to. The deferred exchange runs under
    the next row's compute except where that row reads it (deferred_reads);
    overlap=False keeps every exchange synchronous before the row that may
    read it, the same result bit for bit (tests and timings hold the two
    orders together). When every group is NCCL the step is captured, one
    CUDA graph per key (EPStep.key: the plan's statics and read_rows, the
    order; capture=False asks for the eager step); on gloo it runs eager
    (comm.EAGER_ON_HOST), and capture=True raises there (comm.capture_rule),
    as make_dp_train_step does. Within the graph a deferred exchange
    issued at row r-1 and waited on at row r is an edge from the NCCL
    stream back to the capture stream; every one is waited on before the
    forward ends."""
    group = mesh.groups[axis]
    dp_group = None if dp_axis is None else mesh.groups[dp_axis]
    return EPStep(cfg, mesh, loss_head, optimizer, axis, dp_axis, fns, overlap,
                  comm.capture_rule([group, dp_group], capture))

"""Canonical DAGNN on the direction-merged and the pair-scheduled wavefront.

Counterpart of dagnn_tpu/nn/dagnn.py for the slice the port runs today:
the bidirectional, additive-attention (`attn_*`), GRU-stack configuration
with the slot-space readout — the flagship TOK model. Both direction
passes run in one wavefront whose rows are the concat [fwd block | rev
block]. A batch collated without a pair plan runs the merged wavefront:
each row is one call of the row kernels (ops/row_step.py, K1 forward, K2
backward). A batch with a pair plan (dag/pair.py) runs the pair-scheduled
wavefront, as the JAX package does: each pair of rows is one call of the
pair kernels (ops/pair_step.py, K3 forward, K4 backward). Both are driven
by one torch.autograd.Function and write the same state-buffer layout.

Any other configuration raises NotImplementedError naming its ROADMAP
item; nothing falls back to another path.

Parameters are a flat dict keyed by the JAX tree's dotted paths
("encoder.attr_emb", "aggr.1.0.attn_lin.w", "cells.0.1.w_ih", "head.w";
see convert.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from dagnn_tpu_torch import resolve_device
from dagnn_tpu_torch.convert import flatten_tree
from dagnn_tpu_torch.dag.batch import DAGBatch
from dagnn_tpu_torch.nn.aggregators import AggregatorSpec, aggregator_init
from dagnn_tpu_torch.nn.encoders import EncoderSpec, encoder_init, encode
from dagnn_tpu_torch.ops import pair_step, row_step
from dagnn_tpu_torch.ops.gru import gru_init
from dagnn_tpu_torch.ops.linear import linear, linear_init

# aggregator names (reference src/constants.py:12-19)
NA_SUM = "add"
NA_MAX = "max"
NA_GATED_SUM = "gated_sum"
NA_ATTN_H = "attn_h"

P_MEAN, P_ADD, P_SUM, P_MAX, P_ATTN = "mean", "add", "sum", "max", "attn"

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class DAGNNConfig:
    """The JAX package's DAGNNConfig, field for field (see its docstring
    for each field; reference flag surface dagnn.py:18-21)."""

    num_vocab: int = 0
    max_seq_len: int = 5
    emb_dim: int = 300
    hidden_dim: int = 300
    out_dim: int = 0
    num_rels: int = 2
    w_edge_attr: bool = True
    num_layers: int = 2
    bidirectional: bool = True
    mapper_bias: bool = True
    agg_x: bool = False
    agg: str = NA_ATTN_H
    out_wx: bool = True
    out_pool_all: bool = True
    out_pool: str = P_MAX
    dropout: float = 0.0
    num_class: int = 0
    recurr: bool = True
    encoder: EncoderSpec = EncoderSpec()
    vid_dim: int = 0
    segment_impl: str = "dense"
    ref_shared_agg_quirk: bool = True
    compute_dtype: str = "float32"

    def __post_init__(self):
        if self.agg_x and self.hidden_dim < self.emb_dim:
            raise ValueError("hidden dimension too small for input (agg_x)")
        if self.agg_x and self.agg_attn and not self.agg_attn_x:
            raise ValueError("agg_x requires an *_x attention or sum aggregator")

    @property
    def dirs(self) -> Tuple[int, ...]:
        return (0, 1) if self.bidirectional else (0,)

    @property
    def agg_attn(self) -> bool:
        return "attn" in self.agg

    @property
    def agg_attn_x(self) -> bool:
        return "_x" in self.agg

    @property
    def out_hidden_dim(self) -> int:
        d = len(self.dirs)
        core = self.hidden_dim * d * self.num_layers
        if not self.out_wx:
            return core
        x_copies = d if (self.bidirectional and not self.out_pool_all) else 1
        return self.emb_dim * x_copies + core

    @property
    def effective_num_rels(self) -> int:
        return self.num_rels if self.w_edge_attr else 1

    def aggregator_spec(self, layer: int) -> AggregatorSpec:
        vd = self.vid_dim
        pred_dim = self.emb_dim if self.agg_x else self.hidden_dim
        attn_dim = (self.emb_dim if self.agg_attn_x
                    else self.hidden_dim + vd)
        nr = self.effective_num_rels
        if "self_attn" in self.agg:
            return AggregatorSpec("self_attn", value_dim=pred_dim, key_dim=attn_dim, num_rels=nr)
        if "mattn" in self.agg:
            qd = self.emb_dim if layer == 0 else attn_dim
            return AggregatorSpec("mattn", value_dim=pred_dim, key_dim=attn_dim, query_dim=qd, num_rels=nr)
        if "attn" in self.agg:
            qd = self.emb_dim if layer == 0 else attn_dim
            return AggregatorSpec("attn", value_dim=pred_dim, key_dim=attn_dim, query_dim=qd, num_rels=nr)
        if self.agg == NA_GATED_SUM:
            return AggregatorSpec("gated_sum", value_dim=pred_dim + vd, num_rels=nr,
                                  mapper_bias=self.mapper_bias,
                                  out_dim=self.hidden_dim if vd else 0)
        return AggregatorSpec(self.agg, value_dim=pred_dim, num_rels=nr)

    @property
    def shared_aggregator(self) -> bool:
        return self.agg in (NA_SUM, NA_MAX)

    @property
    def reverse_agg_noop(self) -> bool:
        return self.shared_aggregator and self.ref_shared_agg_quirk


def dagnn_init(seed, cfg: DAGNNConfig, dtype=torch.float32,
               device="cuda") -> Dict[str, torch.Tensor]:
    """Random parameters in the JAX tree's layout, from `seed` (an int or
    a torch.Generator). Returns the flat dotted-path dict on `device`."""
    dev = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator().manual_seed(int(seed))
    p = {"encoder": encoder_init(gen, cfg.encoder, dtype)}
    if cfg.shared_aggregator:
        shared = aggregator_init(gen, cfg.aggregator_spec(0), dtype)
        p["aggr"] = [[shared for _ in range(cfg.num_layers)] for _ in cfg.dirs]
    else:
        p["aggr"] = [[aggregator_init(gen, cfg.aggregator_spec(l), dtype)
                      for l in range(cfg.num_layers)] for _ in cfg.dirs]
    cells = []
    for _ in cfg.dirs:
        row = []
        for l in range(cfg.num_layers):
            in_dim = cfg.emb_dim if l == 0 else cfg.hidden_dim
            if cfg.recurr:
                row.append(gru_init(gen, in_dim, cfg.hidden_dim, dtype))
            else:
                row.append(linear_init(gen, in_dim + cfg.hidden_dim,
                                       cfg.hidden_dim, dtype=dtype))
        cells.append(row)
    p["cells"] = cells
    if cfg.out_pool == P_ATTN:
        d = (cfg.out_hidden_dim // 2 if (cfg.bidirectional and not cfg.out_pool_all)
             else cfg.out_hidden_dim)
        p["pool_attn"] = linear_init(gen, d, 1, dtype=dtype)
    if cfg.num_class > 0:
        p["head"] = linear_init(gen, cfg.out_hidden_dim, cfg.num_class, dtype=dtype)
    elif cfg.num_vocab == 1:
        p["head"] = linear_init(gen, cfg.out_hidden_dim, 1, dtype=dtype)
    else:
        hs = [linear_init(gen, cfg.out_hidden_dim, cfg.num_vocab, dtype=dtype)
              for _ in range(cfg.max_seq_len)]
        p["head"] = {"w": torch.stack([h["w"] for h in hs]),
                     "b": torch.stack([h["b"] for h in hs])}
    return {k: v.to(dev) for k, v in flatten_tree(p).items()}


# ------------------------------------------------------------ applicability

def _fused_applicable(cfg: DAGNNConfig) -> bool:
    """Configs the row kernels cover: additive-attention aggregators with
    a GRU stack, no agg_x / vids."""
    return (cfg.segment_impl == "fused" and not cfg.agg_x
            and cfg.vid_dim == 0 and cfg.recurr
            and cfg.agg_attn and not cfg.agg_attn_x
            and all(cfg.aggregator_spec(l).kind == "attn"
                    for l in range(cfg.num_layers)))


def merged_applicable(cfg: DAGNNConfig, batch: DAGBatch) -> bool:
    if not (cfg.bidirectional and _fused_applicable(cfg)):
        return False
    f, r = batch.fwd, batch.rev
    if tuple(f.node_ids.shape) != tuple(r.node_ids.shape):
        return False
    if f.tgrad_eslot is None or r.tgrad_eslot is None:
        return False
    if f.edge_nsrc is not None or r.edge_nsrc is not None:
        return tuple(f.edge_src_slot.shape)[0] == tuple(r.edge_src_slot.shape)[0]
    return tuple(f.edge_src_slot.shape) == tuple(r.edge_src_slot.shape)


def _require_slice(cfg: DAGNNConfig, batch: DAGBatch):
    if cfg.out_pool_all:
        raise NotImplementedError(
            "out_pool_all (node-space readout) is not ported yet: ROADMAP "
            "queue 1, the rest of the DAGNN config surface")
    if batch.fwd.edge_nsrc is not None or batch.rev.edge_nsrc is not None:
        raise NotImplementedError(
            "near/far layouts (K7) are not ported yet: ROADMAP queue 2")
    if not merged_applicable(cfg, batch):
        raise NotImplementedError(
            "only the direction-merged fused path (bidirectional attn_h + "
            "GRU, segment_impl='fused') is ported: ROADMAP queue 1 (the "
            "rest of the DAGNN config surface) and queue 2 (K1/K2 at "
            "ndirs=1)")


# ------------------------------------------------- direction-merged streams

def _t(a, dev):
    return torch.as_tensor(a, device=dev)


def _remap_slot(slot, unit, L, d):
    """Per-direction buffer index -> merged-buffer index: a per-direction
    buffer [L*unit + 1] (garbage row last) interleaves into the merged
    [L*2*unit + 1] as row*2*unit + d*unit + col."""
    g = L * unit
    row, col = slot // unit, slot % unit
    return torch.where(slot == g, 2 * g, row * (2 * unit) + d * unit + col)


def _build_streams_merged(cfg: DAGNNConfig, x, edge_attr, sf, sr, dev):
    """Merged-direction streams: the per-row concat of both schedules'
    blocks. eslot / teslot are remapped into the merged state / edge-grad
    buffers; edst and tdst stay block-local. x is cast to the compute
    dtype here; the weights are cast inside the wavefront (so their grads
    come back in float32, as through the JAX package's cast)."""
    L, kn = tuple(sf.node_ids.shape)
    dt = _DTYPES[cfg.compute_dtype]
    cat = lambda a, b: torch.cat([_t(a, dev), _t(b, dev)], dim=1)
    node_ids = cat(sf.node_ids, sr.node_ids).long()             # [L, 2Kn]
    fxs = {"x": x.to(dt)[node_ids]}
    if cfg.w_edge_attr and edge_attr is not None and cfg.num_rels > 1:
        eid = cat(sf.edge_id, sr.edge_id).long()
        fxs["ea"] = _t(edge_attr, dev)[eid].to(dt)
    es = lambda s, d: _remap_slot(_t(s.edge_src_slot, dev).long(), kn, L, d)
    ixs = {
        "nmask": cat(sf.node_mask, sr.node_mask),
        "eslot": torch.cat([es(sf, 0), es(sr, 1)], dim=1),
        "edst": cat(sf.edge_dst, sr.edge_dst),
        "emask": cat(sf.edge_mask, sr.edge_mask),
    }
    ke = tuple(sf.edge_src_slot.shape)[1]
    kt = max(tuple(sf.tgrad_eslot.shape)[1], tuple(sr.tgrad_eslot.shape)[1])

    def padt(a, fill):
        a = _t(a, dev)
        w = kt - a.shape[1]
        return a if w == 0 else torch.nn.functional.pad(a, (0, w), value=fill)

    ixs["teslot"] = torch.cat(
        [_remap_slot(padt(sf.tgrad_eslot, L * ke).long(), ke, L, 0),
         _remap_slot(padt(sr.tgrad_eslot, L * ke).long(), ke, L, 1)], dim=1)
    ixs["tdst"] = torch.cat([padt(sf.tgrad_dst, kn), padt(sr.tgrad_dst, kn)], 1)
    ixs["tmask"] = torch.cat([padt(sf.tgrad_mask, False),
                              padt(sr.tgrad_mask, False)], 1)
    # the kernels' index / mask types, converted once per batch
    ixs["edst"] = ixs["edst"].to(torch.int32)
    ixs["tdst"] = ixs["tdst"].to(torch.int32)
    for k in ("nmask", "emask", "tmask"):
        ixs[k] = ixs[k].to(torch.float32)
    return fxs, ixs, (L, 2 * kn)


class StepImpl(NamedTuple):
    """The pair of step functions a wavefront runs: the wrappers (default)
    or the plain versions (for comparison runs on the card)."""
    forward: object
    backward: object


KERNELS = StepImpl(row_step.row_forward, row_step.row_backward)
PLAIN = StepImpl(row_step.row_forward_plain, row_step.row_backward_plain)
PAIR_KERNELS = StepImpl(pair_step.pair_forward, pair_step.pair_backward)
PAIR_PLAIN = StepImpl(pair_step.pair_forward_plain, pair_step.pair_backward_plain)


def _param_keys(cfg: DAGNNConfig, has_ea: bool):
    """Dotted keys of the wavefront's parameters, direction-major."""
    keys = []
    for d in range(2):
        for l in range(cfg.num_layers):
            a = f"aggr.{d}.{l}."
            keys += [a + "attn_lin.w", a + "attn_lin.b"]
            if has_ea:
                keys += [a + "edge_encoder.w", a + "edge_encoder.b"]
            keys += [f"cells.{d}.{l}.{k}" for k in row_step.CELL_KEYS]
    return keys


class _Plan:
    """Static plan of one wavefront over a batch: n steps (merged rows, or
    pairs of rows) of `unit` node slots each, both directions in every
    step. Step s gathers its edges' predecessor states h[eslot[s]] from the
    write-once state buffer, runs the step function (`impl`; `tail` and
    `kw` are its trailing arguments: the pair's block spec, or ndirs=2 for
    a row) and writes its outputs to rows s*unit.. of the buffer. The
    backward runs the steps in reverse: value grads go through the edge-grad
    buffer and come back to their source step through the transpose
    schedule (teslot, tdst, tmask); weight grads add into one f32 buffer."""

    def __init__(self, cfg, fxs, ixs, impl, tail=(), kw=None):
        self.cfg, self.ixs, self.impl = cfg, ixs, impl
        self.tail, self.kw = tail, kw or {}
        self.ea = fxs.get("ea")
        self.has_ea = self.ea is not None and cfg.aggregator_spec(0).wea
        self.static = (self.has_ea, cfg.hidden_dim, cfg.num_layers)
        self.lh = cfg.num_layers * cfg.hidden_dim
        self.dt = _DTYPES[cfg.compute_dtype]
        self.keys = _param_keys(cfg, self.has_ea)
        self.n, self.unit = tuple(fxs["x"].shape[:2])
        self.nv = ixs["eslot"].shape[1]      # value rows gathered per step
        self.ne = ixs["edst"].shape[1]       # edges per step

    def weights(self, wparams):
        """Stacked [2, ...] kernel weights in the compute dtype."""
        cfg, nl = self.cfg, self.cfg.num_layers
        p = {k: v.to(self.dt) for k, v in zip(self.keys, wparams)}
        qdims = [cfg.aggregator_spec(l).query_dim for l in range(nl)]
        flat = []
        for d in range(2):
            aggr, cells = [], []
            for l in range(nl):
                a = f"aggr.{d}.{l}."
                ap = {"attn_lin": {"w": p[a + "attn_lin.w"],
                                   "b": p[a + "attn_lin.b"]}}
                if self.has_ea:
                    ap["edge_encoder"] = {"w": p[a + "edge_encoder.w"],
                                          "b": p[a + "edge_encoder.b"]}
                aggr.append(ap)
                cells.append({k: p[f"cells.{d}.{l}.{k}"]
                              for k in row_step.CELL_KEYS})
            flat.append(row_step.flatten_row_weights(aggr, cells, qdims,
                                                     self.has_ea))
        return row_step.stack_row_weights(flat)

    def _args(self, s):
        ix = self.ixs
        args = (self.ea[s] if self.has_ea else None, ix["edst"][s],
                ix["emask"][s], ix["nmask"][s])
        return args + ((ix["nsrc"][s],) if "nsrc" in ix else ())

    def forward(self, xs, weights, emit_res):
        """n forward steps (K1 or K3). Returns the state buffer
        [n*unit + 1, nl*H] (garbage row last, left zero) and, with
        emit_res, the residual streams alpha32 [n, ne, nl] and
        nres [n, unit, 4*nl*H]."""
        n, unit = self.n, self.unit
        h = torch.zeros((n * unit + 1, self.lh), dtype=self.dt, device=xs.device)
        a32 = nres = None
        if emit_res:
            a32 = torch.empty((n, self.ne, self.cfg.num_layers),
                              dtype=torch.float32, device=xs.device)
            nres = torch.empty((n, unit, 4 * self.lh), dtype=self.dt,
                               device=xs.device)
        for s in range(n):
            vals = h[self.ixs["eslot"][s]]
            out = self.impl.forward(self.static, xs[s], vals, *self._args(s),
                                    weights, *self.tail, emit_res=emit_res,
                                    **self.kw)
            if emit_res:
                out, a32[s], nres[s] = out
            h[s * unit:(s + 1) * unit] = out
        return h, a32, nres

    def backward(self, xs, h, weights, res, g):
        """n backward steps (K2 or K4) in reverse. Predecessor states are
        re-gathered from the final (write-once) state buffer instead of
        being kept as a vals stream; the edge-grad buffer is
        [n*nv + 1, nl*H] (garbage row last, left zero)."""
        n, unit, nv = self.n, self.unit, self.nv
        a32, nres = res
        acc = torch.zeros((n * nv + 1, self.lh), dtype=self.dt, device=h.device)
        dw = row_step._new_dw(weights, self.cfg.num_layers, self.has_ea, h.device)
        dxs = torch.empty_like(xs)
        g_stream = g[: n * unit].to(self.dt).reshape(n, unit, self.lh)
        ix = self.ixs
        for s in range(n - 1, -1, -1):
            tg = acc[ix["teslot"][s]]
            vals = h[ix["eslot"][s]]
            dx, dvals, _dea, _ = self.impl.backward(
                self.static, xs[s], vals, *self._args(s), weights,
                g_stream[s].contiguous(), tg, ix["tdst"][s], ix["tmask"][s],
                (a32[s], nres[s]), *self.tail, dw_acc=dw, **self.kw)
            acc[s * nv:(s + 1) * nv] = dvals
            dxs[s] = dx
        grads = {}
        for d in range(2):
            tree = row_step.unflatten_row_weight_grads(
                {k: v[d] for k, v in dw.items()}, self.cfg.num_layers,
                self.has_ea)
            grads.update(flatten_tree({"aggr": {d: tree["aggr"]},
                                       "cells": {d: tree["cells"]}}))
        return dxs, [grads[k] for k in self.keys]


class _Wavefront(torch.autograd.Function):
    """Both direction passes over a plan (merged: K1 row by row, K2 row by
    row in reverse; pair: K3 pair by pair, K4 in reverse); the residual
    streams of the forward feed the backward."""

    @staticmethod
    def forward(ctx, plan, xs, *wparams):
        weights = plan.weights(wparams)
        h, a32, nres = plan.forward(xs, weights, emit_res=True)
        ctx.plan, ctx.weights, ctx.res = plan, weights, (a32, nres)
        ctx.wdtypes = [p.dtype for p in wparams]
        ctx.save_for_backward(xs, h)
        return h

    @staticmethod
    def backward(ctx, g):
        xs, h = ctx.saved_tensors
        dxs, dws = ctx.plan.backward(xs, h, ctx.weights, ctx.res, g.contiguous())
        dws = [dw.to(dt) for dw, dt in zip(dws, ctx.wdtypes)]
        return (None, dxs, *dws)


def _run(plan, xs, params):
    """The plan's state buffer: through _Wavefront when a gradient is
    wanted, else a forward without residual streams."""
    wparams = [params[k] for k in plan.keys]
    if torch.is_grad_enabled() and (xs.requires_grad
                                    or any(p.requires_grad for p in wparams)):
        return _Wavefront.apply(plan, xs, *wparams)
    with torch.no_grad():
        return plan.forward(xs, plan.weights(wparams), emit_res=False)[0]


def merged_pass(params, cfg: DAGNNConfig, x, edge_attr, batch: DAGBatch,
                impl: StepImpl = KERNELS):
    """Both direction passes in one wavefront. Returns (h_flat
    [L*2Kn, nl*H], x_flat [L*2Kn, emb]) in the merged level-sorted layout:
    row r holds the fwd block at rows r*2Kn..r*2Kn+Kn and the rev block
    after it."""
    fxs, ixs, (L, kn2) = _build_streams_merged(cfg, x, edge_attr, batch.fwd,
                                               batch.rev, x.device)
    xs = fxs["x"]
    h = _run(_Plan(cfg, fxs, ixs, impl, kw={"ndirs": 2}), xs, params)
    return h[: L * kn2], xs.reshape(L * kn2, -1)


# ------------------------------------- pair-scheduled wavefront (two rows)
#
# Half the serial steps of the merged wavefront: one K3/K4 call runs rows
# 2p and 2p+1, with the intra-pair edges routed inside the call (dag/pair.py,
# ops/pair_step.py). The per-step glue (state gather, state write,
# transpose-grad gather, edge-grad write) is issued once per pair. The
# state buffer's layout is the merged path's, so the readout is unchanged.

def pair_applicable(cfg: DAGNNConfig, batch: DAGBatch) -> bool:
    return (getattr(batch, "pair", None) is not None
            and cfg.bidirectional and _fused_applicable(cfg)
            and tuple(batch.fwd.node_ids.shape) == tuple(batch.rev.node_ids.shape))


def _build_streams_pair(cfg: DAGNNConfig, x, edge_attr, plan, dev):
    """Pair streams of dag/pair.py's plan, converted once per batch: x in
    the compute dtype [P, 4Kn, emb], ea [P, W, R], and the index / mask
    streams in the kernels' types. eslot (the plan's eslot_v) gathers the
    U value rows of a pair, garbage the state buffer's last row (L*2Kn);
    teslot's garbage is the edge-grad buffer's last row (P*U). The block
    widths are host ints from the plan's shapes (plan.blocks), so a step
    never reads a device tensor back."""
    dt = _DTYPES[cfg.compute_dtype]
    fxs = {"x": x.to(dt)[_t(plan.node_ids, dev).long()]}
    if cfg.w_edge_attr and edge_attr is not None and cfg.num_rels > 1:
        fxs["ea"] = _t(edge_attr, dev)[_t(plan.eid, dev).long()].to(dt)
    ixs = {"eslot": _t(plan.eslot_v, dev).long(),
           "teslot": _t(plan.teslot, dev).long()}
    for k in ("edst", "nsrc", "tdst"):
        ixs[k] = _t(getattr(plan, k), dev).to(torch.int32)
    ixs["nmask"] = _t(plan.node_mask, dev).to(torch.float32)
    for k in ("emask", "tmask"):
        ixs[k] = _t(getattr(plan, k), dev).to(torch.float32)
    return fxs, ixs


def pair_pass(params, cfg: DAGNNConfig, x, edge_attr, batch: DAGBatch,
              impl: StepImpl = PAIR_KERNELS):
    """Both directions, two wavefront rows per step. Same return layout as
    merged_pass (the state buffer's rows are untouched by pairing)."""
    fxs, ixs = _build_streams_pair(cfg, x, edge_attr, batch.pair, x.device)
    plan = _Plan(cfg, fxs, ixs, impl, tail=(batch.pair.blocks,))
    xs = fxs["x"]
    h = _run(plan, xs, params)
    return h[: plan.n * plan.unit], xs.reshape(plan.n * plan.unit, -1)


# ----------------------------------------------------------------- readout

def _pool_gathered(hsel, mask, kind):
    """Pool pre-gathered per-graph node states [G, Om, D] with mask
    [G, Om] (empty graphs pool to 0)."""
    m = mask[..., None]
    zero = torch.zeros((), dtype=hsel.dtype, device=hsel.device)
    if kind in (P_ADD, P_SUM, P_ATTN):
        # attn: the reference softmaxes a length-1 axis (weights 1.0)
        return torch.where(m, hsel, zero).sum(dim=1)
    if kind == P_MEAN:
        s = torch.where(m, hsel, zero).sum(dim=1)
        cnt = mask.sum(dim=1).to(hsel.dtype)
        return s / torch.clamp(cnt, min=1.0)[:, None]
    if kind == P_MAX:
        neg = torch.finfo(hsel.dtype).min
        out = torch.where(m, hsel, torch.full((), neg, dtype=hsel.dtype,
                                              device=hsel.device)).amax(dim=1)
        return torch.where(out <= neg, zero, out)
    raise ValueError(f"unknown pool kind {kind}")


def _apply_head(params, cfg: DAGNNConfig, out, rng, train):
    if train and cfg.dropout > 0.0:
        raise NotImplementedError("dropout is not ported yet: ROADMAP queue "
                                  "1, the rest of the DAGNN config surface")
    out = out.float()
    if cfg.num_class > 0 or cfg.num_vocab == 1:
        y = linear({"w": params["head.w"], "b": params["head.b"]}, out)
        return torch.relu(y) if cfg.num_class == 0 else y
    # [G, D] x [S, V, D] -> [G, S, V]
    return torch.einsum("gd,svd->gsv", out, params["head.w"]) + params["head.b"][None]


def dagnn_forward(params, cfg: DAGNNConfig, batch: DAGBatch,
                  rng: Optional[torch.Generator] = None, train: bool = False,
                  impl: Optional[StepImpl] = None):
    """Full forward pass: per-position token logits [G, S, V] (class
    logits [G, C] / regression [G, 1] per config). Runs on the device of
    the parameters. A batch with a pair plan runs pair_pass, any other
    merged_pass. `impl` picks their step functions: None for the kernels,
    or KERNELS / PLAIN on the merged path and PAIR_KERNELS / PAIR_PLAIN on
    the pair path (another choice raises ValueError)."""
    _require_slice(cfg, batch)
    pair = pair_applicable(cfg, batch)
    allowed = (PAIR_KERNELS, PAIR_PLAIN) if pair else (KERNELS, PLAIN)
    impl = allowed[0] if impl is None else impl
    if impl not in allowed:
        raise ValueError(f"impl must be one of {allowed} for a "
                         f"{'pair' if pair else 'merged'} batch")
    dev = params["head.w"].device
    enc = {k[len("encoder."):]: v for k, v in params.items()
           if k.startswith("encoder.")}
    node_mask = _t(batch.node_mask, dev).bool()
    x = encode(enc, cfg.encoder, _t(batch.x, dev),
               _t(batch.extras["node_depth"], dev)
               if "node_depth" in batch.extras else None)
    # keep the garbage row exactly zero so pad gathers are inert
    x = torch.where(node_mask[:, None], x, 0.0)
    run = pair_pass if pair else merged_pass
    h2, x2 = run(params, cfg, x, batch.edge_attr, batch, impl)
    parts = []
    for di in range(2):
        sched = batch.fwd if di == 0 else batch.rev
        L, kn = tuple(sched.node_ids.shape)
        oslots = batch.out_slots_fwd if di == 0 else batch.out_slots_rev
        if oslots is None:
            raise NotImplementedError(
                "segment-pool readout without out_slots is not ported yet: "
                "ROADMAP queue 1, the rest of the DAGNN config surface "
                "(nn/readout.py)")
        ms = _remap_slot(_t(oslots, dev).long(), kn, L, di)
        hcat = h2[ms]
        if cfg.out_wx:
            hcat = torch.cat([x2[ms], hcat], dim=-1)
        omask = batch.out_slots_mask_fwd if di == 0 else batch.out_slots_mask_rev
        parts.append(_pool_gathered(hcat, _t(omask, dev).bool(), cfg.out_pool))
    out = torch.cat(parts, dim=-1)
    return _apply_head(params, cfg, out, rng, train)

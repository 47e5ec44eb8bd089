"""Canonical DAGNN on the wavefront: direction-merged, pair-scheduled and
per direction.

Counterpart of dagnn_tpu/nn/dagnn.py, the whole config surface: every
aggregator kind, agg_x, vid_dim, recurr, ref_shared_agg_quirk, dropout,
the slot-space and node-space (out_pool_all) readouts, with or without
out_slots. dagnn_forward routes a batch as the JAX package does:
  * fused (segment_impl="fused", the `attn` kind with a GRU stack, no
    agg_x / vids: _fused_applicable), bidirectional, slot-space readout,
    both directions' padded shapes equal (merged_applicable): both
    direction passes run in one wavefront whose rows are the concat
    [fwd block | rev block]. Without a pair plan that is the merged
    wavefront, each row one call of the row kernels (ops/row_step.py, K1
    forward, K2 backward); with a pair plan (dag/pair.py) the
    pair-scheduled wavefront, each pair of rows one call of the pair
    kernels (ops/pair_step.py, K3, K4). One torch.autograd.Function
    (_Wavefront over a _Plan) drives both.
  * any other fused batch (unidirectional, out_pool_all, or shapes that
    differ): the per-direction wavefront, one _direction_pass per
    direction over the same _Plan with the row kernels at ndirs=1. Its
    backward merges the transpose edge grads inside K2 (KERNELS), or with
    SPLIT_KERNELS in K5 first (row_step.tg_accumulate) and K2 after, the
    JAX package's two-call form. The node-space readout reads its states
    through _perm_gather, whose VJP is the inverse-permutation gather.
  * near/far batches (PadConfig.nearfar: the schedules carry edge_nsrc)
    take the same two fused wavefronts with the row kernels in their nf
    modes (K7): "regions" directions gather only far predecessor rows and
    read near ones from the previous row's outputs; the backward carries
    the near edges' grads from each row to the one before it (near_g).
  * with DAGNN_NO_RES_STREAM=1 (read at import into _NO_RES_STREAM, the
    JAX package's knob) the merged wavefront keeps no residual streams:
    its backward re-gathers full-width values and the row backward
    recomputes the forward (K2r); the pair path is then off, as in JAX.
  * every config the fused paths do not take, under every segment_impl
    ("dense", "scatter", "pallas", and "fused" on another kind): the
    per-direction wavefront's generic branch. Each level runs _step_outs
    (nn/aggregators.py: the attention kinds through the edge-softmax
    aggregate K6 of ops/segment_attn.py, `add` and `gated_sum` through
    K5's segment sum, `max` through a scatter max; a GRU cell or a linear
    cell in torch.matmul) into a write-once state buffer [nl, L*Kn+1, H];
    its autograd Function (_GenericWavefront) replays the levels in
    reverse, each level's VJP by torch.autograd.grad, with the transpose
    edge grads merged by K5.

Nothing falls back to another path. Parameters are a flat dict keyed by
the JAX tree's dotted paths ("encoder.attr_emb", "aggr.1.0.attn_lin.w",
"cells.0.1.w_ih", "head.w"; see convert.py).
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from dagnn_tpu_torch import resolve_device
from dagnn_tpu_torch.convert import flatten_tree, unflatten_tree
from dagnn_tpu_torch.dag.batch import DAGBatch
from dagnn_tpu_torch.nn.aggregators import (SEG_KERNELS, SEG_PLAIN, AggImpl,
                                            AggregatorSpec, aggregate_level,
                                            aggregator_init, encode_edges)
from dagnn_tpu_torch.nn.encoders import EncoderSpec, encoder_init, encode
from dagnn_tpu_torch.nn.readout import pool_nodes
from dagnn_tpu_torch.ops import pair_step, row_step
from dagnn_tpu_torch.ops.gru import gru_cell, gru_init
from dagnn_tpu_torch.ops.linear import linear, linear_init

# aggregator names (reference src/constants.py:12-19)
NA_SUM = "add"
NA_MAX = "max"
NA_GATED_SUM = "gated_sum"
NA_ATTN_H = "attn_h"

P_MEAN, P_ADD, P_SUM, P_MAX, P_ATTN = "mean", "add", "sum", "max", "attn"

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# 1: the merged wavefront's backward re-gathers full-width predecessor
# states and recomputes each row's forward in the row backward (K2r)
# instead of keeping the forward's residual streams; the pair path is off.
# The same variable as the JAX package's knob, so one setting picks the
# same path in both packages.
_NO_RES_STREAM = bool(int(os.environ.get("DAGNN_NO_RES_STREAM", "0")))


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
        # one initial add/max aggregator under every (direction, layer)
        # leaf, as in the JAX package; the copy below makes the leaves
        # separate tensors that training moves apart (ROADMAP queue 3)
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
    return {k: v.to(dev, copy=True) for k, v in flatten_tree(p).items()}


# ------------------------------------------------------------ applicability

# every name but "fused" runs the generic branch, where all compute one
# function (nn/aggregators.py)
SEGMENT_IMPLS = ("dense", "scatter", "fused", "pallas")


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


def _nearfar(cfg: DAGNNConfig, batch: DAGBatch) -> bool:
    """Whether a schedule the config runs has a near/far layout."""
    return any((batch.fwd if d == 0 else batch.rev).edge_nsrc is not None
               for d in cfg.dirs)


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


def _remap_slot_nf(slot, unit, units_total, offset, L):
    """_remap_slot for unequal direction blocks: a per-direction buffer
    [L*unit + 1] interleaves into [L*units_total + 1] at offset `offset`
    within each row (the earlier directions' units)."""
    g = L * unit
    row, col = slot // unit, slot % unit
    return torch.where(slot == g, L * units_total,
                       row * units_total + offset + col)


def _nf_layout(s, kn, dev):
    """One direction's near/far layout: (its nf entry, nsrc [L, Ke_d]
    int32, its forward gather list [L, kv_d]). "r" ("regions") gathers the
    Kf_d far rows only, "t" ("tgonly") full rows, "p" a plain schedule
    (nsrc all pad)."""
    eslot = _t(s.edge_src_slot, dev).long()
    L, ke = tuple(eslot.shape)
    if s.edge_nsrc is None:
        return (("p", ke, ke), torch.full((L, ke), kn, dtype=torch.int32,
                                          device=dev), eslot)
    nsrc = _t(s.edge_nsrc, dev).to(torch.int32)
    kf = s.far_w
    if kf is None:
        return ("t", ke, ke), nsrc, eslot
    return ("r", ke, kf), nsrc, eslot[:, :kf].contiguous()


def _build_streams_merged(cfg: DAGNNConfig, x, edge_attr, sf, sr, dev):
    """Merged-direction streams: the per-row concat of both schedules'
    blocks. eslot / teslot are remapped into the merged state / edge-grad
    buffers; edst and tdst stay block-local. x is cast to the compute
    dtype here; the weights are cast inside the wavefront (so their grads
    come back in float32, as through the JAX package's cast).

    Near/far schedules (K7) add nf (one _nf_layout entry per direction;
    the two directions' widths may differ), nsrc and eslot_v (the forward's
    gather list, far rows only for "r"); their transpose slots index a
    per-direction edge-grad buffer of unit Kf_d ("r") or Ke_d, interleaved
    into the merged buffer of unit sum(kv_d). Returns (fxs, ixs, (L, 2Kn),
    nf or None)."""
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
    units = (ke, ke)
    nf = None
    if sf.edge_nsrc is not None or sr.edge_nsrc is not None:
        lay = [_nf_layout(s, kn, dev) for s in (sf, sr)]
        nf = tuple(e for e, _n, _v in lay)
        ixs["nsrc"] = torch.cat([n for _e, n, _v in lay], dim=1)
        ixs["eslot_v"] = torch.cat([_remap_slot(v, kn, L, d)
                                    for d, (_e, _n, v) in enumerate(lay)], 1)
        units = tuple(kf if m == "r" else kd for m, kd, kf in nf)
    kt = max(tuple(sf.tgrad_eslot.shape)[1], tuple(sr.tgrad_eslot.shape)[1])

    def padt(a, fill):
        a = _t(a, dev)
        w = kt - a.shape[1]
        return a if w == 0 else torch.nn.functional.pad(a, (0, w), value=fill)

    ixs["teslot"] = torch.cat(
        [_remap_slot_nf(padt(s.tgrad_eslot, L * u).long(), u, sum(units),
                        sum(units[:d]), L)
         for d, (s, u) in enumerate(zip((sf, sr), units))], dim=1)
    ixs["tdst"] = torch.cat([padt(sf.tgrad_dst, kn), padt(sr.tgrad_dst, kn)], 1)
    ixs["tmask"] = torch.cat([padt(sf.tgrad_mask, False),
                              padt(sr.tgrad_mask, False)], 1)
    # the kernels' index / mask types, converted once per batch
    ixs["edst"] = ixs["edst"].to(torch.int32)
    ixs["tdst"] = ixs["tdst"].to(torch.int32)
    for k in ("nmask", "emask", "tmask"):
        ixs[k] = ixs[k].to(torch.float32)
    return fxs, ixs, (L, 2 * kn), nf


class StepImpl(NamedTuple):
    """The pair of step functions a fused wavefront runs: the wrappers
    (default) or the plain versions (for comparison runs on the card)."""
    forward: object
    backward: object


KERNELS = StepImpl(row_step.row_forward, row_step.row_backward)
PLAIN = StepImpl(row_step.row_forward_plain, row_step.row_backward_plain)
PAIR_KERNELS = StepImpl(pair_step.pair_forward, pair_step.pair_backward)
PAIR_PLAIN = StepImpl(pair_step.pair_forward_plain, pair_step.pair_backward_plain)
# per direction only (ndirs=1): K5 merges the transpose edge grads, then K2
SPLIT_KERNELS = StepImpl(row_step.row_forward,
                         functools.partial(row_step.row_backward, merge_tg=False))
SPLIT_PLAIN = StepImpl(row_step.row_forward_plain,
                       functools.partial(row_step.row_backward_plain,
                                         merge_tg=False))
# the generic branch runs SEG_KERNELS (K6 and K5) or SEG_PLAIN
_PLAIN_IMPLS = (PLAIN, PAIR_PLAIN, SPLIT_PLAIN, SEG_PLAIN)


def _param_keys(cfg: DAGNNConfig, has_ea: bool, dirs=(0, 1)):
    """Dotted keys of the wavefront's parameters, direction-major."""
    keys = []
    for d in dirs:
        for l in range(cfg.num_layers):
            a = f"aggr.{d}.{l}."
            keys += [a + "attn_lin.w", a + "attn_lin.b"]
            if has_ea:
                keys += [a + "edge_encoder.w", a + "edge_encoder.b"]
            keys += [f"cells.{d}.{l}.{k}" for k in row_step.CELL_KEYS]
    return keys


class _Plan:
    """Static plan of one fused wavefront over a batch: n steps (merged
    rows, pairs of rows, or one direction's rows) of `unit` node slots
    each, every direction of `dirs` in every step. Step s gathers its
    edges' predecessor states h[eslot[s]] from the write-once state buffer,
    runs the step function (`impl`; `tail` and `kw` are its trailing
    arguments: the pair's block spec, or ndirs for a row) and writes its
    outputs to rows s*unit.. of the buffer. The backward runs the steps in
    reverse: value grads go through the edge-grad buffer and come back to
    their source step through the transpose schedule (teslot, tdst, tmask);
    weight grads add into one f32 buffer. Weights are stacked [2, ...]
    over both directions, or unstacked for one.

    nf (near/far rows, K7): the forward gathers eslot_v (far rows only
    under "r") and hands each row the previous row's outputs (prev_out,
    h's rows of step s-1; step 0 has no near edges); the backward carries
    near_g from each row to the one before it (zeros at the last row), and
    its edge-grad buffer has the width of eslot_v. res_stream=False (K2r):
    the forward keeps no residual streams and the backward re-gathers
    full-width rows (eslot) and lets the row backward recompute."""

    def __init__(self, cfg, fxs, ixs, impl, tail=(), kw=None, dirs=(0, 1),
                 nf=None, res_stream=True):
        self.cfg, self.ixs, self.impl = cfg, ixs, impl
        self.tail, self.kw, self.dirs = tail, kw or {}, tuple(dirs)
        self.nf, self.res_stream = nf, res_stream
        self.ea = fxs.get("ea")
        self.has_ea = self.ea is not None and cfg.aggregator_spec(0).wea
        self.static = (self.has_ea, cfg.hidden_dim, cfg.num_layers)
        self.lh = cfg.num_layers * cfg.hidden_dim
        self.dt = _DTYPES[cfg.compute_dtype]
        self.keys = _param_keys(cfg, self.has_ea, self.dirs)
        self.n, self.unit = tuple(fxs["x"].shape[:2])
        self.vkey = "eslot" if nf is None else "eslot_v"
        self.nv = ixs[self.vkey].shape[1]    # value rows gathered per step
        self.ne = ixs["edst"].shape[1]       # edges per step

    def weights(self, wparams):
        """Kernel weights in the compute dtype: stacked [ndirs, ...] over
        the plan's directions, unstacked for one."""
        cfg, nl = self.cfg, self.cfg.num_layers
        p = {k: v.to(self.dt) for k, v in zip(self.keys, wparams)}
        qdims = [cfg.aggregator_spec(l).query_dim for l in range(nl)]
        flat = []
        for d in self.dirs:
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
        return row_step.stack_row_weights(flat) if len(flat) > 1 else flat[0]

    def infer(self, xs, wparams):
        """The state buffer of a forward without residual streams."""
        return self.forward(xs, self.weights(wparams), emit_res=False)[0]

    def _args(self, s):
        ix = self.ixs
        args = (self.ea[s] if self.has_ea else None, ix["edst"][s],
                ix["emask"][s], ix["nmask"][s])
        # a pair step takes nsrc positionally, a near/far row (K7) by name
        return args + ((ix["nsrc"][s],) if "nsrc" in ix and self.nf is None
                       else ())

    def _nf_kw(self, s, h, prev=True):
        """K7's keywords of step s: the layout, nsrc and (prev) the previous
        step's outputs, rows (s-1)*unit.. of h (step 0, which has no near
        edges, reads its own rows)."""
        if self.nf is None:
            return {}
        kw = dict(nf=self.nf, nsrc=self.ixs["nsrc"][s])
        if prev:
            lo = max(s - 1, 0) * self.unit
            kw["prev_out"] = h[lo:lo + self.unit]
        return kw

    def forward(self, xs, weights, emit_res):
        """n forward steps (K1, K7 or K3). Returns the state buffer
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
            vals = h[self.ixs[self.vkey][s]]
            out = self.impl.forward(self.static, xs[s], vals, *self._args(s),
                                    weights, *self.tail, emit_res=emit_res,
                                    **self.kw, **self._nf_kw(s, h))
            if emit_res:
                out, a32[s], nres[s] = out
            h[s * unit:(s + 1) * unit] = out
        return h, a32, nres

    def backward(self, xs, h, weights, res, g):
        """n backward steps (K2, K7, K2r or K4) in reverse. Predecessor
        states are re-gathered from the final (write-once) state buffer
        instead of being kept as a vals stream; the edge-grad buffer is
        [n*nv + 1, nl*H] (garbage row last, left zero). res is (alpha32,
        nres), or None without residual streams."""
        n, unit, nv = self.n, self.unit, self.nv
        if "teslot" not in self.ixs:
            raise NotImplementedError(
                "the fused wavefront's backward needs a transpose schedule "
                "(tgrad_eslot), as in the JAX package")
        acc = torch.zeros((n * nv + 1, self.lh), dtype=self.dt, device=h.device)
        dw = row_step._new_dw(weights, self.cfg.num_layers, self.has_ea, h.device)
        dxs = torch.empty_like(xs)
        g_stream = g[: n * unit].to(self.dt).reshape(n, unit, self.lh)
        near_g = (torch.zeros((unit, self.lh), dtype=self.dt, device=h.device)
                  if self.nf is not None else None)
        ix = self.ixs
        for s in range(n - 1, -1, -1):
            tg = acc[ix["teslot"][s]]
            kw = self._nf_kw(s, h, prev=res is not None)
            if near_g is not None:
                kw["near_g"] = near_g
            out = self.impl.backward(
                self.static, xs[s],
                h[ix[self.vkey if res is not None else "eslot"][s]],
                *self._args(s), weights, g_stream[s].contiguous(), tg,
                ix["tdst"][s], ix["tmask"][s],
                (res[0][s], res[1][s]) if res is not None else None,
                *self.tail, dw_acc=dw, **self.kw, **kw)
            dx, dvals = out[:2]
            if near_g is not None:
                near_g = out[4]
            acc[s * nv:(s + 1) * nv] = dvals
            dxs[s] = dx
        grads = {}
        for i, d in enumerate(self.dirs):
            tree = row_step.unflatten_row_weight_grads(
                {k: v[i] for k, v in dw.items()} if len(self.dirs) > 1 else dw,
                self.cfg.num_layers, self.has_ea)
            grads.update(flatten_tree({"aggr": {d: tree["aggr"]},
                                       "cells": {d: tree["cells"]}}))
        return dxs, [grads[k] for k in self.keys]


class _Wavefront(torch.autograd.Function):
    """Both direction passes over a plan (merged: K1 row by row, K2 row by
    row in reverse; pair: K3 pair by pair, K4 in reverse); the residual
    streams of the forward feed the backward (unless plan.res_stream is
    off: K2r)."""

    @staticmethod
    def forward(ctx, plan, xs, *wparams):
        weights = plan.weights(wparams)
        h, a32, nres = plan.forward(xs, weights, emit_res=plan.res_stream)
        ctx.plan, ctx.weights = plan, weights
        ctx.res = (a32, nres) if plan.res_stream else None
        ctx.wdtypes = [p.dtype for p in wparams]
        ctx.save_for_backward(xs, h)
        return h

    @staticmethod
    def backward(ctx, g):
        xs, h = ctx.saved_tensors
        dxs, dws = ctx.plan.backward(xs, h, ctx.weights, ctx.res, g.contiguous())
        dws = [dw.to(dt) for dw, dt in zip(dws, ctx.wdtypes)]
        return (None, dxs, *dws)


def _run(plan, streams, params, function=None):
    """The plan's state buffer: through its autograd Function (`function`,
    _Wavefront by default) when a gradient is wanted, else plan.infer.
    `streams` are the plan's differentiable inputs (x, and the generic
    branch's xsrc, which may be None)."""
    wparams = [params[k] for k in plan.keys]
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (*streams, *wparams)):
        return (function or _Wavefront).apply(plan, *streams, *wparams)
    with torch.no_grad():
        return plan.infer(*streams, wparams)


def merged_pass(params, cfg: DAGNNConfig, x, edge_attr, batch: DAGBatch,
                impl: StepImpl = KERNELS):
    """Both direction passes in one wavefront. Returns (h_flat
    [L*2Kn, nl*H], x_flat [L*2Kn, emb]) in the merged level-sorted layout:
    row r holds the fwd block at rows r*2Kn..r*2Kn+Kn and the rev block
    after it. Near/far batches run the row kernels' nf modes (K7); with
    _NO_RES_STREAM the backward recomputes each row's forward (K2r)."""
    fxs, ixs, (L, kn2), nf = _build_streams_merged(cfg, x, edge_attr, batch.fwd,
                                                   batch.rev, x.device)
    xs = fxs["x"]
    h = _run(_Plan(cfg, fxs, ixs, impl, kw={"ndirs": 2}, nf=nf,
                   res_stream=not _NO_RES_STREAM), (xs,), params)
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
            and not _NO_RES_STREAM
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
    h = _run(plan, (xs,), params)
    return h[: plan.n * plan.unit], xs.reshape(plan.n * plan.unit, -1)


# ------------------------------------------------- per-direction wavefront
#
# One direction's schedule at a time (dagnn_tpu/nn/dagnn.py _direction_pass):
# the fused branch runs the row kernels at ndirs=1 over the _Plan above;
# the generic branch runs _step_outs level by level.

def _build_streams(cfg: DAGNNConfig, x, edge_attr, sched, dev,
                   kill_edges=False):
    """One direction's streams in the level-sorted layout, converted once
    per batch: x in the compute dtype [L, Kn, emb], ea [L, Ke, R], and the
    index / mask streams in the kernels' types (eslot into the state
    buffer [L*Kn + 1], garbage L*Kn; teslot into the edge-grad buffer
    [L*Ke + 1], garbage L*Ke; edst and tdst block-local, pad Kn). The level
    index of JAX's `lvl` stream is the loop index here. Under agg_x or an
    *_x attention, xsrc = x[edge_src] [L, Ke, emb] (a second differentiable
    stream); with vid_dim, vsrc and vnode: the one-hot vertex ids
    (arange(N+1) % vid_dim, reference dvae/dagnn.py:130-134) at edge_src
    and at node_ids. The transpose keys are left out when the schedule has
    none, under agg_x (whose values are not states), or when a near/far
    schedule's transpose (far edges only) meets the generic branch: its
    backward then scatter-adds, as the JAX package's does. kill_edges (the
    reverse pass under reverse_agg_noop) zeroes emask and tmask. On the
    fused branch a near/far schedule adds nf (one _nf_layout entry), nsrc
    and eslot_v; its transpose slots already index the direction's
    edge-grad buffer (unit Kf under "r", Ke under "t"). Returns (fxs, ixs,
    nf or None)."""
    dt = _DTYPES[cfg.compute_dtype]
    xd = x.to(dt)
    fxs = {"x": xd[_t(sched.node_ids, dev).long()]}
    if cfg.w_edge_attr and edge_attr is not None and cfg.num_rels > 1:
        fxs["ea"] = _t(edge_attr, dev)[_t(sched.edge_id, dev).long()].to(dt)
    if cfg.agg_x or cfg.agg_attn_x:
        fxs["xsrc"] = xd[_t(sched.edge_src, dev).long()]
    if cfg.vid_dim > 0:
        vids = torch.nn.functional.one_hot(
            torch.arange(x.shape[0], device=dev) % cfg.vid_dim,
            cfg.vid_dim).to(dt)
        fxs["vsrc"] = vids[_t(sched.edge_src, dev).long()]
        fxs["vnode"] = vids[_t(sched.node_ids, dev).long()]
    ixs = {"eslot": _t(sched.edge_src_slot, dev).long(),
           "edst": _t(sched.edge_dst, dev).to(torch.int32),
           "nmask": _t(sched.node_mask, dev).to(torch.float32),
           "emask": _t(sched.edge_mask, dev).to(torch.float32)}
    fused = _fused_applicable(cfg)
    nf = None
    if sched.edge_nsrc is not None and fused:
        entry, ixs["nsrc"], ixs["eslot_v"] = _nf_layout(
            sched, tuple(sched.node_ids.shape)[1], dev)
        nf = (entry,)
    use_t = (sched.tgrad_eslot is not None and not cfg.agg_x
             and (sched.edge_nsrc is None or fused))
    if use_t:
        ixs["teslot"] = _t(sched.tgrad_eslot, dev).long()
        ixs["tdst"] = _t(sched.tgrad_dst, dev).to(torch.int32)
        ixs["tmask"] = _t(sched.tgrad_mask, dev).to(torch.float32)
    if kill_edges:
        # every reverse aggregate is exactly zero upstream: masking all
        # edges reproduces that (masked sum 0, fully masked max segment 0)
        # and zeroes the edge-grad stream of the backward
        ixs["emask"] = torch.zeros_like(ixs["emask"])
        if use_t:
            ixs["tmask"] = torch.zeros_like(ixs["tmask"])
    return fxs, ixs, nf


def _step_outs(cfg: DAGNNConfig, params_dir, specs, vals, fxs, ixs, fns):
    """One level's per-layer outputs [nl, Kn, H] from pre-gathered inputs
    (dagnn_tpu/nn/dagnn.py _step_outs): layer i aggregates its
    predecessors' states vals[i] (under agg_x, once for every layer, the
    predecessors' inputs xsrc, zero-padded to H), with keys and queries as
    the kind takes them (*_h: the states, with the vertex ids under
    vid_dim, and the layer's input or the previous layer's output; *_x: the
    inputs), then a GRU cell (or with recurr=False a linear cell over
    [input, aggregate]) and zeroes pad slots. `fns`: the aggregate and
    merge functions (K6, K5 or their plain versions)."""
    inp_x = fxs["x"]
    kn = inp_x.shape[0]
    ea, x_src = fxs.get("ea"), fxs.get("xsrc")
    v_src, v_node = fxs.get("vsrc"), fxs.get("vnode")
    keep = ixs["nmask"][:, None] > 0

    def agg(ap, spec, values, **kw):
        return aggregate_level(
            ap, spec, values, ixs["edst"], ixs["emask"], kn + 1,
            edge_emb=encode_edges(ap, spec, ea), fns=fns, **kw)[:kn]

    ps_common = None
    if cfg.agg_x:
        kw = dict(key_src=x_src, query=inp_x) if cfg.agg_attn else {}
        ps = agg(params_dir["aggr"][0], specs[0], x_src, **kw)
        # zero-pad emb -> hidden (reference dagnn.py:165-167)
        ps_common = torch.nn.functional.pad(
            ps, (0, cfg.hidden_dim - ps.shape[-1]))
    with_vid = lambda t: t if v_src is None else torch.cat([t, v_src], -1)
    cur, outs = inp_x, []
    for i in range(cfg.num_layers):
        if cfg.agg_x:
            ps_h = ps_common
        else:
            spec, val = specs[i], vals[i]
            kw = {}
            if cfg.agg_attn and cfg.agg_attn_x:
                kw = dict(key_src=x_src, query=inp_x)
            elif cfg.agg_attn:
                # layer i's query: its input (the previous layer's output)
                q = cur
                if i > 0 and v_node is not None:
                    q = torch.cat([q, v_node], -1)
                kw = dict(key_src=with_vid(val), query=q)
            ps_h = agg(params_dir["aggr"][i], spec,
                       with_vid(val) if spec.kind == "gated_sum" else val, **kw)
        cell = params_dir["cells"][i]
        if cfg.recurr:
            out = gru_cell(cell, cur, ps_h)
        else:
            out = linear(cell, torch.cat([cur, ps_h], dim=-1))
        cur = torch.where(keep, out, 0.0)
        outs.append(cur)
    return torch.stack(outs)


def _dir_keys(params, d):
    """Dotted keys of direction d's aggregator and cell parameters."""
    return [k for k in params
            if k.split(".")[0] in ("aggr", "cells") and k.split(".")[1] == str(d)]


class _GenericPlan:
    """The generic branch over one direction: L levels of Kn slots. The
    forward scans the levels into the write-once state buffer
    [nl, L*Kn + 1, H] (garbage row last, left zero). The backward replays
    them in reverse (JAX's _wavefront_bwd): at each level the output
    cotangent is g's rows plus, through the transpose schedule, the edge
    grads of later levels merged by `fns.merge` (K5, a launch per layer),
    and torch.autograd.grad of the recomputed _step_outs gives the weight,
    value, x and xsrc grads. Value grads go to the edge-grad buffer
    [nl, L*Ke + 1, H] at rows lvl*Ke (or, without a transpose schedule, are
    scatter-added into the state cotangent). Under agg_x the levels read no
    states: no values are gathered and no value grads flow. Weights are
    cast to the compute dtype inside, so their grads come back in float32
    and the levels' grads are summed in float32."""

    def __init__(self, cfg, fxs, ixs, fns: AggImpl, keys):
        self.cfg, self.ixs, self.fns, self.keys = cfg, ixs, fns, keys
        self.side = {k: fxs[k] for k in ("ea", "vsrc", "vnode") if k in fxs}
        self.dt = _DTYPES[cfg.compute_dtype]
        self.specs = [cfg.aggregator_spec(l) for l in range(cfg.num_layers)]
        self.L, self.kn = tuple(fxs["x"].shape[:2])
        self.ke = ixs["eslot"].shape[1]
        self.reads_states = not cfg.agg_x

    def params_dir(self, wparams):
        """{"aggr": [...], "cells": [...]} in the compute dtype."""
        return unflatten_tree({
            ".".join(k.split(".")[:1] + k.split(".")[2:]): v.to(self.dt)
            for k, v in zip(self.keys, wparams)})

    def _vals(self, h, s):
        """[nl, Ke, H] predecessor states of level s's edges, or None."""
        return h[:, self.ixs["eslot"][s], :] if self.reads_states else None

    def _level(self, s, x, xsrc, vals, pdir):
        fx = {k: v[s] for k, v in self.side.items()}
        fx["x"] = x
        if xsrc is not None:
            fx["xsrc"] = xsrc
        ix = {k: self.ixs[k][s] for k in ("nmask", "edst", "emask")}
        return _step_outs(self.cfg, pdir, self.specs, vals, fx, ix, self.fns)

    def infer(self, xs, xsrc, wparams):
        return self.forward(xs, xsrc, wparams)

    def forward(self, xs, xsrc, wparams):
        cfg, L, kn = self.cfg, self.L, self.kn
        pdir = self.params_dir(wparams)
        h = torch.zeros((cfg.num_layers, L * kn + 1, cfg.hidden_dim),
                        dtype=self.dt, device=xs.device)
        for s in range(L):
            h[:, s * kn:(s + 1) * kn] = self._level(
                s, xs[s], None if xsrc is None else xsrc[s], self._vals(h, s),
                pdir)
        return h

    def backward(self, xs, xsrc, h, wparams, g):
        nl, L, kn, ke = self.cfg.num_layers, self.L, self.kn, self.ke
        ix = self.ixs
        use_t = "teslot" in ix
        acc = (torch.zeros((nl, L * ke + 1, self.cfg.hidden_dim), dtype=g.dtype,
                           device=g.device) if use_t else g.clone())
        dws = [torch.zeros(w.shape, dtype=torch.float32, device=w.device)
               for w in wparams]
        dxs = torch.zeros_like(xs)
        dxsrc = None if xsrc is None else torch.zeros_like(xsrc)
        for s in range(L - 1, -1, -1):
            if use_t:
                tg = acc[:, ix["teslot"][s]]                  # [nl, Kt, H]
                g_out = torch.stack([
                    self.fns.merge(g[l, s * kn:(s + 1) * kn], tg[l],
                                   ix["tdst"][s], ix["tmask"][s])
                    for l in range(nl)])
            else:
                g_out = acc[:, s * kn:(s + 1) * kn]
            with torch.enable_grad():
                wl = [w.detach().requires_grad_(True) for w in wparams]
                ins = [xs[s].detach().requires_grad_(True)]
                if xsrc is not None:
                    ins.append(xsrc[s].detach().requires_grad_(True))
                vals = self._vals(h, s)
                if vals is not None:
                    ins.append(vals.detach().requires_grad_(True))
                outs = self._level(s, ins[0], ins[1] if xsrc is not None else None,
                                   ins[-1] if vals is not None else None,
                                   self.params_dir(wl))
                grads = torch.autograd.grad(outs, wl + ins, g_out,
                                            allow_unused=True)
            for dw, gw in zip(dws, grads[:len(wl)]):
                if gw is not None:
                    dw.add_(gw)
            gin = grads[len(wl):]
            if gin[0] is not None:
                dxs[s] = gin[0]
            if xsrc is not None and gin[1] is not None:
                dxsrc[s] = gin[1]
            dv = gin[-1] if vals is not None else None
            if dv is None:
                continue
            if use_t:
                acc[:, s * ke:(s + 1) * ke] = dv
            else:
                acc.index_add_(1, ix["eslot"][s], dv)
        return dxs, dxsrc, [dw.to(w.dtype) for dw, w in zip(dws, wparams)]


class _GenericWavefront(torch.autograd.Function):
    """One direction's generic wavefront: the levels forward, the replayed
    levels in reverse (see _GenericPlan). xsrc may be None."""

    @staticmethod
    def forward(ctx, plan, xs, xsrc, *wparams):
        h = plan.forward(xs, xsrc, wparams)
        ctx.plan, ctx.has_xsrc = plan, xsrc is not None
        ctx.save_for_backward(xs, xsrc, h, *wparams)
        return h

    @staticmethod
    def backward(ctx, g):
        xs, xsrc, h, *wparams = ctx.saved_tensors
        dxs, dxsrc, dws = ctx.plan.backward(
            xs, xsrc if ctx.has_xsrc else None, h, wparams, g.contiguous())
        return (None, dxs, dxsrc, *dws)


class _PermGather(torch.autograd.Function):
    """src[idx] whose VJP is the inverse-permutation gather (JAX's
    _perm_gather): legal when every row of src appears at most once in idx,
    as each node owns one slot per schedule. d_src[r] = g[inv_idx[r]] where
    inv_valid[r], else 0: no scatter, no atomics."""

    @staticmethod
    def forward(ctx, src, idx, inv_idx, inv_valid):
        ctx.save_for_backward(inv_idx, inv_valid)
        return src[idx]

    @staticmethod
    def backward(ctx, g):
        inv_idx, inv_valid = ctx.saved_tensors
        d_src = torch.where(inv_valid[:, None],
                            g[torch.clamp(inv_idx, 0, g.shape[0] - 1)],
                            torch.zeros((), dtype=g.dtype, device=g.device))
        return d_src, None, None, None


def _perm_gather(src, idx, inv_idx, inv_valid):
    return _PermGather.apply(src, idx, inv_idx, inv_valid)


def _direction_pass(params, cfg: DAGNNConfig, x, edge_attr, sched, d,
                    impl, slot_space: bool = True, kill_edges: bool = False):
    """The wavefront pass of direction d (JAX's _direction_pass). Returns,
    with slot_space, (h_flat [L*Kn, nl*H], layer l in columns l*H:(l+1)*H,
    and x_slot [L*Kn, emb]) in the direction's level-sorted layout; else
    the node-space states [nl, N+1, H] (the fused branch through
    _perm_gather, the generic branch by h[:, node_slot]). `impl`: a
    StepImpl (fused branch, the row kernels at ndirs=1) or an AggImpl
    (generic branch). kill_edges: see _build_streams."""
    dev = x.device
    fxs, ixs, nf = _build_streams(cfg, x, edge_attr, sched, dev, kill_edges)
    xs = fxs["x"]
    L, kn = tuple(xs.shape[:2])
    node_slot = _t(sched.node_slot, dev).long()
    if isinstance(impl, StepImpl):
        h = _run(_Plan(cfg, fxs, ixs, impl, kw={"ndirs": 1}, dirs=(d,), nf=nf),
                 (xs,), params)                            # [L*Kn+1, nl*H]
        if not slot_space:
            n_pad = node_slot.shape[0] - 1
            nid = _t(sched.node_ids, dev).long().reshape(L * kn)
            inv = torch.cat([nid, nid.new_full((1,), n_pad)])
            valid = torch.cat([nid != n_pad, nid.new_zeros((1,), dtype=torch.bool)])
            hn = _perm_gather(h, node_slot, inv, valid)      # [N+1, nl*H]
            return hn.reshape(n_pad + 1, cfg.num_layers, -1).movedim(1, 0)
        h = h[: L * kn]
    else:
        h = _run(_GenericPlan(cfg, fxs, ixs, impl, _dir_keys(params, d)),
                 (xs, fxs.get("xsrc")), params, _GenericWavefront)
        if not slot_space:
            return h[:, node_slot]
        # [nl, L*Kn+1, H] -> [L*Kn, nl*H], the per-layer concat
        h = torch.cat([h[l, : L * kn] for l in range(cfg.num_layers)], dim=-1)
    return h, xs.reshape(L * kn, -1)


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


def _keep_mask(shape, keep, rng, device):
    """Dropout's mask: each element True with probability `keep`, from a
    uniform draw of `rng` (a torch.Generator on `device`)."""
    return torch.rand(shape, generator=rng, device=device) < keep


def _apply_head(params, cfg: DAGNNConfig, out, rng, train):
    """The head over the pooled [G, D], after dropout when training: each
    element kept with probability 1 - dropout and scaled by
    1 / (1 - dropout)."""
    out = out.float()
    if train and cfg.dropout > 0.0:
        if rng is None:
            raise ValueError("dropout in training needs a torch.Generator (rng)")
        keep = 1.0 - cfg.dropout
        out = torch.where(_keep_mask(out.shape, keep, rng, out.device),
                          out / keep, 0.0)
    if cfg.num_class > 0 or cfg.num_vocab == 1:
        y = linear({"w": params["head.w"], "b": params["head.b"]}, out)
        return torch.relu(y) if cfg.num_class == 0 else y
    # [G, D] x [S, V, D] -> [G, S, V]
    return torch.einsum("gd,svd->gsv", out, params["head.w"]) + params["head.b"][None]


def _route(cfg: DAGNNConfig, batch: DAGBatch, impl):
    """(route, impl) of a batch, as the JAX package routes it: "pair",
    "merged" or "direction" (fused), or "generic" (every config the fused
    paths do not take). The node-space readout (out_pool_all) runs per
    direction. SPLIT_KERNELS / SPLIT_PLAIN run one direction at a time, so
    they take any fused batch per direction, except a near/far one
    (ValueError: the near grads join K2's own cotangent sum, as the JAX
    kernel asserts). An unknown segment_impl name raises ValueError."""
    if cfg.segment_impl not in SEGMENT_IMPLS:
        raise ValueError(f"unknown segment_impl {cfg.segment_impl!r}: one of "
                         f"{SEGMENT_IMPLS}")
    if not _fused_applicable(cfg):
        route, allowed = "generic", (SEG_KERNELS, SEG_PLAIN)
    else:
        merged = not cfg.out_pool_all and merged_applicable(cfg, batch)
        if impl in (SPLIT_KERNELS, SPLIT_PLAIN) and _nearfar(cfg, batch):
            raise ValueError("SPLIT_KERNELS / SPLIT_PLAIN (merge_tg=False) "
                             "cannot run a near/far batch: its near grads "
                             "need merge_tg=True")
        if impl in (SPLIT_KERNELS, SPLIT_PLAIN) or not merged:
            route = "direction"
            allowed = (KERNELS, PLAIN, SPLIT_KERNELS, SPLIT_PLAIN)
        elif pair_applicable(cfg, batch):
            route, allowed = "pair", (PAIR_KERNELS, PAIR_PLAIN)
        else:
            route, allowed = "merged", (KERNELS, PLAIN)
    impl = allowed[0] if impl is None else impl
    if impl not in allowed:
        raise ValueError(f"impl must be one of {allowed} on the {route} path")
    return route, impl


def _encode(params, cfg: DAGNNConfig, batch: DAGBatch, dev):
    """The encoder's node inputs [N+1, emb], the garbage row exactly zero
    so pad gathers are inert."""
    enc = {k[len("encoder."):]: v for k, v in params.items()
           if k.startswith("encoder.")}
    x = encode(enc, cfg.encoder, _t(batch.x, dev),
               _t(batch.extras["node_depth"], dev)
               if "node_depth" in batch.extras else None)
    return torch.where(_t(batch.node_mask, dev).bool()[:, None], x, 0.0)


def _node_states(params, cfg, batch, impl, dev):
    x = _encode(params, cfg, batch, dev)
    h_dirs = [_direction_pass(params, cfg, x, batch.edge_attr,
                              batch.fwd if d == 0 else batch.rev, d, impl,
                              slot_space=False,
                              kill_edges=(d == 1 and cfg.reverse_agg_noop))
              for d in cfg.dirs]
    return x, h_dirs


def dagnn_node_states(params, cfg: DAGNNConfig, batch: DAGBatch, impl=None):
    """Run the encoder and every direction pass (the fused branch at one
    direction, or the generic branch); return (x, h_dirs) where h_dirs[d]
    is [num_layers, N+1, H] in node space. The seam the VAE encoder builds
    its own readout on (reference dvae/dagnn.py:147-170). impl: None for
    the kernels (KERNELS or SEG_KERNELS by branch), else as dagnn_forward
    takes it on the "direction" or "generic" route."""
    if impl is None:
        impl = KERNELS if _fused_applicable(cfg) else SEG_KERNELS
    return _node_states(params, cfg, batch, impl, params["head.w"].device)


def dagnn_forward(params, cfg: DAGNNConfig, batch: DAGBatch,
                  rng: Optional[torch.Generator] = None, train: bool = False,
                  impl=None):
    """Full forward pass: per-position token logits [G, S, V] (class
    logits [G, C] / regression [G, 1] per config). Runs on the device of
    the parameters. A fused bidirectional batch with the slot-space
    readout runs pair_pass (with a pair plan) or merged_pass when both
    directions' shapes agree; any other batch runs _direction_pass per
    direction (the fused or the generic branch). `impl` picks the
    functions: None for the kernels; KERNELS / PLAIN on the merged and
    per-direction paths, PAIR_KERNELS / PAIR_PLAIN on the pair path,
    SPLIT_KERNELS / SPLIT_PLAIN (per direction, on any fused batch),
    SEG_KERNELS / SEG_PLAIN on the generic branch (another choice raises
    ValueError). The readout's segment sums use K5 or, under a plain
    impl, its plain version. rng: a torch.Generator for dropout when
    `train` (cfg.dropout > 0)."""
    route, impl = _route(cfg, batch, impl)
    dev = params["head.w"].device
    merge = (row_step.tg_accumulate_plain if impl in _PLAIN_IMPLS
             else row_step.tg_accumulate)
    num_graphs = batch.num_graph_slots
    if cfg.out_pool_all:
        # node space: every direction's layers beside x, pooled per graph
        x, h_dirs = _node_states(params, cfg, batch, impl, dev)
        layers = [h[l] for h in h_dirs for l in range(cfg.num_layers)]
        hcat = torch.cat(([x] if cfg.out_wx else []) + layers, dim=-1)
        out = pool_nodes(hcat, _t(batch.graph_id, dev), num_graphs,
                         cfg.out_pool, _t(batch.node_mask, dev).bool(), merge)
        return _apply_head(params, cfg, out, rng, train)
    x = _encode(params, cfg, batch, dev)
    if route in ("pair", "merged"):
        run = pair_pass if route == "pair" else merged_pass
        h2, x2 = run(params, cfg, x, batch.edge_attr, batch, impl)
    parts = []
    for d in cfg.dirs:
        sched = batch.fwd if d == 0 else batch.rev
        L, kn = tuple(sched.node_ids.shape)
        oslots = batch.out_slots_fwd if d == 0 else batch.out_slots_rev
        merged = route in ("pair", "merged")
        if merged and oslots is not None:
            # this direction's output rows straight from the merged buffer
            hd, xd = h2, x2
            ms = _remap_slot(_t(oslots, dev).long(), kn, L, d)
        elif merged:
            # the direction's view of the merged buffer
            view = lambda a: a.reshape(L, 2, kn, -1)[:, d].reshape(L * kn, -1)
            hd, xd = view(h2), view(x2)
        else:
            hd, xd = _direction_pass(
                params, cfg, x, batch.edge_attr, sched, d, impl,
                kill_edges=(d == 1 and cfg.reverse_agg_noop))
            # pad entries point at slot 0 and are killed by the mask
            ms = None if oslots is None else _t(oslots, dev).long()
        if oslots is not None:
            hcat = hd[ms]
            if cfg.out_wx:          # x's rows are gathered only where read
                hcat = torch.cat([xd[ms], hcat], dim=-1)
            omask = batch.out_slots_mask_fwd if d == 0 else batch.out_slots_mask_rev
            parts.append(_pool_gathered(hcat, _t(omask, dev).bool(), cfg.out_pool))
            continue
        # a segment pool over the direction's slots, its output nodes only
        hcat = torch.cat([xd, hd], dim=-1) if cfg.out_wx else hd
        nid = _t(sched.node_ids, dev).long().reshape(L * kn)
        omask = batch.out_mask_fwd if d == 0 else batch.out_mask_rev
        slot_mask = (_t(omask, dev).bool() & _t(batch.node_mask, dev).bool())[nid]
        parts.append(pool_nodes(hcat, _t(batch.graph_id, dev)[nid], num_graphs,
                                cfg.out_pool, slot_mask, merge))
    out = torch.cat(parts, dim=-1)
    return _apply_head(params, cfg, out, rng, train)


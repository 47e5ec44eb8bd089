"""Row kernels of the wavefront: K1 (row forward) and K2 (row backward).

Counterpart of dagnn_tpu/ops/pallas/row_step.py. One call runs one whole
wavefront row through every GRU layer (layer l's output is layer l+1's
input and query):

  per layer l:
    k      = val_l + ea We_l^T + be_l       (edge-type encoder, optional)
    s_e    = q[dst] wq_l + k wk_l + b_l      (additive attention)
    alpha  = segment_softmax(s) over each destination's edges
             (max-shifted, float32, +1e-16 in the denominator)
    agg    = sum_e alpha_e val_e
    out_l  = GRUCell(cur, agg) * nmask

With ndirs=2 (the direction-merged row) every per-row operand is the
concat of the two direction blocks along axis 0 and each weight is stacked
[2, ...]. State crossing the call is layer-packed: vals / outs /
cotangents are [K, L*H], layer l in columns l*H:(l+1)*H.

K7, the near/far layouts (nf, dag/schedule.py nearfar): nf gives each
direction block (mode, Ke_d, Kf_d), and the blocks' widths may differ
(nf_blocks). "r" (regions): vals hold only the block's Kf_d far rows; its
near edges (the tail of the block, source in the previous wavefront row)
read their values from `prev_out` (the previous row's outputs) at slot
nsrc, pad nsrc = Kn reading zero. "t" (tgonly): full vals. "p": a plain
block. In the backward the transpose stream covers far edges only: each
block's near-edge value grads, rounded to the compute dtype, are summed
over nsrc into `near_g_out` (the previous row's cotangent, in g's dtype),
and the next row's `near_g` is added to this row's float32 cotangent sum.
Under "t" the near rows of dvals are still written (the transpose
schedule never reads them).

K2r, K2 without residual streams (res=None, the JAX kernel's in-kernel
forward recompute): the forward is recomputed from full-width vals (every
block's rows at its edge offset, whatever its mode) and the backward then
runs as with the streams, so its results are bitwise those of K2 fed by
K1 on the same inputs.

Each kernel has two implementations with one signature:
  * row_forward_plain / row_backward_plain: plain PyTorch, the same
    arithmetic and rounding points as the TPU kernel (segment ops are
    indexed sums, not one-hot matmuls). The CPU tests hold them against
    the JAX kernels in interpret mode.
  * row_forward / row_backward: the wrappers. For CPU tensors they call
    the plain version; for CUDA tensors they launch the hand-written
    kernels of csrc/wavefront.cu (built on first use, see ops/build.py) or
    raise. Each counts its launches in `launch_counts`.

K2 consumes the forward's residual streams (use_res). By default it
merges the transpose edge-grads in itself (merge_tg=True); with
merge_tg=False (one direction only) K5, `tg_accumulate`, first adds them
onto the cotangent and K2 takes the pre-merged cotangent with no transpose
list: the JAX package's two-call form (row_step.py _tg_accumulate). K5
rounds that cotangent to the compute dtype, so in bf16 the two forms agree
only to that rounding. Weight grads are float32 and are ADDED into
`dw_acc` when one is given, so a wavefront sums its rows in one buffer
without an extra pass.

The per-block plain math (_block_forward, _block_backward) and the CUDA
launch drivers (cuda_forward, cuda_backward, which take block tables) are
shared with the pair kernels K3/K4 of ops/pair_step.py: a merged row is the
uniform case of a pair's ragged blocks.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dagnn_tpu_torch.ops.gru import gru_gates

_EPS = 1e-16
_F32 = torch.float32

# launches of each wrapper's CUDA kernels (one per wrapper call on a card):
# a call with nf counts as K7 (row_forward_nf, row_backward_nf), a backward
# without residual streams as K2r (row_backward_recompute), with or
# without nf
launch_counts = {"row_forward": 0, "row_backward": 0, "tg_accumulate": 0,
                 "row_forward_nf": 0, "row_backward_nf": 0,
                 "row_backward_recompute": 0}


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------- plumbing

def agg_keys(has_ea, rows=False):
    ks = ("wq", "wk", "b") + (("we", "be") if has_ea else ())
    if rows:
        ks = ks + ("wqr", "wkr")  # row-form copies, backward-only inputs
    return ks


CELL_KEYS = ("w_ih", "w_hh", "b_ih", "b_hh")
CELL_FWD_KEYS = ("w_rz", "w_in", "w_hn", "b_rz", "b_in", "b_hn")


def _names(nlayers, has_ea):
    """Ordered names of the weights that carry a gradient."""
    ns = []
    for l in range(nlayers):
        ns += [f"a{l}_{k}" for k in agg_keys(has_ea)]
        ns += [f"c{l}_{k}" for k in CELL_KEYS]
    return ns


def flatten_row_weights(aggr, cells, query_dims, has_ea):
    """The row kernels' flat weight dict for one direction.

    aggr[l] = {"attn_lin": {"w": [1, Dq+A], "b": [1]}, "edge_encoder"?};
    cells[l] = torch-layout GRU dict; query_dims[l] is layer l's query dim.
    Score weights come in column form [D, 1] (forward) and row form
    [1, D] (backward); w_rz / w_in / w_hn and the combined biases are
    derived views of the canonical GRU weights, computed in the weights'
    own dtype as the JAX package does (b_rz = b_ih[:2H] + b_hh[:2H] is
    rounded once in bf16). Only the canonical names carry gradients."""
    out = {}
    for l, (ap, cp) in enumerate(zip(aggr, cells)):
        w = ap["attn_lin"]["w"]
        dq = query_dims[l]
        out[f"a{l}_wq"] = w[:, :dq].T
        out[f"a{l}_wk"] = w[:, dq:].T
        out[f"a{l}_wqr"] = w[:, :dq]
        out[f"a{l}_wkr"] = w[:, dq:]
        out[f"a{l}_b"] = ap["attn_lin"]["b"].reshape(1, 1)
        if has_ea:
            out[f"a{l}_we"] = ap["edge_encoder"]["w"]
            out[f"a{l}_be"] = ap["edge_encoder"]["b"].reshape(1, -1)
        out[f"c{l}_w_ih"] = cp["w_ih"]
        out[f"c{l}_w_hh"] = cp["w_hh"]
        out[f"c{l}_b_ih"] = cp["b_ih"].reshape(1, -1)
        out[f"c{l}_b_hh"] = cp["b_hh"].reshape(1, -1)
        hd = cp["w_ih"].shape[0] // 3
        out[f"c{l}_w_rz"] = torch.cat(
            [cp["w_ih"][: 2 * hd], cp["w_hh"][: 2 * hd]], dim=1)
        out[f"c{l}_w_in"] = cp["w_ih"][2 * hd:]
        out[f"c{l}_w_hn"] = cp["w_hh"][2 * hd:]
        out[f"c{l}_b_rz"] = (cp["b_ih"][: 2 * hd]
                             + cp["b_hh"][: 2 * hd]).reshape(1, -1)
        out[f"c{l}_b_in"] = cp["b_ih"][2 * hd:].reshape(1, -1)
        out[f"c{l}_b_hn"] = cp["b_hh"][2 * hd:].reshape(1, -1)
    return {k: v.contiguous() for k, v in out.items()}


def stack_row_weights(w_dirs):
    """Stack per-direction flat weight dicts into [ndirs, ...] leaves for
    the direction-merged row (ndirs=2)."""
    return {k: torch.stack([w[k] for w in w_dirs]) for k in w_dirs[0]}


def unflatten_row_weight_grads(dw, nlayers, has_ea):
    """Map one direction's flat weight-grad dict back to the params tree
    shapes ({"aggr": [...], "cells": [...]})."""
    aggr, cells = [], []
    for l in range(nlayers):
        ap = {"attn_lin": {
            "w": torch.cat([dw[f"a{l}_wq"].T, dw[f"a{l}_wk"].T], dim=1),
            "b": dw[f"a{l}_b"].reshape(1)}}
        if has_ea:
            ap["edge_encoder"] = {"w": dw[f"a{l}_we"],
                                  "b": dw[f"a{l}_be"].reshape(-1)}
        aggr.append(ap)
        cells.append({"w_ih": dw[f"c{l}_w_ih"], "w_hh": dw[f"c{l}_w_hh"],
                      "b_ih": dw[f"c{l}_b_ih"].reshape(-1),
                      "b_hh": dw[f"c{l}_b_hh"].reshape(-1)})
    return {"aggr": aggr, "cells": cells}


# -------------------------------------------------------- plain versions

class _Segments:
    """Segment ops of one direction block over its Kn destination slots.

    An edge is valid when its mask is set and its slot lies in [0, Kn);
    pad edges (slot Kn or mask 0) contribute nothing and receive zeros."""

    def __init__(self, dst, mask, kn):
        dst = dst.long()
        self.kn = kn
        self.valid = (mask.float() > 0) & (dst >= 0) & (dst < kn)
        self.idx = torch.where(self.valid, dst, kn)
        self.col = self.valid[:, None]

    def sum(self, v):                 # [K, C] -> [Kn, C] float32
        out = torch.zeros((self.kn + 1,) + v.shape[1:], dtype=v.dtype,
                          device=v.device)
        out.index_add_(0, self.idx, v)
        return out[: self.kn]

    def gather(self, x):              # [Kn, C] -> [K, C], zero if invalid
        idx = torch.clamp(self.idx, max=self.kn - 1)
        return torch.where(self.col, x[idx], torch.zeros((), dtype=x.dtype,
                                                         device=x.device))

    def max(self, s):                 # [K, 1] -> [Kn, 1]; empty -> 0
        neg = torch.finfo(_F32).min
        out = torch.full((self.kn + 1,), neg, dtype=_F32, device=s.device)
        out = out.scatter_reduce(0, self.idx, s[:, 0], "amax",
                                 include_self=True)[: self.kn, None]
        return torch.where(out <= neg, 0.0, out)


def _f(t):
    return t.float()


def _encode_k(val, ea, aggp):
    if ea is None:
        return val
    return (_f(val) + _f(ea) @ _f(aggp["we"]).T + _f(aggp["be"])).to(val.dtype)


def _layer_fwd(aggp, cellp, cur, q, val, ea, seg, nmask, hdim):
    """One layer's forward (the TPU kernel's _layer_fwd). Returns
    (out f32, residuals (alpha32, agg, r, z, n))."""
    dt = val.dtype
    k = _encode_k(val, ea, aggp)
    q_scores = _f(q) @ _f(aggp["wq"])                          # [Kn, 1]
    k_scores = _f(k) @ _f(aggp["wk"]) + _f(aggp["b"])          # [Ke, 1]
    scores = seg.gather(_f(q_scores.to(dt))) + k_scores
    seg_max = seg.max(scores)
    e = torch.where(seg.col,
                    torch.exp(scores - seg.gather(_f(seg_max.to(dt)))), 0.0)
    denom = seg.sum(_f(e.to(dt)))                              # [Kn, 1]
    alpha32 = e / (seg.gather(_f(denom.to(dt))) + _EPS)
    alpha = alpha32.to(dt)
    agg = seg.sum(_f(val * alpha)).to(dt)                      # [Kn, H]
    r, z, n, _h_n = gru_gates(cellp, cur, agg, hdim)
    z_dt, n_dt = z.to(dt), n.to(dt)
    out = ((1.0 - _f(z_dt)) * _f(n_dt) + _f(z_dt) * _f(agg)) * nmask
    return out, (alpha32, agg, r.to(dt), z_dt, n_dt)


def _wsel(weights, ndirs, d):
    return (lambda nm: weights[nm][d]) if ndirs > 1 else (lambda nm: weights[nm])


def _block_forward(static, w, xin, vals, ea, seg, nm):
    """One direction block through every layer. w(name) reads the block's
    direction's weight; vals [Ke, L*H] are its edges' value rows. Returns
    per layer the output [Kn, H] in the compute dtype and the residuals
    (alpha32, agg, r, z, n)."""
    has_ea, hdim, nlayers = static
    cur = xin
    outs, ress = [], []
    for l in range(nlayers):
        aggp = {k: w(f"a{l}_{k}") for k in agg_keys(has_ea)}
        cellp = {k: w(f"c{l}_{k}") for k in CELL_FWD_KEYS}
        o, res = _layer_fwd(aggp, cellp, cur, cur,
                            vals[:, l * hdim:(l + 1) * hdim], ea, seg, nm, hdim)
        cur = o.to(xin.dtype)
        outs.append(cur)
        ress.append(res)
    return outs, ress


def _store_forward(out, a32, nres, ns, es, outs, ress, hdim):
    """Write one block's layer outputs (and residual streams) into the
    call's layer-packed outputs."""
    for l, (o, (alpha32, *gates)) in enumerate(zip(outs, ress)):
        out[ns, l * hdim:(l + 1) * hdim] = o
        if a32 is not None:
            a32[es, l] = alpha32[:, 0]
            for i, t in enumerate(gates):
                c = (4 * l + i) * hdim
                nres[ns, c:c + hdim] = t


def _forward_outputs(xin, ke, nlayers, hdim, emit_res):
    """The forward's outputs: outs [Kn_all, L*H] and, with emit_res,
    alpha32 [Ke_all, L] (zero on pad edges) and nres [Kn_all, 4*L*H]."""
    kn, dt, dev = xin.shape[0], xin.dtype, xin.device
    out = torch.empty((kn, nlayers * hdim), dtype=dt, device=dev)
    if not emit_res:
        return out, None, None
    return (out, torch.zeros((ke, nlayers), dtype=_F32, device=dev),
            torch.empty((kn, 4 * nlayers * hdim), dtype=dt, device=dev))


def nf_blocks(nf, ndirs, ke_total):
    """The direction blocks of a row, per direction (mode, edge offset,
    edge width, vals offset, vals width): the JAX kernels' _nf_blocks.
    nf = ((mode, Ke_d, Kf_d), ...) per direction; a block's vals width is
    Kf_d under "r", Ke_d otherwise. nf None: uniform "p" blocks of
    ke_total / ndirs edges."""
    blocks, eo, vo = [], 0, 0
    for d in range(ndirs):
        mode, ked, kfd = (nf[d] if nf is not None
                          else ("p", ke_total // ndirs, ke_total // ndirs))
        kvd = kfd if mode == "r" else ked
        blocks.append((mode, eo, ked, vo, kvd))
        eo, vo = eo + ked, vo + kvd
    return blocks


def _full_nf(nf):
    """nf with every block plain at its edge width: the layout of
    full-width vals (K2r's recompute)."""
    return None if nf is None else tuple(("p", ked, ked) for _m, ked, _kf in nf)


def _routed(nf):
    return nf is not None and any(m == "r" for m, *_r in nf)


def _route(prev, nsrc, kn):
    """Routed value rows: prev[nsrc] (prev = a node block's layer-packed
    outputs), zero where nsrc is a pad (Kn)."""
    nsrc = nsrc.long()
    ok = (nsrc >= 0) & (nsrc < kn)
    rows = prev[torch.clamp(nsrc, 0, kn - 1)]
    return torch.where(ok[:, None], rows, torch.zeros((), dtype=prev.dtype,
                                                      device=prev.device))


def _block_vals(routed, vals, vo, kvd, nsrc_b, prev, kn):
    """A block's value rows [Ke_d, L*H]: its kvd gathered rows, then (when
    `routed`: a K7 "r" block, or a pair's B block) the rest of its edges'
    rows routed from `prev` by nsrc_b."""
    far = vals[vo:vo + kvd]
    if not routed:
        return far
    return torch.cat([far, _route(prev, nsrc_b[kvd:], kn)])


def row_forward_plain(static, xin, vals, ea, edst, emask, nmask, weights,
                      emit_res: bool = False, ndirs: int = 1, nf=None,
                      nsrc=None, prev_out=None):
    """Whole-row forward (K1), plain PyTorch. vals [ndirs*Ke, L*H];
    returns outs [ndirs*Kn, L*H], and with emit_res the backward's
    residual streams (alpha32 [ndirs*Ke, L] f32, nres [ndirs*Kn, 4*L*H]:
    agg/r/z/n per layer).

    K7 (nf, see nf_blocks): vals [sum of the vals widths, L*H]; an "r"
    block's near rows come from prev_out [ndirs*Kn, L*H] (the previous
    row's outputs) through nsrc [sum Ke_d]. edst / emask / ea / nsrc and
    alpha32 span the full edge widths."""
    has_ea, hdim, nlayers = static
    kn = xin.shape[0] // ndirs
    out, a32, nres = _forward_outputs(xin, edst.shape[0], nlayers, hdim, emit_res)
    for d, (mode, eo, ked, vo, kvd) in enumerate(nf_blocks(nf, ndirs,
                                                           edst.shape[0])):
        ns, es = slice(d * kn, (d + 1) * kn), slice(eo, eo + ked)
        vals_d = _block_vals(mode == "r", vals, vo, kvd,
                             nsrc[es] if mode == "r" else None,
                             prev_out[ns] if mode == "r" else None, kn)
        outs, ress = _block_forward(
            static, _wsel(weights, ndirs, d), xin[ns], vals_d,
            ea[es] if has_ea else None, _Segments(edst[es], emask[es], kn),
            _f(nmask[ns])[:, None])
        _store_forward(out, a32, nres, ns, es, outs, ress, hdim)
    return (out, a32, nres) if emit_res else out


def _layer_bwd(aggp, cellp, cur, q, val, ea, seg, res, g, hdim):
    """One layer's VJP (the TPU kernel's _layer_bwd). g [Kn, H] f32."""
    dt = val.dtype
    k, alpha, alpha32, agg, r, z, n, h_n = res
    r, z, n, h_n = (_f(a) for a in (r, z, n, h_n))
    dn = g * (1.0 - z)
    dz = g * (_f(agg) - n)
    dpre_n = dn * (1.0 - n * n)
    dr = dpre_n * h_n
    dpre_z = dz * z * (1.0 - z)
    dpre_r = dr * r * (1.0 - r)
    dgi = torch.cat([dpre_r, dpre_z, dpre_n], dim=1).to(dt)
    dgh = torch.cat([dpre_r, dpre_z, dpre_n * r], dim=1).to(dt)
    dcur = _f(dgi) @ _f(cellp["w_ih"])                         # [Kn, In]
    dagg = (_f(dgh) @ _f(cellp["w_hh"]) + g * z).to(dt)        # [Kn, H]
    dcell = {
        "w_ih": _f(dgi).T @ _f(cur),
        "w_hh": _f(dgh).T @ _f(agg),
        "b_ih": _f(dgi).sum(0, keepdim=True),
        "b_hh": _f(dgh).sum(0, keepdim=True),
    }
    g_rows = seg.gather(dagg)                                  # [Ke, H]
    dval = alpha * g_rows
    dalpha = _f(g_rows * val).sum(1, keepdim=True)
    seg_dot = seg.sum(_f((alpha32 * dalpha).to(dt)))           # [Kn, 1]
    dscores = (alpha32 * (dalpha - seg.gather(_f(seg_dot.to(dt))))).to(dt)
    dq_scores = seg.sum(_f(dscores)).to(dt)                    # [Kn, 1]
    dq = _f(dq_scores) * _f(aggp["wqr"])                       # [Kn, Dq]
    dk = (_f(dscores) * _f(aggp["wkr"])).to(dt)                # [Ke, A]
    daggp = {
        "wq": _f(q).T @ _f(dq_scores),
        "wk": _f(k).T @ _f(dscores),
        "b": _f(dscores).sum(0, keepdim=True),
    }
    dval = (dval + dk).to(dt)
    dea = None
    if ea is not None:
        daggp["we"] = _f(dk).T @ _f(ea)
        daggp["be"] = _f(dk).sum(0, keepdim=True)
        dea = (_f(dk) @ _f(aggp["we"])).to(dt)
    return dcur, dq, dval, dea, daggp, dcell


def _new_dw(weights, nlayers, has_ea, device):
    return {n: torch.zeros(weights[n].shape, dtype=_F32, device=device)
            for n in _names(nlayers, has_ea)}


def _rebuild_outputs(nres, nm, hdim, nlayers):
    """A block's layer outputs rebuilt from its residual streams: bitwise
    the forward's (z and n were rounded before the combine)."""
    outs = []
    for l in range(nlayers):
        agg, z, n = (nres[:, (4 * l + i) * hdim:(4 * l + i + 1) * hdim]
                     for i in (0, 2, 3))
        outs.append((((1.0 - _f(z)) * _f(n) + _f(z) * _f(agg)) * nm).to(nres.dtype))
    return outs


def _block_backward(static, w, xin, vals, ea, seg, nm, a32, nres, g, gadd,
                    dw_add):
    """One direction block's VJP. The cotangent of layer l's output is
    g[:, l] + gadd[:, l] (gadd f32: the transpose-edge grads, and in a pair
    the intra-pair value grads). k and h_n are rebuilt from vals and agg,
    each layer's input from the residuals. Weight grads (f32) go to
    dw_add(name, grad). Returns (dx f32 [Kn, In], per layer dval [Ke, H]
    in the compute dtype, dea f32 [Ke, R] or None)."""
    has_ea, hdim, nlayers = static
    dt = vals.dtype
    curs = [xin] + _rebuild_outputs(nres, nm, hdim, nlayers)[:-1]
    resids, aggps, cellps = [], [], []
    for l in range(nlayers):
        aggp = {k: w(f"a{l}_{k}") for k in agg_keys(has_ea, rows=True)}
        cellp = {k: w(f"c{l}_{k}") for k in CELL_KEYS + ("w_hn", "b_hn")}
        aggps.append(aggp)
        cellps.append(cellp)
        k_l = _encode_k(vals[:, l * hdim:(l + 1) * hdim], ea, aggp)
        alpha32 = a32[:, l:l + 1]
        agg, r, z, n = (nres[:, (4 * l + i) * hdim:(4 * l + i + 1) * hdim]
                        for i in range(4))
        h_n = (_f(agg) @ _f(cellp["w_hn"]).T + _f(cellp["b_hn"])).to(dt)
        resids.append((k_l, alpha32.to(dt), alpha32, agg, r, z, n, h_n))
    dea = (torch.zeros((vals.shape[0], ea.shape[1]), dtype=_F32,
                       device=vals.device) if has_ea else None)
    dvals = [None] * nlayers
    g_next = None
    for l in range(nlayers - 1, -1, -1):
        g_l = _f(g[:, l * hdim:(l + 1) * hdim]) + gadd[:, l * hdim:(l + 1) * hdim]
        if g_next is not None:
            g_l = g_l + g_next
        g_l = g_l * nm
        dcur, dq, dval, dea_l, daggp, dcell = _layer_bwd(
            aggps[l], cellps[l], curs[l], curs[l],
            vals[:, l * hdim:(l + 1) * hdim], ea, seg, resids[l], g_l, hdim)
        dvals[l] = dval
        for pre, grads in (("a", daggp), ("c", dcell)):
            for key, v in grads.items():
                dw_add(f"{pre}{l}_{key}", v)
        if dea_l is not None:
            dea = dea + _f(dea_l)
        g_next = dcur + dq
    return g_next, dvals, dea


def _dw_adder(dw, stacked, d):
    if stacked:
        return lambda name, v: dw[name][d].add_(v)
    return lambda name, v: dw[name].add_(v)


def tg_accumulate_plain(g, tg, tdst, tmask):
    """K5, plain PyTorch: g [Kn, C] + the sum of the transpose edge grads
    tg [Kt, C] onto their local source slots tdst where tmask is set (pad
    slot Kn dropped), in float32, rounded to g's dtype."""
    seg = _Segments(tdst, tmask, g.shape[0])
    return (_f(g) + seg.sum(_f(tg))).to(g.dtype)


def _split_tg(merge_tg, ndirs, g, tg, tdst, tmask, accumulate, nf=None):
    """The cotangent and transpose streams K2 takes: as given, or with
    merge_tg=False the cotangent pre-merged by K5 (`accumulate`) and empty
    transpose streams."""
    if merge_tg:
        return g, tg, tdst, tmask
    if ndirs != 1:
        raise ValueError("merge_tg=False (the split transpose-grad merge, K5) "
                         "is single-direction only")
    if nf is not None:
        raise ValueError("near/far layouts (nf) need merge_tg=True: the near "
                         "grads join K2's own cotangent sum, as the JAX "
                         "kernel asserts")
    g = accumulate(g, tg, tdst, tmask)
    return g, tg[:0], tdst[:0], tmask[:0]


def _near_grads(mode, dvl, nsrc_b, emask_b, kvd, kn):
    """A block's contribution to the previous row's cotangent [Kn, L*H]
    f32: its near edges' value grads (compute dtype) summed over nsrc;
    zero for a "p" block. Under "r" the near edges are the block's tail
    past the kvd far rows; under "t" every edge is listed and the far ones
    (nsrc = Kn) drop out."""
    if mode == "p":
        return torch.zeros((kn, sum(dv.shape[1] for dv in dvl)), dtype=_F32,
                           device=dvl[0].device)
    lo = kvd if mode == "r" else 0
    seg = _Segments(nsrc_b[lo:], emask_b[lo:], kn)
    return torch.cat([seg.sum(_f(dv[lo:])) for dv in dvl], dim=1)


def row_backward_plain(static, xin, vals, ea, edst, emask, nmask, weights,
                       g, tg, tdst, tmask, res, ndirs: int = 1, dw_acc=None,
                       merge_tg: bool = True, nf=None, nsrc=None,
                       prev_out=None, near_g=None):
    """The row's VJP (K2), plain PyTorch.

    g [ndirs*Kn, L*H] cotangent of the row's outputs; tg [ndirs*Kt, L*H]
    edge grads flowing into this row (gathered by the caller), summed onto
    their local source slots tdst where tmask is set; res = (alpha32,
    nres) from the forward. k and h_n are rebuilt from vals and agg, and
    each layer's output from the (rounded) residuals. merge_tg=False
    (ndirs=1): tg is first added onto g by tg_accumulate_plain (K5).
    Returns (dx [ndirs*Kn, In], dvals [ndirs*Ke, L*H], dea or None,
    dw): dw holds float32 weight grads in _names order, added into dw_acc
    when given.

    res=None (K2r): vals are full width and the residuals are recomputed
    by row_forward_plain first. K7 (nf, nsrc, prev_out as in
    row_forward_plain; with res the vals are the forward's): near_g
    [ndirs*Kn, L*H] (the next row's near_g_out; None reads zero) is added
    to the transpose-grad sum in float32; dvals holds the vals rows only
    (far rows under "r"), and a fifth output near_g_out [ndirs*Kn, L*H]
    in g's dtype carries the near grads to the previous row."""
    has_ea, hdim, nlayers = static
    g, tg, tdst, tmask = _split_tg(merge_tg, ndirs, g, tg, tdst, tmask,
                                   tg_accumulate_plain, nf)
    W = edst.shape[0]
    blocks = nf_blocks(nf, ndirs, W)
    vblocks = blocks                  # where each block's vals rows lie
    if res is None:
        full = _full_nf(nf)
        res = row_forward_plain(static, xin, vals, ea, edst, emask, nmask,
                                weights, emit_res=True, ndirs=ndirs,
                                nf=full)[1:]
        vblocks = nf_blocks(full, ndirs, W)
    a32_all, nres_all = res
    kn = xin.shape[0] // ndirs
    kt = tdst.shape[0] // ndirs
    dx = torch.empty_like(xin)
    dvals = vals.new_empty((sum(b[4] for b in blocks), vals.shape[1]))
    dea = torch.empty_like(ea) if has_ea else None
    ng_out = None if nf is None else g.new_empty((xin.shape[0], g.shape[1]))
    dw = dw_acc if dw_acc is not None else _new_dw(weights, nlayers, has_ea,
                                                   xin.device)
    for d, ((mode, eo, ked, vo, kvd), vb) in enumerate(zip(blocks, vblocks)):
        ns, es = slice(d * kn, (d + 1) * kn), slice(eo, eo + ked)
        ts = slice(d * kt, (d + 1) * kt)
        gadd = _Segments(tdst[ts], tmask[ts], kn).sum(_f(tg[ts]))
        if near_g is not None:
            gadd = gadd + _f(near_g[ns])
        routed = vb[0] == "r"
        vals_d = _block_vals(routed, vals, vb[3], vb[4],
                             nsrc[es] if routed else None,
                             prev_out[ns] if routed else None, kn)
        dx_d, dvl, dea_d = _block_backward(
            static, _wsel(weights, ndirs, d), xin[ns], vals_d,
            ea[es] if has_ea else None, _Segments(edst[es], emask[es], kn),
            _f(nmask[ns])[:, None], a32_all[es], nres_all[ns], g[ns], gadd,
            _dw_adder(dw, ndirs > 1, d))
        for l, dv in enumerate(dvl):
            dvals[vo:vo + kvd, l * hdim:(l + 1) * hdim] = dv[:kvd]
        if ng_out is not None:
            ng_out[ns] = _near_grads(mode, dvl, nsrc[es], emask[es], kvd,
                                     kn).to(ng_out.dtype)
        dx[ns] = dx_d.to(dx.dtype)
        if has_ea:
            dea[es] = dea_d.to(dea.dtype)
    if nf is not None:
        return dx, dvals, dea, dw, ng_out
    return dx, dvals, dea, dw


# ---------------------------------------------------------- CUDA wrappers

_SIGS = {
    "wf_attn_fwd": "ipi" "iiii" "pi" "pi" "p" "pi" "ppp" "ppppp" "pi" "pi" "p",
    "wf_gru_fwd": "iii" "iii" "pi" "pi" "ppppp" "p" "pi" "ppp" "i" "p",
    "wf_seg_merge": "ipi" "iii" "ppppppp" "p",
    "wf_rebuild": "ipi" "ii" "ppp" "i" "ppppp" "i" "p",
    "wf_gru_bwd_elem": "iii" "ii" "pi" "pppppp" "i" "pppp" "p",
    "wf_gemm_nn": "iii" "iii" "pppp" "ppp" "p",
    "wf_attn_bwd": "ipi" "iiiiii" "p" "pi" "pi" "p" "pi" "ppp" "pi" "pppp" "pp"
                   "pi" "pi" "ppp" "p",
    "wf_wgrad": "iii" "iii" "pp" "pi" "pi" "pp" "p",
    "wf_small_reduce": "iii" "iiii" "ppp" "ppppppp" "p",
    "wf_tg_accumulate": "iiii" "pppp" "p" "p",
}
_DT_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    from dagnn_tpu_torch.ops import build
    return build.load("wavefront", _SIGS)


@functools.lru_cache(maxsize=1024)
def _host_table(rows):
    flat = [v for r in rows for v in r]
    return (ctypes.c_int * len(flat))(*flat)


def _tab(rows):
    """(host int array, count) of a block table: rows of (dir, node block,
    edge offset, edge width, value offset, value width, transpose offset,
    transpose width, intra-pair source block or -1), the kernels' Blk. The
    C entry copies it into its launch; the array is cached so that a
    wavefront does not rebuild it for every call."""
    return _host_table(rows), len(rows)


def _check_widths(fn, groups, edge_streams, tdst=None):
    """The edge streams (edst, emask, ea, nsrc; None skipped) and the
    transpose stream must span the block tables' widths: the kernels index
    them by the tables' offsets."""
    rows = [r for g in groups for r in g]
    W, T = sum(r[3] for r in rows), sum(r[7] for r in rows)
    for t in edge_streams:
        if t is not None and t.shape[0] != W:
            raise ValueError(f"{fn}: an edge stream of {t.shape[0]} entries, "
                             f"blocks span {W}")
    if tdst is not None and tdst.shape[0] != T:
        raise ValueError(f"{fn}: transpose streams of {tdst.shape[0]} entries, "
                         f"blocks span {T}")


def _gemm_blocks(rows):
    """nb0 of a block group whose block z is direction z at node block
    nb0 + z: the form the kernels without edge ranges take (GEMM_BLOCKS in
    csrc/wavefront.cu), [d0|d1] of one row."""
    nb0 = rows[0][1]
    if any(r[0] != z or r[1] != nb0 + z for z, r in enumerate(rows)):
        raise ValueError(f"block group {rows} is not the directions of one row")
    return nb0


def row_table(nf, ndirs, ke_total, kt_total):
    """The block table of a row: block d is direction d at node block d,
    its edges and vals rows where nf_blocks puts them, its transpose edges
    at d*Kt. A K7 "r" block reads its near edges' values from node block d
    of the near source (prev_out) through nsrc."""
    kt = kt_total // ndirs
    return tuple((d, d, eo, ked, vo, kvd, d * kt, kt, d if mode == "r" else -1)
                 for d, (mode, eo, ked, vo, kvd) in
                 enumerate(nf_blocks(nf, ndirs, ke_total)))


def near_table(nf, rows, U):
    """K7's near-grad merge: per block of the backward table `rows`, the
    seg_merge entry that sums its near edges' value grads over nsrc onto
    node block d of near_g_out. Its list is the block's near edges [io,
    io+n) of nsrc (under "r" the tail past Kf_d, under "t" all edges, none
    under "p"); their grads are rows so.. of the value-grad buffer, which
    holds dvals (U rows) and after them the grads of edges read through
    nsrc (dnear, rows U + edge)."""
    out = []
    for (mode, _ke, kf), (d, nb, eo, ke, vo, kv, *_r) in zip(nf, rows):
        lo = kf if mode == "r" else 0
        so = vo + lo if lo < kv else U + eo + lo
        out.append((d, nb, 0, 0, so, 0, eo + lo, 0 if mode == "p" else ke - lo,
                    -1))
    return tuple(out)


def _check(rc, fn):
    if rc != 0:
        raise RuntimeError(f"CUDA kernel launch failed in {fn}: error {rc}")


def _ptr(t, offset=0):
    """Device address of t's element `offset` (0 for None)."""
    if t is None:
        return 0
    return t.data_ptr() + offset * t.element_size()


def _on_card(fn, tensors, dt):
    """Validate the operands a CUDA wrapper hands to its kernels."""
    dev = tensors[0].device
    for t in tensors:
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{fn}: operands on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: operands must be contiguous")
    if dt not in _DT_CODE:
        raise TypeError(f"{fn}: compute dtype {dt} not supported "
                        f"(float32 or bfloat16)")


def _weight_views(fn, weights, nw, dt, names):
    """The named weights, checked for dtype and direction stacking (nw
    directions stacked along axis 0; nw = 1: one direction, unstacked)."""
    w = {}
    for n in names:
        t = weights[n]
        if t.dtype != dt:
            raise TypeError(f"{fn}: weight {n} is {t.dtype}, compute dtype is {dt}")
        if nw > 1 and t.shape[0] != nw:
            raise ValueError(f"{fn}: weight {n} not stacked over {nw} directions")
        w[n] = t.contiguous()
    return w


def _expect(fn, operands):
    for t, shape, tdt in operands:
        if t.dtype != tdt or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{fn}: operand {tuple(t.shape)} {t.dtype}, "
                             f"expected {tuple(shape)} {tdt}")


def _indices(*ts):
    return [None if t is None else t.to(torch.int32).contiguous() for t in ts]


def _masks(*ts):
    return [t.to(_F32).contiguous() for t in ts]


def _check_sources(fn, groups, nsrc, near, rows, LH, dt):
    """Blocks with a source read nsrc, and (K7) the near source's rows."""
    if any(r[8] >= 0 for g in groups for r in g) and nsrc is None:
        raise ValueError(f"{fn}: blocks read routed values but nsrc is None")
    if near is not None:
        _expect(fn, [(near, (rows, LH), dt)])


def cuda_forward(fn, static, xin, vals, ea, edst, emask, nmask, weights,
                 emit_res, groups, nw, nsrc=None, near=None):
    """Launch K1/K3's kernels over block groups run in order (within a
    layer a later group may read an earlier one's outputs through nsrc).
    A block with a source reads its routed values from node block `src` of
    `near` (K7: prev_out) or, with near None, of this call's outputs (K3).
    Returns outs (+ alpha32, nres with emit_res), as the plain versions."""
    has_ea, H, nl = static
    dt = xin.dtype
    nblk = sum(len(g) for g in groups)
    kn = xin.shape[0] // nblk
    emb = xin.shape[1]
    LH = nl * H
    U = sum(r[5] for g in groups for r in g)
    _expect(fn, [(vals, (U, LH), dt)])
    _check_widths(fn, groups, (edst, emask, ea, nsrc))
    _check_sources(fn, groups, nsrc, near, xin.shape[0], LH, dt)
    edst, nsrc = _indices(edst, nsrc)
    emask, nmask = _masks(emask, nmask)
    ea = ea.contiguous() if has_ea else None
    _on_card(fn, [xin, vals, ea, edst, emask, nmask, nsrc, near], dt)
    R = ea.shape[1] if has_ea else 0
    names = [f"a{l}_{k}" for l in range(nl) for k in agg_keys(has_ea)]
    names += [f"c{l}_{k}" for l in range(nl)
              for k in ("w_ih", "w_hh", "b_rz", "b_in", "b_hn")]
    w = _weight_views(fn, weights, nw, dt, names)
    lib = _lib()
    code = _DT_CODE[dt]
    stream = torch.cuda.current_stream(xin.device).cuda_stream
    out, a32, nres = _forward_outputs(xin, edst.shape[0], nl, H, emit_res)
    if not emit_res:
        aggbuf = torch.empty((nblk * kn, H), dtype=dt, device=xin.device)
    tabs = [(*_tab(g), _gemm_blocks(g)) for g in groups]
    for l in range(nl):
        din = emb if l == 0 else H
        cur, ldc = (_ptr(xin), emb) if l == 0 else (_ptr(out, (l - 1) * H), LH)
        if emit_res:
            agg, ldg = _ptr(nres, 4 * l * H), 4 * LH
            a32p = _ptr(a32, l)
            res_p = (_ptr(nres, (4 * l + 1) * H), _ptr(nres, (4 * l + 2) * H),
                     _ptr(nres, (4 * l + 3) * H))
        else:
            agg, ldg = _ptr(aggbuf), H
            a32p, res_p = 0, (0, 0, 0)
        src = _ptr(near if near is not None else out, l * H)
        for tab, nb, nb0 in tabs:
            _check(lib.wf_attn_fwd(
                code, tab, nb, kn, H, din, R, cur, ldc, _ptr(vals, l * H), LH,
                _ptr(nsrc), src, LH, _ptr(ea), _ptr(edst),
                _ptr(emask), _ptr(w[f"a{l}_wq"]), _ptr(w[f"a{l}_wk"]),
                _ptr(w[f"a{l}_b"]), _ptr(w.get(f"a{l}_we")),
                _ptr(w.get(f"a{l}_be")), a32p, nl, agg, ldg, stream),
                "wf_attn_fwd")
            _check(lib.wf_gru_fwd(
                code, nb0, nb, kn, H, din, cur, ldc, agg, ldg,
                _ptr(w[f"c{l}_w_ih"]), _ptr(w[f"c{l}_w_hh"]),
                _ptr(w[f"c{l}_b_rz"]), _ptr(w[f"c{l}_b_in"]),
                _ptr(w[f"c{l}_b_hn"]), _ptr(nmask), _ptr(out, l * H), LH,
                *res_p, 4 * LH, stream), "wf_gru_fwd")
    return (out, a32, nres) if emit_res else out


def cuda_backward(fn, static, xin, vals, ea, edst, emask, nmask, weights,
                  g, tg, tdst, tmask, res, dw_acc, plan, nw, nsrc=None,
                  near=None, near_g=None, near_tab=None):
    """Launch K2/K4's kernels. plan: (group, merge) in run order; `merge`
    (or None) is a table whose lists [to, to+kt) over nsrc sum the intra-
    pair value grads of the groups run so far into this group's
    cotangent. A group is the directions of one row, in order (weight
    grads add into one f32 buffer per direction without atomics).
    Returns (dx, dvals, dea or None, dw) as the plain versions.

    K7: blocks with a source read their routed values from `near`
    (prev_out; else from the outputs rebuilt here, K4); near_g is added to
    the transpose-grad sum; near_tab (near_table) sums the near edges'
    value grads into a fifth output, near_g_out [nblk*Kn, L*H]."""
    has_ea, H, nl = static
    dt = xin.dtype
    dev = xin.device
    nblk = sum(len(grp) for grp, _ in plan)
    kn = xin.shape[0] // nblk
    W, T = edst.shape[0], tdst.shape[0]
    emb = xin.shape[1]
    LH = nl * H
    U = sum(r[5] for grp, _ in plan for r in grp)
    a32, nres = res
    rows = nblk * kn
    _expect(fn, [(vals, (U, LH), dt), (g, (rows, LH), dt),
                 (tg, (T, LH), dt), (a32, (W, nl), _F32),
                 (nres, (rows, 4 * LH), dt)]
            + ([(near_g, (rows, LH), dt)] if near_g is not None else []))
    _check_widths(fn, [grp for grp, _ in plan], (edst, emask, ea, nsrc), tdst)
    _check_sources(fn, [grp for grp, _ in plan], nsrc, near, rows, LH, dt)
    if near_tab is not None and nsrc is None:
        raise ValueError(f"{fn}: the near-grad merge needs nsrc")
    edst, tdst, nsrc = _indices(edst, tdst, nsrc)
    emask, tmask, nmask = _masks(emask, tmask, nmask)
    ea = ea.contiguous() if has_ea else None
    _on_card(fn, [xin, vals, ea, edst, emask, nmask, g, tg, tdst, tmask, a32,
                  nres, nsrc, near, near_g], dt)
    R = ea.shape[1] if has_ea else 0
    names = [f"a{l}_{k}" for l in range(nl)
             for k in ("wqr", "wkr") + (("we", "be") if has_ea else ())]
    names += [f"c{l}_{k}" for l in range(nl) for k in ("w_ih", "w_hh", "b_hh")]
    w = _weight_views(fn, weights, nw, dt, names)
    dw = dw_acc if dw_acc is not None else _new_dw(weights, nl, has_ea, dev)
    for n in _names(nl, has_ea):
        if dw[n].dtype != _F32 or not dw[n].is_contiguous() or dw[n].device != dev:
            raise ValueError(f"{fn}: dw[{n}] must be contiguous f32 on {dev}")
    lib = _lib()
    code = _DT_CODE[dt]
    stream = torch.cuda.current_stream(dev).cuda_stream
    e = lambda *s, t=dt: torch.empty(s, dtype=t, device=dev)
    dx = e(rows, emb)
    # value grads: dvals, then the grads of edges read through nsrc (dnear,
    # rows U + edge), in one buffer that near_tab's merge reads
    dv_all = e(U + (W if nsrc is not None else 0), LH)
    dvals = dv_all[:U]
    dnear = dv_all[U:] if nsrc is not None else None
    dea = e(W, R) if has_ea else None
    dea_acc = e(W, R, t=_F32) if has_ea else None
    gtot = e(rows, LH, t=_F32)
    hn = [e(rows, H) for _ in range(nl)]
    outs = e(rows, LH)                 # layer outputs rebuilt from nres
    dgi, dgh = e(rows, 3 * H), e(rows, 3 * H)
    gz = e(rows, H, t=_F32)
    dagg = e(rows, H)
    gbuf = [e(rows, emb if l == 0 else H, t=_F32) for l in range(nl)]
    part = e(rows, max(emb, H) + H + 1 + H * R + H, t=_F32)

    all_tab, all_n = _tab(tuple(r for grp, _ in plan for r in grp))
    _check(lib.wf_seg_merge(code, all_tab, all_n, kn, LH, 0, _ptr(g), _ptr(tg),
                            _ptr(tdst), _ptr(tmask), _ptr(near_g), _ptr(gtot),
                            0, stream), "wf_seg_merge")
    for l in range(nl):
        c = 4 * l * H
        _check(lib.wf_rebuild(
            code, all_tab, all_n, kn, H, _ptr(nres, c), _ptr(nres, c + 2 * H),
            _ptr(nres, c + 3 * H), 4 * LH, _ptr(w[f"c{l}_w_hh"]),
            _ptr(w[f"c{l}_b_hh"]), _ptr(nmask), _ptr(hn[l]), _ptr(outs, l * H),
            LH, stream), "wf_rebuild")
    for grp, merge in plan:
        if merge:
            mt, mn = _tab(merge)
            _check(lib.wf_seg_merge(code, mt, mn, kn, LH, 0, 0, _ptr(dnear),
                                    _ptr(nsrc), _ptr(emask), 0, _ptr(gtot), 0,
                                    stream), "wf_seg_merge")
        tab, nb = _tab(grp)
        nb0 = _gemm_blocks(grp)
        for l in range(nl - 1, -1, -1):
            din = emb if l == 0 else H
            c = 4 * l * H
            cur, ldc = (_ptr(xin), emb) if l == 0 else (_ptr(outs, (l - 1) * H), LH)
            gnext = _ptr(gbuf[l + 1]) if l + 1 < nl else 0
            _check(lib.wf_gru_bwd_elem(
                code, nb0, nb, kn, H, _ptr(gtot, l * H), LH, gnext, _ptr(nmask),
                _ptr(nres, c), _ptr(nres, c + H), _ptr(nres, c + 2 * H),
                _ptr(nres, c + 3 * H), 4 * LH, _ptr(hn[l]), _ptr(dgi), _ptr(dgh),
                _ptr(gz), stream), "wf_gru_bwd_elem")
            _check(lib.wf_gemm_nn(code, nb0, nb, kn, H, din, _ptr(dgh),
                                  _ptr(w[f"c{l}_w_hh"]), _ptr(dagg), _ptr(gz),
                                  _ptr(dgi), _ptr(w[f"c{l}_w_ih"]), _ptr(gbuf[l]),
                                  stream), "wf_gemm_nn")
            _check(lib.wf_attn_bwd(
                code, tab, nb, kn, H, din, R, int(l == nl - 1), int(l == 0),
                _ptr(dagg), cur, ldc, _ptr(vals, l * H), LH, _ptr(nsrc),
                _ptr(near if near is not None else outs, l * H), LH, _ptr(ea),
                _ptr(edst), _ptr(emask),
                _ptr(a32, l), nl, _ptr(w[f"a{l}_wqr"]), _ptr(w[f"a{l}_wkr"]),
                _ptr(w.get(f"a{l}_we")), _ptr(w.get(f"a{l}_be")),
                _ptr(gbuf[l]), _ptr(dx), _ptr(dvals, l * H), LH,
                _ptr(dnear, l * H), LH, _ptr(dea_acc), _ptr(dea), _ptr(part),
                stream), "wf_attn_bwd")
            _check(lib.wf_wgrad(code, nb0, nb, kn, H, din, _ptr(dgi), _ptr(dgh),
                                cur, ldc, _ptr(nres, c), 4 * LH,
                                _ptr(dw[f"c{l}_w_ih"]), _ptr(dw[f"c{l}_w_hh"]),
                                stream), "wf_wgrad")
            _check(lib.wf_small_reduce(
                code, nb0, nb, kn, H, din, R, _ptr(part), _ptr(dgi), _ptr(dgh),
                _ptr(dw[f"a{l}_wq"]), _ptr(dw[f"a{l}_wk"]), _ptr(dw[f"a{l}_b"]),
                _ptr(dw.get(f"a{l}_we")), _ptr(dw.get(f"a{l}_be")),
                _ptr(dw[f"c{l}_b_ih"]), _ptr(dw[f"c{l}_b_hh"]), stream),
                "wf_small_reduce")
    if near_tab is None:
        return dx, dvals, dea, dw
    ng = e(rows, LH)
    nt, nn = _tab(near_tab)
    _check(lib.wf_seg_merge(code, nt, nn, kn, LH, 1, 0, _ptr(dv_all), _ptr(nsrc),
                            _ptr(emask), 0, 0, _ptr(ng), stream), "wf_seg_merge")
    return dx, dvals, dea, dw, ng


def row_forward(static, xin, vals, ea, edst, emask, nmask, weights,
                emit_res: bool = False, ndirs: int = 1, nf=None, nsrc=None,
                prev_out=None):
    """K1, and with nf K7. CPU tensors: row_forward_plain. CUDA tensors:
    the kernels of csrc/wavefront.cu (an attention and a GRU launch per
    layer; under nf the ragged block table, "r" blocks reading their near
    values from prev_out)."""
    if xin.device.type == "cpu":
        return row_forward_plain(static, xin, vals, ea, edst, emask, nmask,
                                 weights, emit_res=emit_res, ndirs=ndirs,
                                 nf=nf, nsrc=nsrc, prev_out=prev_out)
    if xin.device.type != "cuda":
        raise ValueError(f"row_forward: unsupported device {xin.device}")
    routed = _routed(nf)
    out = cuda_forward("row_forward", static, xin, vals, ea, edst, emask,
                       nmask, weights, emit_res,
                       [row_table(nf, ndirs, edst.shape[0], 0)], ndirs,
                       nsrc=nsrc if routed else None,
                       near=prev_out if routed else None)
    launch_counts["row_forward" if nf is None else "row_forward_nf"] += 1
    return out


def tg_accumulate(g, tg, tdst, tmask):
    """K5. CPU tensors: tg_accumulate_plain. CUDA tensors: one launch of
    csrc/wavefront.cu's seg_merge kernel that stores g + the merged sum
    rounded to g's dtype (g [Kn, C], tg [Kt, C] in one compute dtype)."""
    if g.device.type == "cpu":
        return tg_accumulate_plain(g, tg, tdst, tmask)
    if g.device.type != "cuda":
        raise ValueError(f"tg_accumulate: unsupported device {g.device}")
    kn, c = g.shape
    kt = tdst.shape[0]
    _expect("tg_accumulate", [(tg, (kt, c), g.dtype)])
    (tdst,), (tmask,) = _indices(tdst), _masks(tmask)
    _on_card("tg_accumulate", [g, tg, tdst, tmask], g.dtype)
    out = torch.empty_like(g)
    _check(_lib().wf_tg_accumulate(
        _DT_CODE[g.dtype], kn, c, kt, _ptr(g), _ptr(tg), _ptr(tdst),
        _ptr(tmask), _ptr(out), torch.cuda.current_stream(g.device).cuda_stream),
        "wf_tg_accumulate")
    launch_counts["tg_accumulate"] += 1
    return out


def row_backward(static, xin, vals, ea, edst, emask, nmask, weights,
                 g, tg, tdst, tmask, res, ndirs: int = 1, dw_acc=None,
                 merge_tg: bool = True, nf=None, nsrc=None, prev_out=None,
                 near_g=None):
    """K2, with nf K7, with res=None K2r. CPU tensors: row_backward_plain.
    CUDA tensors: the kernels of csrc/wavefront.cu (a transpose-grad merge,
    a rebuild per layer, and five launches per layer: the GRU VJP, both
    input-grad GEMMs in one, the attention VJP, the weight-grad GEMM and the
    bias / score-weight reduction; under nf one more
    merge for near_g_out). merge_tg=False (ndirs=1): K5 (tg_accumulate)
    adds tg onto g first, and K2's merge then sums no transpose list (it
    only widens the cotangent to float32). res=None: K1's kernels
    recompute the residual streams into scratch buffers from the
    full-width vals, then K2's launches run on them."""
    if xin.device.type == "cpu":
        return row_backward_plain(static, xin, vals, ea, edst, emask, nmask,
                                  weights, g, tg, tdst, tmask, res,
                                  ndirs=ndirs, dw_acc=dw_acc, merge_tg=merge_tg,
                                  nf=nf, nsrc=nsrc, prev_out=prev_out,
                                  near_g=near_g)
    if xin.device.type != "cuda":
        raise ValueError(f"row_backward: unsupported device {xin.device}")
    g, tg, tdst, tmask = _split_tg(merge_tg, ndirs, g, tg, tdst, tmask,
                                   tg_accumulate, nf)
    W = edst.shape[0]
    recompute = res is None
    tab = row_table(_full_nf(nf) if recompute else nf, ndirs, W, tdst.shape[0])
    if recompute:
        res = cuda_forward("row_backward", static, xin, vals, ea, edst, emask,
                           nmask, weights, True, [tab], ndirs)[1:]
    routed = not recompute and _routed(nf)
    out = cuda_backward(
        "row_backward", static, xin, vals, ea, edst, emask, nmask, weights,
        g, tg, tdst, tmask, res, dw_acc, [(tab, None)], ndirs,
        nsrc=nsrc if nf is not None else None,
        near=prev_out if routed else None, near_g=near_g,
        near_tab=(near_table(nf, tab, sum(r[5] for r in tab))
                  if nf is not None else None))
    if recompute and _routed(nf):
        # far rows only, as the residual-stream K7 returns them
        dv = out[1]
        out = (out[0], torch.cat([dv[eo:eo + kv] for _m, eo, _k, _v, kv
                                  in nf_blocks(nf, ndirs, W)]), *out[2:])
    launch_counts["row_backward_recompute" if recompute else
                  "row_backward" if nf is None else "row_backward_nf"] += 1
    return out

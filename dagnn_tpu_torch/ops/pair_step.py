"""Pair kernels of the wavefront: K3 (pair forward) and K4 (pair backward).

Counterpart of dagnn_tpu/ops/pallas/pair_step.py. One call runs rows 2p
and 2p+1 of the direction-merged wavefront as four direction blocks
[A0 | A1 | B0 | B1] (A = row 2p, B = row 2p+1, digit = direction), laid
out by dag/pair.py. Per block the math is the row kernels' (ops/row_step.py
_block_forward / _block_backward). What pairing adds:

  * ragged blocks: block b's edges are edst[eo:eo+ke], its gathered value
    rows vals[vo:vo+kv] (_block_offsets);
  * intra-pair edges: a B_d block's edges kv..ke have their source in row
    2p, whose outputs are not in the state buffer yet. Their value rows are
    A_d's layer-packed outputs of the same call, out[A_d rows][nsrc], layer
    l in columns l*H:(l+1)*H; a pad entry (nsrc = Kn) reads zero;
  * the backward runs the blocks in reverse (B before A). B_d's intra-pair
    value grads, rounded to the compute dtype, are summed over nsrc into
    A_d's output cotangent in float32 (with the transpose-edge grads), and
    both blocks of a direction add into that direction's weight grads.

The backward takes A's outputs from the residual streams (the rebuild is
bitwise the forward's values), as the TPU kernel does, so both functions
keep the JAX signatures. Weight grads are float32 and are ADDED into
`dw_acc` when one is given (the JAX kernel returns them in the weights'
dtype).

Each kernel has two implementations with one signature:
  * pair_forward_plain / pair_backward_plain: plain PyTorch, indexed sums,
    no one-hot matrices. The CPU tests hold them against the JAX kernels in
    interpret mode.
  * pair_forward / pair_backward: the wrappers. For CPU tensors they call
    the plain version; for CUDA tensors they launch the kernels of
    csrc/wavefront.cu over the pair's block table, or raise. Each counts
    its launches in `launch_counts`.
"""

from __future__ import annotations

import torch

from dagnn_tpu_torch.ops import row_step as rs

# launches of each wrapper's CUDA kernels (one per wrapper call on a card)
launch_counts = {"pair_forward": 0, "pair_backward": 0}


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


def _block_offsets(blocks):
    """Per block (mode, dir, edge offset, edge width, vals offset, vals
    width, transpose offset, transpose width) from PairPlan.blocks."""
    out, eo, vo, to = [], 0, 0, 0
    for (mode, d, ked, kvd, ktd) in blocks:
        out.append((mode, d, eo, ked, vo, kvd, to, ktd))
        eo, vo, to = eo + ked, vo + kvd, to + ktd
    return out


def pair_forward_plain(static, xin, vals, ea, edst, emask, nmask, nsrc,
                       weights, blocks, emit_res: bool = False):
    """Pair forward (K3), plain PyTorch. xin [4Kn, In]; vals [U, L*H] =
    [A0 | A1 | B0 far | B1 far]; ea / edst / emask / nsrc over the W edges
    of the four blocks; weights stacked [2, ...]. Returns outs [4Kn, L*H]
    (+ alpha32 [W, L] f32 and nres [4Kn, 4*L*H] with emit_res)."""
    has_ea, hdim, nlayers = static
    kn = xin.shape[0] // len(blocks)
    out, a32, nres = rs._forward_outputs(xin, edst.shape[0], nlayers, hdim,
                                         emit_res)
    outs_packed = {}                  # dir -> A block's [Kn, L*H] outputs
    for bi, (mode, d, eo, ked, vo, kvd, _to, _ktd) in enumerate(
            _block_offsets(blocks)):
        ns, es = slice(bi * kn, (bi + 1) * kn), slice(eo, eo + ked)
        # a B block's intra-pair rows: the same-direction A block's outputs
        vals_b = rs._block_vals(mode == "q", vals, vo, kvd, nsrc[es],
                                outs_packed.get(d), kn)
        outs, ress = rs._block_forward(
            static, rs._wsel(weights, 2, d), xin[ns], vals_b,
            ea[es] if has_ea else None, rs._Segments(edst[es], emask[es], kn),
            rs._f(nmask[ns])[:, None])
        rs._store_forward(out, a32, nres, ns, es, outs, ress, hdim)
        if mode == "p":
            outs_packed[d] = torch.cat(outs, dim=1)
    return (out, a32, nres) if emit_res else out


def pair_backward_plain(static, xin, vals, ea, edst, emask, nmask, nsrc,
                        weights, g, tg, tdst, tmask, res, blocks, dw_acc=None):
    """Pair VJP (K4), plain PyTorch, from the forward's residual streams
    res = (alpha32, nres). g [4Kn, L*H]; tg [T, L*H] gathered from the pair
    edge-grad buffer, summed onto block-local source slots tdst where tmask
    is set. Returns (dx [4Kn, In], dvals [U, L*H], dea or None, dw: float32
    weight grads, added into dw_acc when given)."""
    has_ea, hdim, nlayers = static
    a32_all, nres_all = res
    offs = _block_offsets(blocks)
    kn = xin.shape[0] // len(blocks)
    dt = vals.dtype
    dx = torch.empty_like(xin)
    dvals = torch.empty_like(vals)
    dea = torch.empty_like(ea) if has_ea else None
    dw = dw_acc if dw_acc is not None else rs._new_dw(weights, nlayers, has_ea,
                                                      xin.device)
    nms = [rs._f(nmask[bi * kn:(bi + 1) * kn])[:, None] for bi in range(len(offs))]
    outs_packed = {
        d: torch.cat(rs._rebuild_outputs(nres_all[bi * kn:(bi + 1) * kn],
                                         nms[bi], hdim, nlayers), dim=1)
        for bi, (mode, d, *_r) in enumerate(offs) if mode == "p"}
    g_extra = {}                      # dir -> B's intra-pair grads, f32
    for bi in range(len(offs) - 1, -1, -1):
        mode, d, eo, ked, vo, kvd, to, ktd = offs[bi]
        ns, es, ts = (slice(bi * kn, (bi + 1) * kn), slice(eo, eo + ked),
                      slice(to, to + ktd))
        gadd = rs._Segments(tdst[ts], tmask[ts], kn).sum(rs._f(tg[ts]))
        if mode == "p" and d in g_extra:
            gadd = gadd + g_extra[d]
        dx_b, dvl, dea_b = rs._block_backward(
            static, rs._wsel(weights, 2, d), xin[ns],
            rs._block_vals(mode == "q", vals, vo, kvd, nsrc[es],
                           outs_packed.get(d), kn),
            ea[es] if has_ea else None, rs._Segments(edst[es], emask[es], kn),
            nms[bi], a32_all[es], nres_all[ns], g[ns], gadd,
            rs._dw_adder(dw, True, d))
        for l, dv in enumerate(dvl):
            dvals[vo:vo + kvd, l * hdim:(l + 1) * hdim] = dv[:kvd]
        if mode == "q":       # the intra-pair edges: the tail past kvd
            g_extra[d] = rs._near_grads("r", dvl, nsrc[es], emask[es], kvd, kn)
        dx[ns] = dx_b.to(dt)
        if has_ea:
            dea[es] = dea_b.to(dea.dtype)
    return dx, dvals, dea, dw


# ---------------------------------------------------------- CUDA wrappers

def pair_tables(blocks):
    """The kernels' block tables of a pair: (group A, group B, merge). A
    block table row is ops/row_step's (dir, node block, edge offset, edge
    width, vals offset, vals width, transpose offset, transpose width,
    intra-pair source block); a B block's source is its direction's A
    block. `merge` gives each A block the list of its direction's B
    intra-pair edges, whose value grads K4 sums over nsrc into A's
    cotangent."""
    offs = _block_offsets(blocks)
    a_of = {d: bi for bi, (mode, d, *_r) in enumerate(offs) if mode == "p"}
    rows = [(d, bi, eo, ked, vo, kvd, to, ktd, a_of[d] if mode == "q" else -1)
            for bi, (mode, d, eo, ked, vo, kvd, to, ktd) in enumerate(offs)]
    grp_a = tuple(r for r, o in zip(rows, offs) if o[0] == "p")
    grp_b = tuple(r for r, o in zip(rows, offs) if o[0] == "q")
    merge = tuple((d, a_of[d], 0, 0, 0, 0, eo + kv, ke - kv, -1)
                  for (d, _nb, eo, ke, _vo, kv, *_r) in grp_b)
    return grp_a, grp_b, merge


def pair_forward(static, xin, vals, ea, edst, emask, nmask, nsrc, weights,
                 blocks, emit_res: bool = False):
    """K3. CPU tensors: pair_forward_plain. CUDA tensors: the kernels of
    csrc/wavefront.cu, per layer an attention and a GRU launch for the A
    blocks, then for the B blocks (which read A's layer output)."""
    if xin.device.type == "cpu":
        return pair_forward_plain(static, xin, vals, ea, edst, emask, nmask,
                                  nsrc, weights, blocks, emit_res=emit_res)
    if xin.device.type != "cuda":
        raise ValueError(f"pair_forward: unsupported device {xin.device}")
    grp_a, grp_b, _ = pair_tables(blocks)
    out = rs.cuda_forward("pair_forward", static, xin, vals, ea, edst, emask,
                          nmask, weights, emit_res, [grp_a, grp_b], 2, nsrc=nsrc)
    launch_counts["pair_forward"] += 1
    return out


def pair_backward(static, xin, vals, ea, edst, emask, nmask, nsrc, weights,
                  g, tg, tdst, tmask, res, blocks, dw_acc=None):
    """K4. CPU tensors: pair_backward_plain. CUDA tensors: the kernels of
    csrc/wavefront.cu: a transpose-grad merge and a rebuild per layer over
    all four blocks, the B blocks' VJP, the intra-pair merge into A's
    cotangent, then the A blocks' VJP."""
    if xin.device.type == "cpu":
        return pair_backward_plain(static, xin, vals, ea, edst, emask, nmask,
                                   nsrc, weights, g, tg, tdst, tmask, res,
                                   blocks, dw_acc=dw_acc)
    if xin.device.type != "cuda":
        raise ValueError(f"pair_backward: unsupported device {xin.device}")
    grp_a, grp_b, merge = pair_tables(blocks)
    out = rs.cuda_backward("pair_backward", static, xin, vals, ea, edst, emask,
                           nmask, weights, g, tg, tdst, tmask, res, dw_acc,
                           [(grp_b, None), (grp_a, merge)], 2, nsrc=nsrc)
    launch_counts["pair_backward"] += 1
    return out

"""Hierarchical and sort-pooling baseline GNNs (static shapes, masks).

Counterpart of dagnn_tpu/nn/pooling_baselines.py (reference:
ogbg-code/model/gnn2.py:243-440 DGCNN, :453-563 DiffPoolGNN, :585-650
UNet, :654-728 SAGPoolGNN; ogbg-code/model/asap.py ASAP). The reference's
PyG pooling ops filter nodes to data-dependent shapes; the JAX package
replaces them with two static-shape strategies, which this port keeps:

- SPARSE + KEEP MASK (DGCNN, SAGPool): the full [N] node axis stays and
  pooling narrows a boolean mask; dropped nodes are zeroed and left out of
  the segment ops, and edges with a dropped endpoint are masked.
- DENSE PER GRAPH (DiffPool, UNet, ASAP): graphs are padded to a static
  [G, dense_nodes] node axis with a dense (weighted) adjacency.

Everything computes in float32. Parameters keep the JAX tree's names and
layouts (DGCNN's and UNet's conv1d.c2w stays [kw, c1, c2], WIO, and is
read as such where the valid convolution runs). The sums onto nodes run
through ops/segment.SortedSegments, the sums onto graphs through K5's
contract (`merge`), as in nn/baselines.py.

What the port takes care of, beside the JAX package's semantics:
- Top-k and sort pooling sort as JAX does: stable, by graph then by
  descending score, as two stable argsorts (score first, then graph) on
  -score + 0.0 (a -0.0 score sorts as +0.0, as JAX's sort standardises
  it); -inf marks the dropped rows.
- The pair max pool of the conv1d head is amax, whose gradient shares ties
  evenly, as jnp.max's does (ReLU outputs tie at 0).
- The valid convolution of the conv1d head is one contraction over the
  stacked shifted windows, not cuDNN (which defaults to TF32 on the card
  and may pick a backward that adds with atomics).
- ASAP's master query is the JAX package's running jnp.maximum over the
  source axis (a lax.scan over j of maximum(carry, where(E_j, h_j, min))).
  Its value is the max over each destination's sources; its gradient
  follows jnp.maximum's tie rule, half to each side of a tie at every
  step, so of the sources tied at the max (ReLU zeros tie all the time)
  the last takes 1/2, the one before 1/4, ..., and the first as much as
  the second. The port computes both over the support of A~ alone (its
  nonzero (g, i, j) in order: a scatter max, then those powers of two,
  exact), never the [G, j, i, d] candidates of the scan (12.6 GB at G
  160, n 256, d 300).
- DiffPool's BatchNorm statistics include the padding rows of the dense
  batch (gnn2.py:543-549), so dense_nodes (256) stays a static width.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from dagnn_tpu_torch.convert import unflatten_tree
from dagnn_tpu_torch.dag.batch import DAGBatch
from dagnn_tpu_torch.nn.baselines import (FlatEdges, apply_heads, dropout,
                                          embed, heads_init, randn, seeded,
                                          to_params)
from dagnn_tpu_torch.nn.encoders import EncoderSpec, encoder_init
from dagnn_tpu_torch.ops import row_step
from dagnn_tpu_torch.ops.linear import linear, linear_init
from dagnn_tpu_torch.ops.segment import (SortedSegments, merged_segment_sum,
                                         segment_count, segment_max)


@dataclasses.dataclass(frozen=True)
class HPoolConfig:
    kind: str = "dgcnn"          # dgcnn | diffpool | unet | sagpool | asap
    emb_dim: int = 300
    num_vocab: int = 5002
    max_seq_len: int = 5
    num_class: int = 0
    num_rels: int = 2
    encoder: EncoderSpec = EncoderSpec()
    dropout: float = 0.5
    # dgcnn / unet (gnn2.py:247-250, :586-592)
    num_layers: int = 3
    k: int = 30                   # sort-pool size
    hidden: int = 32              # dgcnn latent width (gnn2.py:256)
    conv1d_channels: tuple = (16, 32)
    conv1d_kw: int = 5
    # diffpool cluster-count base (gnn2.py:456 max_nodes=1000)
    max_nodes: int = 1000
    # static per-graph node cap for the dense models (diffpool/unet/asap)
    dense_nodes: int = 256
    # sagpool / asap
    pooling_ratio: float = 0.5    # gnn2.py:654; asap.py ratio=0.8
    asap_ratio: float = 0.8
    asap_hidden: int = 300

    @property
    def total_latent_dim(self) -> int:
        # dgcnn latent dims: [hidden]*num_layers + [1] (gnn2.py:257)
        return self.hidden * self.num_layers + 1

    @property
    def dense_dim(self) -> int:
        d = (self.k - 2) // 2 + 1
        return (d - self.conv1d_kw + 1) * self.conv1d_channels[1]


# ---------------------------------------------------------------------------
# shared sparse mask-based primitives


def _graph_starts(gid, G, nmask):
    """Start index of each graph's contiguous node range [G+1], and the
    count of `nmask` nodes in each [G+1] (int64)."""
    counts = segment_count(gid, G + 1, nmask, torch.int64)
    starts = torch.cumsum(counts, 0) - counts
    return starts, counts


def _stable_order(key, gid=None, dim=0):
    """The stable ascending order of `key` (float; -0.0 sorts as +0.0),
    then, when `gid` is given, stably by gid: jnp.lexsort((key, gid))."""
    order = torch.argsort(key + 0.0, dim=dim, stable=True)
    if gid is not None:
        order = order[torch.argsort(gid[order], stable=True)]
    return order


def _ranks_by_score(score, gid, G, keep):
    """Rank (0 = best) of each node within its graph by descending score,
    counting only kept nodes; dropped and pad nodes rank last."""
    n1 = score.shape[0]
    s = torch.where(keep, score, -math.inf)
    order = _stable_order(-s, gid)                 # (graph, score desc)
    all_starts, _ = _graph_starts(gid, G, torch.ones_like(keep))
    rank_sorted = torch.arange(n1, device=gid.device) - all_starts[gid[order]]
    ranks = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
    return ranks, order


def topk_mask(score, gid, G, ratio, keep):
    """Per-graph top-ceil(ratio*kept) mask (TopKPooling/SAGPooling select)."""
    ranks, _ = _ranks_by_score(score, gid, G, keep)
    _, counts = _graph_starts(gid, G, keep)
    quota = torch.ceil(ratio * counts.to(torch.float32)).long()
    return keep & (ranks < quota[gid])


def _gcn_conv(lp, h, e: FlatEdges, em, keep=None):
    """PyG GCNConv (fill 1): D^-1/2 (A+I) D^-1/2 X W + b over the edges of
    `em` (a subset of e's). `keep` masks the self-loop term for dropped
    nodes."""
    src, dst = e.src, e.dst
    hw = h @ lp["w"].T
    deg = segment_count(dst, e.n1, em, h.dtype) + 1.0
    dis = deg ** -0.5
    msg = (dis[src] * dis[dst])[:, None] * hw[src]
    out = e.by_dst.sum(msg, mask=em) + hw * (1.0 / deg)[:, None]
    if keep is not None:
        out = out * keep.to(h.dtype)[:, None]
    if "b" in lp:
        out = out + lp["b"]
    return out


def _gmp_gap(h, gid, G, keep, merge):
    mx = segment_max(h, gid, G + 1, keep)[:G]
    s = merged_segment_sum(h, gid, G + 1, keep, merge)[:G]
    cnt = torch.clamp(segment_count(gid, G + 1, keep, h.dtype)[:G], min=1.0)
    return torch.cat([mx, s / cnt[:, None]], -1)


# ---------------------------------------------------------------------------
# DGCNN: GCN stack -> global sort pool -> 1d convs (gnn2.py:243-360)


def _sort_pool(h, sort_key, gid, G, nmask, k):
    """Top-k nodes per graph by sort_key desc, features in rank order,
    zero-padded (PyG global_sort_pool)."""
    n1 = h.shape[0]
    s = torch.where(nmask, sort_key, -math.inf)
    order = _stable_order(-s, gid)
    starts, _ = _graph_starts(gid, G, torch.ones_like(nmask))
    j = torch.arange(k, device=h.device)
    gpos = starts[:G, None] + j[None]                      # [G, k]
    _, kept_counts = _graph_starts(gid, G, nmask)
    valid = j[None] < torch.clamp(kept_counts[:G, None], max=k)
    flat = order[torch.clamp(gpos, 0, n1 - 1)]
    return h[flat] * valid[..., None].to(h.dtype)           # [G, k, D]


def _dgcnn_stack_init(gen, cfg: HPoolConfig, in_dim, dtype):
    dims = [cfg.hidden] * cfg.num_layers + [1]
    convs, prev = [], in_dim
    for d in dims:
        convs.append(linear_init(gen, prev, d, dtype=dtype))
        prev = d
    return convs


def _dgcnn_stack(convs, h, e: FlatEdges, em):
    outs = []
    for lp in convs:
        h = torch.tanh(_gcn_conv(lp, h, e, em))
        outs.append(h)
    return torch.cat(outs, -1)  # [N, total_latent_dim]


def _conv1d_head_init(gen, cfg: HPoolConfig, dtype):
    c1, c2 = cfg.conv1d_channels
    return {
        # conv1: kernel = total_latent_dim, stride same -> per-node linear
        "c1": linear_init(gen, cfg.total_latent_dim, c1, dtype=dtype),
        "c2w": randn(gen, (cfg.conv1d_kw, c1, c2), dtype)
        * math.sqrt(2.0 / (cfg.conv1d_kw * c1)),
        "c2b": torch.zeros(c2, dtype=dtype),
    }


def _conv1d_head(p, pooled, cfg: HPoolConfig):
    """[G, k, D] -> conv1(k=D,s=D) -> relu -> maxpool(2,2) -> conv2 -> relu
    -> flatten (gnn2.py:327-339)."""
    G, k, _ = pooled.shape
    z = torch.relu(linear(p["c1"], pooled))               # [G, k, c1]
    z = z[:, : (k // 2) * 2].reshape(G, k // 2, 2, -1).amax(2)
    # the valid convolution over length with window kw, c2w [kw, c1, c2]
    kw = p["c2w"].shape[0]
    lo = z.shape[1] - kw + 1
    win = torch.stack([z[:, t: t + lo] for t in range(kw)], 2)   # [G, lo, kw, c1]
    z = torch.relu(torch.einsum("glkc,kcd->gld", win, p["c2w"]) + p["c2b"])
    # flatten channel-major ([G, c2, L] order) like torch's
    # conv1d_res.view(G, -1): the head weights index this layout
    return z.transpose(1, 2).reshape(G, -1)                # [G, dense_dim]


# ---------------------------------------------------------------------------
# dense per-graph machinery (diffpool / unet / asap)


def _dense_from_batch(x, gid, G, nmask, nmax):
    n1 = x.shape[0]
    starts, _ = _graph_starts(gid, G, torch.ones_like(nmask))
    pos = torch.arange(n1, device=x.device) - starts[gid]
    ok = nmask & (pos < nmax) & (gid < G)
    g = torch.where(ok, gid, G)
    p = torch.where(ok, pos, 0)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    dense = torch.zeros((G + 1, nmax) + tuple(x.shape[1:]), dtype=x.dtype,
                        device=x.device)
    # every row not `ok` writes a zero into the dropped graph slot G
    dense = dense.index_put((g, p), torch.where(ok[:, None], x, zero))
    dmask = torch.zeros((G + 1, nmax), dtype=torch.bool, device=x.device)
    dmask = dmask.index_put((g, p), ok)
    return dense[:G], dmask[:G], pos, ok


def _dense_adj(e: FlatEdges, gid, pos, ok, G, nmax, dtype):
    src, dst = e.src, e.dst
    em = e.em & ok[src] & ok[dst]
    g = torch.where(em, gid[src], G)
    ps = torch.where(em, pos[src], 0)
    pd = torch.where(em, pos[dst], 0)
    # whole-number counts: exact in any order of the accumulation
    adj = torch.zeros((G + 1, nmax, nmax), dtype=dtype, device=gid.device)
    adj = adj.index_put((g, ps, pd), em.to(dtype), accumulate=True)
    return adj[:G]


def _dense_topk(score, dmask, ratio):
    """Per-graph top-ceil(ratio*kept) over the dense node axis."""
    s = torch.where(dmask, score, -math.inf)
    order = _stable_order(-s, dim=1)
    ar = torch.arange(s.shape[1], device=s.device).expand_as(order)
    ranks = torch.empty_like(order).scatter_(1, order, ar)
    quota = torch.ceil(ratio * dmask.sum(1).to(torch.float32)).long()
    return dmask & (ranks < quota[:, None])


def _eye(n, x):
    return torch.eye(n, dtype=x.dtype, device=x.device)


def _dense_gcn(lp, x, adj, dmask, fill):
    """GCNConv on a dense weighted adjacency: D^-1/2 (A + fill*I) D^-1/2
    X W + b (PyG gcn_norm; fill 2 = improved, GraphUNet's convs)."""
    m = dmask.to(x.dtype)
    A = adj * m[:, :, None] * m[:, None, :]
    A = A + _eye(adj.shape[1], x)[None] * fill * m[:, :, None]
    deg = A.sum(-1)
    dis = torch.where(deg > 0, deg ** -0.5, 0.0)
    An = dis[:, :, None] * A * dis[:, None, :]
    out = An @ (x @ lp["w"].T)
    if "b" in lp:
        out = out + lp["b"]
    return out * m[:, :, None]


# --------------------------------------------------------------- DiffPool


def _dense_sage_init(gen, in_dim, out, dtype):
    # PyG DenseSAGEConv: lin_rel has NO bias, lin_root has the bias
    return {"rel": linear_init(gen, in_dim, out, bias=False, dtype=dtype),
            "root": linear_init(gen, in_dim, out, dtype=dtype),
            "bn_s": torch.ones(out, dtype=dtype),
            "bn_b": torch.zeros(out, dtype=dtype)}


def _dense_sage(lp, x, adj, mask):
    deg = torch.clamp(adj.sum(-1, keepdim=True), min=1.0)
    out = linear(lp["rel"], adj @ x / deg) + linear(lp["root"], x)
    if mask is not None:
        out = out * mask[..., None].to(x.dtype)
    return out


def _dense_bn_all(x, scale, bias, eps=1e-5):
    """BatchNorm over the FLATTENED dense batch: the reference flattens
    [G, n, c] to [G*n, c] (gnn2.py:543-549), so the statistics include
    the zero padding rows."""
    flat = x.reshape(-1, x.shape[-1])
    mean = flat.mean(0)
    var = ((flat - mean) ** 2).mean(0)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def _dense_gnn_init(gen, in_dim, hidden, out, dtype, lin=False):
    p = {"convs": [_dense_sage_init(gen, in_dim, hidden, dtype),
                   _dense_sage_init(gen, hidden, hidden, dtype),
                   _dense_sage_init(gen, hidden, out, dtype)]}
    if lin:
        p["lin"] = linear_init(gen, 2 * hidden + out, out, dtype=dtype)
    return p


def _dense_gnn(block, x, adj, mask):
    """gnn2.py:524-562 GNN: 3x (DenseSAGE -> relu -> BN), concat; with
    lin=True a final relu(linear(concat))."""
    outs = []
    for lp in block["convs"]:
        x = torch.relu(_dense_sage(lp, x, adj, mask))
        x = _dense_bn_all(x, lp["bn_s"], lp["bn_b"])
        outs.append(x)
    x = torch.cat(outs, -1)   # [G, n, 2*hidden+out]
    if "lin" in block:
        x = torch.relu(linear(block["lin"], x))
    return x


def _diff_pool(x, adj, s, mask=None):
    s = torch.softmax(s, -1)
    if mask is not None:
        m = mask[..., None].to(s.dtype)
        x, s = x * m, s * m
    x2 = torch.einsum("gnc,gnd->gcd", s, x)
    adj2 = torch.einsum("gnc,gnm,gmd->gcd", s, adj, s)
    return x2, adj2


# ---------------------------------------------------------------------------
# init / forward dispatch


def hpool_init(seed, cfg: HPoolConfig, dtype=torch.float32,
               device="cuda") -> Dict[str, torch.Tensor]:
    """Random parameters in the JAX tree's layout, from `seed` (an int or
    a torch.Generator). Returns the flat dotted-path dict on `device`."""
    gen = seeded(seed)
    d = cfg.emb_dim
    p: Dict[str, Any] = {"encoder": encoder_init(gen, cfg.encoder, dtype)}
    if cfg.kind == "dgcnn":
        p["convs"] = _dgcnn_stack_init(gen, cfg, d + cfg.num_rels, dtype)
        p["conv1d"] = _conv1d_head_init(gen, cfg, dtype)
        p["head"] = heads_init(gen, cfg, cfg.dense_dim, dtype)
    elif cfg.kind == "unet":
        # GraphUNet(emb+num_rels, emb, total_latent_dim, depth=4,
        # ratios .9/.7/.6/.5) — gnn2.py:591; all convs improved GCN
        p["down"] = ([linear_init(gen, d + cfg.num_rels, d, dtype=dtype)]
                     + [linear_init(gen, d, d, dtype=dtype) for _ in range(4)])
        p["pool_w"] = [randn(gen, (d,), dtype) / math.sqrt(d) for _ in range(4)]
        p["up"] = ([linear_init(gen, d, d, dtype=dtype) for _ in range(3)]
                   + [linear_init(gen, d, cfg.total_latent_dim, dtype=dtype)])
        p["conv1d"] = _conv1d_head_init(gen, cfg, dtype)
        p["head"] = heads_init(gen, cfg, cfg.dense_dim, dtype)
    elif cfg.kind == "diffpool":
        c1 = math.ceil(0.25 * cfg.max_nodes)
        c2 = math.ceil(0.25 * c1)
        w = 3 * d  # 2*hidden + embedding, all = emb_dim
        p["gnn1_pool"] = _dense_gnn_init(gen, d, d, c1, dtype, lin=True)
        p["gnn1_embed"] = _dense_gnn_init(gen, d, d, d, dtype)
        p["gnn2_pool"] = _dense_gnn_init(gen, w, d, c2, dtype, lin=True)
        p["gnn2_embed"] = _dense_gnn_init(gen, w, d, d, dtype)
        p["gnn3_embed"] = _dense_gnn_init(gen, w, d, d, dtype)
        p["lin1"] = linear_init(gen, w, d, dtype=dtype)
        p["head"] = heads_init(gen, cfg, d, dtype)
    elif cfg.kind == "sagpool":
        p["convs"] = [linear_init(gen, d, d, dtype=dtype)
                      for _ in range(cfg.num_layers)]
        # SAGPooling's scorer is a GraphConv(d -> 1, aggr=add) in PyG 1.6
        p["scores"] = [{"rel": linear_init(gen, d, 1, dtype=dtype),
                        "root": linear_init(gen, d, 1, bias=False, dtype=dtype)}
                       for _ in range(cfg.num_layers)]
        p["lin1"] = linear_init(gen, 2 * d, d, dtype=dtype)
        p["lin2"] = linear_init(gen, d, d, dtype=dtype)
        p["head"] = heads_init(gen, cfg, d, dtype)
    elif cfg.kind == "asap":
        h = cfg.asap_hidden
        p["conv1"] = {"root": linear_init(gen, d, h, bias=False, dtype=dtype),
                      "rel": linear_init(gen, d, h, dtype=dtype)}
        p["convs"] = [{"root": linear_init(gen, h, h, bias=False, dtype=dtype),
                       "rel": linear_init(gen, h, h, dtype=dtype)}
                      for _ in range(cfg.num_layers - 1)]
        p["pools"] = [{
            "lin": linear_init(gen, h, h, dtype=dtype),
            "att": linear_init(gen, 2 * h, 1, dtype=dtype),
            # LEConv fitness: lin1/lin3 biased, lin2 not
            "le1": linear_init(gen, h, 1, dtype=dtype),
            "le2": linear_init(gen, h, 1, bias=False, dtype=dtype),
            "le3": linear_init(gen, h, 1, dtype=dtype),
        } for _ in range(cfg.num_layers // 2)]
        p["lin1"] = linear_init(gen, cfg.num_layers * h, h, dtype=dtype)
        p["head"] = heads_init(gen, cfg, h, dtype)
    else:
        raise ValueError(cfg.kind)
    return to_params(p, device)


def _edge_feat_concat(x, batch: DAGBatch, e: FlatEdges):
    """DGCNN prologue: concat per-node sums of incident edge attrs
    (gnn2.py:309-315 scatters each edge's feature to BOTH endpoints)."""
    if batch.edge_attr is None:
        return x
    ea = batch.edge_attr.to(x.dtype)
    return torch.cat([x, e.by_src.sum(ea) + e.by_dst.sum(ea)], -1)


def hpool_forward(params, cfg: HPoolConfig, batch: DAGBatch,
                  rng: Optional[torch.Generator] = None, train: bool = False,
                  merge=row_step.tg_accumulate):
    """Logits [G, S, V] (token heads) or [G, C] (class head). `rng`: a
    torch.Generator for SAGPool's and ASAP's dropout when `train`;
    `merge` the graph-level sum (K5's contract)."""
    P = unflatten_tree(params)
    x, nmask, gid, G = embed(P, cfg, batch)
    e = FlatEdges(batch, x.shape[0])

    def drop(v):
        return dropout(v, cfg.dropout, rng) if train and cfg.dropout > 0 else v

    if cfg.kind == "dgcnn":
        h = _edge_feat_concat(x, batch, e)
        em = e.em & nmask[e.src] & nmask[e.dst]
        h = _dgcnn_stack(P["convs"], h, e, em)
        pooled = _sort_pool(h, h[:, -1], gid, G, nmask, cfg.k)
        return apply_heads(P["head"], cfg, _conv1d_head(P["conv1d"], pooled, cfg))

    if cfg.kind == "unet":
        # dense so the inter-depth (A+I)^2 augmentation is exact
        nm = cfg.dense_nodes
        h0 = _edge_feat_concat(x, batch, e)
        dx, dmask, pos, ok = _dense_from_batch(h0, gid, G, nmask, nm)
        adj = _dense_adj(e, gid, pos, ok, G, nm, x.dtype)
        ratios = (0.9, 0.7, 0.6, 0.5)
        h = torch.relu(_dense_gcn(P["down"][0], dx, adj, dmask, 2.0))
        keep = dmask
        skips = [(h, adj, keep)]
        eye = _eye(nm, h)[None]
        for i in range(4):
            # augment_adj: (A~ + I)^2, diagonal removed (GraphUNet)
            m = keep.to(h.dtype)
            A = adj * m[:, :, None] * m[:, None, :]
            A = A + eye * m[:, :, None]
            A = torch.einsum("gij,gjk->gik", A, A)
            A = A * (1.0 - eye)
            # TopKPooling: score = tanh(x.w/|w|), gate, filter
            w = P["pool_w"][i]
            y = torch.tanh(h @ w / torch.linalg.norm(w))
            keep = _dense_topk(y, keep, ratios[i])
            km = keep.to(h.dtype)
            h = h * (y * km)[..., None]
            adj = A * km[:, :, None] * km[:, None, :]
            h = torch.relu(_dense_gcn(P["down"][i + 1], h, adj, keep, 2.0))
            if i < 3:
                skips.append((h, adj, keep))
        for i in range(4):
            res, radj, rkeep = skips[3 - i]
            # unpool: kept slots retain their dense positions
            h = res + h * keep[..., None].to(h.dtype)
            keep = rkeep
            h = _dense_gcn(P["up"][i], h, radj, keep, 2.0)
            if i < 3:
                h = torch.relu(h)
        # back to sort-pool over the dense axis (zero-pad when k > n_dense)
        y = torch.where(dmask, h[..., -1], -math.inf)
        kk = min(cfg.k, nm)
        order = _stable_order(-y, dim=1)[:, :kk]
        pooled = torch.gather(h, 1, order[..., None].expand(-1, -1, h.shape[-1]))
        valid = torch.gather(dmask, 1, order)
        j = torch.arange(kk, device=h.device)[None]
        valid = valid & (j < dmask.sum(1, keepdim=True))
        pooled = pooled * valid[..., None].to(h.dtype)
        if kk < cfg.k:
            pooled = F.pad(pooled, (0, 0, 0, cfg.k - kk))
        return apply_heads(P["head"], cfg, _conv1d_head(P["conv1d"], pooled, cfg))

    if cfg.kind == "diffpool":
        nm = cfg.dense_nodes
        dx, dmask, pos, ok = _dense_from_batch(x, gid, G, nmask, nm)
        adj = _dense_adj(e, gid, pos, ok, G, nm, x.dtype)
        s = _dense_gnn(P["gnn1_pool"], dx, adj, dmask)
        z = _dense_gnn(P["gnn1_embed"], dx, adj, dmask)
        z, adj = _diff_pool(z, adj, s, dmask)
        s = _dense_gnn(P["gnn2_pool"], z, adj, None)
        z2 = _dense_gnn(P["gnn2_embed"], z, adj, None)
        z2, adj = _diff_pool(z2, adj, s)
        z3 = _dense_gnn(P["gnn3_embed"], z2, adj, None)
        out = torch.relu(linear(P["lin1"], z3.mean(1)))
        return apply_heads(P["head"], cfg, out)

    if cfg.kind == "sagpool":
        keep = nmask
        h = x
        xs = None
        for i in range(cfg.num_layers):
            em = e.em & keep[e.src] & keep[e.dst]
            h = torch.relu(_gcn_conv(P["convs"][i], h, e, em, keep=keep))
            sc = P["scores"][i]
            score = (linear(sc["rel"], e.by_dst.sum(h[e.src], mask=em))
                     + h @ sc["root"]["w"].T)[:, 0]
            score = torch.tanh(score)
            keep = topk_mask(score, gid, G, cfg.pooling_ratio, keep)
            h = h * (score * keep.to(h.dtype))[:, None]
            blk = _gmp_gap(h, gid, G, keep, merge)
            xs = blk if xs is None else xs + blk
        out = drop(torch.relu(linear(P["lin1"], xs)))
        out = torch.relu(linear(P["lin2"], out))
        return apply_heads(P["head"], cfg, out)

    if cfg.kind == "asap":
        nm = cfg.dense_nodes
        dx, dmask, pos, ok = _dense_from_batch(x, gid, G, nmask, nm)
        adj = _dense_adj(e, gid, pos, ok, G, nm, x.dtype)

        def gconv(cp, h, A, keep, use_weights):
            m = keep.to(h.dtype)
            Am = A * m[:, :, None] * m[:, None, :]
            W = Am if use_weights else (Am > 0).to(h.dtype)
            s = torch.einsum("gij,gjd->gid", W.transpose(1, 2), h)
            cnt = torch.clamp((Am > 0).sum(1), min=1).to(h.dtype)
            s = s / cnt[..., None]
            out = linear(cp["rel"], s) + h @ cp["root"]["w"].T
            return out * m[..., None]

        def meanpool(h, keep):
            cnt = torch.clamp(keep.sum(1).to(h.dtype), min=1.0)
            return (h * keep[..., None].to(h.dtype)).sum(1) / cnt[:, None]

        h = torch.relu(gconv(P["conv1"], dx, adj, dmask, False))
        keep = dmask
        gs = [meanpool(h, keep)]
        weighted = False   # the first pools see the binary adjacency
        pool_i = 0
        n_convs = cfg.num_layers - 1
        for i in range(n_convs):
            h = torch.relu(gconv(P["convs"][i], h, adj, keep, weighted))
            gs.append(meanpool(h, keep))
            if i % 2 == 0 and i < n_convs - 1:
                h, adj, keep = _asap_pool_dense(P["pools"][pool_i], cfg, h, adj, keep)
                pool_i += 1
                weighted = True
        out = drop(torch.relu(linear(P["lin1"], torch.cat(gs, -1))))
        return apply_heads(P["head"], cfg, out)

    raise ValueError(cfg.kind)


def _pow2_neg(k):
    """2^-k, exact, for whole k >= 0 (0 below the smallest subnormal)."""
    k = k.to(torch.int32)
    normal = (127 - torch.clamp(k, max=126)) << 23
    sub = torch.ones_like(k) << torch.clamp(149 - k, 0, 22)
    bits = torch.where(k <= 126, normal, torch.where(k <= 149, sub, 0))
    return bits.view(torch.float32)


class _MasterQuery(torch.autograd.Function):
    """max over the sources j with E[g, j, i] of h[g, j] (finfo.min where i
    has none), with the gradient of JAX's running jnp.maximum over j."""

    @staticmethod
    def forward(ctx, h, E):
        G, n, d = h.shape
        g, i, j = E.transpose(1, 2).nonzero(as_tuple=True)   # by (g, i), then j
        dest, src = g * n + i, g * n + j
        vals = h.reshape(G * n, d)[src]
        m = torch.full((G * n, d), torch.finfo(h.dtype).min, dtype=h.dtype,
                       device=h.device)
        m = m.scatter_reduce(0, dest[:, None].expand_as(vals), vals, "amax",
                             include_self=True)
        ctx.save_for_backward(h, dest, src, vals, m)
        return m.reshape(G, n, d)

    @staticmethod
    def backward(ctx, gout):
        h, dest, src, vals, m = ctx.saved_tensors
        G, n, d = h.shape
        tie = (vals == m[dest]).to(torch.int32)                # [nnz, d]
        # ties of the same destination before and after each pair, in j order
        c = torch.cumsum(tie, 0)
        lo = torch.searchsorted(dest, dest)
        hi = torch.searchsorted(dest, dest, right=True)
        zero = torch.zeros((1, d), dtype=c.dtype, device=c.device)
        cz = torch.cat([zero, c])
        before, after = cz[:-1] - cz[lo], cz[hi] - cz[:-1] - tie
        w = _pow2_neg(after + (before > 0).to(torch.int32)) * tie.to(torch.float32)
        contrib = w.to(gout.dtype) * gout.reshape(G * n, d)[dest]
        dh = SortedSegments(src, G * n).sum(contrib)
        return dh.reshape(G, n, d), None


def master_query(h, E):
    """ASAP's master query [G, i, d]: the max of h[g, j] over the sources j
    with E[g, j, i] (self loops included), 0 where i has none; the
    gradient that of JAX's running jnp.maximum over j (_MasterQuery)."""
    xq = _MasterQuery.apply(h, E)
    return torch.where(E.any(1)[..., None], xq, 0.0)


def _asap_pool_dense(pp, cfg: HPoolConfig, h, adj, keep):
    """ASAPooling (PyG 1.6.3, GNN=None, add_self_loops=False) on the dense
    per-graph adjacency:

      A~ = A + I (weight-1 self loops); x_q_i = lin(max_{j: A~_ji>0} x_j);
      alpha_ij = softmax_i(LeakyReLU(att([x_q_i, x_j]), 0.2)) over A~ edges;
      cluster x_i = sum_j alpha_ij x_j; fitness = sigmoid(LEConv(x, A~));
      keep top-ratio, scale by fitness; A_pool = S^T A~ S, diag removed.
    """
    G, nm, d = h.shape
    m = keep.to(h.dtype)
    eye = _eye(nm, h)[None]
    A = adj * m[:, :, None] * m[:, None, :]
    A = A + eye * m[:, :, None]
    E = A > 0
    neg = torch.finfo(h.dtype).min
    xq = linear(pp["lin"], master_query(h, E))

    # attention scores per (j -> i) pair over A~'s support
    aw, ab = pp["att"]["w"], pp["att"]["b"]
    scores = F.leaky_relu(
        torch.einsum("gid,d->gi", xq, aw[0, :d])[:, None, :]
        + torch.einsum("gjd,d->gj", h, aw[0, d:])[:, :, None] + ab[0], 0.2)  # [G,j,i]
    scores = torch.where(E, scores, neg)
    alpha = torch.where(E, torch.softmax(scores, dim=1), 0.0)   # S[j,i]
    hc = torch.einsum("gji,gjd->gid", alpha, h)

    # LEConv fitness on A~ (unweighted support): lin3(x_i) +
    # sum_j 1[A~_ji] (lin1(x)_i - lin2(x)_j)
    a = linear(pp["le1"], hc)[..., 0]
    b = linear(pp["le2"], hc)[..., 0]
    indeg = E.sum(1).to(h.dtype)
    fit = (linear(pp["le3"], hc)[..., 0] + indeg * a
           - torch.einsum("gji,gj->gi", E.to(h.dtype), b))
    fitness = torch.sigmoid(fit)

    keep2 = _dense_topk(fitness, keep, cfg.asap_ratio)
    km = keep2.to(h.dtype)
    h2 = hc * (fitness * km)[..., None]
    # reconnection: S columns restricted to kept clusters
    S = alpha * km[:, None, :]
    A2 = torch.einsum("gji,gjk,gkl->gil", S, A, S)
    A2 = A2 * (1.0 - eye)
    return h2, A2, keep2

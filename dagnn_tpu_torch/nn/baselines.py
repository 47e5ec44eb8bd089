"""Baseline GNNs over the full (possibly cyclic) augmented edge set.

Counterpart of dagnn_tpu/nn/baselines.py: the reference's OGB baselines
(reference: ogbg-code/model/conv.py:10-239 GIN/GCN ± virtual node wrapped
by model/gnn.py:11-94; the GAT and GGNN convolutions of the same family).
All message passing runs over the flat edge arrays of a DAGBatch (no
wavefront: these are round-based GNNs).

Parameters keep the JAX tree's names and layouts (convert.flatten_tree
carries them across); the forward reads them through
convert.unflatten_tree. Everything computes in float32, as the JAX
package's baselines do.

The sums onto nodes run through ops/segment.SortedSegments (the edges
sorted by destination once a forward, each node's messages added in that
order: a step repeats bit for bit on the card); GAT's softmax takes its
denominators the same way. The sums onto graphs (the virtual node's pool,
the readout) run through K5's contract (ops/segment.merged_segment_sum,
`merge` = row_step.tg_accumulate: the kernel on the card, its plain
version on the CPU). Degrees and node counts are whole numbers, exact in
any order.

BatchNorm uses masked batch statistics in train and eval alike (the JAX
package's documented deviation from the reference's running statistics).
Dropout draws from a torch.Generator (`rng`) at the JAX package's places.

The trivial baselines (reference ogbg-code/model/baselines.py:8-120) are
numpy functions of a host DAGBatch at the bottom of this module.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from dagnn_tpu_torch import resolve_device
from dagnn_tpu_torch.convert import flatten_tree, unflatten_tree
from dagnn_tpu_torch.dag.batch import DAGBatch
from dagnn_tpu_torch.nn.encoders import EncoderSpec, encode, encoder_init
from dagnn_tpu_torch.nn.readout import pool_nodes
from dagnn_tpu_torch.ops import row_step
from dagnn_tpu_torch.ops.gru import gru_cell, gru_init
from dagnn_tpu_torch.ops.linear import linear, linear_init
from dagnn_tpu_torch.ops.segment import (SortedSegments, merged_segment_sum,
                                         segment_count)


@dataclasses.dataclass(frozen=True)
class MPNNConfig:
    gnn_type: str = "gin"        # gin | gcn | gat | ggnn
    num_layers: int = 5
    emb_dim: int = 300
    dropout: float = 0.5
    residual: bool = False
    jk: str = "last"             # last | sum
    virtual_node: bool = False
    graph_pooling: str = "mean"
    num_vocab: int = 5002
    max_seq_len: int = 5
    num_class: int = 0
    num_rels: int = 2
    heads: int = 1               # gat
    timesteps: int = 5           # ggnn
    # the reference GGNN's weight dropout is dead code (its F.dropout
    # result is discarded, tg/gated_graph_conv.py:52): none here either
    encoder: EncoderSpec = EncoderSpec()


# ----------------------------------------------------------- shared pieces

def seeded(seed) -> torch.Generator:
    """`seed` as a torch.Generator (an int seeds a new CPU one)."""
    return seed if isinstance(seed, torch.Generator) else \
        torch.Generator().manual_seed(int(seed))


def randn(gen, shape, dtype=torch.float32):
    return torch.randn(shape, generator=gen, dtype=torch.float32).to(dtype)


def to_params(tree, device) -> Dict[str, torch.Tensor]:
    """A nested init tree -> the flat dotted-path dict on `device`."""
    dev = resolve_device(device)
    return {k: v.to(dev, copy=True) for k, v in flatten_tree(tree).items()}


def heads_init(gen, cfg, in_dim, dtype):
    """The class head (num_class > 0) or the stacked token heads."""
    if cfg.num_class > 0:
        return linear_init(gen, in_dim, cfg.num_class, dtype=dtype)
    hs = [linear_init(gen, in_dim, cfg.num_vocab, dtype=dtype)
          for _ in range(cfg.max_seq_len)]
    return {"w": torch.stack([h["w"] for h in hs]),
            "b": torch.stack([h["b"] for h in hs])}


def apply_heads(head, cfg, out):
    if cfg.num_class > 0:
        return linear(head, out)
    return torch.einsum("gd,svd->gsv", out, head["w"]) + head["b"][None]


def dropout(v, p, rng):
    """Each element kept with probability 1 - p and scaled by 1 / (1 - p),
    from a uniform draw of `rng` (a torch.Generator on v's device)."""
    if rng is None:
        raise ValueError("dropout in training needs a torch.Generator (rng)")
    keep = 1.0 - p
    m = torch.rand(v.shape, generator=rng, device=v.device) < keep
    return torch.where(m, v / keep, 0.0)


def embed(P, cfg, batch: DAGBatch):
    """The encoder's node embeddings [N+1, D], pad rows zero; the node
    mask, graph ids and graph slots."""
    x = encode(P.get("encoder", {}), cfg.encoder, batch.x,
               batch.extras.get("node_depth"))
    nmask = batch.node_mask.bool()
    x = torch.where(nmask[:, None], x, 0.0)
    return x, nmask, batch.graph_id.long(), batch.num_graph_slots


class FlatEdges:
    """The batch's flat edge arrays, with their segments by destination
    (and, at first use, by source) sorted once: every sum onto nodes of a
    forward shares them."""

    def __init__(self, batch: DAGBatch, n1: int):
        self.src = batch.edge_src_flat.long()
        self.dst = batch.edge_dst_flat.long()
        self.em = batch.edge_mask_flat.bool()
        self.n1 = n1
        self.by_dst = SortedSegments(self.dst, n1, self.em)
        self._by_src = None

    @property
    def by_src(self) -> SortedSegments:
        if self._by_src is None:
            self._by_src = SortedSegments(self.src, self.n1, self.em)
        return self._by_src


# ---------------------------------------------------------------- MPNN

def mpnn_init(seed, cfg: MPNNConfig, dtype=torch.float32,
              device="cuda") -> Dict[str, torch.Tensor]:
    """Random parameters in the JAX tree's layout, from `seed` (an int or
    a torch.Generator). Returns the flat dotted-path dict on `device`."""
    gen = seeded(seed)
    d = cfg.emb_dim
    p: Dict[str, Any] = {"encoder": encoder_init(gen, cfg.encoder, dtype)}
    layers = []
    for _ in range(cfg.num_layers):
        lp: Dict[str, Any] = {"edge_encoder": linear_init(gen, cfg.num_rels, d,
                                                          dtype=dtype)}
        if cfg.gnn_type == "gin":
            lp["mlp1"] = linear_init(gen, d, 2 * d, dtype=dtype)
            lp["mlp2"] = linear_init(gen, 2 * d, d, dtype=dtype)
            lp["bn_scale"] = torch.ones(2 * d, dtype=dtype)
            lp["bn_bias"] = torch.zeros(2 * d, dtype=dtype)
            lp["eps"] = torch.zeros((), dtype=dtype)
        elif cfg.gnn_type == "gcn":
            lp["linear"] = linear_init(gen, d, d, dtype=dtype)
            lp["root_emb"] = randn(gen, (d,), dtype)
        elif cfg.gnn_type == "gat":
            h = cfg.heads
            lp["w"] = linear_init(gen, d, d, bias=False, dtype=dtype)
            lp["att_src"] = randn(gen, (h, d // h), dtype) * 0.1
            lp["att_dst"] = randn(gen, (h, d // h), dtype) * 0.1
        elif cfg.gnn_type == "ggnn":
            lp["step_w"] = [linear_init(gen, d, d, bias=False, dtype=dtype)
                            for _ in range(cfg.timesteps)]
            lp["gru"] = gru_init(gen, d, d, dtype)
        else:
            raise ValueError(cfg.gnn_type)
        # post-layer BN (gnn.py applies BN after each conv)
        lp["out_bn_scale"] = torch.ones(d, dtype=dtype)
        lp["out_bn_bias"] = torch.zeros(d, dtype=dtype)
        layers.append(lp)
    p["layers"] = layers

    if cfg.virtual_node:
        p["vn_emb"] = torch.zeros((d,), dtype=dtype)
        # Sequential(Linear, BN, ReLU, Linear, BN, ReLU) per VN update
        # (conv.py:189-190)
        p["vn_mlps"] = [
            {"l1": linear_init(gen, d, 2 * d, dtype=dtype),
             "bn1_scale": torch.ones(2 * d, dtype=dtype),
             "bn1_bias": torch.zeros(2 * d, dtype=dtype),
             "l2": linear_init(gen, 2 * d, d, dtype=dtype),
             "bn2_scale": torch.ones(d, dtype=dtype),
             "bn2_bias": torch.zeros(d, dtype=dtype)}
            for _ in range(cfg.num_layers - 1)]

    if cfg.gnn_type == "ggnn":
        # GGNN gated readout (gnn2.py:33-41): sigmoid(l([h,x])) * tanh(r([h,x]))
        p["cls_l"] = linear_init(gen, 2 * d, d, dtype=dtype)
        p["cls_r"] = linear_init(gen, 2 * d, d, dtype=dtype)
    if cfg.graph_pooling == "attention":
        p["pool_attn"] = linear_init(gen, d, 1, dtype=dtype)
    p["head"] = heads_init(gen, cfg, d, dtype)
    return to_params(p, device)


def _masked_bn(x, mask, scale, bias, eps=1e-5):
    """BatchNorm over the rows `mask` selects, batch statistics; the other
    rows come out 0."""
    m = mask.to(x.dtype)[:, None]
    cnt = torch.clamp(m.sum(), min=1.0)
    mean = (x * m).sum(0) / cnt
    var = (((x - mean) ** 2) * m).sum(0) / cnt
    return ((x - mean) * torch.rsqrt(var + eps) * scale + bias) * m


def _conv(lp, cfg: MPNNConfig, h, e: FlatEdges, ea, nmask):
    src, dst = e.src, e.dst
    ee = linear(lp["edge_encoder"], ea)
    if cfg.gnn_type == "gin":
        msg = torch.relu(h[src] + ee)
        agg = e.by_dst.sum(msg)
        z = linear(lp["mlp1"], (1 + lp["eps"]) * h + agg)
        z = _masked_bn(z, nmask, lp["bn_scale"], lp["bn_bias"])
        return linear(lp["mlp2"], torch.relu(z))
    if cfg.gnn_type == "gcn":
        hw = linear(lp["linear"], h)
        deg = segment_count(src, e.n1, e.em, h.dtype) + 1.0  # conv.py:53, row
        dis = torch.where(deg > 0, deg ** -0.5, 0.0)
        norm = dis[src] * dis[dst]
        msg = norm[:, None] * torch.relu(hw[src] + ee)
        agg = e.by_dst.sum(msg)
        return agg + torch.relu(hw + lp["root_emb"]) / deg[:, None]
    if cfg.gnn_type == "gat":
        hds = cfg.heads
        dh = cfg.emb_dim // hds
        n1 = h.shape[0]
        hw = linear(lp["w"], h).reshape(n1, hds, dh)
        a_src = (hw * lp["att_src"][None]).sum(-1)          # [N, H]
        a_dst = (hw * lp["att_dst"][None]).sum(-1)
        scores = torch.nn.functional.leaky_relu(a_src[src] + a_dst[dst], 0.2)
        alpha = e.by_dst.softmax(scores)                     # [E, H], per head
        return e.by_dst.sum(hw[src] * alpha[..., None]).reshape(n1, hds * dh)
    if cfg.gnn_type == "ggnn":
        hh = h
        for t in range(cfg.timesteps):
            msg = linear(lp["step_w"][t], hh)[src] + ee
            hh = gru_cell(lp["gru"], e.by_dst.sum(msg), hh)
        return hh
    raise ValueError(cfg.gnn_type)


def mpnn_forward(params, cfg: MPNNConfig, batch: DAGBatch,
                 rng: Optional[torch.Generator] = None, train: bool = False,
                 merge=row_step.tg_accumulate):
    """Node embedding stack + pooling + heads (gnn.py:11-94 skeleton):
    logits [G, S, V] (token heads) or [G, C] (class head). `batch` holds
    tensors (convert.batch_to_torch); `rng` a torch.Generator for dropout
    when `train`; `merge` the graph-level sum (K5's contract)."""
    P = unflatten_tree(params)
    x, nmask, gid, G = embed(P, cfg, batch)
    n1 = x.shape[0]
    e = FlatEdges(batch, n1)
    ea = batch.edge_attr.to(x.dtype)
    drop = train and cfg.dropout > 0
    gsum = lambda v: merged_segment_sum(v, gid, G + 1, nmask, merge)

    vn = gmask = None
    if cfg.virtual_node:
        vn = P["vn_emb"].expand(G + 1, cfg.emb_dim)
        # real-graph mask for VN batch norms (pad slots excluded)
        gmask = torch.cat([batch.graph_mask.bool(),
                           torch.zeros(1, dtype=torch.bool, device=x.device)])

    hs = [x]
    h = x
    for li, lp in enumerate(P["layers"]):
        if vn is not None:
            h = h + vn[gid]
        h_in = h  # pre-conv state (VN message added) — conv.py:204 h_list
        h2 = _conv(lp, cfg, h_in, e, ea, nmask)
        h2 = _masked_bn(h2, nmask, lp["out_bn_scale"], lp["out_bn_bias"])
        if li < cfg.num_layers - 1:
            h2 = torch.relu(h2)
        if drop:
            h2 = dropout(h2, cfg.dropout, rng)
        if cfg.residual:
            h2 = h2 + h_in
        if vn is not None and li < cfg.num_layers - 1:
            # VN update pools the PRE-conv states (conv.py:223)
            pooled = gsum(h_in) + vn
            mlp = P["vn_mlps"][li]
            z = linear(mlp["l1"], pooled)
            z = torch.relu(_masked_bn(z, gmask, mlp["bn1_scale"], mlp["bn1_bias"]))
            z = linear(mlp["l2"], z)
            z = torch.relu(_masked_bn(z, gmask, mlp["bn2_scale"], mlp["bn2_bias"]))
            if drop:
                z = dropout(z, cfg.dropout, rng)
            vn = vn + z if cfg.residual else z
        h = h2
        hs.append(h)

    h_node = sum(hs[1:]) if cfg.jk == "sum" else hs[-1]

    if cfg.gnn_type == "ggnn":
        hx = torch.cat([h_node, x], -1)
        h_node = torch.sigmoid(linear(P["cls_l"], hx)) * torch.tanh(
            linear(P["cls_r"], hx))
        pool_kind = "add"
    else:
        pool_kind = {"attention": "attn"}.get(cfg.graph_pooling, cfg.graph_pooling)

    out = pool_nodes(h_node, gid, G, pool_kind, mask=nmask, merge=merge,
                     attn_params=P.get("pool_attn"), attn_compat=False)
    return apply_heads(P["head"], cfg, out)


# --- trivial baselines (reference model/baselines.py) ----------------------

def guess_node_one_token(batch: DAGBatch, attridx2vocabidx: Dict[int, int],
                         num_vocab: int, max_seq_len: int) -> np.ndarray:
    """Predict position 0 as the attr-token of the node after each root
    (baselines.py:8-43): one-hot where mappable, zeros elsewhere."""
    depth = np.asarray(batch.extras["node_depth"]).reshape(-1)
    roots = np.flatnonzero((depth == 0) & np.asarray(batch.node_mask))
    G = batch.num_graph_slots
    out = np.zeros((G, max_seq_len, num_vocab), np.float32)
    x = np.asarray(batch.x)
    gid = np.asarray(batch.graph_id)
    for r in roots:
        g = gid[r]
        if g >= G or r + 1 >= len(gid) or gid[r + 1] != g:
            continue
        attr = int(x[r + 1, 1])
        if attr in attridx2vocabidx:
            out[g, 0, attridx2vocabidx[attr]] = 1.0
    return out


def guess_tokens_by_occurrence(batch: DAGBatch, attridx2vocabidx: Dict[int, int],
                               num_vocab: int, max_seq_len: int,
                               min_occ: int = 2) -> np.ndarray:
    """Predict the per-graph most frequent mappable attr tokens
    (baselines.py:45-88)."""
    G = batch.num_graph_slots
    out = np.full((G, max_seq_len, num_vocab), -1.0, np.float32)
    x = np.asarray(batch.x)
    gid = np.asarray(batch.graph_id)
    nmask = np.asarray(batch.node_mask)
    for g in range(int(batch.n_graph)):
        sel = (gid == g) & nmask
        counts = np.zeros(num_vocab, np.int64)
        for attr in x[sel, 1]:
            v = attridx2vocabidx.get(int(attr))
            if v is not None:
                counts[v] += 1
        for j in range(max_seq_len):
            tok = int(np.argmax(counts))
            if counts[tok] >= min_occ:
                out[g, j, tok] = 1.0
            counts[tok] = 0
    return out


def perfect_model(batch: DAGBatch, num_vocab: int, max_seq_len: int) -> np.ndarray:
    """Oracle upper bound: one-hot of the true y_arr (baselines.py:90-120)."""
    G = batch.num_graph_slots
    out = np.zeros((G, max_seq_len, num_vocab), np.float32)
    y = np.asarray(batch.y["y_arr"])
    for g in range(int(batch.n_graph)):
        for j in range(max_seq_len):
            out[g, j, int(y[g, j])] = 1.0
    return out

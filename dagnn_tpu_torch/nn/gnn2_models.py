"""The reference's gnn2.py message-passing baselines: GGNN_Simple, GGNN
(edge-typed, residual), GAT.

Counterpart of dagnn_tpu/nn/gnn2_models.py (reference: ogbg-code/model/
gnn2.py:15-77 GGNN_Simple, :80-147 GGNN, :160-212 GAT;
tg/gated_graph_conv.py, the edge-typed GatedGraphConv). All run over the
flat (4-way augmented, possibly cyclic) edge set with static shapes and
mask-based padding, in float32. Parameters keep the JAX tree's names and
layouts; the sums onto nodes run through ops/segment.SortedSegments (a
fixed order), the sums onto graphs through K5's contract (`merge`), as in
nn/baselines.py.

Reference quirks kept, as the JAX package keeps them:
- tg/gated_graph_conv.py:52 applies F.dropout to the weights out of place
  and discards the result: no weight dropout.
- tg/gated_graph_conv.py:72-80: the incoming messages are initialised once
  and accumulated across timesteps; each step adds the new aggregation to
  the previous step's (already degree-normalised) messages, then divides
  the sum by (indegree + 1e-7) again.
- GAT's conv3 has 6 heads of 121; the final mean over those heads comes
  after the graph mean pool (gnn2.py:203).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from dagnn_tpu_torch.convert import unflatten_tree
from dagnn_tpu_torch.dag.batch import DAGBatch
from dagnn_tpu_torch.nn.baselines import (FlatEdges, apply_heads, embed,
                                          heads_init, seeded, to_params)
from dagnn_tpu_torch.nn.encoders import EncoderSpec, encoder_init
from dagnn_tpu_torch.ops import row_step
from dagnn_tpu_torch.ops.gru import gru_cell, gru_init
from dagnn_tpu_torch.ops.linear import linear, linear_init
from dagnn_tpu_torch.ops.segment import merged_segment_sum, segment_count


@dataclasses.dataclass(frozen=True)
class GNN2Config:
    kind: str = "ggnn_simple"     # ggnn_simple | ggnn | gat
    emb_dim: int = 300
    num_vocab: int = 5002
    max_seq_len: int = 5
    num_class: int = 0
    num_rels: int = 2
    encoder: EncoderSpec = EncoderSpec()
    # ggnn_simple (gnn2.py:18 layer_timesteps=[5])
    layer_timesteps: tuple = (5,)
    # ggnn (gnn2.py:84-85): per layer i, residual inputs from layers listed
    ggnn_timesteps: tuple = (2, 2, 1, 2, 1)
    ggnn_residuals: tuple = ((), (), (0,), (), (0, 2))
    # gat (gnn2.py:161-176)
    num_layers: int = 3
    heads: int = 4
    # no dropout anywhere in these reference forwards (GAT's is commented
    # out, gnn2.py:196-200); kept for driver-config uniformity
    dropout: float = 0.0


def _uniform_sq(gen, shape, d, dtype):
    # PyG inits.uniform(size=out_channels): U(-1/sqrt(out), 1/sqrt(out))
    b = 1.0 / (float(d) ** 0.5)
    return ((torch.rand(shape, generator=gen, dtype=torch.float32) * 2.0 - 1.0)
            * b).to(dtype)


def gnn2_init(seed, cfg: GNN2Config, dtype=torch.float32,
              device="cuda") -> Dict[str, torch.Tensor]:
    """Random parameters in the JAX tree's layout, from `seed` (an int or
    a torch.Generator). Returns the flat dotted-path dict on `device`."""
    gen = seeded(seed)
    d = cfg.emb_dim
    p: Dict[str, Any] = {"encoder": encoder_init(gen, cfg.encoder, dtype)}
    if cfg.kind == "ggnn_simple":
        # PyG GatedGraphConv(emb, t) per entry of layer_timesteps
        p["convs"] = [{"w": _uniform_sq(gen, (t, d, d), d, dtype),
                       "gru": gru_init(gen, d, d, dtype)}
                      for t in cfg.layer_timesteps]
        p["cls_l"] = linear_init(gen, 2 * d, d, dtype=dtype)
        p["cls_r"] = linear_init(gen, 2 * d, d, dtype=dtype)
        p["head"] = heads_init(gen, cfg, d, dtype)
    elif cfg.kind == "ggnn":
        p["convs"] = []
        for i, t in enumerate(cfg.ggnn_timesteps):
            rdim = len(cfg.ggnn_residuals[i]) * d
            p["convs"].append({
                "w": _uniform_sq(gen, (t, cfg.num_rels, d, d), d, dtype),
                "gru": gru_init(gen, d + rdim, d, dtype)})
        p["cls_l"] = linear_init(gen, 2 * d, d, dtype=dtype)
        p["cls_r"] = linear_init(gen, 2 * d, d, dtype=dtype)
        p["head"] = heads_init(gen, cfg, d, dtype)
    elif cfg.kind == "gat":
        h = cfg.heads

        def gatp(kin, heads, out):
            return {"w": linear_init(gen, kin, heads * out, bias=False, dtype=dtype),
                    "att_l": torch.randn((heads, out), generator=gen).to(dtype) * 0.1,
                    "att_r": torch.randn((heads, out), generator=gen).to(dtype) * 0.1,
                    "bias": torch.zeros(heads * out, dtype=dtype)}

        p["conv1"] = gatp(d, h, d)
        p["convs"] = [gatp(h * d, h, d) for _ in range(cfg.num_layers - 2)]
        p["conv3"] = gatp(h * d, 6, 121)
        p["head"] = heads_init(gen, cfg, 121, dtype)
    else:
        raise ValueError(cfg.kind)
    return to_params(p, device)


def _gat_conv(gp, h, e: FlatEdges, nmask, heads, out):
    """PyG-1.6 GATConv with self-loops: alpha = softmax_dst(LeakyReLU(
    att_l.x_src + att_r.x_dst)) over the in-edges and the self loop,
    out = sum alpha * x_src, heads concatenated."""
    n1 = h.shape[0]
    src, dst, em = e.src, e.dst, e.em
    hw = linear(gp["w"], h).reshape(n1, heads, out)
    a_l = (hw * gp["att_l"][None]).sum(-1)            # [N, H] source term
    a_r = (hw * gp["att_r"][None]).sum(-1)            # [N, H] target term
    lrelu = lambda v: torch.nn.functional.leaky_relu(v, 0.2)
    scores = lrelu(a_l[src] + a_r[dst])               # [E, H]
    self_scores = lrelu(a_l + a_r)                    # [N, H]
    # segment softmax over {edges into i} U {self loop}
    neg = torch.finfo(scores.dtype).min
    es = torch.where(em[:, None], scores, neg)
    seg_max = torch.full((n1, heads), neg, dtype=scores.dtype, device=h.device)
    seg_max = seg_max.scatter_reduce(0, dst[:, None].expand_as(es), es, "amax",
                                     include_self=True)
    mx = torch.maximum(seg_max, self_scores)
    ee = torch.where(em[:, None], torch.exp(scores - mx[dst]), 0.0)
    se = torch.exp(self_scores - mx) * nmask[:, None]
    denom = e.by_dst.sum(ee) + se + 1e-16
    out_e = e.by_dst.sum(ee[..., None] * hw[src])
    out_n = (out_e + se[..., None] * hw) / denom[..., None]
    return out_n.reshape(n1, heads * out) + gp["bias"]


def gnn2_forward(params, cfg: GNN2Config, batch: DAGBatch,
                 rng: Optional[torch.Generator] = None, train: bool = False,
                 merge=row_step.tg_accumulate):
    """Logits [G, S, V] (token heads) or [G, C] (class head). No dropout
    (rng and train are taken for the drivers' uniformity); `merge` is the
    graph-level sum (K5's contract)."""
    P = unflatten_tree(params)
    x, nmask, gid, G = embed(P, cfg, batch)
    n1 = x.shape[0]
    e = FlatEdges(batch, n1)
    gsum = lambda v: merged_segment_sum(v, gid, G + 1, nmask, merge)[:G]

    if cfg.kind in ("ggnn_simple", "ggnn"):
        h = x
        if cfg.kind == "ggnn_simple":
            for conv in P["convs"]:
                for t in range(conv["w"].shape[0]):
                    m = e.by_dst.sum((h @ conv["w"][t])[e.src])
                    h = gru_cell(conv["gru"], m, h)
        else:
            ea = batch.edge_attr.to(h.dtype)
            layer_states = [h]
            # the degree divisor counts every edge, whatever its relation
            indeg = segment_count(e.dst, n1, e.em, h.dtype)
            for i, conv in enumerate(P["convs"]):
                res = [layer_states[r] for r in cfg.ggnn_residuals[i]]
                hh = layer_states[-1]
                # reference quirk: messages accumulate ACROSS timesteps
                # (tg/gated_graph_conv.py:72-80)
                msgs = torch.zeros((n1, cfg.emb_dim), dtype=h.dtype, device=h.device)
                for t in range(conv["w"].shape[0]):
                    for j in range(cfg.num_rels):
                        msgs = msgs + e.by_dst.sum((hh @ conv["w"][t, j])[e.src],
                                                   mask=ea[:, j] > 0)
                    msgs = msgs / (indeg + 1e-7)[:, None]
                    hh = gru_cell(conv["gru"], torch.cat(res + [msgs], -1), hh)
                layer_states.append(hh)
            h = layer_states[-1]
        hx = torch.cat([h, x], -1)
        g = torch.sigmoid(linear(P["cls_l"], hx)) * torch.tanh(linear(P["cls_r"], hx))
        return apply_heads(P["head"], cfg, gsum(g))

    if cfg.kind == "gat":
        d, hds = cfg.emb_dim, cfg.heads
        h = torch.nn.functional.elu(_gat_conv(P["conv1"], x, e, nmask, hds, d))
        for gp in P["convs"]:
            h = torch.nn.functional.elu(_gat_conv(gp, h, e, nmask, hds, d))
        h = _gat_conv(P["conv3"], h, e, nmask, 6, 121)
        # mean pool over real nodes, then mean over the 6 heads
        cnt = torch.clamp(segment_count(gid, G + 1, nmask, h.dtype)[:G], min=1.0)
        pooled = gsum(h) / cnt[:, None]
        return apply_heads(P["head"], cfg, pooled.reshape(G, 6, 121).mean(1))

    raise ValueError(cfg.kind)

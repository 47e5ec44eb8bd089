"""Per-level predecessor aggregation: the six aggregator kinds.

Counterpart of dagnn_tpu/nn/aggregators.py (reference: ogbg-code/model/
dagnn.py:232-409: AggConv sum/max, GatedSumConv, SelfAttnConv, AttnConv,
MultAttnConv). On the fused paths the `attn` math runs inside the row
kernels (ops/row_step.py); the per-direction wavefront's generic branch
runs every kind here, one level at a time:

    value_src [Ke, H]   message values (source states, already gathered)
    key_src   [Ke, A]   attention keys (source states or inputs)
    query     [Kn, Dq]  per-destination-slot queries (level-local)
    edge_dst  [Ke]      local destination slot of each edge (pad Kn)
    edge_emb  [Ke, A]   encoded edge attributes, added to the keys of the
                        attention kinds and to the values of the sum kinds

The attention kinds score each edge (`attn`: the query and key parts of
the additive score, the query projection once per destination slot;
`self_attn`: the key alone; `mattn`: a product of projected query and
key), then run the edge-softmax aggregate K6 (ops/segment_attn.py). `add`
and `gated_sum` sum through K5's contract (ops/segment.merged_segment_sum),
`max` through ops/segment.segment_max.

The config's segment_impl does not reach this module: every name
("dense", "scatter", "fused", "pallas") computes the same function, and
the JAX package's "dense" differs only by one-hot MXU matmuls, a TPU
device trick the port drops (nn/dagnn.py checks the name). `fns` picks
the functions run:
SEG_KERNELS (the default; the kernels on the card, their plain versions
for CPU tensors) or SEG_PLAIN. Parameter layout as in JAX: attn_lin w
[1, Dq + A] (torch-layout compatible with the reference's attn_lin,
dagnn.py:359), the one-hot edge encoder w [A or H, R] (dagnn.py:238,356).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from dagnn_tpu_torch.ops import row_step, segment, segment_attn
from dagnn_tpu_torch.ops.linear import linear, linear_init

class AggImpl(NamedTuple):
    """The segment functions the generic branch runs: the edge-softmax
    aggregate (K6's contract, forward and backward) and the masked segment
    merge (K5's contract: the transpose-grad merge and the sum kinds'
    segment sum), as wrappers or plain versions."""
    aggregate: object
    merge: object


SEG_KERNELS = AggImpl(segment_attn.pallas_edge_softmax_aggregate,
                      row_step.tg_accumulate)
SEG_PLAIN = AggImpl(segment_attn.plain_edge_softmax_aggregate,
                    row_step.tg_accumulate_plain)


@dataclasses.dataclass(frozen=True)
class AggregatorSpec:
    """Static configuration of one aggregator instance (see the JAX
    module for the meaning of each field)."""

    kind: str
    value_dim: int
    key_dim: int = 0
    query_dim: int = 0
    num_rels: int = 1
    mapper_bias: bool = True
    out_dim: int = 0  # gated_sum output dim; 0 -> value_dim

    @property
    def gated_out_dim(self) -> int:
        return self.out_dim or self.value_dim

    @property
    def wea(self) -> bool:
        return self.num_rels > 1

    @property
    def edge_emb_dim(self) -> int:
        # attention kinds encode edges into key space, sum kinds into value space
        return self.key_dim if self.kind in ("self_attn", "attn", "mattn") else self.value_dim


def aggregator_init(gen: torch.Generator, spec: AggregatorSpec,
                    dtype=torch.float32):
    p = {}
    if spec.wea:
        p["edge_encoder"] = linear_init(gen, spec.num_rels,
                                        spec.edge_emb_dim, dtype=dtype)
    if spec.kind == "gated_sum":
        p["gate"] = linear_init(gen, spec.value_dim, spec.gated_out_dim,
                                dtype=dtype)
        p["mapper"] = linear_init(gen, spec.value_dim, spec.gated_out_dim,
                                  bias=spec.mapper_bias, dtype=dtype)
    elif spec.kind == "self_attn":
        p["attn_lin"] = linear_init(gen, spec.key_dim, 1, dtype=dtype)
    elif spec.kind == "attn":
        p["attn_lin"] = linear_init(gen, spec.query_dim + spec.key_dim, 1,
                                    dtype=dtype)
    elif spec.kind == "mattn":
        p["attn_linl"] = linear_init(gen, spec.query_dim, spec.query_dim,
                                     dtype=dtype)
        p["attn_linr"] = linear_init(gen, spec.key_dim, spec.query_dim,
                                     dtype=dtype)
    elif spec.kind not in ("add", "max"):
        raise ValueError(f"unknown aggregator kind {spec.kind}")
    return p


def encode_edges(params, spec: AggregatorSpec,
                 edge_attr: Optional[torch.Tensor]):
    """Apply this aggregator's one-hot edge encoder (dagnn.py:238,261,287)."""
    if not spec.wea or edge_attr is None:
        return None
    return linear(params["edge_encoder"], edge_attr)


def _clamped(edge_dst, rows):
    """edge_dst with pad slot `rows` read as row rows-1, as JAX's clamped
    gather reads it; the callers cut the pad slot's row off, so the read is
    inert (ROADMAP queue 3)."""
    return torch.clamp(edge_dst.long(), max=rows - 1)


def aggregate_level(params, spec: AggregatorSpec, value_src: torch.Tensor,
                    edge_dst: torch.Tensor, edge_mask: torch.Tensor,
                    num_slots: int, key_src: Optional[torch.Tensor] = None,
                    query: Optional[torch.Tensor] = None,
                    edge_emb: Optional[torch.Tensor] = None,
                    fns: AggImpl = SEG_KERNELS):
    """Aggregate one level's messages into [num_slots, out dim].

    num_slots is Kn + 1 (the pad slot is a real segment); callers slice
    [:Kn]."""
    if spec.kind in ("add", "max", "gated_sum"):
        v = value_src if edge_emb is None else value_src + edge_emb
        if spec.kind == "max":
            return segment.segment_max(v, edge_dst, num_slots, edge_mask)
        if spec.kind == "gated_sum":
            v = torch.sigmoid(linear(params["gate"], v)) * linear(params["mapper"], v)
        return segment.merged_segment_sum(v, edge_dst, num_slots, edge_mask,
                                          fns.merge)

    k = key_src if key_src is not None else value_src
    if edge_emb is not None:
        k = k + edge_emb
    if spec.kind == "self_attn":
        scores = linear(params["attn_lin"], k)[..., 0]
    elif spec.kind == "attn":
        w = params["attn_lin"]["w"]                               # [1, Dq + A]
        dq = spec.query_dim
        q_scores = query @ w[:, :dq].T + params["attn_lin"]["b"]  # [Kn, 1]
        k_scores = k @ w[:, dq:].T                                # [Ke, 1]
        scores = (q_scores[_clamped(edge_dst, q_scores.shape[0])] + k_scores)[..., 0]
    elif spec.kind == "mattn":
        ql = linear(params["attn_linl"], query)                   # [Kn, Dq]
        kr = linear(params["attn_linr"], k)                       # [Ke, Dq]
        scores = (ql[_clamped(edge_dst, ql.shape[0])] * kr).sum(-1)
    else:
        raise ValueError(f"unknown aggregator kind {spec.kind}")
    return fns.aggregate(scores, value_src, edge_dst, edge_mask, num_slots)

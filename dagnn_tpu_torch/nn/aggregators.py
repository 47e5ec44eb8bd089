"""Aggregator specs, the `attn` kind's parameters and its level aggregate.

Counterpart of dagnn_tpu/nn/aggregators.py. On the fused paths the
attention math runs inside the row kernels (ops/row_step.py); the
per-direction wavefront's generic branch (segment_impl="pallas") runs it
here, one level at a time: the query and key parts of the additive score
(SDDMM-style, the query projection once per destination slot), then the
edge-softmax aggregate K6 (ops/segment_attn.py). The parameter layout:
attn_lin w [1, Dq + A] (torch-layout compatible with the reference's
attn_lin, dagnn.py:359) and the one-hot edge encoder w [A, R]
(dagnn.py:238,356).

Only the `attn` kind with impl="pallas" is ported; the other kinds
(self_attn, mattn, add, max, gated_sum) and impls (dense, scatter) raise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from dagnn_tpu_torch.ops import segment_attn
from dagnn_tpu_torch.ops.linear import linear, linear_init

_UNPORTED = ("is not ported yet (ROADMAP queue 1, item 5: the rest of the "
             "DAGNN config surface)")


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
    out_dim: int = 0

    @property
    def wea(self) -> bool:
        return self.num_rels > 1

    @property
    def edge_emb_dim(self) -> int:
        # attention kinds encode edges into key space, sum kinds into value space
        return self.key_dim if self.kind in ("self_attn", "attn", "mattn") else self.value_dim


def aggregator_init(gen: torch.Generator, spec: AggregatorSpec,
                    dtype=torch.float32):
    if spec.kind != "attn":
        raise NotImplementedError(f"aggregator kind {spec.kind!r} {_UNPORTED}")
    p = {}
    if spec.wea:
        p["edge_encoder"] = linear_init(gen, spec.num_rels,
                                        spec.edge_emb_dim, dtype=dtype)
    p["attn_lin"] = linear_init(gen, spec.query_dim + spec.key_dim, 1,
                                dtype=dtype)
    return p


def encode_edges(params, spec: AggregatorSpec,
                 edge_attr: Optional[torch.Tensor]):
    """Apply this aggregator's one-hot edge encoder (dagnn.py:238,261,287)."""
    if not spec.wea or edge_attr is None:
        return None
    return linear(params["edge_encoder"], edge_attr)


def aggregate_level(params, spec: AggregatorSpec, value_src: torch.Tensor,
                    edge_dst: torch.Tensor, edge_mask: torch.Tensor,
                    num_slots: int, key_src: Optional[torch.Tensor] = None,
                    query: Optional[torch.Tensor] = None,
                    edge_emb: Optional[torch.Tensor] = None,
                    impl: str = "pallas", softmax_aggregate=None):
    """Aggregate one level's messages into [num_slots, value_dim].

    value_src [Ke, H] gathered source states, query [Kn, Dq] per-slot
    queries, edge_dst [Ke] local destination slots (pad Kn), edge_mask
    [Ke]. num_slots is Kn + 1 (the pad slot is a real segment); callers
    slice [:Kn]. `softmax_aggregate` is K6's contract function:
    segment_attn.pallas_edge_softmax_aggregate (the default, the kernels)
    or plain_edge_softmax_aggregate."""
    if spec.kind != "attn":
        raise NotImplementedError(f"aggregator kind {spec.kind!r} {_UNPORTED}")
    if impl != "pallas":
        raise NotImplementedError(f"segment_impl {impl!r} {_UNPORTED}")
    k = key_src if key_src is not None else value_src
    if edge_emb is not None:
        k = k + edge_emb
    w = params["attn_lin"]["w"]                               # [1, Dq + A]
    dq = spec.query_dim
    q_scores = query @ w[:, :dq].T + params["attn_lin"]["b"]  # [Kn, 1]
    k_scores = k @ w[:, dq:].T                                # [Ke, 1]
    # a pad edge's slot Kn lies past q_scores: read row Kn-1 (as JAX's
    # clamped gather does); K6 leaves masked edges out, so it is inert
    qi = torch.clamp(edge_dst, max=q_scores.shape[0] - 1)
    scores = (q_scores[qi] + k_scores)[..., 0]
    fn = softmax_aggregate or segment_attn.pallas_edge_softmax_aggregate
    return fn(scores, value_src, edge_dst, edge_mask, num_slots)

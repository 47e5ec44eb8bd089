"""Segment ops over per-level edge groups.

Counterpart of dagnn_tpu/ops/segment.py (segment_sum, segment_max,
segment_softmax, edge_softmax_aggregate). Every edge
carries a LOCAL destination slot within its level, so segments span
[0, num_segments): small, dense and static.

An edge counts when its mask is set and its segment id lies in
[0, num_segments); any other edge contributes nothing (jax.ops.segment_sum
drops an out-of-range id the same way). Empty and fully masked segments
sum to 0 and have a softmax max of 0. The softmax subtracts the segment
max, exponentiates and divides by (sum + 1e-16), as
torch_geometric.utils.softmax does. Everything is computed in the inputs'
dtype, as the JAX functions do.

segment_sum, segment_softmax and edge_softmax_aggregate are plain PyTorch
functions: the CPU tests use them, and on the card they are the reference
the kernels are held against (ops/segment_attn.py, ops/row_step.
tg_accumulate), never the path. The path's sum is merged_segment_sum, an
autograd Function over K5's contract (on the card row_step.tg_accumulate:
a fixed float32 order, one rounding, no atomics, so a step repeats bit for
bit). segment_max stays scatter_reduce("amax") on the card too: the JAX
package computes it in XLA, and a max does not depend on the order.
"""

from __future__ import annotations

from typing import Optional

import torch

# Matches torch_geometric.utils.softmax's denominator epsilon.
SOFTMAX_EPS = 1e-16


def valid_edges(segment_ids: torch.Tensor, num_segments: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[E] bool: the edges that belong to a segment."""
    ok = (segment_ids >= 0) & (segment_ids < num_segments)
    if mask is not None:
        ok = ok & (mask > 0)
    return ok


def _ids(segment_ids, valid, num_segments):
    """Segment ids with every invalid edge sent to the drop row
    num_segments (the scratch row of the sums below)."""
    return torch.where(valid, segment_ids.long(), num_segments)


def segment_sum(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum `values` rows [E, ...] into [num_segments, ...] buckets; edges
    outside any segment (masked, or id out of range) contribute 0."""
    valid = valid_edges(segment_ids, num_segments, mask)
    out = torch.zeros((num_segments + 1,) + tuple(values.shape[1:]),
                      dtype=values.dtype, device=values.device)
    out.index_add_(0, _ids(segment_ids, valid, num_segments), values)
    return out[:num_segments]


def segment_softmax(scores: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-segment softmax of edge scores [E]: max-shifted, normalised by
    (sum + 1e-16). Edges outside any segment get weight 0 and do not touch
    the others' normalisation."""
    valid = valid_edges(segment_ids, num_segments, mask)
    ids = _ids(segment_ids, valid, num_segments)
    neg = torch.finfo(scores.dtype).min
    masked = torch.where(valid, scores, torch.full((), neg, dtype=scores.dtype,
                                                   device=scores.device))
    seg_max = torch.full((num_segments + 1,), neg, dtype=scores.dtype,
                         device=scores.device)
    seg_max = seg_max.scatter_reduce(0, ids, masked, "amax", include_self=True)
    seg_max = torch.where(seg_max <= neg, 0.0, seg_max)   # empty segments
    # a select, not a product with the mask: an invalid edge never reaches
    # exp(), so no inf * 0 turns into a NaN
    expd = torch.where(valid, torch.exp(masked - seg_max[ids]), 0.0)
    denom = torch.zeros((num_segments + 1,), dtype=scores.dtype,
                        device=scores.device).index_add_(0, ids, expd)
    return expd / (denom[ids] + SOFTMAX_EPS)


def edge_softmax_aggregate(scores: torch.Tensor, values: torch.Tensor,
                           segment_ids: torch.Tensor, num_segments: int,
                           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(scores) per destination segment, then the alpha-weighted sum
    of `values` [E, H] -> [num_segments, H]: the core of the attention
    aggregators' message passing (reference ogbg-code/model/dagnn.py:307-310)."""
    alpha = segment_softmax(scores, segment_ids, num_segments, mask)
    return segment_sum(values * alpha[:, None], segment_ids, num_segments, mask)


def segment_max(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-segment max of `values` rows [E, ...] -> [num_segments, ...].
    Masked rows read finfo.min (of values' dtype); an empty or fully masked
    segment gives 0, with a zero gradient. Tied maxima share the gradient
    evenly, as jax.ops.segment_max's does."""
    valid = valid_edges(segment_ids, num_segments, mask)
    neg = torch.finfo(values.dtype).min
    col = valid.reshape((-1,) + (1,) * (values.dim() - 1))
    v = torch.where(col, values, torch.full((), neg, dtype=values.dtype,
                                            device=values.device))
    ids = _ids(segment_ids, valid, num_segments)
    ids = ids.reshape(col.shape).expand_as(v)
    out = torch.full((num_segments + 1,) + tuple(values.shape[1:]), neg,
                     dtype=values.dtype, device=values.device)
    out = out.scatter_reduce(0, ids, v, "amax", include_self=False)
    out = out[:num_segments]
    return torch.where(out <= neg, torch.zeros((), dtype=out.dtype,
                                               device=out.device), out)


class _MergedSegmentSum(torch.autograd.Function):
    """forward: merge(zeros [num_segments, C], values, ids, mask), K5's
    contract; backward: the masked gather of the cotangent at ids."""

    @staticmethod
    def forward(ctx, values, segment_ids, mask, num_segments, merge):
        ctx.save_for_backward(segment_ids, mask)
        ctx.num_segments = num_segments
        zero = torch.zeros((num_segments, values.shape[1]), dtype=values.dtype,
                           device=values.device)
        return merge(zero, values.contiguous(), segment_ids, mask)

    @staticmethod
    def backward(ctx, g):
        segment_ids, mask = ctx.saved_tensors
        valid = valid_edges(segment_ids, ctx.num_segments, mask)
        idx = torch.where(valid, segment_ids.long(), 0)
        dv = torch.where(valid[:, None], g[idx],
                         torch.zeros((), dtype=g.dtype, device=g.device))
        return dv, None, None, None, None


def merged_segment_sum(values: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int, mask: torch.Tensor,
                       merge) -> torch.Tensor:
    """segment_sum of values [E, C] into [num_segments, C], differentiable,
    through `merge`, a function with K5's contract (g, tg, tdst, tmask) ->
    g + the masked sum of tg's rows onto tdst: row_step.tg_accumulate (the
    kernel on the card, its plain version for CPU tensors) or
    row_step.tg_accumulate_plain. Either sums in float32 and rounds once to
    values' dtype."""
    return _MergedSegmentSum.apply(values, segment_ids, mask, num_segments,
                                   merge)

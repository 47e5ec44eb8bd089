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

The baselines (nn/baselines.py, nn/gnn2_models.py, nn/pooling_baselines.py)
sum messages over the flat edge set onto every node: tens of thousands of
segments, where K5's slot-per-block scan of the whole key list does not
fit, and where index_add_'s float atomics would make a step differ from
run to run. SortedSegments sorts the edges by segment once per batch
(stable, the invalid ones into a drop segment), keeps the CSR offsets, and
sums each segment's rows in that fixed order (torch.segment_reduce, a
sequential loop per segment and column): the same step gives the same bits
on every run. Its softmax takes its max by scatter_reduce("amax") and its
denominators through the same ordered sum.
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
    expd = _shifted_exp(scores, valid, ids, num_segments)
    denom = torch.zeros((num_segments + 1,), dtype=scores.dtype,
                        device=scores.device).index_add_(0, ids, expd)
    return expd / (denom[ids] + SOFTMAX_EPS)


def _shifted_exp(scores, valid, ids, num_segments):
    """exp(score - its segment's max) of each valid edge, 0 elsewhere:
    the numerators of a segment softmax of scores [E] or [E, H] (ids: the
    edges' segments, the drop segment num_segments for invalid ones). An
    empty segment's max is 0."""
    col = valid.reshape((-1,) + (1,) * (scores.dim() - 1))
    neg = torch.finfo(scores.dtype).min
    masked = torch.where(col, scores, torch.full((), neg, dtype=scores.dtype,
                                                 device=scores.device))
    seg_max = torch.full((num_segments + 1,) + tuple(scores.shape[1:]), neg,
                         dtype=scores.dtype, device=scores.device)
    seg_max = seg_max.scatter_reduce(
        0, ids.reshape(col.shape).expand_as(scores), masked, "amax",
        include_self=True)
    seg_max = torch.where(seg_max <= neg, 0.0, seg_max)   # empty segments
    # a select, not a product with the mask: an invalid edge never reaches
    # exp(), so no inf * 0 turns into a NaN
    return torch.where(col, torch.exp(masked - seg_max[ids]), 0.0)


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


def segment_count(segment_ids: torch.Tensor, num_segments: int,
                  mask: Optional[torch.Tensor] = None,
                  dtype=torch.float32) -> torch.Tensor:
    """[num_segments] count of the edges in each segment, as `dtype`.
    Counts are whole numbers, exact in any summation order (below 2^24 in
    float32), so index_add_ gives the same bits on every run."""
    valid = valid_edges(segment_ids, num_segments, mask)
    out = torch.zeros((num_segments + 1,), dtype=dtype,
                      device=segment_ids.device)
    out.index_add_(0, _ids(segment_ids, valid, num_segments), valid.to(dtype))
    return out[:num_segments]


class SortedSegments:
    """The edges of one segment key (a destination or source node id),
    sorted by segment once per batch, for deterministic segment sums.

    An edge belongs to its segment when `mask` is set and its id lies in
    [0, num_segments); the others are sorted into the drop segment
    num_segments. perm is the stable sort, offsets [num_segments + 2] the
    CSR bounds (searchsorted: no host sync)."""

    def __init__(self, segment_ids: torch.Tensor, num_segments: int,
                 mask: Optional[torch.Tensor] = None):
        self.num_segments = num_segments
        self.valid = valid_edges(segment_ids, num_segments, mask)
        self.ids = _ids(segment_ids, self.valid, num_segments)
        self.perm = torch.argsort(self.ids, stable=True)
        bounds = torch.arange(num_segments + 2, device=self.ids.device)
        self.offsets = torch.searchsorted(self.ids[self.perm], bounds)

    def sum(self, values: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """segment_sum of values [E, ...] into [num_segments, ...], each
        segment's rows added in the sorted order. `mask` (a subset of the
        edges' own) zeroes further rows first: adding an exact 0 leaves
        every partial sum as it was."""
        if mask is not None:
            col = mask.reshape((-1,) + (1,) * (values.dim() - 1)) > 0
            values = torch.where(col, values, torch.zeros(
                (), dtype=values.dtype, device=values.device))
        out = torch.segment_reduce(values[self.perm], "sum",
                                   offsets=self.offsets, axis=0, unsafe=True)
        return out[: self.num_segments]

    def softmax(self, scores: torch.Tensor) -> torch.Tensor:
        """segment_softmax of scores [E] or [E, H] over this key: the max
        by scatter_reduce("amax"), the denominators by the ordered sum.
        Edges outside any segment get weight 0."""
        expd = _shifted_exp(scores, self.valid, self.ids, self.num_segments)
        denom = torch.segment_reduce(expd[self.perm], "sum",
                                     offsets=self.offsets, axis=0, unsafe=True)
        return expd / (denom[self.ids] + SOFTMAX_EPS)


def merged_segment_softmax(scores: torch.Tensor, segment_ids: torch.Tensor,
                           num_segments: int, mask: torch.Tensor,
                           merge) -> torch.Tensor:
    """segment_softmax of scores [E] whose denominators are summed through
    `merge` (K5's contract, as merged_segment_sum): the graph-level
    softmax of the attention readout."""
    valid = valid_edges(segment_ids, num_segments, mask)
    ids = _ids(segment_ids, valid, num_segments)
    expd = _shifted_exp(scores, valid, ids, num_segments)
    denom = merged_segment_sum(expd[:, None], segment_ids, num_segments,
                               mask, merge)[:, 0]
    denom = torch.cat([denom, denom.new_zeros(1)])
    return expd / (denom[ids] + SOFTMAX_EPS)

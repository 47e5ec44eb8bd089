"""Segment ops over per-level edge groups: the plain semantics.

Counterpart of dagnn_tpu/ops/segment.py (segment_sum, segment_softmax,
edge_softmax_aggregate), the part this port's wavefronts use. Every edge
carries a LOCAL destination slot within its level, so segments span
[0, num_segments): small, dense and static.

An edge counts when its mask is set and its segment id lies in
[0, num_segments); any other edge contributes nothing (jax.ops.segment_sum
drops an out-of-range id the same way). Empty and fully masked segments
sum to 0 and have a softmax max of 0. The softmax subtracts the segment
max, exponentiates and divides by (sum + 1e-16), as
torch_geometric.utils.softmax does. Everything is computed in the inputs'
dtype, as the JAX functions do.

These are plain PyTorch functions: the CPU tests use them, and on the card
they are the reference the kernels are held against (ops/segment_attn.py,
ops/row_step.tg_accumulate), never the path.
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

"""Graph readouts: masked segment pooling over graph ids.

Counterpart of dagnn_tpu/nn/readout.py: PyG's global_{max,mean,add}_pool
as the reference readout uses them (reference: ogbg-code/model/dagnn.py:
88-93,184-202), plus the attention pool. The reference's attention pool
(dagnn.py:114-117) softmaxes the last dim of an [N, 1] score tensor, which
is identically 1.0, so it is add pooling (attn_compat=True, the default,
which DAGNN takes); attn_compat=False weighs each node by the per-graph
softmax of linear(attn_params, h), the evidently intended pool, which the
baselines' attention pooling takes (nn/baselines.py).

The sums, and the softmax's denominators, run through
ops/segment.merged_segment_sum (K5's contract: `merge` is
row_step.tg_accumulate, the kernel on the card, or its plain version), the
max through ops/segment.segment_max.
"""

from __future__ import annotations

import torch

from dagnn_tpu_torch.ops import row_step, segment
from dagnn_tpu_torch.ops.linear import linear


def pool_nodes(h: torch.Tensor, graph_id: torch.Tensor, num_graphs: int,
               kind: str, mask: torch.Tensor,
               merge=row_step.tg_accumulate, attn_params=None,
               attn_compat: bool = True) -> torch.Tensor:
    """Pool node states [N, D] into per-graph [num_graphs, D].

    mask selects the nodes that take part (e.g. only the final-level nodes
    of the reference's out_pool over output nodes). Pad nodes carry
    graph_id == num_graphs and drop into an extra segment. kind "attn"
    with attn_compat=False needs attn_params ({"w": [1, D], "b": [1]})."""
    segs = num_graphs + 1
    ssum = lambda v: segment.merged_segment_sum(v, graph_id, segs, mask, merge)
    if kind in ("add", "sum") or (kind == "attn" and attn_compat):
        # attn: a softmax over a length-1 axis is 1.0 (reference dagnn.py:116)
        out = ssum(h)
    elif kind == "attn":
        scores = linear(attn_params, h)[..., 0]
        weights = segment.merged_segment_softmax(scores, graph_id, segs, mask,
                                                 merge)
        out = ssum(h * weights[:, None])
    elif kind == "max":
        out = segment.segment_max(h, graph_id, segs, mask)
    elif kind == "mean":
        cnt = segment.segment_count(graph_id, segs, mask)
        out = (ssum(h) / torch.clamp(cnt, min=1.0)[:, None]).to(h.dtype)
    else:
        raise ValueError(f"unknown pool kind {kind}")
    return out[:num_graphs]

"""Graph readouts: masked segment pooling over graph ids.

Counterpart of dagnn_tpu/nn/readout.py: PyG's global_{max,mean,add}_pool
as the reference readout uses them (reference: ogbg-code/model/dagnn.py:
88-93,184-202), plus the attention pool. The reference's attention pool
(dagnn.py:114-117) softmaxes the last dim of an [N, 1] score tensor, which
is identically 1.0, so it is add pooling (the JAX package's
attn_compat=True, the only form its models use).

The sums run through ops/segment.merged_segment_sum (K5's contract:
`merge` is row_step.tg_accumulate, the kernel on the card, or its plain
version), the max through ops/segment.segment_max.
"""

from __future__ import annotations

import torch

from dagnn_tpu_torch.ops import row_step, segment


def pool_nodes(h: torch.Tensor, graph_id: torch.Tensor, num_graphs: int,
               kind: str, mask: torch.Tensor,
               merge=row_step.tg_accumulate) -> torch.Tensor:
    """Pool node states [N, D] into per-graph [num_graphs, D].

    mask selects the nodes that take part (e.g. only the final-level nodes
    of the reference's out_pool over output nodes). Pad nodes carry
    graph_id == num_graphs and drop into an extra segment."""
    segs = num_graphs + 1
    ssum = lambda v: segment.merged_segment_sum(v, graph_id, segs, mask, merge)
    if kind in ("add", "sum", "attn"):
        # attn: a softmax over a length-1 axis is 1.0 (reference dagnn.py:116)
        out = ssum(h)
    elif kind == "max":
        out = segment.segment_max(h, graph_id, segs, mask)
    elif kind == "mean":
        # node counts in float32 are exact in any summation order
        valid = segment.valid_edges(graph_id, segs, mask)
        cnt = torch.zeros((segs + 1,), dtype=torch.float32, device=h.device)
        cnt.index_add_(0, torch.where(valid, graph_id.long(), segs),
                       valid.float())
        out = (ssum(h) / torch.clamp(cnt[:segs], min=1.0)[:, None]).to(h.dtype)
    else:
        raise ValueError(f"unknown pool kind {kind}")
    return out[:num_graphs]

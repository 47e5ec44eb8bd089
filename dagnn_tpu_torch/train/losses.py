"""Training losses of the OGB drivers.

Counterpart of dagnn_tpu/train/losses.py. tok: per-position cross entropy
averaged over the sequence positions (reference: ogbg-code/main_pyg.py:
55-60). class (LP): a single softmax cross entropy (main_pyg_lp.py:56-60).
Padded graph slots are masked out; the mean is over real graphs.
"""

from __future__ import annotations

import torch


def _cross_entropy(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """optax.softmax_cross_entropy_with_integer_labels over the last axis."""
    picked = torch.gather(logits, -1, y.long()[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - picked


def tok_loss(logits: torch.Tensor, y_arr: torch.Tensor,
             graph_mask: torch.Tensor) -> torch.Tensor:
    """logits [G, S, V]; y_arr [G, S] int targets; graph_mask [G] bool.

    Double-where NaN safety: pad graphs can carry non-finite logits, so
    the logits are sanitized BEFORE the cross entropy — masking only the
    CE afterwards would still multiply the zero cotangent by
    softmax(non-finite) = NaN in the backward."""
    gm = graph_mask.bool()
    safe = torch.where(gm[:, None, None], logits, 0.0)
    ce = _cross_entropy(safe, y_arr)                           # [G, S]
    per_graph = torch.where(gm, ce.mean(dim=-1), 0.0)
    m = gm.to(logits.dtype)
    return per_graph.sum() / torch.clamp(m.sum(), min=1.0)


def class_loss(logits: torch.Tensor, y: torch.Tensor,
               graph_mask: torch.Tensor) -> torch.Tensor:
    """logits [G, C]; y [G] int; graph_mask [G]. NaN-safe like tok_loss:
    pad graphs' logits are zeroed before the cross entropy and their terms
    masked after it."""
    gm = graph_mask.bool()
    safe = torch.where(gm[:, None], logits, 0.0)
    ce = torch.where(gm, _cross_entropy(safe, y), 0.0)
    m = gm.to(logits.dtype)
    return ce.sum() / torch.clamp(m.sum(), min=1.0)

"""Node-input encoders.

Counterpart of dagnn_tpu/nn/encoders.py, the reference encoder family:
  * ast:  type/attr/depth embedding sum (reference: ogbg-code/utils.py:6-28)
  * ast2: type/attr only (reference: ogbg-code/utils2.py:6-28)
  * bag:  EmbeddingBag-sum over token-id lists (dagnn.py:218-223)
  * identity: features used as given (the D-VAE pipeline's one-hot x)
The JAX package looks the two small AST tables up by a one-hot matmul (a
TPU device trick); here every table is plain indexing. Embedding tables
init N(0, 1), matching torch.nn.Embedding defaults.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class EncoderSpec:
    kind: str = "identity"          # identity | ast | ast2 | bag
    emb_dim: int = 0
    num_nodetypes: int = 0
    num_nodeattributes: int = 0
    max_depth: int = 20
    vocab_size: int = 0             # bag encoder


def encoder_init(gen: torch.Generator, spec: EncoderSpec,
                 dtype=torch.float32):
    if spec.kind == "identity":
        return {}
    n = lambda rows: torch.randn((rows, spec.emb_dim), generator=gen,
                                 dtype=torch.float32).to(dtype)
    if spec.kind in ("ast", "ast2"):
        p = {"type_emb": n(spec.num_nodetypes),
             "attr_emb": n(spec.num_nodeattributes)}
        if spec.kind == "ast":
            p["depth_emb"] = n(spec.max_depth + 1)
        return p
    if spec.kind == "bag":
        return {"emb": n(spec.vocab_size)}
    raise ValueError(f"unknown encoder kind {spec.kind}")


def encode(params, spec: EncoderSpec, x: torch.Tensor,
           node_depth: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Encode raw node inputs into [N, emb] float embeddings.

    ast/ast2: x [N, 2] int (type id, attr id); ast adds the depth
    embedding, depth clipped to max_depth. bag: x [N, T] int token ids,
    every id summed (EmbeddingBag's sum). identity: x as given (cast to
    float32 when it is not a float)."""
    if spec.kind == "identity":
        return x if x.is_floating_point() else x.float()
    if spec.kind in ("ast", "ast2"):
        x = x.long()
        out = params["type_emb"][x[:, 0]] + params["attr_emb"][x[:, 1]]
        if spec.kind == "ast":
            d = torch.clamp(node_depth.reshape(-1).long(), 0, spec.max_depth)
            out = out + params["depth_emb"][d]
        return out
    if spec.kind == "bag":
        return params["emb"][x.long()].sum(dim=-2)
    raise ValueError(f"unknown encoder kind {spec.kind}")

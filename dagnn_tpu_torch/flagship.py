"""The flagship workload: ogbg-code2 TOK at the reference configuration.

Counterpart of the JAX package's `__graft_entry__._flagship_cfg` and
`_pad_for`: emb/hidden 300, bidirectional 2-layer `attn_h` with 2 edge
relations, the AST encoder, 5 token heads over 5002 words, a max pool over
the final nodes, bf16 compute (reference defaults of scripts/ogb_tok.sh).
The port runs it on the direction-merged wavefront with the CUDA row
kernels, or with a pair plan on the pair-scheduled wavefront with the CUDA
pair kernels (segment_impl="fused"). Two variants of the same model run
per direction: bidirectional=False (scripts/ogb_tok.sh's BIDIR=0) on the
row kernels at one direction, and segment_impl="pallas" on the generic
branch with the edge-softmax aggregate K6.
"""

from __future__ import annotations

import dataclasses

from dagnn_tpu_torch.dag.batch import PadConfig
from dagnn_tpu_torch.nn.dagnn import DAGNNConfig
from dagnn_tpu_torch.nn.encoders import EncoderSpec

VOCAB = 5002
SEQ = 5


def flagship_cfg(emb: int = 300, hidden: int = 300, vocab: int = VOCAB,
                 seq: int = SEQ, compute_dtype: str = "bfloat16",
                 num_attrs: int = 10030, segment_impl: str = "fused",
                 bidirectional: bool = True) -> DAGNNConfig:
    return DAGNNConfig(
        num_vocab=vocab, max_seq_len=seq,
        emb_dim=emb, hidden_dim=hidden,
        num_rels=2, w_edge_attr=True, num_layers=2,
        bidirectional=bidirectional,
        agg="attn_h", out_wx=False, out_pool_all=False, out_pool="max",
        encoder=EncoderSpec("ast", emb_dim=emb, num_nodetypes=98,
                            num_nodeattributes=num_attrs, max_depth=20),
        compute_dtype=compute_dtype,
        segment_impl=segment_impl,
    )


def pad_for(graphs, chunk: int = 256, edge_budget: int = 512,
            stagger: int = 2, pair: int = 0, n_shards: int = 1) -> PadConfig:
    """Bucket config: exact batch statistics at a fixed scan-row chunk
    width, stagger (critical-path) packing on, edge-heavy levels split
    into extra rows of about edge_budget edges. n_shards > 1 (one bucket
    for every data-parallel shard of parallel/dp.split_by_nodes) divides
    the counts across the shards with headroom, since a shard's maxima can
    exceed total / shards (the JAX package's `__graft_entry__._pad_for`).
    pair > 0 adds a pair plan (PadConfig.pair; 2 is the JAX bench's
    default, the pair-affine row packer) and rounds max_levels up to even,
    as a pair plan needs (the JAX bench does the same, bench.py:146-152)."""
    pad = PadConfig.for_graphs(graphs, chunk_size=chunk,
                               edge_budget=edge_budget, stagger=stagger)
    if n_shards > 1:
        r = lambda v: int(v * 1.3) + 16
        pad = dataclasses.replace(
            pad,
            max_nodes=r(pad.max_nodes / n_shards),
            max_edges=r(pad.max_edges / n_shards),
            max_graphs=max(1, len(graphs) // n_shards) + 2,
            max_levels=pad.max_levels + 8,
            edges_per_level=r(pad.edges_per_level),
            tgrad_per_level=r(pad.tgrad_per_level) if pad.tgrad_per_level else 0,
        )
    if pair:
        pad = dataclasses.replace(pad, pair=pair,
                                  max_levels=pad.max_levels + pad.max_levels % 2)
    return pad

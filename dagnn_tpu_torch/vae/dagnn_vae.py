"""DAGNN-encoder VAE: the coupled model for NA/BN scoring.

Counterpart of dagnn_tpu/vae/dagnn_vae.py (reference: dvae/dagnn.py:18-239,
dvae/dagnn_bn.py:19-233): a wavefront DAGNN encoder (with one-hot vertex
ids for NA) feeding the D-VAE latent heads, and the autoregressive D-VAE
decoder (vae/dvae.py) with the encoder-shared aggregation parameters:

  * agg == gated_sum: the encoder's gate/mapper ARE the decoder's
    gate_f/mapper_f (and _b) (dvae/dagnn.py:62-66). They are stored once,
    under "dec.*"; the encoder has no "enc.aggr.*" keys and its view
    (_effective_enc_params) maps the decoder's tensors in;
  * attention aggs: the decoder reuses the encoder's forward-direction
    layer-0 aggregator "enc.aggr.0.0.*" (dvae/dagnn.py:236-237).

Both uses read the same tensors, not copies, so autograd sums the
encoder's and the decoder's gradients into one leaf, as jax.grad does.

The encoder runs the port's DAGNN (nn/dagnn.dagnn_node_states) on the
per-direction wavefront's generic branch: vid_dim > 0 (NA) or the default
segment_impl "dense" (BN) rule the fused row kernels out, so attn_h runs
the edge-softmax aggregate K6 per level and layer and its backward merges
transpose grads with K5; gated_sum sums through K5. `impl` (SEG_KERNELS,
the default, or SEG_PLAIN) picks those functions.

Readout (fixed-size graphs, dvae/dagnn.py:147-170): last-vertex states
(+ first-vertex for bidirectional, merged by hg_unify), or out_linear over
the concatenated layer states; pooled variants project node states before
pooling.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from dagnn_tpu_torch import resolve_device
from dagnn_tpu_torch.dag.batch import DAGBatch, PadConfig, collate
from dagnn_tpu_torch.data.na import NAGraph, na_graph_to_dag
from dagnn_tpu_torch.nn.aggregators import SEG_KERNELS
from dagnn_tpu_torch.nn.dagnn import DAGNNConfig, dagnn_init, dagnn_node_states
from dagnn_tpu_torch.nn.encoders import EncoderSpec
from dagnn_tpu_torch.nn.readout import pool_nodes
from dagnn_tpu_torch.ops.linear import linear, linear_init
from dagnn_tpu_torch.vae.dvae import (DVAEConfig, _generator, _on,
                                      dvae_decode, dvae_decoder_init,
                                      dvae_teacher_loss, kld, reparameterize,
                                      sub_params)

NA_GATED_SUM = "gated_sum"


@dataclasses.dataclass(frozen=True)
class DAGNNVAEConfig:
    """The JAX package's DAGNNVAEConfig, field for field. `dropout` does
    not reach encoder_cfg, as in the JAX package (ROADMAP queue 3)."""

    max_n: int
    nvt: int                     # total vertex types (incl. start/end)
    hs: int = 501
    nz: int = 56
    num_layers: int = 2
    bidirectional: bool = False
    agg: str = "attn_h"
    out_wx: bool = False
    out_pool_all: bool = False
    out_pool: str = "max"
    dropout: float = 0.0
    bn: bool = False             # DAGNN_BN variant
    beta: float = 0.005
    eps_scale: float = 0.01

    @property
    def num_nodes(self) -> int:
        # fixed graph size == nvt for these corpora (train.py:169)
        return self.max_n

    @property
    def vid(self) -> bool:
        return not self.bn       # the BN variant drops the vertex ids

    @property
    def dvae(self) -> DVAEConfig:
        return DVAEConfig(
            max_n=self.max_n, nvt=self.nvt, hs=self.hs, nz=self.nz,
            num_layers=self.num_layers, bidirectional=self.bidirectional,
            vid=self.vid, bn=self.bn,
            dec_agg=self.agg if "attn" in self.agg else NA_GATED_SUM,
            pred_source="h", beta=self.beta, eps_scale=self.eps_scale)

    @property
    def encoder_cfg(self) -> DAGNNConfig:
        return DAGNNConfig(
            num_vocab=0, max_seq_len=1, emb_dim=self.nvt, hidden_dim=self.hs,
            num_rels=1, w_edge_attr=False, num_layers=self.num_layers,
            bidirectional=self.bidirectional, mapper_bias=False, agg=self.agg,
            out_wx=self.out_wx, out_pool_all=self.out_pool_all,
            out_pool=self.out_pool, num_class=1,   # a dummy head, unused
            encoder=EncoderSpec("identity"),
            vid_dim=self.num_nodes if self.vid else 0,
            # the dvae model fixes the shared-AggConv reverse bug upstream
            # (dvae/dagnn.py:67-70), so the coupling uses the intended
            # reverse aggregation
            ref_shared_agg_quirk=False)

    @property
    def out_hidden_dim(self) -> int:
        return (self.nvt + self.hs * self.num_layers if self.out_wx
                else self.hs * self.num_layers)


def dagnn_vae_init(seed, cfg: DAGNNVAEConfig, dtype=torch.float32,
                   device="cuda") -> Dict[str, torch.Tensor]:
    """Random parameters in the JAX tree's layout, from `seed` (an int or a
    torch.Generator: the port's own stream): "enc.*" (dagnn_init of
    encoder_cfg, without "enc.aggr.*" under gated_sum), "dec.*", "fc1.*",
    "fc2.*" and, by config, "hg_unify.*", "out_linear.*", "pool_attn.*".
    The flat dotted-path dict on `device`."""
    dev = resolve_device(device)
    gen = _generator(seed)
    enc = dagnn_init(gen, cfg.encoder_cfg, dtype, device=dev)
    if cfg.agg == NA_GATED_SUM:
        # the encoder's aggregators are the decoder's gate/mapper
        enc = {k: v for k, v in enc.items() if not k.startswith("aggr.")}
    dec = dvae_decoder_init(gen, cfg.dvae, dtype, device=dev)
    p = {"fc1": linear_init(gen, cfg.hs, cfg.nz, dtype=dtype),
         "fc2": linear_init(gen, cfg.hs, cfg.nz, dtype=dtype)}
    if cfg.bidirectional:
        p["hg_unify"] = linear_init(gen, cfg.hs * 2 * cfg.num_layers, cfg.hs,
                                    dtype=dtype)
    if cfg.num_layers > 1:
        p["out_linear"] = linear_init(gen, cfg.out_hidden_dim, cfg.hs, dtype=dtype)
    if cfg.out_pool == "attn":
        p["pool_attn"] = linear_init(gen, cfg.hs, 1, dtype=dtype)
    out = {f"enc.{k}": v for k, v in enc.items()}
    out.update({f"dec.{k}": v for k, v in dec.items()})
    out.update(_on(p, dev))
    return out


def _effective_enc_params(params, cfg: DAGNNVAEConfig):
    """The encoder's flat dict (dagnn_node_states' keys): "enc.*" unprefixed,
    and under gated_sum the decoder's gate/mapper tensors in the
    aggregator slots, direction by direction."""
    enc = sub_params(params, "enc.")
    if cfg.agg != NA_GATED_SUM:
        return enc
    for di, d in enumerate(cfg.encoder_cfg.dirs):
        suff = "f" if d == 0 else "b"
        for l in range(cfg.num_layers):
            for part in ("gate", "mapper"):
                for leaf in ("w", "b"):
                    key = f"dec.{part}_{suff}.{l}.{leaf}"
                    if key in params:
                        enc[f"aggr.{di}.{l}.{part}.{leaf}"] = params[key]
    return enc


def _decoder_attn_params(params, cfg: DAGNNVAEConfig):
    """The attention decoder's aggregator: the encoder's aggr[0][0]."""
    if "attn" in cfg.agg:
        return sub_params(_effective_enc_params(params, cfg), "aggr.0.0.")
    return None


def dagnn_vae_embed(params, cfg: DAGNNVAEConfig, batch: DAGBatch, impl=None):
    """Encoder forward to the graph embedding Hg [G, hs]
    (dvae/dagnn.py:104-175). batch: a collated DAGBatch on the
    parameters' device (convert.batch_to_torch); impl: SEG_KERNELS (None)
    or SEG_PLAIN."""
    ecfg = cfg.encoder_cfg
    x, h_dirs = dagnn_node_states(_effective_enc_params(params, cfg), ecfg,
                                  batch, impl)
    G = batch.num_graph_slots
    nn_sz = cfg.num_nodes
    dev = x.device
    if not cfg.out_pool_all:
        # fixed-size index arithmetic (dvae/dagnn.py:147-161)
        gidx = torch.arange(G, device=dev)
        last = gidx * nn_sz + (nn_sz - 1)
        h_last = torch.cat([h_dirs[0][l][last] for l in range(cfg.num_layers)], -1)
        if cfg.bidirectional:
            first = gidx * nn_sz
            h_first = torch.cat([h_dirs[1][l][first]
                                 for l in range(cfg.num_layers)], -1)
            return linear(sub_params(params, "hg_unify."),
                          torch.cat([h_last, h_first], -1))
        if cfg.num_layers > 1:
            return linear(sub_params(params, "out_linear."), h_last)
        return h_last
    # pooled over all nodes: project node states, then pool (dvae/dagnn.py:162-170)
    layers = [h_dirs[di][l] for di in range(len(ecfg.dirs))
              for l in range(cfg.num_layers)]
    hcat = torch.cat(([x] if cfg.out_wx else []) + layers, -1)
    if cfg.bidirectional:
        hcat = linear(sub_params(params, "hg_unify."), hcat)
    elif cfg.num_layers > 1:
        hcat = linear(sub_params(params, "out_linear."), hcat)
    return pool_nodes(hcat, torch.as_tensor(batch.graph_id, device=dev), G,
                      cfg.out_pool, torch.as_tensor(batch.node_mask, device=dev).bool(),
                      (impl or SEG_KERNELS).merge)


def dagnn_vae_encode(params, cfg: DAGNNVAEConfig, batch: DAGBatch, impl=None):
    """(mu, logvar) [G, nz] of a collated batch."""
    hg = dagnn_vae_embed(params, cfg, batch, impl)
    return linear(sub_params(params, "fc1."), hg), linear(sub_params(params, "fc2."), hg)


def dagnn_vae_loss(params, cfg: DAGNNVAEConfig, batch: DAGBatch, types, adj,
                   nv, gen: Optional[torch.Generator], training: bool = True,
                   impl=None):
    """The VAE loss, teacher-forced reconstruction + beta * KLD
    (models_pyg.py:398-456): (total, recon, kld). types/adj/nv are the
    dense decoder views of the batch's graphs (na_dense_views) on the
    parameters' device; gen draws the reparameterization noise when
    training."""
    mu, logvar = dagnn_vae_encode(params, cfg, batch, impl)
    mu = mu[: types.shape[0]]
    logvar = logvar[: types.shape[0]]
    z = reparameterize(gen, mu, logvar, cfg.eps_scale, training)
    recon, _ = dvae_teacher_loss(
        sub_params(params, "dec."), cfg.dvae, z, types, adj, nv,
        attn_params=_decoder_attn_params(params, cfg))
    k = kld(mu, logvar)
    return recon + cfg.beta * k, recon, k


def dagnn_vae_decode(params, cfg: DAGNNVAEConfig, z, gen=None, stochastic=True,
                     capture=True):
    return dvae_decode(sub_params(params, "dec."), cfg.dvae, z, gen, stochastic,
                       attn_params=_decoder_attn_params(params, cfg), capture=capture)


# --- host-side helpers -----------------------------------------------------

def na_dense_views(graphs: Sequence[NAGraph], max_n: int):
    """Dense decoder arrays (types, adj, nv) for a list of NAGraphs."""
    B = len(graphs)
    types = np.zeros((B, max_n), np.int32)
    adj = np.zeros((B, max_n, max_n), np.float32)
    nv = np.zeros(B, np.int32)
    for i, g in enumerate(graphs):
        n = g.num_nodes
        types[i, :n] = g.types
        adj[i, :n, :n] = g.adj
        nv[i] = n
    return types, adj, nv


def na_collate(graphs: Sequence[NAGraph], cfg: DAGNNVAEConfig,
               pad_graphs: Optional[int] = None):
    """Collate NAGraphs into (DAGBatch, types, adj, nv), numpy, for the
    encoder and the loss. Every level is sized statically (all edges could
    start in one row), so every batch of one size shares one shape."""
    dags = [na_graph_to_dag(g, cfg.nvt) for g in graphs]
    nb = pad_graphs or len(graphs)
    nn_sz = cfg.num_nodes
    per_level = max(1, nb * nn_sz * nn_sz // 2)
    pad = PadConfig(max_nodes=nb * nn_sz, max_edges=per_level, max_graphs=nb,
                    max_levels=nn_sz, nodes_per_level=nb * nn_sz,
                    edges_per_level=per_level, tgrad_per_level=per_level)
    batch = collate(dags, pad)
    types, adj, nv = na_dense_views(graphs, cfg.max_n)
    return batch, types, adj, nv

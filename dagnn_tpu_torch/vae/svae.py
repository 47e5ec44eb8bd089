"""S-VAE baselines: string/sequence VAEs over flattened DAG encodings.

Counterpart of dagnn_tpu/vae/svae.py (reference SVAE / SVAE_oneshot /
SVAE_GraphRNN / SVAE_GraphRNN_BFS, dvae/models.py:18-460): each DAG becomes
a [steps, xs] tensor; row j encodes vertex j+1 as one-hot(type) ++
incoming-connection bits from vertices 0..max_n-2 (the decode_*_to_tensor
codec, dvae/util.py:114-133). SVAE runs a GRU over the rows (optionally
bidirectional, hg_unify merge); the decoder feeds relu(fc3(z)) as a
constant input sequence to a GRU and reads per-step type logits + edge
probabilities. SVAE_oneshot swaps both for MLPs over the flattened tensor.
The GraphRNN decoder runs a graph-level GRU over the shifted true rows and
an edge-level GRU over each vertex's shifted connection bits; the BFS
variant re-orders nodes by a random BFS at collate time and widens rows to
nvt + max_n. Loss = CE(types) + BCE(edges) + beta * KLD (models.py:138-148).

The codec (`graph_to_string_tensor`, `_random_bfs_order`) is a numpy copy
of the JAX package's: the same host generator gives the same rows and BFS
orders. Parameters are flat dotted-path dicts ("fc1.w", "grue.w_ih",
"add_vertex.l1.w"), the JAX tree's paths. `_graphrnn_sample` draws every
type and edge bit from one torch.Generator on the latents' device and
reads nothing on the host inside its loops.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from dagnn_tpu_torch.convert import unflatten_tree
from dagnn_tpu_torch.data.na import NAGraph
from dagnn_tpu_torch.ops.gru import gru_cell, gru_init
from dagnn_tpu_torch.ops.linear import linear, linear_init
from dagnn_tpu_torch.vae.dvae import _generator, _mlp2, _on, kld, reparameterize


@dataclasses.dataclass(frozen=True)
class SVAEConfig:
    """The JAX package's SVAEConfig, field for field."""

    max_n: int
    nvt: int
    hs: int = 501
    nz: int = 56
    bidirectional: bool = False
    oneshot: bool = False
    graphrnn: bool = False
    bfs: bool = False
    start_type: int = 0
    end_type: int = 1
    beta: float = 0.005
    eps_scale: float = 0.01

    @property
    def xs(self) -> int:
        return self.nvt + (self.max_n if self.bfs else self.max_n - 1)

    @property
    def steps(self) -> int:
        return self.max_n if self.bfs else self.max_n - 1

    @property
    def edge_bits(self) -> int:
        return self.xs - self.nvt


def graph_to_string_tensor(g: NAGraph, cfg: SVAEConfig,
                           rng: "np.random.Generator" = None) -> np.ndarray:
    """NAGraph -> [steps, xs] row encoding; padding rows use the START
    type bit (models.py:88-105 _collate_fn semantics). With cfg.bfs, nodes
    are first permuted by a random BFS over the undirected skeleton and all
    max_n rows (incl. the start node) are emitted
    (SVAE_GraphRNN_BFS._collate_fn, models.py:400-420)."""
    out = np.zeros((cfg.steps, cfg.xs), np.float32)
    out[:, cfg.start_type] = 1.0  # padding marker, overwritten for real rows
    n = g.num_nodes
    adj = np.asarray(g.adj)
    types = np.asarray(g.types)
    if cfg.bfs:
        order = _random_bfs_order(adj[:n, :n], rng or np.random.default_rng())
        adj = adj[np.ix_(order, order)]
        types = types[order]
        for j in range(min(n, cfg.max_n)):
            row = out[j]
            row[:] = 0.0
            row[int(types[j])] = 1.0
            preds = np.flatnonzero(adj[: cfg.max_n, j])
            row[cfg.nvt + preds] = 1.0
        return out
    for j in range(1, min(n, cfg.max_n)):
        row = out[j - 1]
        row[:] = 0.0
        row[int(types[j])] = 1.0
        preds = np.flatnonzero(adj[: cfg.max_n - 1, j])
        row[cfg.nvt + preds] = 1.0
    return out


def _random_bfs_order(adj: np.ndarray, rng) -> np.ndarray:
    """Random-start BFS over the undirected skeleton (models.py:360-377);
    unreached nodes (disconnected) are appended in index order."""
    n = adj.shape[0]
    und = (adj + adj.T) > 0
    seen = np.zeros(n, bool)
    order = []
    queue = [int(rng.integers(n))]
    while queue:
        cur = queue.pop(0)
        if seen[cur]:
            continue
        seen[cur] = True
        order.append(cur)
        for x in np.flatnonzero(und[cur]):
            if not seen[x]:
                queue.append(int(x))
    order.extend(int(i) for i in np.flatnonzero(~seen))
    return np.asarray(order)


def _mlp2_init(gen, a, b, c, dtype):
    return {"l1": linear_init(gen, a, b, dtype=dtype),
            "l2": linear_init(gen, b, c, dtype=dtype)}


def svae_init(seed, cfg: SVAEConfig, dtype=torch.float32,
              device="cuda") -> Dict[str, torch.Tensor]:
    """The JAX tree's leaves (the same keys and shapes), from `seed` (an
    int or a torch.Generator: the port's own random stream), as a flat
    dict on `device`."""
    gen = _generator(seed)
    hs = cfg.hs
    p: Dict = {
        "fc1": linear_init(gen, hs, cfg.nz, dtype=dtype),
        "fc2": linear_init(gen, hs, cfg.nz, dtype=dtype),
        "fc3": linear_init(gen, cfg.nz, hs, dtype=dtype),
    }
    if cfg.oneshot:
        flat = cfg.steps * cfg.xs
        p["enc1"] = linear_init(gen, flat, 2 * flat, dtype=dtype)
        p["enc2"] = linear_init(gen, 2 * flat, hs, dtype=dtype)
        p["dec1"] = linear_init(gen, hs, 2 * hs, dtype=dtype)
        p["dec2"] = linear_init(gen, 2 * hs, flat, dtype=dtype)
        return _on(p, device)
    p["grue"] = gru_init(gen, cfg.xs, hs, dtype)
    if cfg.bidirectional:
        p["grue_b"] = gru_init(gen, cfg.xs, hs, dtype)
        p["hg_unify"] = linear_init(gen, 2 * hs, hs, dtype=dtype)
    p["add_vertex"] = _mlp2_init(gen, hs, hs, cfg.nvt, dtype)
    if cfg.graphrnn:
        p["grud"] = gru_init(gen, cfg.xs, hs, dtype)        # graph level
        p["grud_edge"] = gru_init(gen, 1, hs, dtype)        # edge level
        p["add_edge"] = _mlp2_init(gen, hs, hs, 1, dtype)
    else:
        p["grud"] = gru_init(gen, hs, hs, dtype)
        p["add_edges"] = _mlp2_init(gen, hs, hs, cfg.max_n - 1, dtype)
    return _on(p, device)


def _run_gru(gp, xs, h0=None):
    """GRU over [B, T, X]; returns the final hidden [B, H] and all outputs
    [B, T, H]."""
    h = h0
    if h is None:
        h = torch.zeros((xs.shape[0], gp["w_hh"].shape[1]), dtype=xs.dtype,
                        device=xs.device)
    outs = []
    for t in range(xs.shape[1]):
        h = gru_cell(gp, xs[:, t], h)
        outs.append(h)
    return h, torch.stack(outs, 1)


def svae_encode(params, cfg: SVAEConfig, G: torch.Tensor):
    """G: [B, steps, xs] -> (mu, logvar)."""
    p = unflatten_tree(params)
    if cfg.oneshot:
        hg = torch.relu(linear(p["enc2"], torch.relu(
            linear(p["enc1"], G.reshape(G.shape[0], -1)))))
    else:
        hg, _ = _run_gru(p["grue"], G)
        if cfg.bidirectional:
            hb, _ = _run_gru(p["grue_b"], torch.flip(G, [1]))
            hg = linear(p["hg_unify"], torch.cat([hg, hb], -1))
    return linear(p["fc1"], hg), linear(p["fc2"], hg)


def _decode_scores(p, cfg: SVAEConfig, z):
    h0 = torch.relu(linear(p["fc3"], z))
    if cfg.oneshot:
        s = linear(p["dec2"], torch.relu(linear(p["dec1"], h0)))
        s = s.reshape(len(z), cfg.steps, cfg.xs)
        return s[:, :, : cfg.nvt], torch.sigmoid(s[:, :, cfg.nvt:])
    h_in = h0[:, None].expand(len(z), cfg.steps, cfg.hs)
    _, outs = _run_gru(p["grud"], h_in)
    return _mlp2(p["add_vertex"], outs), torch.sigmoid(_mlp2(p["add_edges"], outs))


def _graphrnn_scores(p, cfg: SVAEConfig, z, G):
    """Teacher-forced GraphRNN decoder scores (models.py:301-330): a graph-
    level GRU over the shifted true rows emits per-vertex states; per vertex
    an edge-level GRU rolls over the shifted true connection bits."""
    B, T, E = len(z), cfg.steps, cfg.edge_bits
    h0 = torch.relu(linear(p["fc3"], z))
    zero = lambda *s: torch.zeros(s, dtype=z.dtype, device=z.device)
    g_in = torch.cat([zero(B, 1, cfg.xs), G[:, :-1]], 1)
    _, g_out = _run_gru(p["grud"], g_in, h0)            # [B, T, hs]
    types = _mlp2(p["add_vertex"], g_out)              # [B, T, nvt]
    # edge level: batch = (graph, vertex); init hidden = that vertex's state
    h0_e = g_out.reshape(B * T, cfg.hs)
    bits = G[:, :, cfg.nvt:]
    e_in = torch.cat([zero(B, T, 1), bits[:, :, :-1]], 2).reshape(B * T, E, 1)
    _, e_out = _run_gru(p["grud_edge"], e_in, h0_e)     # [B*T, E, hs]
    edges = torch.sigmoid(_mlp2(p["add_edge"], e_out))[..., 0]
    return types, edges.reshape(B, T, E)


def svae_loss(params, cfg: SVAEConfig, G: torch.Tensor, gen, training=True):
    """(total, recon, kld): CE types + BCE edges + beta*KLD
    (models.py:138-148); gen draws the reparameterization noise."""
    p = unflatten_tree(params)
    mu, logvar = svae_encode(params, cfg, G)
    z = reparameterize(gen, mu, logvar, cfg.eps_scale, training)
    if cfg.graphrnn:
        type_scores, edge_scores = _graphrnn_scores(p, cfg, z, G)
    else:
        type_scores, edge_scores = _decode_scores(p, cfg, z)
    true_types = torch.argmax(G[:, :, : cfg.nvt], -1)
    logp = torch.log_softmax(type_scores, -1)
    ce = -torch.sum(torch.gather(logp, -1, true_types[..., None]))
    true_edges = G[:, :, cfg.nvt:]
    es = torch.clamp(edge_scores, 1e-7, 1 - 1e-7)
    bce = -torch.sum(true_edges * torch.log(es) + (1 - true_edges) * torch.log(1 - es))
    recon = ce + bce
    k = kld(mu, logvar)
    return recon + cfg.beta * k, recon, k


def _graphrnn_sample(p, cfg: SVAEConfig, z, gen):
    """Autoregressive GraphRNN sampling (models.py:255-296): sampled types
    and edge bits are fed back as the next inputs. Returns one-hot type
    scores [B, steps, nvt] and 0/1 edge bits [B, steps, edge_bits]."""
    B, E = len(z), cfg.edge_bits
    dt, dev = z.dtype, z.device
    h = torch.relu(linear(p["fc3"], z))
    row = torch.zeros((B, cfg.xs), dtype=dt, device=dev)
    tscores, escores = [], []
    for _ in range(cfg.steps):
        h = gru_cell(p["grud"], row, h)
        probs = torch.softmax(_mlp2(p["add_vertex"], h), -1)
        t = torch.multinomial(probs, 1, generator=gen)[:, 0]
        t_oh = F.one_hot(t, cfg.nvt).to(dt)
        he = h
        e_in = torch.zeros((B, 1), dtype=dt, device=dev)
        bits = []
        for _ in range(E):
            he = gru_cell(p["grud_edge"], e_in, he)
            pe = torch.sigmoid(_mlp2(p["add_edge"], he))[:, 0]
            bit = (torch.rand(pe.shape, generator=gen, dtype=dt, device=dev)
                   < pe).to(dt)
            bits.append(bit)
            e_in = bit[:, None]
        bits = torch.stack(bits, -1)                    # [B, E]
        tscores.append(t_oh)
        escores.append(bits)
        row = torch.cat([t_oh, bits], -1)
    return torch.stack(tscores, 1), torch.stack(escores, 1)


@torch.no_grad()
def svae_decode(params, cfg: SVAEConfig, z, gen=None,
                stochastic=True) -> List[NAGraph]:
    """Sample graphs from latents z [B, nz] (construct_igraph,
    models.py:150-186), on z's device; gen a torch.Generator there
    (seeded 0 when None). GraphRNN variants sample autoregressively, then
    construct deterministically from the sampled one-hots/bits
    (models.py:297-299); the BFS variant clips edge bits to ek < vj so the
    result stays a DAG. The host draws of stochastic construction come
    from a numpy generator seeded by one draw of gen."""
    p = unflatten_tree(params)
    z = torch.as_tensor(z)
    if gen is None:
        gen = torch.Generator(device=z.device).manual_seed(0)
    if cfg.graphrnn:
        type_scores, edge_scores = _graphrnn_sample(p, cfg, z, gen)
        stochastic = False
    else:
        type_scores, edge_scores = _decode_scores(p, cfg, z)
    type_probs = torch.softmax(type_scores, -1).cpu().numpy()
    type_scores = type_scores.cpu().numpy()
    edge_probs = edge_scores.cpu().numpy()
    host = np.random.default_rng(int(torch.randint(
        0, np.iinfo(np.int32).max, (1,), generator=gen, device=z.device)))
    out = []
    for gi in range(len(z)):
        types = [cfg.start_type]
        adj = np.zeros((cfg.max_n, cfg.max_n), np.uint8)
        for vj in range(1, cfg.max_n):
            if vj == cfg.max_n - 1:
                t = cfg.end_type
            elif stochastic:
                t = int(host.choice(cfg.nvt, p=type_probs[gi, vj - 1]))
            else:
                # row index: bfs rows cover all vertices incl. the start node
                t = int(np.argmax(type_scores[gi, vj if cfg.bfs else vj - 1]))
            types.append(t)
            if t == cfg.end_type:
                outdeg = adj[: vj, :].sum(-1)
                for v in np.flatnonzero(outdeg == 0):
                    adj[v, vj] = 1
                break
            for ek in range(vj):
                pe = edge_probs[gi, vj if cfg.bfs else vj - 1, ek]
                if (host.random() < pe) if stochastic else (pe > 0.5):
                    adj[ek, vj] = 1
        n = len(types)
        out.append(NAGraph(types=np.asarray(types, np.int32), adj=adj[:n, :n]))
    return out

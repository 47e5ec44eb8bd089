"""D-VAE baseline variants: DVAE_GCN, DVAE_fast, DVAE_DeepGMG.

Counterpart of dagnn_tpu/vae/dvae_variants.py, over the padded dense
views (types [B, max_n], adj [B, max_n, max_n], nv [B]) of vae/dvae.py:

  * DVAE_GCN (reference dvae/models.py:887-983): `levels` rounds of a
    directed-GCN propagation replace the sequential GRU encoder; decoder and
    loss are the base D-VAE's. The reference sweeps vertices IN INDEX ORDER
    within each level and overwrites states in place, so later vertices see
    already-updated predecessors (Gauss-Seidel). Here the states are a list
    of per-vertex [B, hs] tensors whose entries are replaced, so nothing
    autograd saved is written in place.
  * DVAE_fast (models.py:1097-1180): base D-VAE encoder + the S-VAE GRU
    decoder (grud over a constant h0 sequence, per-step type logits + a
    max_n-1-wide edge head).
  * DVAE_DeepGMG (models.py:1182-1546): DeepGMG adapted to DAGs: per-round
    Jacobi message passing with per-round GRU cells and an edge-direction
    bit, gated graph states (gs = 2*hs), a teacher-forced loss that
    alternates add-vertex NLL, add-edge stop BCE and select-node NLL while
    true edges are inserted in descending predecessor order (adjlist
    .pop()). A vertex's state is replaced by a select over the whole
    [B, max_n, hs] tensor (a new tensor), the inserted edges by a copy.

Parameters are flat dotted-path dicts in the JAX trees' layout ("gconv.1.w",
"dec.grud.0.w_ih", "grue.2.w_hh", "add_vertex_seq.l1.w"); the arithmetic
takes their dtype (float32; float64 for a reference step). One-hots of
types beyond nvt are zero, as jax.nn.one_hot gives them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F

from dagnn_tpu_torch.convert import unflatten_tree
from dagnn_tpu_torch.ops.gru import gru_cell, gru_init
from dagnn_tpu_torch.ops.linear import linear, linear_init
from dagnn_tpu_torch.vae.dvae import (DVAEConfig, _decoder_tree, _generator,
                                      _mlp2, _on, dvae_base_init,
                                      dvae_encode_sequential,
                                      dvae_teacher_loss, kld, reparameterize,
                                      sub_params)


def _one_hot(t, n: int, dtype=torch.float32):
    return (t.long()[..., None] == torch.arange(n, device=t.device)).to(dtype)


# ---------------------------------------------------------------------------
# DVAE_GCN


@dataclasses.dataclass(frozen=True)
class DVAEGCNConfig:
    """The JAX package's DVAEGCNConfig, field for field."""

    max_n: int
    nvt: int
    hs: int = 501
    nz: int = 56
    levels: int = 3
    bidirectional: bool = False   # ignore edge directions in the GCN
    start_type: int = 0
    end_type: int = 1
    beta: float = 0.005
    eps_scale: float = 0.01

    def base(self) -> DVAEConfig:
        """Decoder config: base D-VAE decoder, unidirectional
        (models.py:887 passes bidirectional only to the GCN side)."""
        return DVAEConfig(max_n=self.max_n, nvt=self.nvt, hs=self.hs,
                          nz=self.nz, bidirectional=False,
                          start_type=self.start_type, end_type=self.end_type,
                          beta=self.beta, eps_scale=self.eps_scale)


def dvae_gcn_init(seed, cfg: DVAEGCNConfig, dtype=torch.float32,
                  device="cuda") -> Dict[str, torch.Tensor]:
    """Keys "dec.*" (the base decoder), "gconv.<level>.*", "fc1.*",
    "fc2.*", from `seed` (the port's own random stream)."""
    gen = _generator(seed)
    p = {"dec": _decoder_tree(gen, cfg.base(), dtype),
         "gconv": [linear_init(gen, cfg.nvt if lv == 0 else cfg.hs, cfg.hs,
                               dtype=dtype) for lv in range(cfg.levels)],
         "fc1": linear_init(gen, cfg.hs, cfg.nz, dtype=dtype),
         "fc2": linear_init(gen, cfg.hs, cfg.nz, dtype=dtype)}
    return _on(p, device)


def dvae_gcn_encode(params, cfg: DVAEGCNConfig, types, adj, nv):
    """Directed-GCN encoder (models.py:907-971): per level lv and vertex v,
    Hv = ReLU(W_lv(x_v/(d_in(v)+1) + sum_u pred x_u /
    sqrt((d_out(u)+1)(d_in(v)+1)))); graph state = sum of final states over
    inner vertices 1..nv-2. Level 0 reads the static type one-hots (all
    vertices at once); deeper levels sweep vertices in index order, each
    reading its predecessors' newest states (Gauss-Seidel)."""
    p = unflatten_tree(params)
    dt = p["fc1"]["w"].dtype
    nv = nv.long()
    vrange = torch.arange(cfg.max_n, device=types.device)[None, :]
    in_graph = (vrange < nv[:, None]).to(dt)
    adj = adj.to(dt) * in_graph[:, :, None] * in_graph[:, None, :]
    if cfg.bidirectional:
        nbr = torch.clamp(adj + adj.transpose(1, 2), 0, 1)
        deg_dst = deg_src = nbr.sum(1)  # symmetric degree
    else:
        nbr = adj                       # nbr[:, u, v] = u sends to v
        deg_dst = adj.sum(1)            # indegree of target
        deg_src = adj.sum(2)            # outdegree of source
    # norm[b, u, v] = nbr / sqrt((deg_src(u)+1)(deg_dst(v)+1))
    norm = nbr / torch.sqrt((deg_src[:, :, None] + 1.0) * (deg_dst[:, None, :] + 1.0))
    X = _one_hot(types, cfg.nvt, dt) * in_graph[..., None]
    lvl0 = X / (deg_dst[..., None] + 1.0) + torch.einsum("buv,bud->bvd", norm, X)
    H = list((torch.relu(linear(p["gconv"][0], lvl0)) * in_graph[..., None]).unbind(1))
    for lv in range(1, cfg.levels):
        for v in range(cfg.max_n):
            self_term = H[v] / (deg_dst[:, v, None] + 1.0)
            pred_term = (norm[:, :, v, None] * torch.stack(H, 1)).sum(1)
            hv = torch.relu(linear(p["gconv"][lv], self_term + pred_term))
            H[v] = torch.where((v < nv)[:, None], hv, H[v])
    m = ((vrange >= 1) & (vrange < (nv - 1)[:, None])).to(dt)
    hg = (torch.stack(H, 1) * m[..., None]).sum(1)
    return linear(p["fc1"], hg), linear(p["fc2"], hg)


def dvae_gcn_loss(params, cfg: DVAEGCNConfig, types, adj, nv, gen,
                  training=True):
    mu, logvar = dvae_gcn_encode(params, cfg, types, adj, nv)
    z = reparameterize(gen, mu, logvar, cfg.eps_scale, training)
    recon, _ = dvae_teacher_loss(sub_params(params, "dec."), cfg.base(), z,
                                 types, adj, nv)
    k = kld(mu, logvar)
    return recon + cfg.beta * k, recon, k


# ---------------------------------------------------------------------------
# DVAE_fast


def dvae_fast_init(seed, cfg: DVAEConfig, dtype=torch.float32,
                   device="cuda") -> Dict[str, torch.Tensor]:
    """The base D-VAE's keys plus "grud_seq.*", "add_vertex_seq.*" and
    "add_edges_seq.*"."""
    gen = _generator(seed)
    p = dvae_base_init(gen, cfg, dtype, device)
    p.update(_on({
        "grud_seq": gru_init(gen, cfg.hs, cfg.hs, dtype),
        "add_vertex_seq": {"l1": linear_init(gen, cfg.hs, cfg.hs, dtype=dtype),
                           "l2": linear_init(gen, cfg.hs, cfg.nvt, dtype=dtype)},
        "add_edges_seq": {"l1": linear_init(gen, cfg.hs, cfg.hs, dtype=dtype),
                          "l2": linear_init(gen, cfg.hs, cfg.max_n - 1,
                                            dtype=dtype)}}, device))
    return p


def _dvae_fast_scores(p, cfg: DVAEConfig, z):
    """S-VAE style decoder (models.py:1112-1118): GRU over a constant
    relu(fc3(z)) input sequence of length max_n-1."""
    h_in = torch.relu(linear(p["dec"]["fc3"], z))
    h = torch.zeros((len(z), cfg.hs), dtype=z.dtype, device=z.device)
    outs = []
    for _ in range(cfg.max_n - 1):
        h = gru_cell(p["grud_seq"], h_in, h)
        outs.append(h)
    outs = torch.stack(outs, 1)
    return (_mlp2(p["add_vertex_seq"], outs),
            torch.sigmoid(_mlp2(p["add_edges_seq"], outs)))


def dvae_fast_loss(params, cfg: DVAEConfig, types, adj, nv, gen,
                   training=True):
    """CE over teacher types (START pads) + BCE over transposed-adjacency
    rows + beta*KLD (models.py:1120-1137)."""
    mu, logvar = dvae_encode_sequential(params, cfg, types, adj, nv)
    z = reparameterize(gen, mu, logvar, cfg.eps_scale, training)
    type_scores, edge_scores = _dvae_fast_scores(unflatten_tree(params), cfg, z)
    nv = nv.long()
    live = torch.arange(1, cfg.max_n, device=z.device)[None, :] < nv[:, None]
    teacher = torch.where(live, types[:, 1:].long(), cfg.start_type)
    logp = torch.log_softmax(type_scores, -1)
    ce = -torch.sum(torch.gather(logp, -1, teacher[..., None]))
    # true edges: adjacency transposed [1:, :-1], zero beyond nv
    tgt = adj.transpose(1, 2)[:, 1:, :-1].to(z.dtype) * live[..., None]
    es = torch.clamp(edge_scores, 1e-7, 1 - 1e-7)
    bce = -torch.sum(tgt * torch.log(es) + (1 - tgt) * torch.log(1 - es))
    recon = ce + bce
    k = kld(mu, logvar)
    return recon + cfg.beta * k, recon, k


# ---------------------------------------------------------------------------
# DVAE_DeepGMG


@dataclasses.dataclass(frozen=True)
class DeepGMGConfig:
    """The JAX package's DeepGMGConfig, field for field."""

    max_n: int
    nvt: int
    hs: int = 501
    nz: int = 56
    Td: int = 3                   # decode message-passing rounds
    Te: int = 3                   # encode message-passing rounds
    bidirectional: bool = False
    start_type: int = 0
    end_type: int = 1
    beta: float = 0.005
    eps_scale: float = 0.01

    @property
    def gs(self) -> int:
        return 2 * self.hs


def deepgmg_init(seed, cfg: DeepGMGConfig, dtype=torch.float32,
                 device="cuda") -> Dict[str, torch.Tensor]:
    gen = _generator(seed)
    hs, gs = cfg.hs, cfg.gs
    lin = lambda a, b, bias=True: linear_init(gen, a, b, bias=bias, dtype=dtype)
    p = {
        "grue": [gru_init(gen, 2 * hs, hs, dtype) for _ in range(cfg.Te)],
        "grud": [gru_init(gen, 2 * hs, hs, dtype) for _ in range(cfg.Td)],
        "fe": lin(2 * hs + 1, 2 * hs),
        "fc1": lin(gs, cfg.nz),
        "fc2": lin(gs, cfg.nz),
        "fc3": lin(cfg.nz, gs),
        "finit": lin(cfg.nvt + gs, hs),
        "add_vertex": lin(gs, cfg.nvt),
        "add_edge": lin(gs + hs, 1),
        "select_node": lin(2 * hs, 1),
        "gate": lin(hs, gs),
        "mapper": lin(hs, gs, bias=False),
        "gate_init": lin(hs, gs),
        "mapper_init": lin(hs, gs, bias=False),
    }
    return _on(p, device)


def _set_vertex(H, v: int, hv):
    """H [B, max_n, hs] with vertex v's rows replaced by hv [B, hs]: a new
    tensor."""
    sel = (torch.arange(H.shape[1], device=H.device) == v)[None, :, None]
    return torch.where(sel, hv[:, None, :], H)


def _gmg_propagate(p, cfg: DeepGMGConfig, H, adj, count, cells):
    """Jacobi message-passing rounds (models.py:1287-1350): per round t,
    Av = sum over neighbors of fe([H_nbr, dir_bit, Hv]); Hv' = GRU_t(Av, Hv).
    Nodes with no neighbors (or beyond count) keep their state."""
    n = cfg.max_n
    vmask = (torch.arange(n, device=H.device)[None, :] < count[:, None]).to(H.dtype)
    A = adj * vmask[:, :, None] * vmask[:, None, :]
    for cell in cells:
        def messages(pred_adj, direction_bit):
            # pred_adj[:, u, v] = 1 when u sends to v
            B = H.shape[0]
            src = H[:, :, None, :].expand(B, n, n, cfg.hs)
            tgt = H[:, None, :, :].expand(B, n, n, cfg.hs)
            dirb = torch.full((B, n, n, 1), direction_bit, dtype=H.dtype,
                              device=H.device)
            m = linear(p["fe"], torch.cat([src, dirb, tgt], -1))
            return (m * pred_adj[..., None]).sum(1)  # [B, max_n, 2hs]

        Av = messages(A, 1.0)
        if cfg.bidirectional:
            Av = Av + messages(A.transpose(1, 2), 0.0)
        has_nbr = (A.sum(1) + (A.sum(2) if cfg.bidirectional else 0)) > 0
        Hn = gru_cell(cell, Av.reshape(-1, 2 * cfg.hs),
                      H.reshape(-1, cfg.hs)).reshape(H.shape)
        H = torch.where((has_nbr & (vmask > 0))[..., None], Hn, H)
    return H


def _gmg_graph_state(p, cfg: DeepGMGConfig, H, count, init=False,
                     exclude_last=False):
    """Gated-sum graph state over current vertices (models.py:1377-1398)."""
    idx = torch.arange(cfg.max_n, device=H.device)[None, :]
    m = (idx < count[:, None] - (1 if exclude_last else 0)).to(H.dtype)
    g = p["gate_init" if init else "gate"]
    mp = p["mapper_init" if init else "mapper"]
    h = torch.sigmoid(linear(g, H)) * linear(mp, H)
    return (h * m[..., None]).sum(1)  # [B, gs]


def _gmg_init_v(p, cfg: DeepGMGConfig, H, types_oh, count, v, Hg=None):
    """finit([one_hot(type), graph-state]) for vertex v (models.py:1268-1285);
    Hg defaults to the init-gated state excluding v itself."""
    if Hg is None:
        Hg = _gmg_graph_state(p, cfg, H, count, init=True, exclude_last=True)
    hv = linear(p["finit"], torch.cat([types_oh[:, v], Hg], -1))
    return _set_vertex(H, v, torch.where((v < count)[:, None], hv, H[:, v]))


def deepgmg_encode(params, cfg: DeepGMGConfig, types, adj, nv):
    p = unflatten_tree(params)
    B = types.shape[0]
    dt, dev = p["fc1"]["w"].dtype, types.device
    nv = nv.long()
    types_oh = _one_hot(types, cfg.nvt, dt)
    H = torch.zeros((B, cfg.max_n, cfg.hs), dtype=dt, device=dev)
    zero_g = torch.zeros((B, cfg.gs), dtype=dt, device=dev)
    for v in range(cfg.max_n):
        H = _gmg_init_v(p, cfg, H, types_oh, nv, v, Hg=zero_g)
    H = _gmg_propagate(p, cfg, H, adj.to(dt), nv, p["grue"])
    hg = _gmg_graph_state(p, cfg, H, nv)
    return linear(p["fc1"], hg), linear(p["fc2"], hg)


def deepgmg_loss(params, cfg: DeepGMGConfig, types, adj_true, nv, gen,
                 training=True):
    """Teacher-forced loss (models.py:1488-1546): per added vertex,
    add-vertex NLL; then per edge slot k (descending predecessor order),
    add-edge stop BCE over still-active graphs + select-node NLL."""
    mu, logvar = deepgmg_encode(params, cfg, types, adj_true, nv)
    z = reparameterize(gen, mu, logvar, cfg.eps_scale, training)
    p = unflatten_tree(params)
    B = types.shape[0]
    dt, dev = z.dtype, z.device
    nv = nv.long()
    vrange = torch.arange(cfg.max_n, device=dev)[None, :]
    teacher = torch.where(vrange < nv[:, None], types.long(), cfg.start_type)
    types_oh = _one_hot(teacher, cfg.nvt, dt)
    adj_true = adj_true.to(dt)

    H0 = torch.tanh(linear(p["fc3"], z))
    H = torch.zeros((B, cfg.max_n, cfg.hs), dtype=dt, device=dev)
    H = _set_vertex(H, 0, linear(p["finit"], torch.cat([types_oh[:, 0], H0], -1)))
    adj = torch.zeros_like(adj_true)
    count = torch.minimum(torch.ones_like(nv), nv)  # 1 vertex (or 0 for empty)

    res = torch.zeros((), dtype=dt, device=dev)
    for v in range(1, cfg.max_n):
        H = _gmg_propagate(p, cfg, H, adj, count, p["grud"])
        logp = torch.log_softmax(linear(p["add_vertex"],
                                        _gmg_graph_state(p, cfg, H, count)), -1)
        res = res + logp.gather(1, teacher[:, v:v + 1]).sum()
        count = count + (teacher[:, v] != cfg.start_type).long()
        H = _gmg_init_v(p, cfg, H, types_oh, count, v)

        # true in-edges of v, consumed in DESCENDING predecessor order
        # (igraph adjlist + .pop(), models.py:1512-1537)
        pred_bits = adj_true[:, :v, v]                            # [B, v]
        indeg = pred_bits.sum(-1)
        # desc_rank[b, u] = #preds >= u; the k-th pop has desc_rank == k+1
        desc_rank = torch.flip(torch.cumsum(torch.flip(pred_bits, [1]), 1), [1])
        for k in range(v + 1):
            # graphs still in graph_idx: ALL at k=0 (incl. padded ones,
            # which contribute a stop-BCE, models.py:1517-1525), then those
            # that added an edge last round
            in_loop = indeg >= k
            # the reference's while loop exits once no graph remains, so a
            # propagation past the batch's largest in-degree must not
            # change H (models.py:1516 `while graph_idx:`)
            H = torch.where(in_loop.any(),
                            _gmg_propagate(p, cfg, H, adj, count, p["grud"]), H)
            Hg = _gmg_graph_state(p, cfg, H, count)
            Hv = H[:, v]
            add_logit = linear(p["add_edge"], torch.cat([Hg, Hv], -1))[:, 0]
            bce = F.softplus(add_logit) - (indeg > k).to(dt) * add_logit
            res = res - torch.sum(torch.where(in_loop, bce, 0.0))
            if k == v:
                break
            # select-node NLL for graphs that do add an edge this round:
            # target = the k-th largest remaining predecessor
            sel_in = torch.cat([H[:, :v], Hv[:, None].expand(B, v, cfg.hs)], -1)
            sel_logits = linear(p["select_node"], sel_in)[..., 0]  # [B, v]
            has_edge = indeg > k
            target_oh = ((pred_bits > 0) & (desc_rank == k + 1)).to(dt)
            ell = (torch.log_softmax(sel_logits, -1) * target_oh).sum(-1)
            res = res + torch.sum(torch.where(has_edge, ell, 0.0))
            # insert that edge (into a copy: autograd saved the old adj)
            adj = adj.clone()
            adj[:, :v, v] += target_oh * has_edge[:, None].to(dt)

    recon = -res
    k_ = kld(mu, logvar)
    return recon + cfg.beta * k_, recon, k_

"""D-VAE scaffolding: the autoregressive DAG decoder, the teacher-forced
loss, the sequential baseline encoder, stochastic decoding.

Counterpart of dagnn_tpu/vae/dvae.py (reference: dvae/models_pyg.py:17-736
DVAE_PYG / DVAE_BN_PYG). Graphs are dense padded tensors: types
[B, max_n] int, adjacency [B, max_n, max_n] (adj[b, i, j] = edge i->j),
true vertex count nv [B]. Parameters are flat dotted-path dicts
("fc3.w", "grud.0.w_ih", "gate_f.1.b"; convert.flatten_tree of the JAX
tree); the functions read them through convert.unflatten_tree, whose
leaves are the same tensors.

The reference quirks the JAX module reproduces are kept, as they shape
the loss values:
  * multi-layer propagation aggregates predecessors ONLY at layer 0 and
    reuses that message for upper layers (models_pyg.py:166-180);
  * the dense attention softmax runs over max-predecessor-count padded
    slots including zero-vector pads (dvae/dagnn.py:362-369): the
    denominator includes (P - n_pred) * exp(score(q, 0)). That is not K6's
    function (a masked segment softmax), and JAX computes it outside any
    Pallas kernel: here it is plain tensor code as well (dec_aggregate);
  * padded (finished) graphs still contribute add-vertex log-likelihood at
    START_TYPE and edge BCE against all-zero targets (models_pyg.py:409-456).

Where the JAX module writes a vertex's states with `state.at[l, :, v].set`,
the port keeps a list per layer of per-vertex [B, hs] tensors and replaces
list entries: no tensor that autograd saved is written in place. The
teacher loss takes the unrolled step sequence of JAX's oracle (36 decoder
updates at max_n 8); JAX's default scan pads the inner edge loop to
max_n - 1 masked steps (57 updates), whose extra re-propagations are
idempotent, so both give the same loss. Nothing here reads a tensor's value
on the host inside the loops (p_eff stays a tensor), so a decode or a loss
queues its launches without a sync.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dagnn_tpu_torch import resolve_device
from dagnn_tpu_torch.convert import flatten_tree, unflatten_tree
from dagnn_tpu_torch.ops.gru import gru_cell, gru_init
from dagnn_tpu_torch.ops.linear import linear, linear_init
from dagnn_tpu_torch.train.graphs import CapturedStep


@dataclasses.dataclass(frozen=True)
class DVAEConfig:
    """The JAX package's DVAEConfig, field for field."""

    max_n: int
    nvt: int
    hs: int = 501
    nz: int = 56
    num_layers: int = 1
    bidirectional: bool = False
    vid: bool = True              # concat one-hot vertex id to predecessor states
    bn: bool = False              # BN family: sum graph state, H0 in edge scorer
    dec_agg: str = "gated_sum"    # decoder aggregation: gated_sum | attn | self_attn
    pred_source: str = "h"        # aggregate predecessor 'h' or one-hot 'x' (DVAE_BN)
    start_type: int = 0
    end_type: int = 1
    beta: float = 0.005
    eps_scale: float = 0.01

    @property
    def vs(self) -> int:
        return self.hs + self.max_n if self.vid else self.hs

    @property
    def gs(self) -> int:
        return self.hs

    @property
    def gated_in_dim(self) -> int:
        if self.pred_source == "x":
            return self.nvt
        return self.vs


def _generator(seed) -> torch.Generator:
    return seed if isinstance(seed, torch.Generator) else \
        torch.Generator().manual_seed(int(seed))


def sub_params(params: Dict[str, torch.Tensor], prefix: str):
    """The entries of `params` under `prefix` ("dec."), prefix dropped:
    the same tensors."""
    n = len(prefix)
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix)}


def _decoder_tree(gen, cfg: DVAEConfig, dtype):
    p = {
        "fc3": linear_init(gen, cfg.nz, cfg.hs, dtype=dtype),
        "add_vertex": {
            "l1": linear_init(gen, cfg.hs, cfg.hs * 2, dtype=dtype),
            "l2": linear_init(gen, cfg.hs * 2, cfg.nvt, dtype=dtype),
        },
        "grud": [gru_init(gen, cfg.nvt if l == 0 else cfg.hs, cfg.hs, dtype)
                 for l in range(cfg.num_layers)],
        # gated-sum gate/mapper pairs, shared with the encoder in the
        # reference (models_pyg.py:57-70); the mapper is bias-free so
        # padded zeros map to zeros
        "gate_f": [linear_init(gen, cfg.gated_in_dim, cfg.hs, dtype=dtype)
                   for _ in range(cfg.num_layers)],
        "mapper_f": [linear_init(gen, cfg.gated_in_dim, cfg.hs, bias=False,
                                 dtype=dtype) for _ in range(cfg.num_layers)],
        "gate_b": [linear_init(gen, cfg.gated_in_dim, cfg.hs, dtype=dtype)
                   for _ in range(cfg.num_layers)],
        "mapper_b": [linear_init(gen, cfg.gated_in_dim, cfg.hs, bias=False,
                                 dtype=dtype) for _ in range(cfg.num_layers)],
    }
    if cfg.bn:
        # BN edge scorer includes H0: Linear(3hs, hs) -> ReLU -> Linear(hs, 1)
        p["add_edge"] = {"l1": linear_init(gen, cfg.hs * 3, cfg.hs, dtype=dtype),
                         "l2": linear_init(gen, cfg.hs, 1, dtype=dtype)}
    else:
        # Linear(2hs, 4hs) -> ReLU -> Linear(4hs, 1) (models_pyg.py:50-54)
        p["add_edge"] = {"l1": linear_init(gen, cfg.hs * 2, cfg.hs * 4, dtype=dtype),
                         "l2": linear_init(gen, cfg.hs * 4, 1, dtype=dtype)}
    return p


def _on(tree, device):
    dev = resolve_device(device)
    return {k: v.to(dev, copy=True) for k, v in flatten_tree(tree).items()}


def dvae_decoder_init(seed, cfg: DVAEConfig, dtype=torch.float32,
                      device="cuda") -> Dict[str, torch.Tensor]:
    """Decoder parameters (models_pyg.py:42-70) in the JAX tree's layout,
    from `seed` (an int or a torch.Generator: the port's own random
    stream); the flat dotted-path dict on `device`."""
    return _on(_decoder_tree(_generator(seed), cfg, dtype), device)


def dvae_base_init(seed, cfg: DVAEConfig, dtype=torch.float32,
                   device="cuda") -> Dict[str, torch.Tensor]:
    """The base D-VAE (sequential GRU encoder, decoder, latent heads):
    keys "dec.*", "grue_f.*", "grue_b.*", "fc1.*", "fc2.*" and, when
    bidirectional, "hg_unify.*"."""
    gen = _generator(seed)
    p = {"dec": _decoder_tree(gen, cfg, dtype)}
    for name in ("grue_f", "grue_b"):
        p[name] = [gru_init(gen, cfg.nvt if l == 0 else cfg.hs, cfg.hs, dtype)
                   for l in range(cfg.num_layers)]
    p["fc1"] = linear_init(gen, cfg.gs, cfg.nz, dtype=dtype)
    p["fc2"] = linear_init(gen, cfg.gs, cfg.nz, dtype=dtype)
    if cfg.bidirectional:
        p["hg_unify"] = linear_init(gen, cfg.gs * 2 * cfg.num_layers, cfg.gs,
                                    dtype=dtype)
    return _on(p, device)


def _mlp2(p, x):
    return linear(p["l2"], torch.relu(linear(p["l1"], x)))


def _vid_eye(cfg: DVAEConfig, B: int, like: torch.Tensor):
    eye = torch.eye(cfg.max_n, dtype=like.dtype, device=like.device)
    return eye.expand(B, cfg.max_n, cfg.max_n)


def _attn_score(attn_p, q, k):
    """Additive attention score from the decomposed attn_lin([q, k]).
    q: [B, Dq]; k: [B, P, Dk] -> [B, P]."""
    w = attn_p["attn_lin"]["w"]                                 # [1, Dq + Dk]
    dq = q.shape[-1]
    qs = q @ w[:, :dq].T + attn_p["attn_lin"]["b"]              # [B, 1]
    ks = k @ w[:, dq:].T                                        # [B, P, 1]
    return qs + ks[..., 0]


def dec_aggregate(dec, cfg: DVAEConfig, state0, pred_mask, X_q,
                  types_onehot=None, attn_params=None, direction="f"):
    """Gated or attention aggregation of predecessor states for one vertex.

    dec: the decoder's nested tree (unflatten_tree); state0 [B, max_n, hs]
    the layer-0 vertex states; pred_mask [B, max_n] the 0/1 predecessor
    indicator; X_q [B, nvt] the query (one-hot of the target's type);
    attn_params the nested {"attn_lin": {"w", "b"}}. The dense
    padded-softmax semantics of the module docstring, in tensor ops."""
    B = state0.shape[0]
    dtype = state0.dtype
    m = pred_mask.to(dtype)
    n_pred = m.sum(-1)                                          # [B]
    vals = types_onehot if cfg.pred_source == "x" else state0   # [B, P, *]

    if cfg.dec_agg == "gated_sum":
        z = vals
        if cfg.vid and cfg.pred_source == "h":
            z = torch.cat([vals, _vid_eye(cfg, B, vals)], -1)
        gate = dec[f"gate_{direction}"][0]
        mapper = dec[f"mapper_{direction}"][0]
        h = torch.sigmoid(linear(gate, z)) * linear(mapper, z)
        return (h * m[..., None]).sum(1)                        # [B, hs]

    if "attn" in cfg.dec_agg:
        if attn_params is None:
            raise ValueError("attention decoder params required")
        keys = state0
        if cfg.vid:
            keys = torch.cat([state0, _vid_eye(cfg, B, state0)], -1)
        s = _attn_score(attn_params, X_q, keys)                 # [B, P]
        zero_key = torch.zeros((B, 1, keys.shape[-1]), dtype=dtype,
                               device=keys.device)
        s_pad = _attn_score(attn_params, X_q, zero_key)[:, 0]
        p_eff = n_pred.amax()        # the reference's padded row width
        n_pad = p_eff - n_pred       # [B] zero-vector slots in each row
        neg = torch.finfo(dtype).min
        live = m > 0
        mx_real = torch.where(live, s, neg).amax(-1)
        mx = torch.where(n_pad > 0, torch.maximum(mx_real, s_pad), mx_real)
        # rows with neither preds nor pads (p_eff == 0): a neutral max so
        # no inf/NaN enters an unselected branch (it would poison grads)
        mx = torch.where(n_pred + n_pad > 0, mx, 0.0)
        shift = torch.where(live, s - mx[:, None], 0.0)
        e_real = torch.where(live, torch.exp(shift), 0.0)
        pad_shift = torch.where(n_pad > 0, s_pad - mx, 0.0)
        pad_term = torch.where(n_pad > 0, n_pad * torch.exp(pad_shift), 0.0)
        denom = e_real.sum(-1) + pad_term
        denom = torch.where(denom == 0, 1.0, denom)
        alpha = e_real / denom[:, None]
        out = (alpha[..., None] * state0).sum(1)
        return torch.where(p_eff > 0, out, torch.zeros_like(out))

    raise ValueError(f"unknown decoder aggregation {cfg.dec_agg}")


def _zero_state(cfg: DVAEConfig, B: int, like: torch.Tensor):
    """Per layer, per vertex, a [B, hs] zero state (one shared zero)."""
    z = torch.zeros((B, cfg.hs), dtype=like.dtype, device=like.device)
    return [[z] * cfg.max_n for _ in range(cfg.num_layers)]


def _stack(layer):
    return torch.stack(layer, 1)                                # [B, max_n, hs]


def decoder_update_v(dec, cfg: DVAEConfig, state, types_oh, adj, nv, v,
                     H0=None, attn_params=None):
    """_update_iv (models_pyg.py:247-250): recompute vertex v's states
    through the grud stack from its current predecessors. state: per
    layer a list of per-vertex [B, hs]; adj [B, max_n, max_n] the partial
    adjacency. Graphs with v >= nv keep their previous state. Returns the
    new state (new lists; the old ones are left as they were)."""
    X = types_oh[:, v]                                          # [B, nvt]
    active = (v < nv)[:, None]
    if H0 is None:
        H = dec_aggregate(dec, cfg, _stack(state[0]), adj[:, :, v], X,
                          types_onehot=types_oh, attn_params=attn_params)
    else:
        H = H0
    state = [list(layer) for layer in state]
    Hv = X
    for l in range(cfg.num_layers):
        Hv = gru_cell(dec["grud"][l], Hv, H)
        state[l][v] = torch.where(active, Hv, state[l][v])
    return state


def _graph_state(cfg: DVAEConfig, state, vcount):
    """Decode-time graph state (models_pyg.py:294-309; BN :573-590): the
    last added vertex's top-layer state, or for BN the sum of the current
    vertices' states."""
    top = _stack(state[-1])                                     # [B, max_n, hs]
    B = top.shape[0]
    if cfg.bn:
        idx = torch.arange(cfg.max_n, device=top.device)[None, :]
        m = (idx < vcount[:, None]).to(top.dtype)
        return (top * m[..., None]).sum(1)
    last = torch.clamp(vcount - 1, 0, cfg.max_n - 1).long()
    return top[torch.arange(B, device=top.device), last]


def _edge_score_logits(dec, cfg: DVAEConfig, Hvi, H, H0):
    inp = torch.cat([Hvi, H, H0] if cfg.bn else [Hvi, H], -1)
    return _mlp2(dec["add_edge"], inp)[..., 0]


def kld(mu, logvar):
    return -0.5 * torch.sum(1 + logvar - mu ** 2 - torch.exp(logvar))


def reparameterize(gen: Optional[torch.Generator], mu, logvar,
                   eps_scale: float = 0.01, training: bool = True):
    """mu + eps * std with eps ~ N(0, eps_scale^2) drawn from `gen` (a
    torch.Generator on mu's device); mu itself when not training."""
    if not training:
        return mu
    if gen is None:
        raise ValueError("reparameterize in training needs a torch.Generator")
    std = torch.exp(0.5 * logvar)
    eps = torch.randn(std.shape, generator=gen, dtype=std.dtype,
                      device=std.device) * eps_scale
    return mu + eps * std


def _trees(dec, attn_params):
    return (unflatten_tree(dec),
            None if attn_params is None else unflatten_tree(attn_params))


def dvae_teacher_loss(dec, cfg: DVAEConfig, z, types, adj_true, nv,
                      attn_params=None):
    """Teacher-forced reconstruction loss (models_pyg.py:398-456): the
    negative log-likelihood of each vertex's type and of each edge
    vi -> v, summed over the batch. dec: the decoder's flat dict;
    attn_params: the attention decoder's flat {"attn_lin.w", "attn_lin.b"}
    or None. types [B, max_n] int (garbage beyond nv), adj_true
    [B, max_n, max_n], nv [B]. Returns (recon_loss, {}); the caller adds
    beta * KLD."""
    d, ap = _trees(dec, attn_params)
    B = z.shape[0]
    dev, dt = z.device, z.dtype
    H0 = torch.tanh(linear(d["fc3"], z))
    nv = nv.long()
    # teacher types: START_TYPE marks padding beyond nv (models_pyg.py:409-412)
    in_graph = torch.arange(cfg.max_n, device=dev)[None, :] < nv[:, None]
    teacher_types = torch.where(in_graph, types.long(), cfg.start_type)
    types_oh = F.one_hot(teacher_types, cfg.nvt).to(dt)
    adj_true = adj_true.to(dt)

    state = _zero_state(cfg, B, z)
    adj = torch.zeros_like(adj_true)
    state = decoder_update_v(d, cfg, state, types_oh, adj, nv, 0, H0=H0,
                             attn_params=ap)
    res = torch.zeros((), dtype=dt, device=dev)
    for v in range(1, cfg.max_n):
        Hg = _graph_state(cfg, state, torch.clamp(nv, max=v))
        logp = torch.log_softmax(_mlp2(d["add_vertex"], Hg), dim=-1)
        res = res + logp.gather(1, teacher_types[:, v:v + 1]).sum()
        state = decoder_update_v(d, cfg, state, types_oh, adj, nv, v,
                                 attn_params=ap)
        scores = []
        active_v = (v < nv).to(dt)
        live_v = (v < nv)[:, None]
        for vi in range(v - 1, -1, -1):
            Hvi = torch.where((vi < nv)[:, None], state[-1][vi], 0.0)
            H = torch.where(live_v, state[-1][v], 0.0)
            scores.append(_edge_score_logits(d, cfg, Hvi, H, H0))  # [B]
            # add the true edge vi -> v where present, then re-propagate
            adj = adj.clone()
            adj[:, vi, v] = adj_true[:, vi, v] * active_v
            state = decoder_update_v(d, cfg, state, types_oh, adj, nv, v,
                                     attn_params=ap)
        logits = torch.stack(scores[::-1], dim=1)               # [B, v], col vi
        target = adj_true[:, :v, v] * active_v[:, None]
        # BCE with sum reduction, padded graphs against all-zero targets
        res = res - torch.sum(F.softplus(logits) - target * logits)
    return -res, {}


def dvae_encode_sequential(params, cfg: DVAEConfig, types, adj, nv):
    """The base D-VAE encoder (models_pyg.py:117-184, 312-321): gated-sum
    propagation in vertex order (vertices are topologically ordered by
    construction), an optional reverse pass, the graph state from the
    last (reverse: first) vertex, or for BN the sum over inner vertices.
    params: the model's flat dict ("dec.*", "grue_f.*", ...). Returns
    (mu, logvar)."""
    p = unflatten_tree(params)
    dec = p["dec"]
    B = types.shape[0]
    dev = types.device
    dt = p["fc1"]["w"].dtype        # float32, or float64 for a reference step
    nv = nv.long()
    types_oh = F.one_hot(types.long(), cfg.nvt).to(dt)
    like = types_oh

    def run(direction):
        rev = direction == "b"
        state = _zero_state(cfg, B, like)
        order = range(cfg.max_n - 1, -1, -1) if rev else range(cfg.max_n)
        grue = p["grue_b"] if rev else p["grue_f"]
        first = True
        for v in order:
            X = types_oh[:, v]
            active = (v < nv)[:, None]
            if first:
                H = torch.zeros((B, cfg.hs), dtype=dt, device=dev)
                first = False
            else:
                pred_mask = adj[:, v, :] if rev else adj[:, :, v]
                H = dec_aggregate(dec, cfg, _stack(state[0]), pred_mask, X,
                                  types_onehot=types_oh, direction=direction)
            Hv = X
            for l in range(cfg.num_layers):
                Hv = gru_cell(grue[l], Hv, H)
                state[l][v] = torch.where(active, Hv, state[l][v])
        return state

    state_f = run("f")
    if cfg.bn:
        # BN graph state: sum over inner vertices 1..nv-2 (models_pyg.py:721-729)
        idx = torch.arange(cfg.max_n, device=dev)[None, :]
        m = ((idx >= 1) & (idx < (nv - 1)[:, None])).to(dt)
        hg = (_stack(state_f[-1]) * m[..., None]).sum(1)
        if cfg.bidirectional:
            hg_b = (_stack(run("b")[-1]) * m[..., None]).sum(1)
            hg = linear(p["hg_unify"], torch.cat([hg, hg_b], -1))
    else:
        last = torch.clamp(nv - 1, 0, cfg.max_n - 1)
        hg = _stack(state_f[-1])[torch.arange(B, device=dev), last]
        if cfg.bidirectional:
            hg_b = run("b")[-1][0]
            hg = linear(p["hg_unify"], torch.cat([hg, hg_b], -1))
    return linear(p["fc1"], hg), linear(p["fc2"], hg)


def _draw_types(probs, gen):
    """One vertex type a row of probs [B, nvt], drawn as ATen's
    torch.multinomial(probs, 1, generator=gen) draws it (its single-sample
    path: the argmax of probs over Exp(1) noise from gen), the same numbers,
    without that path's host read of the probabilities' range, which a
    CUDA graph cannot hold."""
    q = torch.empty_like(probs).exponential_(1.0, generator=gen)
    return torch.argmax(probs / q, -1)


def _decode(d, ap, cfg: DVAEConfig, z, gen, stochastic: bool):
    """The decode of dvae_decode on trees d / ap (unflattened): (types,
    adj, nv) tensors on z's device."""
    dev = z.device
    B = z.shape[0]
    H0 = torch.tanh(linear(d["fc3"], z))
    types = torch.full((B, cfg.max_n), cfg.start_type, dtype=torch.long, device=dev)
    adj = torch.zeros((B, cfg.max_n, cfg.max_n), dtype=torch.float32, device=dev)
    nv = torch.ones((B,), dtype=torch.long, device=dev)
    finished = torch.zeros((B,), dtype=torch.bool, device=dev)
    vrange = torch.arange(cfg.max_n, device=dev)

    state = _zero_state(cfg, B, z)
    oh = lambda t: F.one_hot(t, cfg.nvt).to(z.dtype)
    state = decoder_update_v(d, cfg, state, oh(types), adj, nv, 0, H0=H0,
                             attn_params=ap)
    for idx in range(1, cfg.max_n):
        if idx == cfg.max_n - 1:
            new_types = torch.full((B,), cfg.end_type, dtype=torch.long, device=dev)
        else:
            logits = _mlp2(d["add_vertex"], _graph_state(cfg, state, nv))
            if stochastic:
                new_types = _draw_types(torch.softmax(logits, -1), gen)
            else:
                new_types = torch.argmax(logits, -1)
        grow = ~finished
        types[:, idx] = torch.where(grow, new_types, types[:, idx])
        nv = torch.where(grow, idx + 1, nv)
        types_oh = oh(types)
        state = decoder_update_v(d, cfg, state, types_oh, adj, nv, idx,
                                 attn_params=ap)
        # wire the loose ends to a fresh END vertex (models_pyg.py:383-390):
        # vertices < idx with out-degree 0
        just_ended = grow & (new_types == cfg.end_type)
        loose = (adj.sum(-1) == 0.0) & (vrange[None, :] < idx)
        adj[:, :, idx] = torch.where(just_ended[:, None] & loose, 1.0,
                                     adj[:, :, idx])
        finished = finished | just_ended
        # re-propagate (a no-op for graphs whose column did not change)
        state = decoder_update_v(d, cfg, state, types_oh, adj, nv, idx,
                                 attn_params=ap)
        for vi in range(idx - 1, -1, -1):
            prob = torch.sigmoid(_edge_score_logits(
                d, cfg, state[-1][vi], state[-1][idx], H0))
            if stochastic:
                bits = torch.rand(prob.shape, generator=gen, device=dev) < prob
            else:
                bits = prob > 0.5
            add = bits & ~finished & (nv > idx)
            adj[:, vi, idx] = torch.where(add, 1.0, adj[:, vi, idx])
            state = decoder_update_v(d, cfg, state, types_oh, adj, nv, idx,
                                     attn_params=ap)
    return types, adj, nv


def _decode_step(state, inputs):
    """The decode as DECODE's step: ((dec, attn_params), (z, cfg,
    stochastic, gen)) -> (the same state, (types, adj, nv)), drawing from
    gen."""
    z, cfg, stochastic, gen = inputs
    return state, _decode(*_trees(*state), cfg, z, gen, stochastic)


class _DecodeKey(NamedTuple):
    device: str
    z: Tuple[int, int]          # [B, nz]
    dtype: torch.dtype
    cfg: DVAEConfig
    stochastic: bool
    attention: bool             # attention parameters given


# the decode's captured program, one graph a _DecodeKey and generator (one
# in a BO run); the parameters are read where they lie (their tensors are
# part of the key)
DECODE = CapturedStep(_decode_step, writes_state=False)


@torch.no_grad()
def dvae_decode(dec, cfg: DVAEConfig, z, gen: Optional[torch.Generator] = None,
                stochastic: bool = True, attn_params=None, capture: bool = True):
    """Stochastic or greedy decoding (models_pyg.py:338-396) of a batch of
    latents z [B, nz], every conditional update a mask, on z's device.
    Stochastic draws come from `gen` (a torch.Generator on z's device;
    seeded 0 when None): a vertex type from the softmax of its logits (as
    torch.multinomial draws one, _draw_types), an edge where a uniform draw
    is below its probability. Greedy: argmax, and an edge where its
    probability is above 0.5. Returns numpy (types [B, max_n], adj
    [B, max_n, max_n], nv [B]), read on the host once; finished graphs get
    their loose ends wired to the END vertex. capture: one replay of
    DECODE's graph, `gen` registered with it (False: eager)."""
    z = torch.as_tensor(z)
    dev = z.device
    if stochastic and gen is None:
        gen = torch.Generator(device=dev).manual_seed(0)
    if capture:
        key = _DecodeKey(str(dev), tuple(z.shape), z.dtype, cfg, stochastic,
                         attn_params is not None)
        _, out = DECODE(key, (dec, attn_params), (z, cfg, stochastic, gen),
                        (gen,) if stochastic else ())
    else:
        out = _decode(*_trees(dec, attn_params), cfg, z, gen, stochastic)
    types, adj, nv = (t.cpu().numpy() for t in out)
    return types.astype(np.int32), adj, nv.astype(np.int32)

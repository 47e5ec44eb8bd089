"""Carry weights and batches across from the JAX package's layouts.

The JAX params already use torch layout (Linear w [out, in], GRU w_ih
[3H, In]), so a conversion is only a renaming: the nested `dagnn_init`
pytree (dicts and lists) becomes one flat dict keyed by dotted paths —
"encoder.attr_emb", "aggr.1.0.attn_lin.w", "cells.0.1.w_ih", "head.w" —
which is the parameter dict every function of this package takes. The
VAE trees (`dagnn_vae_init`'s "enc.*", "dec.grud.0.w_ih", "fc1.w", ...;
`dvae_base_init`'s) go the same way; an empty subtree (the identity
encoder's, gated_sum's emptied enc.aggr) has no leaf to carry.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from dagnn_tpu_torch import resolve_device


def flatten_tree(tree, prefix: str = "") -> Dict[str, Any]:
    """Nested dicts / lists -> {dotted path: leaf}."""
    out = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}{k}."))
    return out


def unflatten_tree(flat: Dict[str, Any]):
    """Inverse of flatten_tree: integer path parts become list indices."""
    root: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split(".")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def params_from_numpy(tree, device="cuda") -> Dict[str, torch.Tensor]:
    """The `dagnn_init` pytree (numpy leaves) -> the port's parameters."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(v)).to(dev)
            for k, v in flatten_tree(tree).items()}


def params_to_numpy(params: Dict[str, torch.Tensor]):
    """The port's parameters (or gradients) -> the nested numpy pytree."""
    return unflatten_tree({k: v.detach().float().cpu().numpy()
                           for k, v in params.items()})


def tree_map(fn, *trees):
    """fn over the leaves of equal-structured trees (NamedTuples, dicts,
    tuples and lists; None stays None), as jax.tree.map maps them: the
    walk every batch conversion and stack of this package takes."""
    t = trees[0]
    if t is None:
        return None
    if isinstance(t, dict):
        return {k: tree_map(fn, *[x[k] for x in trees]) for k in t}
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*[tree_map(fn, *xs) for xs in zip(*trees)])
    if isinstance(t, (tuple, list)):
        return type(t)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def batch_to_torch(batch, device="cuda"):
    """A collated DAGBatch with every numpy array moved to `device` as a
    tensor (schedules and extras included). Done once per batch, as the
    JAX bench does with jax.tree.map(jnp.asarray, batch)."""
    dev = resolve_device(device)

    def conv(a):
        if isinstance(a, np.ndarray):
            if a.dtype == np.uint32:
                a = a.astype(np.int64)
            return torch.as_tensor(a).to(dev)
        return a

    return tree_map(conv, batch)

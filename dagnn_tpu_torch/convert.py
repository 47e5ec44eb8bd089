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

import functools
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


def _as_torch(a):
    """A host array as the tensor batch_to_torch makes of it (uint32, which
    torch's kernels do not index with, widened to int64)."""
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.as_tensor(a)


def batch_to_torch(batch, device="cuda", out=None):
    """A collated DAGBatch with every numpy array moved to `device` as a
    tensor (schedules and extras included). Done once per batch, as the
    JAX bench does with jax.tree.map(jnp.asarray, batch).

    out: a tree of tensors of the batch's structure (a captured step's
    static buffers, train/graphs.py): the batch is copied into them and
    `out` returned. A host array goes through pinned memory without a
    synchronise (non_blocking, ordered on the current stream after the
    work that read the buffers before), a tensor by a device copy; every
    other leaf must equal out's (batch_key holds it)."""
    if out is None:
        dev = resolve_device(device)

        def conv(a):
            if isinstance(a, np.ndarray):
                return _as_torch(a).to(dev)
            return a

        return tree_map(conv, batch)

    def stage(a, dst):
        if isinstance(a, np.ndarray):
            src = _as_torch(np.require(a, requirements="C"))
            if dst.is_cuda:
                src = src.pin_memory()
            dst.copy_(src, non_blocking=True)
        elif isinstance(a, torch.Tensor):
            dst.copy_(a, non_blocking=True)
        elif a != dst:
            raise ValueError(f"batch_to_torch: host value {a!r} where the "
                             f"buffers hold {dst!r}")
        return dst

    return tree_map(stage, batch, out)


def static_buffers(batch, device="cuda"):
    """Fresh tensors on `device` holding a copy of every array or tensor
    leaf of `batch` (other leaves kept): the static input buffers of a
    captured step, which each replay's batch is copied into."""
    dev = resolve_device(device)

    def conv(a):
        if isinstance(a, np.ndarray):
            a = _as_torch(a)
        if isinstance(a, torch.Tensor):
            return a.to(dev, copy=True)     # never the caller's memory
        return a

    return tree_map(conv, batch)


@functools.lru_cache(maxsize=None)
def _dtype_of(np_dtype):
    return _as_torch(np.empty(0, np_dtype)).dtype


def batch_key(tree):
    """A hashable signature of a batch (or any tree of arrays): its
    structure, the shape and dtype of every array or tensor leaf (as
    batch_to_torch makes it), and the value of every other leaf. Two
    batches with one key run the same launches with the same host values:
    every host value the wavefront bakes into a launch (the block tables'
    widths, the pair plan's blocks, a near/far layout's far width) is a
    shape of the batch's arrays."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return ("dict",) + tuple((k, batch_key(v)) for k, v in tree.items())
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__,) + tuple(batch_key(v) for v in tree)
    if isinstance(tree, np.ndarray):
        return ("array", tree.shape, _dtype_of(tree.dtype))
    if isinstance(tree, torch.Tensor):
        return ("array", tuple(tree.shape), tree.dtype)
    return ("value", tree)


def widen_out_slots(batch, width):
    """The host batch as if collated with PadConfig.out_per_graph = width:
    its per-graph output-slot lists [.., G, Om] padded to [.., G, width]
    with slot 0 and mask False, what collate writes past a graph's
    outputs (the readout masks them: dagnn._pool_gathered). The loader's
    bucket leaves out_per_graph to each batch (dag/batch.py), so Om
    differs from batch to batch; widened to the epoch's widest
    (DAGLoader.out_per_graph), every batch of a bucket has one shape, and
    a captured step one graph. A batch without the lists is returned as
    it is."""
    if batch.out_slots_fwd is None:
        return batch
    om = batch.out_slots_fwd.shape[-1]
    if om == width:
        return batch
    if om > width:
        raise ValueError(f"widen_out_slots: {om} output slots a graph, wider "
                         f"than {width}")
    pad = lambda a: np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, width - om)])
    return batch._replace(**{k: pad(getattr(batch, k)) for k in (
        "out_slots_fwd", "out_slots_mask_fwd", "out_slots_rev",
        "out_slots_mask_rev")})

"""Data-parallel training over a process group.

Counterpart of dagnn_tpu/parallel/dp.py. The JAX package pre-splits the
global batch into per-device sub-batches balanced by node count (the
reference Collater's policy, reference: ogbg-code/tg/dataloader.py:16-35),
stacks them on a leading 'dp' axis, and runs one shard_map program whose
gradients are pmean'd over the axis. Here every rank is a process: it
takes its own shard of the stacked batch, runs the port's normal forward
and backward on it (dagnn_forward: on the card the merged wavefront's K1
and K2 at the flagship config), then all-reduces ONE flat float32 buffer
holding every gradient leaf and the loss, averages it (JAX's pmean: the
sum over ranks divided by their number) and applies the optimizer. This
is DDP's gradient bucket without its nn.Module wrapper: the port's
parameters are a dict of tensors.

The loss averaged is the mean of the per-shard mean losses, as in JAX:
split_by_nodes gives shards unequal graph counts, so it is not the
single-device batch mean.

JAX jits the step; over NCCL the port captures it (train/graphs.py
CapturedStep: one CUDA graph per batch shape, the all-reduce inside it),
and over gloo, whose collectives go through host memory, it runs eager
(parallel/comm.py capture_rule). Dropout draws from one generator a rank,
reseeded from (seed, rank) each call and registered with the graph.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from dagnn_tpu_torch.convert import batch_key, batch_to_torch, tree_map
from dagnn_tpu_torch.dag.batch import DAGBatch, DAGGraph, PadConfig, collate
from dagnn_tpu_torch.parallel import comm
from dagnn_tpu_torch.train import graphs


def split_by_nodes(graphs: Sequence[DAGGraph], n_shards: int) -> List[List[DAGGraph]]:
    """Split a batch into n_shards contiguous groups balanced by NODE count
    (the reference Collater's cumsum/round policy, tg/dataloader.py:16-28)."""
    if n_shards <= 1:
        return [list(graphs)]
    sizes = np.array([g.num_nodes for g in graphs], dtype=np.float64)
    cum = np.cumsum(sizes)
    total = cum[-1] if len(cum) else 0
    device_id = (
        np.round(cum * n_shards / max(total, 1e-9) - 0.5).astype(int).clip(0, n_shards - 1)
        if len(cum) else np.zeros(0, int)
    )
    out = [[] for _ in range(n_shards)]
    for g, d in zip(graphs, device_id):
        out[d].append(g)
    return out


def stack_batches(batches: Sequence[DAGBatch]) -> DAGBatch:
    """Stack per-shard DAGBatches on a leading 'dp' axis (all must share
    one PadConfig so shapes agree)."""
    return tree_map(lambda *xs: np.stack(xs, axis=0), *batches)


def shard_of(stacked: DAGBatch, i: int) -> DAGBatch:
    """Shard i of a stacked batch (the leading axis indexed away)."""
    return tree_map(lambda a: np.asarray(a[i]), stacked)


def collate_sharded(graphs: Sequence[DAGGraph], n_shards: int,
                    pad: PadConfig) -> DAGBatch:
    shards = split_by_nodes(graphs, n_shards)
    return stack_batches([collate(s, pad) for s in shards])


def dropout_seed(seed: int, rank: int) -> int:
    """This rank's dropout seed, from (seed, rank): the counterpart of
    jax.random.fold_in(rng, axis_index)."""
    return int(seed) * 1_000_003 + int(rank)


def reduce_flat(loss: torch.Tensor, grads: dict, reduce):
    """(loss, grads) through one flat float32 buffer [every leaf's
    elements..., loss] and reduce(buffer): one collective a step."""
    keys = list(grads)
    flat = torch.cat([grads[k].reshape(-1).float() for k in keys]
                     + [loss.detach().reshape(1).float()])
    flat = reduce(flat)
    out, at = {}, 0
    for k in keys:
        n = grads[k].numel()
        # back in the leaf's own layout (autograd may hand a leaf with
        # transposed strides, and the clip's norm reduces in the layout's
        # order): one rank repeats the single-process step bit for bit
        out[k] = torch.empty_like(grads[k]).copy_(flat[at:at + n].view(grads[k].shape))
        at += n
    return flat[at].clone(), out


def apply_updates(optimizer, params, grads, opt_state):
    """(params, opt_state) after the optimizer's update of `grads`."""
    with torch.no_grad():
        updates, opt_state = optimizer.update(grads, opt_state)
        return {k: params[k] + updates[k] for k in params}, opt_state


class DPStep:
    """The data-parallel train step of make_dp_train_step. With capture,
    a call replays one CUDA graph per key (train/graphs.CapturedStep):
    the state (params, opt_state) is written in place into buffers the
    step owns and returned (a later call overwrites what an earlier one
    returned); on CPU tensors the step stages its inputs the same way and
    runs directly. `form` says which form it runs."""

    def __init__(self, loss_fn: Callable, optimizer, group, capture: bool = False):
        self.loss_fn, self.optimizer, self.group = loss_fn, optimizer, group
        self.rank = comm.rank(group)
        self.rng = None          # this rank's dropout generator, reseeded a call
        self.captured = graphs.CapturedStep(self._fn) if capture else None
        self.form = comm.form_of([group], capture)

    def shard(self, stacked: DAGBatch, device) -> DAGBatch:
        """This rank's shard of a stacked host batch, on `device`."""
        return batch_to_torch(shard_of(stacked, self.rank), device)

    def _generator(self, seed, device) -> torch.Generator:
        """The one generator of this rank and step, reseeded from (seed,
        rank): the draws a new generator from that seed gives, and one
        object for a captured step's key and graph."""
        if self.rng is None:
            self.rng = torch.Generator(device=device)
        return self.rng.manual_seed(dropout_seed(seed, self.rank))

    def _grads(self, params, batch, rng):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = self.loss_fn(p, batch, rng)
        gs = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(p.items(), gs)}
        return reduce_flat(loss, grads,
                           lambda flat: comm.all_reduce_mean(flat, self.group))

    def grads(self, params, batch, seed: int = 0):
        """(loss, grads) of this rank's shard, averaged over the group
        (eager)."""
        return self._grads(params, batch,
                           self._generator(seed, next(iter(params.values())).device))

    def _fn(self, state, batch):
        params, opt_state = state
        loss, grads = self._grads(params, batch, self.rng)
        return apply_updates(self.optimizer, params, grads, opt_state), loss

    def __call__(self, params, opt_state, batch, seed: int = 0):
        """(params, opt_state, loss) after one step on every rank's shard,
        its dropout drawn from (seed, rank)."""
        rng = self._generator(seed, next(iter(params.values())).device)
        if self.captured is None:
            (params, opt_state), loss = self._fn((params, opt_state), batch)
            return params, opt_state, loss
        (params, opt_state), loss = self.captured(
            ("dp", batch_key(batch)), (params, opt_state), batch, (rng,))
        return params, opt_state, loss


def make_dp_train_step(loss_fn: Callable, optimizer, group,
                       capture: Optional[bool] = None) -> DPStep:
    """The SPMD train step over `group` (the JAX package's
    make_dp_train_step, which it jits). loss_fn(params, batch, rng) ->
    scalar loss sees this rank's shard (step.shard of the stacked host
    batch); rng is a torch.Generator seeded from (seed, rank), for
    dropout. Loss and gradients are averaged over the group before the
    optimizer's update. On an NCCL group the step is captured, one CUDA
    graph per key (capture=False asks for the eager step); on gloo it runs
    eager (comm.EAGER_ON_HOST), and capture=True raises there
    (comm.capture_rule)."""
    return DPStep(loss_fn, optimizer, group, comm.capture_rule([group], capture))

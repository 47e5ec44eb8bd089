"""Collectives over torch.distributed process groups.

The counterpart of what shard_map's named-axis collectives give the JAX
package (jax.lax.all_to_all, all_gather, psum, pmean): a thin layer over
torch.distributed with the differentiable forms the edge-partitioned step
needs where a gradient crosses ranks.

The transport follows the group's backend, and nothing else decides it:
  * NCCL: the tensors go to the collective as they are, on the device;
  * gloo: a CUDA tensor is copied to the host before the collective and
    back to its device after it, explicitly (torch.distributed's backend
    table lists gloo's all_to_all and all_gather for CPU tensors only;
    torch 2.11 took CUDA tensors there too, which the port does not lean
    on); a CPU tensor goes as it is.
NCCL refuses two ranks on one GPU ("Duplicate GPU detected", seen on the
H100), so ranks that share a card run gloo (mesh.default_backend). Collectives that only move data send the
tensor's bytes, so no backend's type table is involved (gloo has no
int16, and bf16 only in recent versions); sums run in the tensor's own
type (float32 on every path that sums).

`issued` counts the collectives handed to torch.distributed, by route.
exchange (and exchange_async, the same all_to_all issued now and waited
on later) and all_gather_stack are the identity at group size 1 and issue
none there; all_reduce_sum issues its collective at every size, so a
one-rank NCCL group still runs the device route. A CUDA graph replay
issues nothing from Python: `issued` is counted with the kernel wrappers'
launches (ops.count_issued, as "collective.device" and
"collective.host"), so a captured step (train/graphs.py) records the
collectives its capture issued and adds them at each replay, and `issued`
reads as if each replay had been an eager step.

Which form a train step over these groups takes (capture_rule): the
device route can be captured into a CUDA graph, and the parallel steps are
captured there by default, as the JAX package compiles every step; the
host route's copies through host memory cannot be, so a step over a gloo
group runs eager and says so (EAGER_ON_HOST), and asking for its capture
raises.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from dagnn_tpu_torch import ops

issued = ops.count_issued("collective", {"device": 0, "host": 0})


def reset_issued():
    for k in issued:
        issued[k] = 0


def size(group) -> int:
    return dist.get_world_size(group)


def rank(group) -> int:
    return dist.get_rank(group)


def route(group) -> str:
    """"device" (NCCL: device tensors) or "host" (gloo: staged on the host)."""
    return "host" if dist.get_backend(group) == "gloo" else "device"


EAGER_ON_HOST = "eager (gloo: staged on the host)"


def capture_rule(groups, capture=None) -> bool:
    """Whether a train step over `groups` (None entries skipped) is
    captured: by default when every group runs the device route (NCCL);
    capture=False asks for the eager step; capture=True over a group that
    stages its collectives on the host (gloo) raises ValueError, as no
    CUDA graph can hold a copy through host memory. Nothing falls back
    from one form to the other."""
    on_device = all(route(g) == "device" for g in groups if g is not None)
    if capture and not on_device:
        raise ValueError("capture asked for over a gloo group: its collectives "
                         "are staged on the host, which a CUDA graph cannot "
                         "hold; the step runs " + EAGER_ON_HOST)
    return on_device if capture is None else bool(capture)


def form_of(groups, captured: bool) -> str:
    """A step's form as the entry points print it: "captured", "eager"
    (asked for on NCCL) or EAGER_ON_HOST."""
    if captured:
        return "captured"
    if any(route(g) == "host" for g in groups if g is not None):
        return EAGER_ON_HOST
    return "eager"


def _to_wire(t: torch.Tensor, group) -> torch.Tensor:
    """t as a data-moving collective sends it: its bytes (uint8, the last
    dim widened), on the host under gloo. Counts the collective."""
    issued[route(group)] += 1
    t = t.contiguous().view(torch.uint8)
    if route(group) == "host" and t.device.type != "cpu":
        t = t.cpu()
    return t


def _from_wire(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return t.view(like.dtype).to(like.device)


class Exchange:
    """An all_to_all in flight (exchange_async). It holds its send and
    receive tensors until wait(), which returns what exchange returns.
    On the device route wait() makes the current stream wait for the
    collective and returns at once; on the host route it blocks until the
    collective is done, then copies the result to the block's device. A
    failed collective raises from wait()."""

    def __init__(self, block: torch.Tensor, group):
        self.block, self.work = block, None
        if size(group) == 1:
            return
        self.send = _to_wire(block.movedim(1, 0), group)      # [Dp, L, B, H]
        self.recv = torch.empty_like(self.send)
        self.work = dist.all_to_all_single(self.recv, self.send, group=group,
                                           async_op=True)

    def wait(self) -> torch.Tensor:
        if self.work is not None:
            self.work.wait()
            self.block = _from_wire(self.recv, self.block).movedim(0, 1)
            self.send = self.recv = self.work = None
        return self.block


def exchange_async(block: torch.Tensor, group) -> Exchange:
    """exchange, issued now and read at Exchange.wait(): counted in
    `issued` when it is issued; at group size 1 it issues nothing and
    wait() returns the block itself."""
    return Exchange(block, group)


def exchange(block: torch.Tensor, group) -> torch.Tensor:
    """all_to_all of a per-peer block [L, Dp, B, H] along dim 1: entry p of
    the result is the block peer p addressed to this rank. The identity at
    group size 1 (the JAX package's _exchange)."""
    return exchange_async(block, group).wait()


def all_gather_stack(t: torch.Tensor, group) -> torch.Tensor:
    """[D, ...]: every rank's t stacked in rank order (no gradient)."""
    if size(group) == 1:
        return t[None]
    send = _to_wire(t, group)
    outs = [torch.empty_like(send) for _ in range(size(group))]
    dist.all_gather(outs, send, group=group)
    return _from_wire(torch.stack(outs), t)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of t over the group's ranks (a new tensor; no gradient)."""
    issued[route(group)] += 1
    dev = torch.device("cpu") if route(group) == "host" else t.device
    buf = t.detach().to(dev, copy=True).contiguous()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(t.device)


def all_reduce_mean(t: torch.Tensor, group) -> torch.Tensor:
    """The mean over the group's ranks: the sum divided by the group size,
    as jax.lax.pmean computes it."""
    return all_reduce_sum(t, group) / size(group)


class _SumOverRanks(torch.autograd.Function):
    """Forward: the sum of every rank's t. Backward: the sum of every
    rank's cotangent, the transpose of a sum that each rank goes on
    computing with (psum's transpose in JAX)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_sum(t, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous(), ctx.group), None


class _GatherOverRanks(torch.autograd.Function):
    """Forward: every rank's t stacked [D, ...]. Backward: rank d's slice
    of the sum of every rank's cotangent (all_gather's transpose, a
    reduce-scatter)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_gather_stack(t, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous(), ctx.group)[rank(ctx.group)], None


def sum_over_ranks(t: torch.Tensor, group) -> torch.Tensor:
    return _SumOverRanks.apply(t, group)


def gather_over_ranks(t: torch.Tensor, group) -> torch.Tensor:
    return _GatherOverRanks.apply(t, group)

"""K6: the edge-softmax aggregate, forward and backward.

Counterpart of dagnn_tpu/ops/pallas/segment_attn.py. Per destination slot
s of num_slots, over the edges e with dst[e] == s and mask[e] set:

    alpha_e = exp(score_e - max_s) / (sum_s exp(score - max_s) + 1e-16)
    out[s]  = sum_e alpha_e values[e]

in float32, the output rounded to values' dtype (the TPU kernel `_kernel`
and `_forward`). The backward recomputes alpha from the scores, as `_bwd`
does, and returns d_values in values' dtype and d_scores in scores' dtype:

    d_values[e] = alpha_e g[s]
    d_alpha_e   = <g[s], values[e]>
    d_scores_e  = alpha_e (d_alpha_e - sum_s alpha d_alpha)

Edges outside every slot (masked, or dst out of [0, num_slots)) contribute
nothing and get zero grads. An empty slot aggregates to 0.

Each direction has two implementations with one signature:
  * segment_attn_forward_plain / segment_attn_backward_plain: plain
    PyTorch (the segment ops of ops/segment.py, no one-hot matrices).
  * segment_attn_forward / segment_attn_backward: the wrappers. For CPU
    tensors they call the plain version; for CUDA tensors they launch the
    kernels of csrc/segment_attn.cu (built on first use, see ops/build.py)
    or raise. Each counts its launches in `launch_counts`.

pallas_edge_softmax_aggregate is the JAX function's contract (scores [Ke],
values [Ke, H], dst [Ke], mask [Ke], num_slots) as an autograd Function
over the wrappers; plain_edge_softmax_aggregate is the same over the plain
versions (the reference a run on the card is held against).
"""

from __future__ import annotations

import torch

from dagnn_tpu_torch.ops import segment

# launches of each wrapper's CUDA kernel (one per wrapper call on a card)
launch_counts = {"segment_attn_forward": 0, "segment_attn_backward": 0}


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


# -------------------------------------------------------- plain versions

def segment_attn_forward_plain(scores, values, dst, mask, num_slots: int):
    """[num_slots, H] in values' dtype; the math in float32."""
    out = segment.edge_softmax_aggregate(scores.float(), values.float(), dst,
                                         num_slots, mask)
    return out.to(values.dtype)


def segment_attn_backward_plain(scores, values, dst, mask, g,
                                num_slots: int):
    """(d_scores [Ke] in scores' dtype, d_values [Ke, H] in values' dtype)
    for the cotangent g [num_slots, H]; alpha recomputed in float32."""
    alpha = segment.segment_softmax(scores.float(), dst, num_slots, mask)
    valid = segment.valid_edges(dst, num_slots, mask)
    idx = torch.where(valid, dst.long(), 0)
    g_rows = torch.where(valid[:, None], g.float()[idx], 0.0)   # [Ke, H]
    d_values = alpha[:, None] * g_rows
    d_alpha = (g_rows * values.float()).sum(-1)
    seg_dot = segment.segment_sum(alpha * d_alpha, dst, num_slots, mask)
    d_scores = torch.where(valid, alpha * (d_alpha - seg_dot[idx]), 0.0)
    return d_scores.to(scores.dtype), d_values.to(values.dtype)


# ---------------------------------------------------------- CUDA wrappers

_SIGS = {
    "sa_forward": "iiii" "pppp" "p" "p",
    "sa_backward": "iiii" "pppp" "ppp" "p",
}
_DT_CODE = {torch.float32: 0, torch.bfloat16: 1}


_LIB = None


def _lib():
    """csrc/segment_attn.cu's library, built and loaded at the first call
    and kept here (build.load takes its lock on every call)."""
    global _LIB
    if _LIB is None:
        from dagnn_tpu_torch.ops import build
        _LIB = build.load("segment_attn", _SIGS)
    return _LIB


def _operands(fn, scores, values, dst, mask, g=None):
    """The kernels' operand forms (dst int32, mask float32, all contiguous
    on one card), or raise on what they do not take."""
    if values.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {values.device}")
    if values.dtype not in _DT_CODE or scores.dtype != values.dtype:
        raise TypeError(f"{fn}: scores {scores.dtype} and values "
                        f"{values.dtype} must share float32 or bfloat16")
    ke = values.shape[0]
    if scores.shape != (ke,) or dst.shape != (ke,) or mask.shape != (ke,):
        raise ValueError(f"{fn}: scores, dst and mask must be [{ke}]")
    dst = dst.to(torch.int32).contiguous()
    mask = mask.to(torch.float32).contiguous()
    ts = [scores.contiguous(), values.contiguous(), dst, mask]
    if g is not None:
        if g.dtype != values.dtype:
            raise TypeError(f"{fn}: cotangent {g.dtype}, values {values.dtype}")
        ts.append(g.contiguous())
    if any(t.device != values.device for t in ts):
        raise ValueError(f"{fn}: operands on different devices")
    return ts


def segment_attn_forward(scores, values, dst, mask, num_slots: int):
    """K6 forward. CPU tensors: the plain version. CUDA tensors: one
    launch of csrc/segment_attn.cu's sa_fwd_kernel (a warp per slot over
    dst / mask / scores staged in shared memory, the softmax in the warp);
    scores and values share one dtype."""
    if values.device.type == "cpu":
        return segment_attn_forward_plain(scores, values, dst, mask, num_slots)
    ts = _operands("segment_attn_forward", scores, values, dst, mask)
    ke, h = values.shape
    out = torch.empty((num_slots, h), dtype=values.dtype, device=values.device)
    rc = _lib().sa_forward(
        _DT_CODE[values.dtype], ke, num_slots, h, *[t.data_ptr() for t in ts],
        out.data_ptr(), torch.cuda.current_stream(values.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel launch failed in sa_forward: error {rc}")
    launch_counts["segment_attn_forward"] += 1
    return out


def segment_attn_backward(scores, values, dst, mask, g, num_slots: int):
    """K6 backward. CPU tensors: the plain version. CUDA tensors: one
    launch of csrc/segment_attn.cu's sa_bwd_kernel (a warp per slot as in
    the forward, g[s] in registers; the dead edges' zero grads written in
    the same launch). Returns (d_scores, d_values)."""
    if values.device.type == "cpu":
        return segment_attn_backward_plain(scores, values, dst, mask, g,
                                           num_slots)
    ts = _operands("segment_attn_backward", scores, values, dst, mask, g)
    if tuple(g.shape) != (num_slots, values.shape[1]):
        raise ValueError(f"segment_attn_backward: cotangent {tuple(g.shape)}, "
                         f"expected {(num_slots, values.shape[1])}")
    ke, h = values.shape
    d_scores = torch.empty_like(ts[0])
    d_values = torch.empty_like(ts[1])
    rc = _lib().sa_backward(
        _DT_CODE[values.dtype], ke, num_slots, h, *[t.data_ptr() for t in ts],
        d_scores.data_ptr(), d_values.data_ptr(),
        torch.cuda.current_stream(values.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel launch failed in sa_backward: error {rc}")
    launch_counts["segment_attn_backward"] += 1
    return d_scores, d_values


# ------------------------------------------------------ autograd Function

class _EdgeSoftmaxAggregate(torch.autograd.Function):
    """forward / backward: a (forward, backward) pair of the functions
    above; gradients flow to scores and values."""

    @staticmethod
    def forward(ctx, scores, values, dst, mask, num_slots, fns):
        ctx.save_for_backward(scores, values, dst, mask)
        ctx.num_slots, ctx.bwd = num_slots, fns[1]
        return fns[0](scores, values, dst, mask, num_slots)

    @staticmethod
    def backward(ctx, g):
        scores, values, dst, mask = ctx.saved_tensors
        d_scores, d_values = ctx.bwd(scores, values, dst, mask,
                                     g.contiguous(), ctx.num_slots)
        return d_scores, d_values, None, None, None, None


_KERNELS = (segment_attn_forward, segment_attn_backward)
_PLAIN = (segment_attn_forward_plain, segment_attn_backward_plain)


def pallas_edge_softmax_aggregate(scores, values, dst, mask, num_slots: int):
    """softmax(scores) per destination slot, then the alpha-weighted sum of
    values -> [num_slots, H], through K6 (forward and backward)."""
    return _EdgeSoftmaxAggregate.apply(scores, values, dst, mask, num_slots,
                                       _KERNELS)


def plain_edge_softmax_aggregate(scores, values, dst, mask, num_slots: int):
    """pallas_edge_softmax_aggregate over the plain versions."""
    return _EdgeSoftmaxAggregate.apply(scores, values, dst, mask, num_slots,
                                       _PLAIN)

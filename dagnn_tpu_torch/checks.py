"""Error measures for holding one implementation against another: the
port's CUDA kernels against their plain versions, and the port against the
JAX package. They take numpy arrays or torch tensors.

Every error is taken on the reference's own scale, max|ref| of that
output or gradient leaf, so that a leaf of size 1e-3 is held as tightly as
one of size 1.

Some gradient elements are zero in exact arithmetic. The attention score's
query weight and bias, and the edge encoder's bias, shift every score of a
destination by one constant, which the segment softmax cancels. So does
the edge encoder's weight when all of a direction's edges share one
relation. In either implementation such an element holds only the
rounding noise of a cancelling sum, and its relative error means nothing.
A float32 `truth` of the same gradient tells those elements apart: |truth|
at most ZERO times the largest |truth| of the whole gradient tree. They
are held to a noise bound instead (grad_err).
"""

import numpy as np

ZERO = 1e-6


def _np(x):
    if hasattr(x, "detach"):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def to_f32(x):
    """x with every floating tensor in it (through tuples and dicts) as
    float32: the inputs of a float32 `truth` run."""
    if isinstance(x, dict):
        return {k: to_f32(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(to_f32(v) for v in x)
    if hasattr(x, "is_floating_point") and x.is_floating_point():
        return x.float()
    return x


def rel_err(a, b):
    """(max|a - b| / max|b|, max|a - b|, max|b|). A non-finite a gives
    inf; an all-zero b gives the absolute error."""
    a, b = _np(a), _np(b)
    if a.shape != b.shape:
        raise ValueError(f"shapes differ: {a.shape} vs {b.shape}")
    if not np.isfinite(a).all():
        return float("inf"), float("inf"), float(np.max(np.abs(b), initial=0.0))
    err = float(np.max(np.abs(a - b), initial=0.0))
    scale = float(np.max(np.abs(b), initial=0.0))
    return (err / scale if scale > 0 else err), err, scale


def tree_max(truth):
    """The largest |value| over a dict of gradient leaves."""
    return max(float(np.max(np.abs(_np(v)), initial=0.0)) for v in truth.values())


def grad_err(a, b, truth, tmax):
    """Gradient leaf a against the reference b; truth is the same leaf in
    float32 arithmetic, tmax the tree's largest |truth| (tree_max).

    Returns (rel, abs_err, scale, noise): rel_err over the elements that
    are not zero in exact arithmetic, and over the others max|a| as a
    multiple of max|b| there plus the zero threshold ZERO * tmax."""
    a, b, t = _np(a), _np(b), _np(truth)
    if not (a.shape == b.shape == t.shape):
        raise ValueError(f"shapes differ: {a.shape}, {b.shape}, {t.shape}")
    live = np.abs(t) > ZERO * tmax
    rel, err, scale = rel_err(a[live], b[live]) if live.any() else (0.0, 0.0, 0.0)
    dead = ~live
    num = float(np.max(np.abs(a[dead]), initial=0.0))
    den = float(np.max(np.abs(b[dead]), initial=0.0)) + ZERO * tmax
    noise = num / den if den > 0 else (0.0 if num == 0 else float("inf"))
    if not np.isfinite(a).all():
        noise = float("inf")
    return rel, err, scale, noise


def score_linears(grads):
    """A gradient dict with each attention score's weight and bias
    ("...attn_lin.w", "...attn_lin.b") as one numpy leaf, for grad_err's
    noise bound. The query part of the weight and the bias are both
    softmax-invariant, zero in exact arithmetic, and hold the same rounding
    noise; the bias alone is a single cancelling sum per level, whose noise
    is one draw that may land on exactly 0 in either implementation."""
    out = {}
    for k, v in grads.items():
        if k.endswith("attn_lin.b"):
            continue
        if k.endswith("attn_lin.w"):
            v = np.concatenate([_np(v).ravel(), _np(grads[k[:-1] + "b"]).ravel()])
        out[k] = v
    return out


class KernelProbe:
    """The generic branch's segment functions (an AggImpl: `impl()`)
    through the kernel wrappers, each call also through its plain version
    on the same inputs: K6 forward on every call, K6 backward on the
    cotangent each output receives (a tensor hook), K5 on every merge.
    Keeps every call's max|kernel - plain| and max|plain| on the device
    until `report`. It holds the kernels against their plain versions at
    the shapes a path gives them; the launches it adds are not the path's.

    A call's error is taken on its own max|plain|, floored at ZERO times
    the largest max|plain| of that output over the pass: a call whose
    output is zero in exact arithmetic (a backward row whose destinations
    each have one edge: the softmax's score grads) holds rounding noise or
    denormals, which the card flushes to zero, as grad_err's exact-zero
    elements do."""

    def __init__(self):
        self._rows = {}      # (kernel, output) -> [(shape, tensor [err, scale])]
        self.calls = {}

    def _note(self, name, key, got, want, out: int = 0):
        import torch
        a, b = got.detach().float(), want.detach().float()
        if a.shape != b.shape:
            raise ValueError(f"{name}: shapes differ: {a.shape} vs {b.shape}")
        if a.numel() == 0:
            return
        inf = torch.full((), float("inf"), device=a.device)
        err = torch.where(torch.isfinite(a).all(), (a - b).abs().amax(), inf)
        self._rows.setdefault((name, out), []).append(
            (key, torch.stack([err, b.abs().amax()])))

    def _count(self, name):
        self.calls[name] = self.calls.get(name, 0) + 1

    def aggregate(self, scores, values, dst, mask, num_slots: int):
        import torch
        from dagnn_tpu_torch.ops import segment_attn as sa
        out = sa.pallas_edge_softmax_aggregate(scores, values, dst, mask, num_slots)
        key = (*values.shape, num_slots)
        self._count("segment_attn_forward")
        with torch.no_grad():
            self._note("segment_attn_forward", key, out,
                       sa.segment_attn_forward_plain(scores, values, dst, mask,
                                                     num_slots))
        if out.requires_grad:
            sv = (scores.detach(), values.detach(), dst, mask)

            def hook(g):
                self._count("segment_attn_backward")
                with torch.no_grad():
                    g = g.contiguous()
                    got = sa.segment_attn_backward(*sv, g, num_slots)
                    want = sa.segment_attn_backward_plain(*sv, g, num_slots)
                    for i, (a, b) in enumerate(zip(got, want)):
                        self._note("segment_attn_backward", key, a, b, i)

            out.register_hook(hook)
        return out

    def merge(self, g, tg, tdst, tmask):
        import torch
        from dagnn_tpu_torch.ops import row_step as rs
        out = rs.tg_accumulate(g, tg, tdst, tmask)
        self._count("tg_accumulate")
        with torch.no_grad():
            self._note("tg_accumulate", (*g.shape, tg.shape[0]), out,
                       rs.tg_accumulate_plain(g, tg, tdst, tmask))
        return out

    def impl(self):
        from dagnn_tpu_torch.nn.aggregators import AggImpl
        return AggImpl(self.aggregate, self.merge)

    def report(self) -> dict:
        """{kernel: {"rel", "err", "scale", "floor", "shape", "output",
        "max_abs_err", "calls", "shapes"}}: the call with the worst error
        on its (floored) scale, its error, max|plain| and floor, shape and
        output index; the largest error of any call; the calls and the
        distinct shapes held."""
        import torch
        rows, shapes = {}, {}
        for (name, o), items in self._rows.items():
            m = torch.stack([r for _, r in items]).double().cpu().numpy()
            err, scale = m[:, 0], m[:, 1]
            floor = ZERO * float(np.nanmax(scale))
            den = np.maximum(scale, floor)
            with np.errstate(divide="ignore", invalid="ignore"):
                rel = np.where(den > 0, err / den, err)
            bad = np.flatnonzero(~np.isfinite(rel))
            i = int(bad[0]) if len(bad) else int(np.lexsort((scale, rel))[-1])
            shapes.setdefault(name, set()).update(k for k, _ in items)
            rows.setdefault(name, []).append(
                {"rel": float(rel[i]), "err": float(err[i]), "scale": float(scale[i]),
                 "floor": floor, "shape": [int(k) for k in items[i][0]], "output": o,
                 "max_abs_err": float(np.max(err))})
        return {name: worst_call(rs, calls=self.calls[name], shapes=len(shapes[name]))
                for name, rs in rows.items()}


def worst_call(rows, **extra) -> dict:
    """Of KernelProbe report rows, the one with the worst rel (a
    non-finite one first), with max_abs_err the largest of them all."""
    w = max(rows, key=lambda r: (not np.isfinite(r["rel"]), r["rel"], r["scale"]))
    return dict(w, max_abs_err=max(r["max_abs_err"] for r in rows), **extra)

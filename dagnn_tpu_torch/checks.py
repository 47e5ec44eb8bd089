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

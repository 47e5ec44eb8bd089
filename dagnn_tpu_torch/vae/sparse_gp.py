"""Sparse Gaussian-process regression + expected improvement, in PyTorch.

Counterpart of dagnn_tpu/vae/sparse_gp.py (which replaces the reference's
Theano sparse GP, dvae/bayesian_optimization/sparse_gp.py): a Titsias
collapsed-bound sparse GP (M inducing points, ARD RBF kernel) trained with
Adam, exact sparse posterior prediction, and the EI machinery of the BO
loop (grid + gradient-refined candidate selection with greedy batch
construction, sparse_gp.py:272-340).

Scores follow the reference convention: y = normalized NEGATIVE objective,
so BO MINIMIZES and EI improves below the incumbent.

Device and precision. Everything runs on the device of the caller's
tensors (numpy inputs go to `device`, the card by default) in float32
unless the caller's tensors are float64. The JAX package computes in
float32 too: it converts to float64 but runs with jax_enable_x64 off, so
its arrays are narrowed back. Its "CPU float64" refit is therefore a CPU
float32 refit; the port's counterpart refits in float64 on the same
device when the float32 fit ends non-finite, prints one line, and sets
SparseGP.refit_f64. TF32 would replace the float32 products by 10-bit
mantissas and break the 500x500 Cholesky, so on a CUDA device the entry
points raise when torch.backends.cuda.matmul.allow_tf32 is on.

Host-side draws (the inducing points, their de-duplication noise, the EI
grid) keep their numpy seeds, so the same seed gives the same points as
in the JAX package. Nothing inside the Adam loops or the greedy EI loop
reads a value on the host: each entry point syncs once, at its end.

One dispatch, as the JAX package compiles them (train/graphs.py): on a
CUDA device each of the fit's Adam steps replays one CUDA graph (FIT: one
step a graph, replayed `iters` times; keyed on the rows, D, M, lr, dtype
and whether rows are masked), and each greedy-EI
candidate replays one graph (EI: the grid's log EI, the top 8, their
clipped Adam refinement, the best, the believer's update of B and A y,
the new cache and incumbent; keyed on the grid size, D, M, refine_iters
and dtype). A replay launches what the eager form launches, in the same
order: the two give the same bits. capture=False keeps the eager form; on
CPU tensors the captured form calls the same step functions directly.

The EI's normal CDF is written from erf / erfc as JAX's ndtr is (see
_ndtr). The JAX package writes log(max(ei, 1e-300)); in float32, where it
runs, 1e-300 is 0, so its log EI is -inf wherever EI underflows and its
gradient there NaN. On a trained NA VAE's latents that happens in the
greedy EI: a refined point whose predicted mean lies far below the data's
drops the believer's incumbent, every grid point's EI then underflows,
the refinement's Adam steps go NaN, and the NaN point poisons the
believer's system, so every later candidate of the round is NaN (49 of
50 on the card, and in JAX on the CPU from the same latents). The port's
floor is 1e-300 where the dtype holds it (float64) and the dtype's
smallest normal number elsewhere (1.2e-38 in float32): log EI is finite
there, its gradient 0, and wherever EI is at least the floor the values
are JAX's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from dagnn_tpu_torch import resolve_device
from dagnn_tpu_torch.train.graphs import CapturedStep
from dagnn_tpu_torch.train.optim import make_optimizer

_SQRT_2PI = math.sqrt(2.0 * math.pi)
_HALF_SQRT2 = 0.5 * math.sqrt(2.0)


@dataclasses.dataclass
class SparseGP:
    """Fitted parameters (Z [M, D], log_ls [D], log_sf2 [], log_sn2 [])
    and the real training rows X [n, D], y [n], all on the fit's device in
    its dtype; refit_f64 says whether the float32 fit went non-finite and
    was redone in float64."""

    params: Dict[str, torch.Tensor]
    X: torch.Tensor
    y: torch.Tensor
    refit_f64: bool = False

    @property
    def d_input(self) -> int:
        return self.X.shape[1]


def _check_precision(dev: torch.device):
    if dev.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the sparse GP needs float32 matmuls: turn TF32 off "
            "(torch.backends.cuda.matmul.allow_tf32 = False)")


def _host64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def _like(a, ref: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=ref.dtype, device=ref.device) \
        if not isinstance(a, torch.Tensor) else a.to(ref.device, ref.dtype)


def _cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, NaN where A is not positive definite (as
    jnp.linalg.cholesky gives), without a host sync."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info > 0)[..., None, None], torch.nan, L)


def _solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """L^-1 b for lower-triangular L; b [M] or [M, K]."""
    if b.dim() == 1:
        return torch.linalg.solve_triangular(L, b[:, None], upper=False)[:, 0]
    return torch.linalg.solve_triangular(L, b, upper=False)


def _kernel(p, a, b):
    ls = torch.exp(p["log_ls"])          # [D]
    sf2 = torch.exp(p["log_sf2"])
    a = a / ls
    b = b / ls
    d2 = (torch.sum(a ** 2, 1)[:, None] - 2 * a @ b.T + torch.sum(b ** 2, 1)[None])
    # jnp.maximum: at a tie each side gets half the gradient, as here
    return sf2 * torch.exp(-0.5 * torch.maximum(d2, torch.zeros_like(d2)))


def _titsias_bound(p, X, y, mask=None):
    """Collapsed variational lower bound (Titsias 2009).

    mask [n] (0/1) drops padding rows exactly: their Kmn columns and y
    entries are zeroed and n becomes the real count, so a caller may pad
    the train set to a fixed shape while the data grows (the BO loop's
    Kriging-believer augmentation)."""
    Z = p["Z"]
    M = Z.shape[0]
    sn2 = torch.exp(p["log_sn2"]) + 1e-6
    # dtype-aware jitter: float32 needs a larger floor to keep the
    # 500x500 Cholesky positive definite
    f64 = X.dtype == torch.float64
    jit_rel, jit_abs = (1e-5, 1e-8) if f64 else (1e-4, 1e-6)
    eye = torch.eye(M, dtype=X.dtype, device=X.device)
    Kmm = _kernel(p, Z, Z) + (jit_rel * torch.exp(p["log_sf2"]) + jit_abs) * eye
    Kmn = _kernel(p, Z, X)
    if mask is None:
        n = X.shape[0]
    else:
        m = mask.to(X.dtype)
        n = torch.sum(m)
        Kmn = Kmn * m[None, :]
        y = y * m
    Lm = _cholesky(Kmm)
    A = _solve(Lm, Kmn) / torch.sqrt(sn2)
    Lb = _cholesky(eye + A @ A.T)
    c = _solve(Lb, A @ y) / torch.sqrt(sn2)
    bound = (-0.5 * n * torch.log(2 * math.pi * sn2)
             - torch.sum(torch.log(torch.diagonal(Lb)))
             - 0.5 * torch.sum(y ** 2) / sn2
             + 0.5 * torch.sum(c ** 2))
    # trace correction
    kdiag = torch.exp(p["log_sf2"]) * n
    return bound - 0.5 / sn2 * (kdiag - sn2 * torch.sum(A ** 2))


_ADAM = make_optimizer(clip=0.0)


def _adam_step(carry, data):
    """One Adam step (optax.adam: eps outside the square root, no clip) on
    the negative bound, as fn((params, Adam state), (X, y, mask, lr)) ->
    ((params, Adam state), its loss): the eager loop's step and the
    captured program (FIT) both."""
    p, state = carry
    X, y, mask, lr = data
    q = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    with torch.enable_grad():
        loss = -_titsias_bound(q, X, y, mask)
        gs = torch.autograd.grad(loss, list(q.values()))
    with torch.no_grad():
        updates, state = _ADAM.update(dict(zip(q, gs)), state, lr)
        p = {k: p[k] + updates[k] for k in p}
    return (p, state), loss.detach()


class _FitKey(NamedTuple):
    device: str
    rows: Tuple[int, int]        # X's [n (padded), D]
    M: int
    lr: float
    dtype: torch.dtype
    masked: bool


# the fit's captured program, one graph a _FitKey: {unpadded, padded} x
# {float32, float64} in a BO run
FIT = CapturedStep(_adam_step, keep=4)


def _adam_fit(p, X, y, mask, iters: int, lr: float, capture: bool = False):
    """`iters` Adam steps on the negative bound; (params, the last step's
    loss). capture: each step a replay of FIT's graph; the parameters
    returned are the fit's own, not the graph's buffers."""
    carry = (p, _ADAM.init(p))
    data = (X, y, mask, lr)
    loss = torch.full((), torch.nan, dtype=X.dtype, device=X.device)
    key = _FitKey(str(X.device), tuple(X.shape), p["Z"].shape[0], lr, X.dtype,
                  mask is not None)
    step = FIT if capture else lambda _, c, d: _adam_step(c, d)
    for _ in range(iters):
        carry, loss = step(key, carry, data)
    params = carry[0]
    # captured: the fit's own tensors, not the graph's buffers
    return ({k: v.clone() for k, v in params.items()} if capture else params), loss


def _fit_problem(Xh, yh, M: int, seed: int, pad_to: Optional[int], dt, dev):
    """A fit's start on `dev` in `dt` from the float64 host rows Xh [n, D]
    and targets yh [n]: (initial parameters, the rows and targets padded
    to pad_to with zeros, the padding mask or None). The inducing points
    are M rows drawn by a numpy generator seeded `seed`."""
    n, d = Xh.shape
    mask = None
    Xp, yp = Xh, yh
    if pad_to is not None and pad_to > n:
        mask = np.zeros(pad_to, np.float32)
        mask[:n] = 1.0
        Xp = np.concatenate([Xh, np.zeros((pad_to - n, d))], 0)
        yp = np.concatenate([yh, np.zeros(pad_to - n)], 0)
    rng = np.random.default_rng(seed)
    M = min(M, n)
    Z0 = Xh[rng.choice(n, M, replace=False)]
    # break exact duplicates (undertrained encoders emit near-identical
    # latents; duplicated inducing points make Kmm singular beyond jitter)
    Z0 = Z0 + 1e-4 * (Xh.std(0) + 1e-6) * rng.standard_normal(Z0.shape)
    t = lambda a: torch.as_tensor(a, dtype=dt, device=dev)
    p = {"Z": t(Z0),
         "log_ls": torch.log(t(Xh.std(0) + 1e-3) * float(np.sqrt(d))),
         "log_sf2": t(np.log(yh.var() + 1e-3)),
         "log_sn2": t(np.log(yh.var() * 0.1 + 1e-3))}
    return p, t(Xp), t(yp), None if mask is None else t(mask)


def fit_sparse_gp(X, y, M: int = 500, iters: int = 200, lr: float = 5e-3,
                  seed: int = 0, pad_to: Optional[int] = None,
                  device="cuda", capture: bool = True) -> SparseGP:
    """Fit by maximizing the collapsed bound with Adam (the reference trains
    its SGP with Adam too, bo.py:256-260).

    X [n, D], y [n] or [n, 1]: numpy arrays (run on `device` in float32)
    or tensors (run on their device, in their dtype when it is float64,
    else float32). pad_to: pad the train set to this row count with masked
    zeros (the BO rounds' growing set keeps one shape). A float32 fit
    whose last loss or any parameter is non-finite is redone in float64 on
    the same device. capture: the Adam steps replayed from FIT's graphs
    (False: eager); the finiteness test after them, one host sync."""
    if isinstance(X, torch.Tensor):
        dev = X.device
        dtype = torch.float64 if X.dtype == torch.float64 else torch.float32
    else:
        dev, dtype = resolve_device(device), torch.float32
    _check_precision(dev)
    Xh = _host64(X)
    yh = _host64(y).reshape(-1)

    def fit(dt):
        p, last = _adam_fit(*_fit_problem(Xh, yh, M, seed, pad_to, dt, dev), iters,
                            lr, capture)
        finite = torch.isfinite(last) & torch.stack(
            [torch.isfinite(v).all() for v in p.values()]).all()
        return p, bool(finite)

    params, ok = fit(dtype)
    refit = False
    if not ok and dtype == torch.float32:
        print("sparse GP: the float32 fit went non-finite; refitting in "
              f"float64 on {dev}")
        params, _ = fit(torch.float64)
        dtype, refit = torch.float64, True
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    return SparseGP(params=params, X=t(Xh), y=t(yh), refit_f64=refit)


def _posterior_terms(gp: SparseGP):
    """(Lm, A over the train rows, sn2) of the posterior; the jitter is
    1e-5 sf2 + 1e-8 in every dtype, as the JAX package's posterior has it."""
    p = gp.params
    Z = p["Z"]
    M = Z.shape[0]
    sn2 = torch.exp(p["log_sn2"]) + 1e-6
    eye = torch.eye(M, dtype=Z.dtype, device=Z.device)
    Lm = _cholesky(_kernel(p, Z, Z) + (1e-5 * torch.exp(p["log_sf2"]) + 1e-8) * eye)
    A = _solve(Lm, _kernel(p, Z, gp.X)) / torch.sqrt(sn2)
    return Lm, A, sn2, eye


def _stable(gp: SparseGP) -> SparseGP:
    """gp, or a float64 copy of it when the posterior's Kmm has no float32
    Cholesky factor. The posterior's jitter is 1e-5 sf2 + 1e-8 in every
    dtype, as in the JAX package, below the float32 fit's 1e-4 sf2 +
    1e-6: a float32 fit can succeed where its posterior factor fails,
    and JAX's float32 posterior is then NaN. One host sync."""
    if gp.X.dtype == torch.float64 or bool(torch.isfinite(
            _posterior_terms(gp)[0]).all()):
        return gp
    print("sparse GP: the float32 posterior has no Cholesky factor; "
          f"predicting in float64 on {gp.X.device}")
    return _float64(gp)


def _float64(gp: SparseGP) -> SparseGP:
    return SparseGP({k: v.double() for k, v in gp.params.items()}, gp.X.double(),
                    gp.y.double(), gp.refit_f64)


def _cache(p, Lm, Bmat, Ay, sn2):
    Lb = _cholesky(Bmat)
    return p, Lm, Lb, _solve(Lb, Ay) / torch.sqrt(sn2)


def _posterior_cache(gp: SparseGP):
    Lm, A, sn2, eye = _posterior_terms(gp)
    return _cache(gp.params, Lm, eye + A @ A.T, A @ gp.y, sn2)


def _mean_var(cache, x):
    p, Lm, Lb, c = cache
    tmp1 = _solve(Lm, _kernel(p, p["Z"], x))
    tmp2 = _solve(Lb, tmp1)
    var = torch.exp(p["log_sf2"]) - torch.sum(tmp1 ** 2, 0) + torch.sum(tmp2 ** 2, 0)
    return tmp2.T @ c, var


@torch.no_grad()
def predict(gp: SparseGP, Xs) -> Tuple[torch.Tensor, torch.Tensor]:
    """Posterior mean and variance (incl. noise-free latent var) at Xs
    [B, D], on the GP's device (in float64 where _stable says so)."""
    _check_precision(gp.X.device)
    gp = _stable(gp)
    mean, var = _mean_var(_posterior_cache(gp), _like(Xs, gp.X))
    return mean, torch.clamp(var, min=1e-10)


def _ndtr(x):
    """The standard normal CDF from erf / erfc, as jax.scipy.special.ndtr
    computes it. torch.special.ndtr in float32 loses the lower tail (0 at
    x = -7 on the CPU, where the EI below still needs it to about 1e-6)."""
    w = x * _HALF_SQRT2
    z = torch.abs(w)
    y = torch.where(z < _HALF_SQRT2, 1.0 + torch.erf(w),
                    torch.where(w > 0, 2.0 - torch.erfc(z), torch.erfc(z)))
    return 0.5 * y


def _log_ei_from(mean, var, incumbent):
    sd = torch.sqrt(torch.clamp(var, min=1e-10))
    gamma = (incumbent - mean) / sd
    ei = sd * (gamma * _ndtr(gamma)
               + torch.exp(-0.5 * gamma ** 2) / _SQRT_2PI)
    # JAX's 1e-300 where the dtype holds it (float64), else the dtype's
    # smallest normal number; new_full: no H2D copy
    floor = ei.new_full((), max(1e-300, torch.finfo(ei.dtype).tiny))
    return torch.log(torch.maximum(ei, floor))


def log_ei(gp_cache, x, incumbent):
    """log EI for minimization at points x [B, D]."""
    return _log_ei_from(*_mean_var(gp_cache, x), incumbent)


_REFINE_ADAM = make_optimizer(0.05, clip=0.0)


def _candidate_step(state, refine_iters: int):
    """One greedy-EI candidate: (state, best [1, D]) from state = (round,
    (Bmat, Ay, Lb, c, incumbent)), the round's
    constants (params, Lm, sn2, the grid, its t1 through Lm and sum of
    squares, the box) and the believer's running system. The grid's log
    EI, the top 8 by argsort, their refine_iters clipped Adam steps (lr
    0.05), the best by log EI; then the believer's rank-1 update of B = I
    + A A^T and of A y with the best point's predicted mean, the new cache
    and the incumbent. The eager loop's step and the captured program (EI)
    both."""
    (p, Lm, sn2, grid, t1_grid, t1_sq, lower, upper), run = state
    Bmat, Ay, Lb, c, incumbent = run
    cache = (p, Lm, Lb, c)
    t2 = _solve(Lb, t1_grid)
    lei = _log_ei_from(t2.T @ c, torch.exp(p["log_sf2"]) - t1_sq
                       + torch.sum(t2 ** 2, 0), incumbent)
    x = grid[torch.argsort(-lei)[:8]]          # refine the top grid points
    adam = _REFINE_ADAM.init({"x": x})
    for _ in range(refine_iters):
        xg = x.detach().requires_grad_(True)
        with torch.enable_grad():
            g, = torch.autograd.grad(-torch.sum(log_ei(cache, xg, incumbent)), xg)
        upd, adam = _REFINE_ADAM.update({"x": g}, adam)
        x = torch.clamp(x + upd["x"], lower, upper)
    # a 1-d index: a 0-d one reads its value on the host
    best = x[torch.argmax(log_ei(cache, x, incumbent))[None]]
    # Kriging believer: pretend we observed the predicted mean
    mb = _mean_var(cache, best)[0]
    a = _solve(Lm, _kernel(p, p["Z"], best)) / torch.sqrt(sn2)      # [M, 1]
    Bmat = Bmat + a @ a.T
    Ay = Ay + a[:, 0] * mb[0]
    _, _, Lb, c = _cache(p, Lm, Bmat, Ay, sn2)
    incumbent = torch.minimum(incumbent, mb[0])
    return (state[0], (Bmat, Ay, Lb, c, incumbent)), best


class _EIKey(NamedTuple):
    device: str
    grid_size: int
    D: int
    M: int
    refine_iters: int
    dtype: torch.dtype


# a greedy-EI candidate's captured program, one graph a _EIKey (float32 and
# float64)
EI = CapturedStep(_candidate_step, keep=2)


@torch.no_grad()
def batched_greedy_ei(gp: SparseGP, q: int, lower, upper, mean, std,
                      sample: str = "normal", grid_size: int = 10000,
                      refine_iters: int = 50, seed: int = 0,
                      capture: bool = True) -> torch.Tensor:
    """Select q candidate latents [q, D] by greedy EI (sparse_gp.py:
    296-340): sample a grid (numpy, seeded), find the incumbent (min
    predicted mean), then repeatedly pick the 8 best-EI grid points, refine
    them by Adam (lr 0.05) clipped to [lower, upper], and keep the best;
    a selected point joins the train set with its predicted mean (Kriging
    believer) so the batch spreads out. The [M, N] part of the posterior
    is built once; each believer point is a rank-1 update of B = I + A A^T
    and of A y. Runs in float64 where _stable says so; a float32 round
    with a non-finite candidate (the believer's B = I + A A^T can lose its
    float32 Cholesky factor after an update) is redone in float64 on the
    same device, with one printed line (one host sync). The round's set-up
    is eager; capture: each candidate a replay of EI's graph (False:
    _candidate_step eagerly)."""
    dev = gp.X.device
    _check_precision(dev)
    gp = _stable(gp)
    rng = np.random.default_rng(seed)
    d = gp.d_input
    if sample == "normal":
        grid = mean + rng.standard_normal((grid_size, d)) * std
    else:
        grid = lower + rng.random((grid_size, d)) * (upper - lower)
    grid_t, lower_t, upper_t = (_like(_host64(a), gp.X) for a in (grid, lower, upper))
    p = gp.params
    Z = p["Z"]
    Lm, A0, sn2, eye = _posterior_terms(gp)
    Bmat = eye + A0 @ A0.T
    Ay = A0 @ gp.y
    cache = _cache(p, Lm, Bmat, Ay, sn2)
    # grid quantities through Lm are iteration-invariant: computed once
    t1_grid = _solve(Lm, _kernel(p, Z, grid_t))
    t1_sq = torch.sum(t1_grid ** 2, 0)
    incumbent = torch.minimum(_mean_var(cache, grid_t)[0].min(), gp.y.min())
    state = ((p, Lm, sn2, grid_t, t1_grid, t1_sq, lower_t, upper_t),
             (Bmat, Ay, cache[2], cache[3], incumbent))
    key = _EIKey(str(dev), grid_size, d, Z.shape[0], refine_iters, gp.X.dtype)
    step = EI if capture else lambda _, s, n: _candidate_step(s, n)
    chosen = []
    for _ in range(q):
        state, best = step(key, state, refine_iters)
        chosen.append(best)
    out = torch.cat(chosen, 0)
    if gp.X.dtype == torch.float32 and not bool(torch.isfinite(out).all()):
        print("greedy EI: a float32 candidate went non-finite; redoing the round "
              f"in float64 on {dev}")
        return batched_greedy_ei(_float64(gp), q, lower, upper, mean, std, sample,
                                 grid_size, refine_iters, seed, capture)
    return out

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

The EI's normal CDF is written from erf / erfc as JAX's ndtr is (see
_ndtr). Where the JAX package writes log(max(ei, 1e-300)), the floor is a
constant of the operands' dtype: 0 in float32, so log EI is -inf wherever
EI underflows, as in JAX's float32 arithmetic (the top-8 argsort and the
argmax then rank the same points).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from dagnn_tpu_torch import resolve_device
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


def _adam_fit(p, X, y, mask, iters: int, lr: float):
    """`iters` Adam steps (optax.adam: eps outside the square root, no
    clip) on the negative bound; (params, the last step's loss)."""
    opt = make_optimizer(lr, clip=0.0)
    state = opt.init(p)
    loss = torch.full((), torch.nan, dtype=X.dtype, device=X.device)
    for _ in range(iters):
        q = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        with torch.enable_grad():
            loss = -_titsias_bound(q, X, y, mask)
            gs = torch.autograd.grad(loss, list(q.values()))
        with torch.no_grad():
            updates, state = opt.update(dict(zip(q, gs)), state)
            p = {k: p[k] + updates[k] for k in p}
    return p, loss.detach()


def fit_sparse_gp(X, y, M: int = 500, iters: int = 200, lr: float = 5e-3,
                  seed: int = 0, pad_to: Optional[int] = None,
                  device="cuda") -> SparseGP:
    """Fit by maximizing the collapsed bound with Adam (the reference trains
    its SGP with Adam too, bo.py:256-260).

    X [n, D], y [n] or [n, 1]: numpy arrays (run on `device` in float32)
    or tensors (run on their device, in their dtype when it is float64,
    else float32). pad_to: pad the train set to this row count with masked
    zeros (the BO rounds' growing set keeps one shape). A float32 fit
    whose last loss or any parameter is non-finite is redone in float64 on
    the same device."""
    if isinstance(X, torch.Tensor):
        dev = X.device
        dtype = torch.float64 if X.dtype == torch.float64 else torch.float32
    else:
        dev, dtype = resolve_device(device), torch.float32
    _check_precision(dev)
    Xh = _host64(X)
    yh = _host64(y).reshape(-1)
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

    def fit(dt):
        t = lambda a: torch.as_tensor(a, dtype=dt, device=dev)
        p = {"Z": t(Z0),
             "log_ls": torch.log(t(Xh.std(0) + 1e-3) * float(np.sqrt(d))),
             "log_sf2": t(np.log(yh.var() + 1e-3)),
             "log_sn2": t(np.log(yh.var() * 0.1 + 1e-3))}
        m = None if mask is None else t(mask)
        p, last = _adam_fit(p, t(Xp), t(yp), m, iters, lr)
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
    return SparseGP({k: v.double() for k, v in gp.params.items()}, gp.X.double(),
                    gp.y.double(), gp.refit_f64)


def _cache(gp: SparseGP, Lm, Bmat, Ay, sn2):
    Lb = _cholesky(Bmat)
    return gp.params, Lm, Lb, _solve(Lb, Ay) / torch.sqrt(sn2)


def _posterior_cache(gp: SparseGP):
    Lm, A, sn2, eye = _posterior_terms(gp)
    return _cache(gp, Lm, eye + A @ A.T, A @ gp.y, sn2)


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
    floor = torch.tensor(1e-300, dtype=ei.dtype, device=ei.device)  # 0 in f32
    return torch.log(torch.maximum(ei, floor))


def log_ei(gp_cache, x, incumbent):
    """log EI for minimization at points x [B, D]."""
    return _log_ei_from(*_mean_var(gp_cache, x), incumbent)


@torch.no_grad()
def batched_greedy_ei(gp: SparseGP, q: int, lower, upper, mean, std,
                      sample: str = "normal", grid_size: int = 10000,
                      refine_iters: int = 50, seed: int = 0) -> torch.Tensor:
    """Select q candidate latents [q, D] by greedy EI (sparse_gp.py:
    296-340): sample a grid (numpy, seeded), find the incumbent (min
    predicted mean), then repeatedly pick the 8 best-EI grid points, refine
    them by Adam (lr 0.05) clipped to [lower, upper], and keep the best;
    a selected point joins the train set with its predicted mean (Kriging
    believer) so the batch spreads out. The [M, N] part of the posterior
    is built once; each believer point is a rank-1 update of B = I + A A^T
    and of A y. Runs in float64 where _stable says so."""
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
    cache = _cache(gp, Lm, Bmat, Ay, sn2)

    # grid quantities through Lm are iteration-invariant: computed once
    t1_grid = _solve(Lm, _kernel(p, Z, grid_t))
    sf2 = torch.exp(p["log_sf2"])
    t1_sq = torch.sum(t1_grid ** 2, 0)

    def grid_log_ei(cache, incumbent):
        t2 = _solve(cache[2], t1_grid)
        return _log_ei_from(t2.T @ cache[3], sf2 - t1_sq + torch.sum(t2 ** 2, 0),
                            incumbent)

    incumbent = torch.minimum(_mean_var(cache, grid_t)[0].min(), gp.y.min())
    opt = make_optimizer(0.05, clip=0.0)

    def refine(x, cache, incumbent):
        state = opt.init({"x": x})
        for _ in range(refine_iters):
            xg = x.detach().requires_grad_(True)
            with torch.enable_grad():
                g, = torch.autograd.grad(-torch.sum(log_ei(cache, xg, incumbent)), xg)
            upd, state = opt.update({"x": g}, state)
            x = torch.clamp(x + upd["x"], lower_t, upper_t)
        return x

    chosen = []
    for _ in range(q):
        lei = grid_log_ei(cache, incumbent)
        x0 = grid_t[torch.argsort(-lei)[:8]]       # refine the top grid points
        xr = refine(x0, cache, incumbent)
        best = xr[torch.argmax(log_ei(cache, xr, incumbent))][None]
        chosen.append(best)
        # Kriging believer: pretend we observed the predicted mean
        mb = _mean_var(cache, best)[0]
        a = _solve(Lm, _kernel(p, Z, best)) / torch.sqrt(sn2)      # [M, 1]
        Bmat = Bmat + a @ a.T
        Ay = Ay + a[:, 0] * mb[0]
        cache = _cache(gp, Lm, Bmat, Ay, sn2)
        incumbent = torch.minimum(incumbent, mb[0])
    return torch.cat(chosen, 0)

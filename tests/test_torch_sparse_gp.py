"""The port's sparse GP (dagnn_tpu_torch/vae/sparse_gp.py) against the JAX
package's on the CPU, both in float32 (the JAX package runs with
jax_enable_x64 off): the collapsed bound and its gradient, masked and
unmasked; a 5-iteration fit from the same seed; predict; log EI, and
where EI underflows in float32 (JAX's log(max(ei, 1e-300)) is -inf there,
its floor being 0 in float32) the port's floor, float32's smallest normal
number; batched greedy EI from the same
fitted parameters and seed. Then the port's own versions of the JAX
package's behavioural cases (tests/test_sparse_gp.py:10, 25, 61), the
float64 refit when the float32 fit goes non-finite, the float64 posterior
when its float32 factor fails, the float64 greedy-EI round when a
float32 candidate goes non-finite, and the TF32 guard.

Sizes: a few hundred rows of seeded numpy data, M 20-64. Tolerances: the
bound 1e-5 relative, its gradient rtol 5e-4 / atol 5e-5; fitted
parameters rtol 1e-3; the predictive mean and variance 1e-4 of max|ref|;
log EI rtol 1e-4 where finite; greedy EI's candidates 1e-3 of the box
width.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dagnn_tpu.vae import sparse_gp as J
from dagnn_tpu_torch.vae import sparse_gp as T

torch.set_num_threads(1)


def _data(n=200, d=4, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d))
    y = np.sin(X[:, 0]) + 0.5 * np.cos(X[:, 1]) + 0.1 * rng.standard_normal(n)
    return X, y, rng.standard_normal((40, d))


def _params(X, y, M=20, seed=0):
    """Bound parameters in float32, away from the initial point."""
    rng = np.random.default_rng(seed)
    d = X.shape[1]
    return {"Z": X[rng.choice(len(X), M, replace=False)].astype(np.float32)
            + 0.05 * rng.standard_normal((M, d)).astype(np.float32),
            "log_ls": np.log(np.full(d, 1.3, np.float32)),
            "log_sf2": np.float32(np.log(0.8)),
            "log_sn2": np.float32(np.log(0.05))}


def _port_gp(gj):
    """The JAX GP's fitted parameters and rows as a port SparseGP (f32)."""
    f = lambda a: torch.tensor(np.asarray(a, np.float32))
    return T.SparseGP({k: f(v) for k, v in gj.params.items()}, f(gj.X), f(gj.y))


@pytest.mark.parametrize("masked", [False, True])
def test_bound_and_grad_match_jax(masked):
    X, y, _ = _data()
    p = _params(X, y)
    mask = None
    if masked:   # 60 padding rows of garbage, masked out
        X = np.concatenate([X, np.random.default_rng(9).standard_normal((60, 4))])
        y = np.concatenate([y, np.full(60, 7.0)])
        mask = (np.arange(len(X)) < 200).astype(np.float32)
    X32, y32 = X.astype(np.float32), y.astype(np.float32)
    jm = None if mask is None else jnp.asarray(mask)
    jval, jg = jax.value_and_grad(
        lambda q: J._titsias_bound(q, jnp.asarray(X32), jnp.asarray(y32), jm)
    )({k: jnp.asarray(v) for k, v in p.items()})
    q = {k: torch.tensor(v).requires_grad_(True) for k, v in p.items()}
    tm = None if mask is None else torch.tensor(mask)
    tval = T._titsias_bound(q, torch.tensor(X32), torch.tensor(y32), tm)
    tg = torch.autograd.grad(tval, list(q.values()))
    assert abs(float(tval.detach()) - float(jval)) <= 1e-5 * abs(float(jval))
    for k, g in zip(q, tg):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]), rtol=5e-4,
                                   atol=5e-5, err_msg=k)


def test_fit_predict_ei_match_jax():
    X, y, Xs = _data()
    gj = J.fit_sparse_gp(X, y, M=20, iters=5, lr=1e-2, seed=0)
    gt = T.fit_sparse_gp(X, y, M=20, iters=5, lr=1e-2, seed=0, device="cpu")
    assert not gt.refit_f64 and gt.params["Z"].dtype == torch.float32
    for k, v in gj.params.items():
        np.testing.assert_allclose(gt.params[k].numpy(), v, rtol=1e-3, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_array_equal(gt.X.numpy(), gj.X.astype(np.float32))
    # predict, from the JAX fit's parameters on both sides
    gp = _port_gp(gj)
    for got, want in zip(T.predict(gp, Xs), J.predict(gj, Xs)):
        assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    # log EI: finite values agree, the lower tail included (gamma to -12:
    # the normal CDF from erfc, as in JAX); where EI underflows in float32
    # (an incumbent 30 predictive sds below the mean) JAX's is -inf and the
    # port's is its floor, log of float32's smallest normal number
    xq = np.concatenate([Xs[:10], 25.0 + Xs[:3]]).astype(np.float32)
    cj, ct = J._posterior_cache(gj), T._posterior_cache(gp)
    floor = np.log(np.finfo(np.float32).tiny, dtype=np.float32)
    for inc in (-0.3, -40.0):
        want = np.asarray(J.log_ei(cj, jnp.asarray(xq), inc))
        got = T.log_ei(ct, torch.tensor(xq), torch.tensor(inc)).numpy()
        np.testing.assert_array_equal(got[np.isneginf(want)], floor)
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4, atol=1e-5)
    assert np.isneginf(want).all()   # inc -40: every EI underflows
    # greedy EI from the same parameters and seed
    lo, hi = X.min(0), X.max(0)
    cand_j = J.batched_greedy_ei(gj, 3, lo, hi, X.mean(0), X.std(0),
                                 grid_size=500, refine_iters=10, seed=1)
    cand_t = T.batched_greedy_ei(gp, 3, lo, hi, X.mean(0), X.std(0),
                                 grid_size=500, refine_iters=10, seed=1)
    assert cand_t.shape == (3, 4)
    assert (np.abs(cand_t.numpy() - cand_j) <= 1e-3 * (hi - lo)).all()


def test_sparse_gp_learns_smooth_function():
    rng = np.random.default_rng(0)
    X = rng.uniform(-3, 3, (400, 2))
    y = np.sin(X[:, 0]) + 0.5 * np.cos(2 * X[:, 1]) + 0.05 * rng.standard_normal(400)
    gp = T.fit_sparse_gp(X, y, M=64, iters=300, lr=2e-2, device="cpu")
    Xs = rng.uniform(-3, 3, (100, 2))
    ys = np.sin(Xs[:, 0]) + 0.5 * np.cos(2 * Xs[:, 1])
    mu, var = (t.numpy() for t in T.predict(gp, Xs))
    assert np.sqrt(np.mean((mu - ys) ** 2)) < 0.25
    assert (var > 0).all() and np.corrcoef(mu, ys)[0, 1] > 0.95


def test_ei_selection_prefers_low_regions():
    rng = np.random.default_rng(1)
    X = rng.uniform(-2, 2, (200, 1))
    y = (X[:, 0] - 1.0) ** 2  # min at x=1
    gp = T.fit_sparse_gp(X, y, M=32, iters=300, lr=2e-2, device="cpu")
    cand = T.batched_greedy_ei(gp, 5, X.min(0), X.max(0), X.mean(0), X.std(0),
                               grid_size=500, refine_iters=25).numpy()
    assert cand.shape == (5, 1) and np.abs(cand - 1.0).min() < 0.5


def test_pad_to_mask_matches_unpadded():
    rng = np.random.default_rng(3)
    X = rng.standard_normal((300, 6))
    y = np.sin(X[:, 0]) + 0.1 * rng.standard_normal(300)
    Xs = rng.standard_normal((40, 6))
    g1 = T.fit_sparse_gp(X, y, M=50, iters=40, lr=1e-2, seed=0, device="cpu")
    g2 = T.fit_sparse_gp(X, y, M=50, iters=40, lr=1e-2, seed=0, pad_to=420,
                         device="cpu")
    np.testing.assert_allclose(T.predict(g1, Xs)[0].numpy(),
                               T.predict(g2, Xs)[0].numpy(), rtol=1e-4, atol=1e-5)


def test_refit_in_float64_when_float32_goes_nonfinite(capsys):
    """Scores of order 1e20 (variance 1e40, beyond float32's range): in
    float32 sf2 overflows, Kmm has no Cholesky factor and the fit ends
    NaN; the port refits in float64 on the same device, says so, and
    returns float64 parameters that predict finite values."""
    X, y, Xs = _data(n=120)
    gp = T.fit_sparse_gp(X, 1e20 * y, M=16, iters=5, lr=1e-2, device="cpu")
    assert gp.refit_f64 and "float64" in capsys.readouterr().out
    assert all(v.dtype == torch.float64 and torch.isfinite(v).all()
               for v in gp.params.values())
    mean, var = T.predict(gp, Xs)
    assert mean.dtype == torch.float64 and torch.isfinite(mean).all()
    assert torch.isfinite(var).all()
    # an ordinary fit stays in float32
    assert not T.fit_sparse_gp(X, y, M=16, iters=5, device="cpu").refit_f64


def test_posterior_in_float64_when_its_float32_factor_fails(monkeypatch, capsys):
    """A float32 fit whose posterior Kmm (jitter 1e-5 sf2 + 1e-8, below
    the fit's) has no float32 Cholesky factor (forced here: the float32
    factorization reports failure) predicts and selects candidates in
    float64; JAX's float32 posterior is NaN there."""
    X, y, Xs = _data(n=120)
    gp = T.fit_sparse_gp(X, y, M=16, iters=5, device="cpu")
    assert gp.X.dtype == torch.float32
    want = T.predict(T.SparseGP({k: v.double() for k, v in gp.params.items()},
                                gp.X.double(), gp.y.double()), Xs)
    chol = T._cholesky
    monkeypatch.setattr(T, "_cholesky", lambda A: chol(A) if A.dtype == torch.float64
                        else torch.full_like(A, torch.nan))
    got = T.predict(gp, Xs)
    assert "float64" in capsys.readouterr().out
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and torch.equal(g, w)
    cand = T.batched_greedy_ei(gp, 2, X.min(0), X.max(0), X.mean(0), X.std(0),
                               grid_size=200, refine_iters=3)
    assert cand.dtype == torch.float64 and torch.isfinite(cand).all()


def test_greedy_ei_in_float64_when_a_float32_candidate_goes_nonfinite(monkeypatch,
                                                                      capsys):
    """A float32 greedy-EI round with a non-finite candidate (forced here:
    the believer's float32 B loses its Cholesky factor after the first
    update, as on a trained NA VAE's latents) is redone in float64, with
    one printed line: the float64 round's candidates, all finite."""
    X, y, _ = _data(n=120)
    gp = T.fit_sparse_gp(X, y, M=16, iters=5, device="cpu")
    args = (3, X.min(0), X.max(0), X.mean(0), X.std(0))
    kw = dict(grid_size=200, refine_iters=3, seed=1, capture=False)
    want = T.batched_greedy_ei(T._float64(gp), *args, **kw)
    step = T._candidate_step

    def broken(state, n):
        state, best = step(state, n)
        if best.dtype == torch.float32:
            best = torch.full_like(best, torch.nan)
        return state, best

    monkeypatch.setattr(T, "_candidate_step", broken)
    got = T.batched_greedy_ei(gp, *args, **kw)
    assert "float64" in capsys.readouterr().out
    assert got.dtype == torch.float64 and torch.equal(got, want)


def test_tf32_is_refused_on_the_card():
    """On a CUDA device the entry points raise while TF32 matmuls are on
    (no card is needed to reach the check)."""
    old = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="TF32"):
            T._check_precision(torch.device("cuda"))
        T._check_precision(torch.device("cpu"))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old

"""BO's stages on a trained NA VAE, and the VAE driver's curve across a
plateau drop, the port against the JAX package on the CPU.

One module fixture trains the DAGNN VAE with the JAX driver
(dagnn_tpu/cli/train_vae.py) on the corpus's first 80 rows after the
burn-in (72 train graphs, batches of 8, hs 16, nz 8, lr 1e-3, 5 epochs)
under a plateau schedule of patience 1 fed a constant metric, so that it
drops to 0.1 after epoch 3; and the port's driver with the same flags,
the same drop and the JAX init (tests/na_curve_check.py's set-up). Its
weights and latents are what the BO stages read.

Tolerances: each epoch's loss within tests/na_curve_check.py's RTOL of
JAX's; the GP's fitted parameters rtol 1e-3 / atol 1e-5; the greedy EI's
grid candidates (no refinement) equal, its refined ones within 5e-2 of
the box width: these latents' box is 0.04-0.2 wide a coordinate, so the
refinement's Adam (lr 0.05) crosses a fifth of it or more in a step and
rounding moves where it ends (read: up to 2.7e-2); greedy decodes equal
arrays; the share of valid stochastic decodes within 4 binomial standard
deviations of the difference of two shares, plus 1/N.
"""

import dataclasses
import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dagnn_tpu.cli import run_bo as jbo
from dagnn_tpu.cli import train_vae as jdriver
from dagnn_tpu.train import optim as joptim
from dagnn_tpu.vae import dagnn_vae as jvae
from dagnn_tpu.vae import sparse_gp as J
from dagnn_tpu_torch import convert
from dagnn_tpu_torch.cli import run_bo as tbo
from dagnn_tpu_torch.cli import train_vae as tdriver
from dagnn_tpu_torch.data.na import NAGraph, is_valid_enas
from dagnn_tpu_torch.train import optim as toptim
from dagnn_tpu_torch.vae import dagnn_vae as tvae
from dagnn_tpu_torch.vae import sparse_gp as T
from na_curve_check import RTOL

torch.set_num_threads(1)

EPOCHS = 5
# inducing points: at 72 rows of latents this tightly clustered, 40 or
# more make the float32 fit chaotic (Adam's first steps follow the signs of
# near-zero gradients, which rounding flips), in JAX as in the port
M = 10
FLAGS = ["--max-count", "80", "--hs", "16", "--nz", "8", "--batch-size", "8",
         "--infer-batch-size", "8", "--lr", "1e-3", "--epochs", str(EPOCHS),
         "--save-interval", str(EPOCHS), "--no-test", "--cpu"]


class _JaxPatience1(joptim.PlateauScheduler):
    """ReduceLROnPlateau at patience 1 fed a constant metric: the scale
    drops to 0.1 after epoch 3."""

    def __init__(self, factor=0.1, patience=10, min_lr=0.0):
        super().__init__(factor, 1, min_lr)

    def step(self, metric):
        return super().step(1.0)


class _Patience1(toptim.PlateauScheduler):
    def __init__(self, factor=0.1, patience=10):
        super().__init__(factor, 1)

    def step(self, metric):
        return super().step(1.0)


def _rows(res_dir):
    with open(os.path.join(res_dir, "train_loss.txt")) as f:
        return [[float(v) for v in r[1:]] for r in list(csv.reader(f))[1:]]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("trained")
    mp = pytest.MonkeyPatch()

    def init(self, seed):
        cfg = jvae.DAGNNVAEConfig(**dataclasses.asdict(self.cfg))
        tree = jvae.dagnn_vae_init(jax.random.PRNGKey(seed), cfg)
        return convert.params_from_numpy(jax.tree.map(np.asarray, tree), self.device)

    mp.setattr(jdriver, "PlateauScheduler", _JaxPatience1)
    mp.setattr(tdriver, "PlateauScheduler", _Patience1)
    mp.setattr(tdriver.VAEModel, "init", init)
    try:
        jparams = jdriver.main(FLAGS + ["--res_dir", str(root / "jax")])
        tdriver.main(FLAGS + ["--res_dir", str(root / "port")])
    finally:
        mp.undo()
    args = tdriver.parse_args(FLAGS)
    cfg = tvae.DAGNNVAEConfig(max_n=8, nvt=8, hs=args.hs, nz=args.nz,
                              num_layers=args.dagnn_layers, agg=args.dagnn_agg)
    return dict(root=root, jparams=jparams, jcfg=jvae.DAGNNVAEConfig(
        **dataclasses.asdict(cfg)), cfg=cfg,
        params=convert.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu"),
        mat=str(root / "jax" / f"final_structures6_latent_epoch{EPOCHS}.mat"))


def test_plateau_drop_curve_matches_jax(trained):
    """The port's per-epoch (loss, recon) through a drop after epoch 3
    within RTOL of the JAX driver's: both scale the gradients by the
    schedule's 0.1 before the clip and Adam at lr 1e-3."""
    j, t = _rows(trained["root"] / "jax"), _rows(trained["root"] / "port")
    assert len(j) == len(t) == EPOCHS
    for e, (a, b) in enumerate(zip(j, t), 1):
        np.testing.assert_allclose(b[:2], a[:2], rtol=RTOL, err_msg=f"epoch {e}")


def _valid_share(types, adj, nv, max_n):
    ok = [is_valid_enas(NAGraph(types=types[r][:nv[r]],
                                adj=adj[r][:nv[r], :nv[r]].astype(np.uint8)))
          and nv[r] == max_n for r in range(len(nv))]
    return float(np.mean(ok))


def test_bo_stages_match_jax_on_trained_weights(trained):
    """On the JAX-trained weights and latents: the GP fit at run_bo's
    defaults but M (10 inducing points of the 72 rows), its 50 greedy-EI
    candidates on run_bo's box and grid, kept on the grid and refined (and
    all finite where JAX's float32 EI underflows), the greedy decodes of
    the refined candidates and of 50
    training latents bit for bit, and the share of valid stochastic
    decodes of both sets (20 attempts each), port against JAX."""
    X, y, *_ = tbo.load_latents(trained["mat"])
    gj = J.fit_sparse_gp(X, y, M=M, iters=100, lr=5e-4, seed=0)
    gt = T.fit_sparse_gp(X, y, M=M, iters=100, lr=5e-4, seed=0, device="cpu")
    assert not gt.refit_f64
    for k, v in gj.params.items():
        np.testing.assert_allclose(gt.params[k].numpy(), v, rtol=1e-3, atol=1e-5,
                                   err_msg=k)
    box = (50, X.min(0), X.max(0), X.mean(0), X.std(0))
    f = lambda a: torch.tensor(np.asarray(a, np.float32))
    gp = T.SparseGP({k: f(v) for k, v in gj.params.items()}, f(gj.X), f(gj.y))
    width = X.max(0) - X.min(0)
    for refine, tol in ((0, 0.0), (50, 5e-2)):
        cj = J.batched_greedy_ei(gj, *box, seed=0, refine_iters=refine)
        ct = T.batched_greedy_ei(gp, *box, seed=0, refine_iters=refine).numpy()
        assert (np.abs(ct - cj) <= tol * width).all(), refine
    # an incumbent 15 standard deviations below the scores (the believer's
    # read -13.5 on the card at 100 epochs): every grid point's EI underflows in
    # float32, JAX's log EI is -inf and its refinement NaN; the port's
    # floor keeps every candidate finite
    low = gj.y.copy()
    low[np.argmin(low)] = -15.0
    nan_j = J.batched_greedy_ei(J.SparseGP(gj.params, gj.X, low), *box, seed=0)
    fin_t = T.batched_greedy_ei(T.SparseGP(gp.params, gp.X, f(low)), *box, seed=0)
    assert not np.isfinite(nan_j).all() and bool(torch.isfinite(fin_t).all())

    z = np.concatenate([cj, X[:50]]).astype(np.float32)
    want = jvae.dagnn_vae_decode(trained["jparams"], trained["jcfg"], jnp.asarray(z),
                                 stochastic=False)
    got = tvae.dagnn_vae_decode(trained["params"], trained["cfg"], torch.as_tensor(z),
                                stochastic=False)
    for a, b, what in zip(got, want, ("types", "adj", "nv")):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=what)

    attempts = 20
    zt = np.tile(z, (attempts, 1))
    jd = jvae.dagnn_vae_decode(trained["jparams"], trained["jcfg"], jnp.asarray(zt),
                               jax.random.PRNGKey(0))
    td = tvae.dagnn_vae_decode(trained["params"], trained["cfg"], torch.as_tensor(zt),
                               torch.Generator().manual_seed(0))
    pj, pt = (_valid_share(*(np.asarray(a) for a in d), 8) for d in (jd, td))
    n = len(zt)
    bound = 4 * np.sqrt(2 * max(pj * (1 - pj), 1.0 / n) / n) + 1.0 / n
    assert abs(pj - pt) <= bound, (pj, pt, bound)
    # the vote as run_bo casts it: one valid share a latent, both packages
    vj = jbo.decode_from_latent((trained["jcfg"], trained["jparams"]), z, attempts,
                                "ENAS", jax.random.PRNGKey(1))
    vt = tbo.decode_from_latent((trained["cfg"], trained["params"]), z, attempts,
                                "ENAS", torch.Generator().manual_seed(1))
    sj, st = (float(np.mean([a is not None for a in v])) for v in (vj, vt))
    assert abs(sj - st) <= 4 * np.sqrt(2 * max(sj * (1 - sj), 1.0 / len(z)) / len(z)) \
        + 1.0 / len(z), (sj, st)


def test_bo_diagnose_reads_the_stages(trained, monkeypatch, capsys):
    """scripts.bo_diagnose on the port's run of the fixture (its checkpoint
    and latents; one round on the grid, 5 attempts, 10 training latents,
    candidates scored by corpus lookup):
    a.'s shares, b.'s candidate statistics and c.'s GP, each in range, and
    the training latents paired with the corpus's train split."""
    from dagnn_tpu_torch.scripts import bo_diagnose as bd
    from dagnn_tpu_torch.vae import enas_eval

    class NoScores:        # the surrogate's training on the whole corpus, cut
        def __init__(self, path, **kw):
            self.score = lambda arc: None

        def quality(self):
            return "none"

    monkeypatch.setattr(enas_eval, "EvalENAS", NoScores)
    monkeypatch.setattr(bd, "ROUNDS", 1)
    monkeypatch.setattr(bd, "REFINE", (0,))
    monkeypatch.setattr(bd, "ROWS", 10)
    monkeypatch.setattr(bd, "ATTEMPTS", 5)
    port = trained["root"] / "port"
    out = bd.main(["--cpu", "--latent", str(port / f"final_structures6_latent_epoch{EPOCHS}.mat"),
                   "--checkpoint", str(port / f"DAGNN_0_{EPOCHS}.ckpt"), "--hs", "16",
                   "--nz", "8", "--max-count", "80", "--M", str(M), "--gp-iters", "5"])
    a, (r,) = out["train"], out["rounds"][0]
    assert a["n"] == 10 and all(0 <= a[k] <= 1 for k in ("valid", "own", "valid_1", "own_1"))
    assert out["scale"] > 0 and r["round"] == 0 and r["nonfinite"] == 0
    assert 0 <= r["valid"] <= 1 and 0 <= r["on_bounds"] <= 1
    assert 0 < r["near_min"] <= r["near_med"] <= r["near_max"]
    assert r["gp"]["dtype"] in ("float32", "float64") and r["gp"]["sn2"] > 0
    text = capsys.readouterr().out
    assert "a. 10 training latents" in text and "d. refine 0, round 0" in text
    with pytest.raises(SystemExit):        # latents of another corpus cut
        bd.main(["--cpu", "--latent", str(port / f"final_structures6_latent_epoch{EPOCHS}.mat"),
                 "--checkpoint", str(port / f"DAGNN_0_{EPOCHS}.ckpt"), "--hs", "16",
                 "--nz", "8", "--max-count", "90"])

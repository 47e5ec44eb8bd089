"""The port's latent scoring and BO (dagnn_tpu_torch/vae/enas_eval.py,
cli/run_bo.py, cli/summarize.py, utils/plot.py) against the JAX package's
on the CPU: featurize_row; the ENAS surrogate trained from the JAX
surrogate's initial weights on a 300-row slice of the repo's corpus; the
majority vote over the same decoded arrays; run_bo's GP-only lines from
the same .mat; summarize's text. Then the port's own: one BO round on a
tiny port DAGNN checkpoint, the plots, and the card-only default.

Tolerances: the surrogate's predictions 1e-4 of max|ref| and quality()'s
numbers within 1e-3 (400 Adam epochs in float32 on both sides); run_bo's
RMSE / ll / Pearson r within 1e-3 each (both fit in float32, printed to 4
decimals); the vote, featurize_row and summarize's text equal.
"""

import ast
import gzip
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch

from dagnn_tpu.cli import run_bo as jbo
from dagnn_tpu.cli import summarize as jsum
from dagnn_tpu.data.na import parse_enas_row as jparse
from dagnn_tpu.data.na import parse_bn_row as jparse_bn
from dagnn_tpu.data.na import synthetic_bn_rows
from dagnn_tpu.vae import dagnn_vae as jvae
from dagnn_tpu.vae import dvae as jdvae
from dagnn_tpu.vae import enas_eval as jev
from dagnn_tpu_torch.cli import run_bo as tbo
from dagnn_tpu_torch.cli import summarize as tsum
from dagnn_tpu_torch.cli import train_vae as tdriver
from dagnn_tpu_torch.data.na import parse_enas_row
from dagnn_tpu_torch.utils.plot import plot_dag
from dagnn_tpu_torch.vae import enas_eval as tev

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "data", "final_structures6.txt.gz")


@pytest.fixture(scope="module")
def corpus_slice(tmp_path_factory):
    """The corpus's first 300 rows as a plain-text corpus file."""
    path = tmp_path_factory.mktemp("corpus") / "enas300.txt"
    with gzip.open(CORPUS, "rt") as f, open(path, "w") as out:
        for _, line in zip(range(300), f):
            out.write(line)
    return str(path)


def _rows(path, n):
    with open(path) as f:
        return [ast.literal_eval(line)[0] for _, line in zip(range(n), f)]


def test_featurize_row_matches_jax(corpus_slice):
    for row in _rows(corpus_slice, 50):
        np.testing.assert_array_equal(tev.featurize_row(row), jev.featurize_row(row))
        np.testing.assert_array_equal(tev.featurize_row(str(row)),
                                      jev.featurize_row(str(row)))


def _jax_init(d, hidden, seed):
    """EvalENAS._fit's initial weights in the JAX package
    (dagnn_tpu/vae/enas_eval.py:77-86)."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    return {"w1": jax.random.normal(k1, (d, hidden)) * (2.0 / d) ** 0.5,
            "b1": jnp.zeros(hidden),
            "w2": jax.random.normal(k2, (hidden, hidden)) * (2.0 / hidden) ** 0.5,
            "b2": jnp.zeros(hidden),
            "w3": jax.random.normal(k3, (hidden, 1)) * (1.0 / hidden) ** 0.5,
            "b3": jnp.zeros(1)}


def test_enas_surrogate_matches_jax(corpus_slice, monkeypatch):
    monkeypatch.setattr(
        tev.EvalENAS, "init_params",
        lambda self, d, hidden, seed: {k: torch.tensor(np.asarray(v)) for k, v in
                                       _jax_init(d, hidden, seed).items()})
    want = jev.EvalENAS(corpus_slice)
    got = tev.EvalENAS(corpus_slice, device="cpu")
    assert got.table == want.table and len(got.table) == 300
    assert (got.mu, got.sd) == (want.mu, want.sd)
    X = np.stack([tev.featurize_row(r) for r in _rows(corpus_slice, 300)])
    ref = np.asarray(want._mlp(want._params, jnp.asarray(X))).ravel()
    assert np.abs(got.predict(X) - ref).max() <= 1e-4 * np.abs(ref).max()
    assert abs(got.val_rmse - want.val_rmse) <= 1e-3
    assert abs(got.val_pearson - want.val_pearson) <= 1e-3
    # corpus rows score exactly; an unseen row through the surrogate
    row = _rows(corpus_slice, 1)[0]
    assert got.score(str(row)) == want.score(str(row))
    unseen = str([[0]] + [[1] + [1] * i for i in range(1, 6)])
    assert unseen not in got.table
    assert abs(got.score(unseen) - want.score(unseen)) <= 1e-3
    assert got.score("[[0], [1,") is None


def _decoded(graphs, n, attempts, max_n, seed):
    """attempts x n decoded rows (row a * n + i: attempt a of latent i),
    each one of `graphs`, some made invalid (an edge dropped), as dense
    arrays (types, adj, nv)."""
    rng = np.random.default_rng(seed)
    R = attempts * n
    types = np.zeros((R, max_n), np.int32)
    adj = np.zeros((R, max_n, max_n), np.float32)
    nv = np.zeros(R, np.int32)
    for r in range(R):
        g = graphs[int(rng.integers(len(graphs))) if rng.random() < 0.5
                   else r % n % len(graphs)]
        k = g.num_nodes
        types[r, :k], adj[r, :k, :k], nv[r] = g.types, g.adj, k
        if rng.random() < 0.3:               # drop the chain edge 0 -> 1
            adj[r, 0, 1] = 0
    return types, adj, nv


@pytest.mark.parametrize("data_type", ["ENAS", "BN"])
def test_majority_vote_matches_jax(corpus_slice, monkeypatch, data_type):
    """The port's vote on decoded arrays against JAX's decode_from_latent
    with its decoder patched to return the same arrays."""
    attempts, n = 6, 5
    if data_type == "ENAS":
        graphs = [jparse(r) for r in _rows(corpus_slice, 3)]
        max_n = nvt = 8
        cfg = jvae.DAGNNVAEConfig(max_n=8, nvt=8, hs=4, nz=2)
        bundle = (cfg, None)
    else:
        graphs = [jparse_bn(ast.literal_eval(r)[0])
                  for r in synthetic_bn_rows(3, seed=2, score=False)]
        max_n = nvt = 10
        cfg = jdvae.DVAEConfig(max_n=10, nvt=10, hs=4, nz=2)
        bundle = (cfg, {"dec": None})
    types, adj, nv = _decoded(graphs, n, attempts, max_n, seed=1)
    fixed = lambda *a, **k: (types, adj, nv)
    monkeypatch.setattr(jvae, "dagnn_vae_decode", fixed)
    monkeypatch.setattr(jdvae, "dvae_decode", fixed)
    want = jbo.decode_from_latent(bundle, np.zeros((n, 2), np.float32), attempts,
                                  data_type, jax.random.PRNGKey(0))
    got = tbo.majority_vote(types, adj, nv, n, attempts, data_type, max_n, nvt)
    assert got == want
    assert any(v is not None for v in got)


def _write_mat(path, n_train=150, n_test=30, d=4, seed=0):
    rng = np.random.default_rng(seed)
    Z = rng.standard_normal((n_train + n_test, d)).astype(np.float32)
    Y = 0.7 + 0.05 * np.sin(Z[:, 0]) + 0.01 * rng.standard_normal(len(Z))
    scipy.io.savemat(path, {"Z_train": Z[:n_train], "Z_test": Z[n_train:],
                            "Y_train": Y[:n_train], "Y_test": Y[n_train:]})


def _numbers(path):
    return [[float(x.split(":")[1]) for x in line.split(",")]
            for line in open(path)]


def test_run_bo_gp_lines_match_jax(tmp_path):
    mat = str(tmp_path / "latent.mat")
    _write_mat(mat)
    flags = ["--latent", mat, "--seeds", "2", "--M", "20", "--gp-iters", "20",
             "--gp-lr", "1e-2", "--cpu"]
    jbo.main(flags + ["--res_dir", str(tmp_path / "jax")])
    out = tbo.main(flags + ["--res_dir", str(tmp_path / "port")])
    want = _numbers(tmp_path / "jax" / "Test_RMSE_ll.txt")
    got = _numbers(tmp_path / "port" / "Test_RMSE_ll.txt")
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    assert [r[3] for r in out["gp"]] == [False, False]     # no float64 refit
    assert not (tmp_path / "port" / "best_arc_scores.txt").exists()


def test_run_bo_one_round_on_a_port_checkpoint(tmp_path, corpus_slice, capsys):
    """A tiny DAGNN trained by the port's train_vae, then one BO round:
    the GP on its latents, greedy EI, the batched decode and the vote,
    the surrogate scorer (on the corpus slice). It runs and writes its
    files; the round's line gives its valid count and its seconds."""
    vae = str(tmp_path / "vae")
    tdriver.main(["--max-count", "40", "--hs", "8", "--nz", "4", "--batch-size",
                  "12", "--epochs", "1", "--save-interval", "1", "--cpu",
                  "--no-test", "--res_dir", vae])
    res = str(tmp_path / "bo")
    out = tbo.main(["--latent", f"{vae}/final_structures6_latent_epoch1.mat",
                    "--checkpoint", f"{vae}/DAGNN_0_1.ckpt", "--bo", "--seeds", "1",
                    "--BO_rounds", "1", "--bo-batch", "3", "--decode-attempts", "4",
                    "--M", "10", "--gp-iters", "5", "--refine-iters", "3",
                    "--hs", "8", "--nz", "4", "--enas-corpus", corpus_slice,
                    "--res_dir", res, "--cpu"])
    printed = capsys.readouterr().out
    assert len(open(f"{res}/Test_RMSE_ll.txt").readlines()) == 1
    assert "surrogate val RMSE" in open(f"{res}/scorer_quality.txt").read()
    (r,) = out["rounds"]
    assert r["n"] == 3 and 0 <= r["valid"] <= 3 and "BO round 0" in printed
    assert "greedy EI" in printed and "decode" in printed
    assert os.path.exists(f"{res}/best_arc_scores.txt") == (r["valid"] > 0)
    # the S-VAE and variant checkpoints are latent-scored only
    with pytest.raises(SystemExit, match="latent-scored"):
        tbo.load_model(tbo.parse_args(["--latent", "x", "--checkpoint", "c",
                                       "--model", "SVAE", "--cpu"]), "cpu")


def test_summarize_prints_what_jax_prints(tmp_path, capsys):
    with open(tmp_path / "Test_RMSE_ll.txt", "w") as f:
        for v in (0.81, 0.77, 0.93):
            f.write(f"Test RMSE: {v:.4f}, ll: {-v - 0.4:.4f}, Pearson r: {v / 2:.4f}\n")
    with open(tmp_path / "best_arc_scores.txt", "w") as f:
        f.write("[[0], [1, 1]], 0.7401\n[[2], [3, 0]], 0.7488\n")
    jsum.main(["--res_dir", str(tmp_path)])
    want = capsys.readouterr().out
    tsum.main(["--res_dir", str(tmp_path)])
    assert capsys.readouterr().out == want and "3 seeds" in want


def test_plots_write_pngs(tmp_path):
    pytest.importorskip("matplotlib")
    g = parse_enas_row([[2], [3, 1], [4, 0, 1]])
    for name, kw in (("arc", {}), ("arc_bb", {"backbone": True})):
        p = plot_dag(g, str(tmp_path), name, **kw)
        assert os.path.getsize(p) > 0 and p.endswith(".png")
    assert plot_dag(None, str(tmp_path), "bad", pdf=True).endswith(".pdf")
    with open(tmp_path / "best_arc_scores.txt", "w") as f:
        f.write("[[0]], 0.7401\n[[2]], 0.7488\n")
    assert os.path.getsize(tsum.plot_best_arcs(str(tmp_path))) > 0


def test_run_bo_without_cpu_needs_a_card(tmp_path):
    """Without --cpu run_bo runs on the card, and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: run_bo runs there")
    mat = str(tmp_path / "latent.mat")
    _write_mat(mat)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbo.main(["--latent", mat, "--res_dir", str(tmp_path / "r")])
    assert not (tmp_path / "r").exists()

"""The BO loop's captured programs on the CPU: the GP fit's Adam steps and
a greedy-EI candidate (dagnn_tpu_torch/vae/sparse_gp.py FIT, EI), the
D-VAE decode (vae/dvae.py DECODE), the ENAS surrogate's train step and MLP
(vae/enas_eval.py FIT, PREDICT), and run_bo's counts of them. On CPU
tensors a CapturedStep stages its inputs and state into its own buffers
and calls the step function directly, so these tests reach what a replay
reads: each captured form is held bit for bit to its eager form
(capture=False), which is the JAX package's jitted program written out,
and to the JAX package itself at tests/test_torch_sparse_gp.py's
tolerances (fitted parameters rtol 1e-3 / atol 1e-6; greedy EI's
candidates within 1e-3 of the box width) and at tests/test_torch_vae.py's
greedy-decode parity (equal arrays). The card's cases are in
tests/test_torch_cuda.py.

Sizes: 200 rows of seeded numpy data, D 4, M 20, 6 Adam steps; a grid of
500 points, 10 refinement steps; decodes of 2-6 latents at hs 10; the
surrogate on the corpus's first 300 rows, 30 epochs; run_bo on a 40-graph
DAGNN trained for one epoch, 2 rounds of 3 candidates.
"""

import gzip

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dagnn_tpu.vae import dvae as jd
from dagnn_tpu.vae import sparse_gp as J
from dagnn_tpu_torch import convert
from dagnn_tpu_torch.cli import run_bo as tbo
from dagnn_tpu_torch.cli import train_vae as tdriver
from dagnn_tpu_torch.vae import dvae as td
from dagnn_tpu_torch.vae import enas_eval as tev
from dagnn_tpu_torch.vae import sparse_gp as T

torch.set_num_threads(1)


def _data(n=200, d=4, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d))
    y = np.sin(X[:, 0]) + 0.5 * np.cos(X[:, 1]) + 0.1 * rng.standard_normal(n)
    return X, y


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("masked", [False, True], ids=["rows", "padded"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_fit_captured_equals_eager_and_jax(dtype, masked):
    """The fit through FIT (one Adam step a graph, replayed 6 times) bit for
    bit the eager loop in the rows' dtype, and in float32 within rtol 1e-3
    / atol 1e-6 of JAX's fit (which runs in float32; Adam's first steps
    follow the gradients' signs, which float64 flips on a few of the
    inducing points' near-zero gradients). A second fit of the key
    copies its fresh start in and replays: no new capture, and the first
    fit's parameters are its own, not the buffers the second one
    overwrote."""
    X, y = _data()
    Xt, yt = (torch.as_tensor(a, dtype=dtype) for a in (X, y))
    kw = dict(M=20, iters=6, lr=1e-2, pad_to=260 if masked else None)
    eager = T.fit_sparse_gp(Xt, yt, seed=0, capture=False, **kw)
    c0, r0 = T.FIT.captures, T.FIT.replays
    got = T.fit_sparse_gp(Xt, yt, seed=0, **kw)
    _equal(got.params, eager.params)
    assert not got.refit_f64 and got.params["Z"].dtype == dtype
    assert T.FIT.captures - c0 <= 1 and T.FIT.replays - r0 == 6
    if dtype == torch.float32:
        want = J.fit_sparse_gp(X, y, seed=0, **kw)
        for k, v in want.params.items():
            np.testing.assert_allclose(got.params[k].numpy(), v, rtol=1e-3, atol=1e-6,
                                       err_msg=k)
    first = {k: v.clone() for k, v in got.params.items()}
    c1 = T.FIT.captures
    other = T.fit_sparse_gp(Xt, yt, seed=1, **kw)
    _equal(other.params, T.fit_sparse_gp(Xt, yt, seed=1, capture=False, **kw).params)
    assert T.FIT.captures == c1
    _equal(got.params, first)


def test_fit_float64_refit_captured_equals_eager():
    """Scores of order 1e20: the float32 fit ends NaN and is redone in
    float64 (two keys of FIT); the captured fits equal the eager ones."""
    X, y = _data(n=120)
    kw = dict(M=16, iters=5, lr=1e-2, device="cpu")
    eager = T.fit_sparse_gp(X, 1e20 * y, capture=False, **kw)
    got = T.fit_sparse_gp(X, 1e20 * y, **kw)
    assert got.refit_f64 and eager.refit_f64
    _equal(got.params, eager.params)
    assert all(v.dtype == torch.float64 for v in got.params.values())


def _port_gp(gj, dtype):
    f = lambda a: torch.tensor(np.asarray(a, np.float32)).to(dtype)
    return T.SparseGP({k: f(v) for k, v in gj.params.items()}, f(gj.X), f(gj.y))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_greedy_ei_captured_equals_eager_and_jax(dtype):
    """One round of 3 candidates through EI (a replay each) bit for bit the
    eager candidates from the same fitted parameters and seed; in float32
    within 1e-3 of the box width of JAX's (which runs in float32). A second
    round of the key replays without a new capture."""
    X, y = _data()
    gj = J.fit_sparse_gp(X, y, M=20, iters=5, lr=1e-2, seed=0)
    gp = _port_gp(gj, dtype)
    lo, hi = X.min(0), X.max(0)
    args = (3, lo, hi, X.mean(0), X.std(0))
    kw = dict(grid_size=500, refine_iters=10, seed=1)
    eager = T.batched_greedy_ei(gp, *args, capture=False, **kw)
    c0, r0 = T.EI.captures, T.EI.replays
    got = T.batched_greedy_ei(gp, *args, **kw)
    assert got.shape == (3, 4) and got.dtype == dtype and torch.equal(got, eager)
    assert T.EI.captures - c0 <= 1 and T.EI.replays - r0 == 3
    again = T.batched_greedy_ei(gp, *args, **{**kw, "seed": 2})
    assert torch.equal(again, T.batched_greedy_ei(gp, *args, capture=False,
                                                  **{**kw, "seed": 2}))
    assert T.EI.captures - c0 <= 1 and T.EI.replays - r0 == 6
    if dtype == torch.float32:
        want = J.batched_greedy_ei(gj, *args, **kw)
        assert (np.abs(got.numpy() - want) <= 1e-3 * (hi - lo)).all()


def test_draw_types_is_multinomials_draw():
    """The decode's vertex-type draw gives torch.multinomial(probs, 1)'s
    numbers from the same generator state, and leaves the generator where
    multinomial leaves it."""
    probs = torch.softmax(torch.randn(64, 8, generator=torch.Generator().manual_seed(2)), -1)
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    for _ in range(3):
        assert torch.equal(td._draw_types(probs, g1),
                           torch.multinomial(probs, 1, generator=g2)[:, 0])
    assert torch.equal(torch.rand(4, generator=g1), torch.rand(4, generator=g2))


def _jax_decoder(dec_agg, max_n=6):
    cfg_kw = dict(max_n=max_n, nvt=8, hs=10, nz=4, vid=True, dec_agg=dec_agg)
    jcfg, tcfg = jd.DVAEConfig(**cfg_kw), td.DVAEConfig(**cfg_kw)
    dec = jd.dvae_decoder_init(jax.random.PRNGKey(3), jcfg)
    attn = None
    if dec_agg == "attn":
        from dagnn_tpu.ops.linear import linear_init
        attn = {"attn_lin": linear_init(jax.random.PRNGKey(9), jcfg.nvt + jcfg.vs, 1)}
    port = lambda t: None if t is None else {
        k: torch.tensor(np.asarray(v)) for k, v in
        convert.flatten_tree(jax.tree.map(np.asarray, t)).items()}
    return jcfg, tcfg, dec, attn, port(dec), port(attn)


@pytest.mark.parametrize("dec_agg", ["gated_sum", "attn"])
def test_decode_captured_equals_eager_and_jax(dec_agg):
    """Greedy: DECODE's decode equals JAX's arrays (test_torch_vae.py's
    parity) and the eager decode's. Stochastic: the captured decode draws
    what the eager one draws from a generator of the same seed, batch 2
    and 5 (two keys)."""
    jcfg, tcfg, jdec, jattn, dec, attn = _jax_decoder(dec_agg)
    rng = np.random.default_rng(4)
    z = 2.0 * rng.standard_normal((6, 4)).astype(np.float32)
    want = jd.dvae_decode(jdec, jcfg, jnp.asarray(z), stochastic=False, attn_params=jattn)
    got = td.dvae_decode(dec, tcfg, torch.as_tensor(z), stochastic=False, attn_params=attn)
    eager = td.dvae_decode(dec, tcfg, torch.as_tensor(z), stochastic=False,
                           attn_params=attn, capture=False)
    for a, b, c, what in zip(got, want, eager, ("types", "adj", "nv")):
        np.testing.assert_array_equal(a, b, err_msg=what)
        np.testing.assert_array_equal(a, c, err_msg=what)
    assert (got[2] > 2).any() and got[1].sum() > 0
    for B in (2, 5):
        zb = torch.as_tensor(z[:B])
        a = td.dvae_decode(dec, tcfg, zb, torch.Generator().manual_seed(7), attn_params=attn)
        b = td.dvae_decode(dec, tcfg, zb, torch.Generator().manual_seed(7), attn_params=attn,
                           capture=False)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def corpus_slice(tmp_path_factory):
    """The corpus's first 300 rows as a plain-text corpus file."""
    import os
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "data", "final_structures6.txt.gz")
    path = tmp_path_factory.mktemp("corpus") / "enas300.txt"
    with gzip.open(src, "rt") as f, open(path, "w") as out:
        for _, line in zip(range(300), f):
            out.write(line)
    return str(path)


def test_enas_surrogate_captured_equals_eager(corpus_slice):
    """FIT's step (a replay an epoch) leaves the parameters the eager
    epochs leave, bit for bit, and PREDICT's MLP predicts what the eager
    one does; a second surrogate of the key replays without a capture."""
    eager = tev.EvalENAS(corpus_slice, epochs=30, device="cpu", capture=False)
    c0, r0 = tev.FIT.captures, tev.FIT.replays
    got = tev.EvalENAS(corpus_slice, epochs=30, device="cpu")
    _equal(got._params, eager._params)
    assert (got.val_rmse, got.val_pearson) == (eager.val_rmse, eager.val_pearson)
    X = np.stack([tev.featurize_row(r) for r in list(got.table)[:40]])
    np.testing.assert_array_equal(got.predict(X), eager.predict(X))
    assert tev.FIT.captures - c0 <= 1 and tev.FIT.replays - r0 == 30
    first = {k: v.clone() for k, v in got._params.items()}
    again = tev.EvalENAS(corpus_slice, epochs=30, device="cpu", seed=1)
    assert tev.FIT.captures - c0 <= 1 and tev.FIT.replays - r0 == 60
    _equal(got._params, first)
    assert not torch.equal(again._params["w1"], got._params["w1"])


def test_run_bo_captured_equals_eager(tmp_path, corpus_slice, capsys):
    """Two BO rounds on a tiny DAGNN checkpoint, captured and eager: the
    same rounds and files; the captured run stages each program once a key
    (the fit unpadded and padded, one EI, one decode, the surrogate's step,
    its MLP at the validation rows and at one row) and prints its counts."""
    vae = str(tmp_path / "vae")
    tdriver.main(["--max-count", "40", "--hs", "8", "--nz", "4", "--batch-size",
                  "12", "--epochs", "1", "--save-interval", "1", "--cpu",
                  "--no-test", "--res_dir", vae])
    flags = ["--latent", f"{vae}/final_structures6_latent_epoch1.mat",
             "--checkpoint", f"{vae}/DAGNN_0_1.ckpt", "--bo", "--seeds", "1",
             "--BO_rounds", "2", "--bo-batch", "3", "--decode-attempts", "4",
             "--M", "10", "--gp-iters", "5", "--refine-iters", "3", "--hs", "8",
             "--nz", "4", "--enas-corpus", corpus_slice, "--cpu"]
    tbo.release_graphs()
    got = tbo.main(flags + ["--res_dir", str(tmp_path / "cap")])
    printed = capsys.readouterr().out
    want = tbo.main(flags + ["--res_dir", str(tmp_path / "eager")], capture=False)
    strip = lambda r: [{k: v for k, v in x.items() if not k.endswith("_s")} for x in r]
    assert strip(got["rounds"]) == strip(want["rounds"]) and len(got["rounds"]) == 2
    assert got["gp"] == want["gp"]
    for f in ("Test_RMSE_ll.txt", "best_arc_scores.txt"):
        a, b = tmp_path / "cap" / f, tmp_path / "eager" / f
        assert a.exists() == b.exists() and (not a.exists()
                                             or a.read_text() == b.read_text())
    g = got["graphs"]
    assert g["GP fit"] == (2, 3 * 5) and g["greedy EI"] == (1, 2 * 3)
    assert g["decode"] == (1, 2) and g["surrogate fit"] == (1, 400)
    assert g["surrogate predict"][0] <= 2
    assert "captured programs (captures / replays) this run: GP fit 2 / 15" in printed
    assert all(v == (0, 0) for v in want["graphs"].values())

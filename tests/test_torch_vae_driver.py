"""The port's VAE driver (dagnn_tpu_torch/cli/train_vae.py) against the JAX
package's, end to end on the CPU: the same flags and data through
`main(argv)` of both, from the same initial weights (the port's
VAEModel.init monkeypatched to carry the JAX driver's dagnn_vae_init over)
and with the reparameterization noise off on both sides (each package's
`reparameterize` patched to return mu: their random streams differ).

Sizes: the repo's ENAS corpus at --max-count 60 (54 train / 6 test), hs 16,
nz 6, 2 layers, batch 18 (three full steps, so the JAX driver compiles one
scan), 2 epochs, latents every epoch. Tolerances: the loss file's columns,
the test NLL and the latents at rtol 5e-4 / atol 5e-5 (the f32 grads
tolerance: two epochs of Adam steps carry the gradients' rounding
differences into the weights); scores equal. The port's resumed run is
held to its uninterrupted one bit for bit (DAGNN, and SVAE_GraphRNN_BFS,
whose BFS orders come from a host generator seeded per epoch). Every
other --model trains two epochs on 30 graphs and writes its latents.
"""

import csv
import dataclasses
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from dagnn_tpu.cli import train_vae as jdriver
from dagnn_tpu.vae import dagnn_vae as jvae
from dagnn_tpu_torch import convert
from dagnn_tpu_torch.cli import train_vae as tdriver
from dagnn_tpu_torch.vae import dagnn_vae as tvae

torch.set_num_threads(1)

SMALL = ["--max-count", "60", "--hs", "16", "--nz", "6", "--batch-size", "18",
         "--infer-batch-size", "64", "--epochs", "2", "--save-interval", "1",
         "--cpu"]
RTOL, ATOL = 5e-4, 5e-5


@pytest.fixture
def no_noise(monkeypatch):
    mu_only = lambda rng, mu, logvar, eps_scale=0.01, training=True: mu
    monkeypatch.setattr(jvae, "reparameterize", mu_only)
    monkeypatch.setattr(jdriver, "reparameterize", mu_only)
    monkeypatch.setattr(tvae, "reparameterize", mu_only)
    monkeypatch.setattr(tdriver, "reparameterize", mu_only)


@pytest.fixture
def jax_weights(monkeypatch):
    def init(self, seed):
        cfg = jvae.DAGNNVAEConfig(**dataclasses.asdict(self.cfg))
        tree = jvae.dagnn_vae_init(jax.random.PRNGKey(seed), cfg)
        return convert.params_from_numpy(jax.tree.map(np.asarray, tree),
                                         self.device)
    monkeypatch.setattr(tdriver.VAEModel, "init", init)


def _rows(res_dir):
    with open(os.path.join(res_dir, "train_loss.txt")) as f:
        return [[float(v) for v in r] for r in list(csv.reader(f))[1:]]


def _nll(res_dir):
    with open(os.path.join(res_dir, "test_results.txt")) as f:
        return [float(line.rsplit(":", 1)[1]) for line in f]


def _latents(res_dir, epoch):
    with open(os.path.join(res_dir, f"final_structures6_latent_epoch{epoch}.pkl"),
              "rb") as f:
        return pickle.load(f)


def test_dagnn_driver_matches_jax(tmp_path, no_noise, jax_weights):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jdriver.main(SMALL + ["--res_dir", jdir])
    tdriver.main(SMALL + ["--res_dir", tdir])
    j, t = _rows(jdir), _rows(tdir)
    assert [r[0] for r in t] == [r[0] for r in j] == [1, 2]
    np.testing.assert_allclose(np.asarray(t)[:, 1:], np.asarray(j)[:, 1:],
                               rtol=RTOL, atol=ATOL)
    assert t[1][1] < t[0][1] and np.isfinite(np.asarray(t)).all()
    np.testing.assert_allclose(_nll(tdir), _nll(jdir), rtol=RTOL, atol=ATOL)
    for epoch in (1, 2):
        jz, tz = _latents(jdir, epoch), _latents(tdir, epoch)
        assert tz[0].shape == (54, 6) and tz[2].shape == (6, 6)
        for a, b in zip(tz, jz):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
        assert os.path.exists(os.path.join(
            tdir, f"final_structures6_latent_epoch{epoch}.mat"))
    # the port reads only its own cache and checkpoints
    assert sorted(f for f in os.listdir(tdir) if f.endswith((".npz", ".ckpt", ".pkl"))
                  and "latent" not in f) == [
        "DAGNN_0_1.ckpt", "DAGNN_0_2.ckpt", "final_structures6_torch.npz"]


def test_resume_matches_uninterrupted(tmp_path):
    """Port only, with its own weights and noise: 3 epochs in one run
    against 2 epochs and a --load-latest-model run to 3 in the same
    directory (the cache read back, the permutation generator
    fast-forwarded, the noise reseeded by epoch, the scheduler restored):
    the same loss rows, latents, parameters and optimizer state bit for
    bit."""
    whole, part = str(tmp_path / "whole"), str(tmp_path / "resumed")
    flags = lambda d, e: SMALL[:-5] + ["--epochs", str(e), "--save-interval", "1",
                                       "--cpu", "--res_dir", d]
    tdriver.main(flags(whole, 3))
    tdriver.main(flags(part, 2))
    tdriver.main(flags(part, 3) + ["--load-latest-model"])
    assert _rows(part) == _rows(whole)
    for a, b in zip(_latents(part, 3), _latents(whole, 3)):
        np.testing.assert_array_equal(a, b)
    a, b = (torch.load(os.path.join(d, "DAGNN_0_3.ckpt"), weights_only=True)
            for d in (whole, part))
    assert a["results"] == b["results"] and a["epoch"] == b["epoch"] == 3
    for part_ in ("params", "opt_state"):
        fa, fb = convert.flatten_tree(a[part_]), convert.flatten_tree(b[part_])
        assert fa.keys() == fb.keys()
        for k in fa:
            assert torch.equal(fa[k], fb[k]), (part_, k)
    assert int(b["opt_state"]["count"]) == 3 * 3
    # --continue-from reads a named epoch's checkpoint
    tdriver.main(flags(part, 3) + ["--continue-from", "2", "--no-test"])
    assert _rows(part)[-1] == _rows(whole)[-1]


# per model, a leaf whose shape does not depend on nz (kept by a partial
# load into a model with a wider latent)
KEPT = {"SVAE": "grue.w_hh", "SVAE_oneshot": "enc1.w",
        "SVAE_GraphRNN": "grud_edge.w_hh", "SVAE_GraphRNN_BFS": "grud_edge.w_hh",
        "DVAE_DeepGMG": "grue.0.w_hh"}


@pytest.mark.parametrize("model, flags", [
    ("DAGNN_BN", ["--data-type", "BN", "--nvt", "8", "--bidirectional"]),
    ("DVAE", []),
    ("DVAE_BN", ["--data-type", "BN", "--nvt", "8", "--bidirectional"]),
    ("SVAE", []),
    ("SVAE_oneshot", []),
    ("SVAE_GraphRNN", []),
    ("SVAE_GraphRNN_BFS", []),
    ("DVAE_GCN", []),
    ("DVAE_fast", []),
    ("DVAE_DeepGMG", []),
])
def test_other_models_train(tmp_path, model, flags):
    """Every other --model trains on the CPU (DAGNN_BN and DVAE_BN on the
    synthetic BN corpus, the rest on the repo's ENAS corpus): finite
    losses, latents of the expected shape; a run with a wider latent (nz
    5) starts from a partial load of that checkpoint and trains."""
    d = str(tmp_path / model)
    argv = lambda nz, res: ["--model", model, "--max-count", "30", "--hs", "8",
                            "--nz", str(nz), "--batch-size", "9", "--epochs", "2",
                            "--save-interval", "2", "--cpu", "--res_dir", res] + flags
    tdriver.main(argv(4, d))
    rows = _rows(d)
    assert len(rows) == 2 and np.isfinite(np.asarray(rows)).all()
    z = _latents(d, 2)
    assert z[0].shape == (27, 4) and z[2].shape == (3, 4)
    saved = torch.load(os.path.join(d, f"{model}_0_2.ckpt"), weights_only=True)
    wide = tdriver.main(argv(5, d + "_wide") + [
        "--load-partial", os.path.join(d, f"{model}_0_2.ckpt"), "--epochs", "1",
        "--no-test"])
    assert all(torch.isfinite(v).all() for v in wide.values())
    assert "fc1.w" in saved["params"] and wide["fc1.w"].shape[0] == 5
    kept = KEPT.get(model, "dec.grud.0.w_hh")
    assert saved["params"][kept].shape == wide[kept].shape


def test_svae_bfs_resume_matches_uninterrupted(tmp_path):
    """SVAE_GraphRNN_BFS draws a random BFS order per graph and batch from
    the model's host generator, which the driver seeds from (--seed,
    epoch): 3 epochs in one run against 2 and a --load-latest-model run to
    3 give the same loss rows, latents and parameters bit for bit."""
    whole, part = str(tmp_path / "whole"), str(tmp_path / "resumed")
    flags = lambda d, e: ["--model", "SVAE_GraphRNN_BFS", "--max-count", "40",
                          "--hs", "8", "--nz", "4", "--batch-size", "12",
                          "--epochs", str(e), "--save-interval", "1", "--cpu",
                          "--res_dir", d]
    tdriver.main(flags(whole, 3))
    tdriver.main(flags(part, 2))
    tdriver.main(flags(part, 3) + ["--load-latest-model"])
    assert _rows(part) == _rows(whole)
    for a, b in zip(_latents(part, 3), _latents(whole, 3)):
        np.testing.assert_array_equal(a, b)
    a, b = (torch.load(os.path.join(d, "SVAE_GraphRNN_BFS_0_3.ckpt"),
                       weights_only=True) for d in (whole, part))
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k


def test_no_cpu_fallback(tmp_path):
    """Without --cpu the driver runs on the card, and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the driver runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdriver.main(["--res_dir", str(tmp_path / "r")])
    assert not (tmp_path / "r").exists()


@pytest.mark.parametrize("data_type, extra", [("ENAS", []),
                                              ("BN", ["--nvt", "8"])])
def test_cache_follows_the_corpus_flags(tmp_path, data_type, extra):
    """The corpus cache is read back only for the flags that built it: in
    one --res_dir, another --max-count (or, for the synthetic BN corpus,
    another --seed) builds the corpus anew, and the original flags then
    find the corpus they built at first."""
    base = ["--data-type", data_type, "--res_dir", str(tmp_path), "--cpu"] + extra
    load = lambda *f: tdriver.load_data(tdriver.parse_args(base + list(f)))
    tr30, te30, _ = load("--max-count", "30")
    assert (len(tr30), len(te30)) == (27, 3)
    tr50, te50, _ = load("--max-count", "50")
    assert (len(tr50), len(te50)) == (45, 5)
    again, _, _ = load("--max-count", "30")
    assert [g.types.tolist() for g in again] == [g.types.tolist() for g in tr30]
    if data_type == "BN":
        other, _, _ = load("--max-count", "30", "--seed", "2")
        assert [g.adj.tolist() for g in other] != [g.adj.tolist() for g in tr30]

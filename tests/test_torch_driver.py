"""The port's TOK/LP training driver against the JAX driver's, end to end
on the CPU: the same flags, data and initial weights through
`run(args, task)` of both packages, compared by the CSVs each writes.

Sizes: emb 16, 2 layers, head 20 (vocab 18 + UNK/EOS), batch 8, chunk 32,
60 synthetic ASTs of mean 20 nodes (48 train / 6 valid / 6 test), 2
epochs, 1 fold. The JAX side runs --segment_impl dense in float32 (the
same function as its fused path, without Pallas interpret mode); the port
runs its fused path's plain versions in float32. Initial weights: the JAX
package's dagnn_init(PRNGKey(seed + fold)), carried over by
convert.params_from_numpy into the port's `init_params`.

Tolerances: each epoch's mean loss at rtol 5e-4 / atol 5e-5 (the f32
grads tolerance of tests/test_torch_train_step.py); F1, accuracy and the
fold summary (best epoch and its metrics) equal. A resumed port run is
held to an uninterrupted one bit for bit.
"""

import argparse
import csv
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dagnn_tpu.cli import ogb_driver as jdriver
from dagnn_tpu.nn import dagnn as jdagnn
from dagnn_tpu.nn import encoders as jencoders
from dagnn_tpu_torch import convert
from dagnn_tpu_torch.cli import main_tok
from dagnn_tpu_torch.cli import ogb_driver as tdriver
from dagnn_tpu_torch.nn import dagnn as tdagnn
from test_code2_dataset import make_raw_tree

torch.set_num_threads(1)

SMALL = ["--synthetic", "60", "--synthetic_mean_nodes", "20", "--emb_dim", "16",
         "--dagnn_layers", "2", "--num_vocab", "18", "--batch_size", "8",
         "--chunk_size", "32", "--epochs", "2", "--folds", "1", "--lr", "5e-3",
         "--cpu", "--compute_dtype", "float32"]


def _set(argv, flag, value=None):
    """`argv` with `flag`'s value replaced (or the flag dropped: None)."""
    i = argv.index(flag)
    return argv[:i] + ([flag, value] if value is not None else []) + argv[i + 2:]


def _args(driver, argv, tmp_path, tag):
    p = driver.add_common_args(argparse.ArgumentParser())
    return p.parse_args(argv + ["--dir_results", str(tmp_path / tag / "results"),
                                "--dir_save", str(tmp_path / tag / "saved")])


def _jax_cfg(cfg):
    """The port's DAGNNConfig as the JAX package's, field for field."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw["encoder"] = jencoders.EncoderSpec(**dataclasses.asdict(cfg.encoder))
    return jdagnn.DAGNNConfig(**kw)


@pytest.fixture
def jax_weights(monkeypatch):
    """Each fold of the port starts from the JAX driver's initial weights."""
    def init(cfg, seed, device):
        tree = jdagnn.dagnn_init(jax.random.PRNGKey(seed), _jax_cfg(cfg))
        return convert.params_from_numpy(jax.tree.map(np.asarray, tree),
                                         device=device)
    monkeypatch.setattr(tdriver, "init_params", init)


def _rows(tmp_path, tag, name, suffix="_train"):
    with open(tmp_path / tag / "results" / f"{name}{suffix}.csv") as f:
        return [[float(v) for v in r] for r in list(csv.reader(f))[1:]]


def _run_both(tmp_path, task, argv, impls=("dense", "fused")):
    """Both drivers on the same flags, each with its --segment_impl of
    `impls`; returns their train and fold rows."""
    name = f"dagnn_{task}"
    jres = jdriver.run(_args(jdriver, argv + ["--segment_impl", impls[0]],
                             tmp_path, "jax"), task)
    tres = tdriver.run(_args(tdriver, argv + ["--segment_impl", impls[1]],
                             tmp_path, "port"), task)
    assert tres == jres
    return ({tag: _rows(tmp_path, tag, name) for tag in ("jax", "port")},
            {tag: _rows(tmp_path, tag, name, "") for tag in ("jax", "port")})


def _same_curves(train, folds, epochs):
    j, t = train["jax"], train["port"]
    assert len(j) == len(t) == epochs
    for jr, tr in zip(j, t):
        assert tr[:2] == jr[:2]                       # fold, epoch
        np.testing.assert_allclose(tr[2], jr[2], rtol=5e-4, atol=5e-5,
                                   err_msg=f"loss, epoch {jr[1]}")
        assert tr[3:] == jr[3:], f"metrics, epoch {jr[1]}: {tr} vs {jr}"
    assert folds["port"] == folds["jax"]
    assert np.isfinite([r[2] for r in t]).all() and t[-1][2] < t[0][2]


def test_tok_matches_jax(tmp_path, jax_weights):
    train, folds = _run_both(tmp_path, "tok", SMALL)
    _same_curves(train, folds, 2)
    assert max(r[3] for r in train["port"]) > 0       # some F1 to compare


def test_lp_matches_jax(tmp_path, jax_weights):
    train, folds = _run_both(tmp_path, "lp", SMALL + ["--dagnn_agg", "attn_h"])
    _same_curves(train, folds, 2)
    assert max(r[3] for r in train["port"]) > 0


def test_raw_tree_matches_jax(tmp_path, jax_weights):
    """A constructed ogbg-code2 tree (processed into each package's npz
    cache): the same vocabulary and targets, then the same curves."""
    argv = _set(SMALL, "--synthetic")
    for tag in ("jax", "port"):
        make_raw_tree(str(tmp_path / tag / "ds" / "ogbg_code2"), n_graphs=30, seed=5)
    loaded = {}
    for tag, driver in (("jax", jdriver), ("port", tdriver)):
        args = _args(driver, argv + ["--data_root", str(tmp_path / tag / "ds")],
                     tmp_path, tag)
        loaded[tag] = driver.load_dataset(args, "tok")
    assert loaded["port"][3] == loaded["jax"][3]      # idx2vocab
    for js, ts in zip(loaded["jax"][:3], loaded["port"][:3]):
        assert len(js) == len(ts)
        for jg, tg in zip(js, ts):
            np.testing.assert_array_equal(tg.y["y_arr"], jg.y["y_arr"])
            np.testing.assert_array_equal(tg.edge_src, jg.edge_src)
    train, folds = {}, {}
    for tag, driver in (("jax", jdriver), ("port", tdriver)):
        impl = "dense" if tag == "jax" else "fused"
        driver.run(_args(driver, argv + ["--data_root", str(tmp_path / tag / "ds"),
                                         "--segment_impl", impl], tmp_path, tag), "tok")
        train[tag] = _rows(tmp_path, tag, "dagnn_tok")
        folds[tag] = _rows(tmp_path, tag, "dagnn_tok", "")
    _same_curves(train, folds, 2)


def test_resume_matches_uninterrupted(tmp_path):
    """Port only: 3 epochs in one run against 2 epochs and a resumed third
    (through main_tok.main): the same final parameters and optimizer
    state bit for bit, the same CSV rows, one checkpoint left."""
    flags = lambda tag, epochs: _set(SMALL, "--epochs", str(epochs)) + [
        "--dir_results", str(tmp_path / tag / "results"),
        "--dir_save", str(tmp_path / tag / "saved")]
    main_tok.main(flags("whole", 3))
    main_tok.main(flags("resumed", 2))
    assert os.listdir(tmp_path / "resumed" / "saved") == ["dagnn_tok_1_2.ckpt"]
    main_tok.main(flags("resumed", 3))
    for tag in ("whole", "resumed"):
        assert os.listdir(tmp_path / tag / "saved") == ["dagnn_tok_1_3.ckpt"]
    a, b = (torch.load(tmp_path / tag / "saved" / "dagnn_tok_1_3.ckpt",
                       weights_only=True) for tag in ("whole", "resumed"))
    assert a["epoch"] == b["epoch"] == 3 and a["results"] == b["results"]
    for part in ("params", "opt_state"):
        flat_a, flat_b = (convert.flatten_tree(x[part]) for x in (a, b))
        assert flat_a.keys() == flat_b.keys()
        for k in flat_a:
            assert flat_a[k].dtype == flat_b[k].dtype, (part, k)
            assert torch.equal(flat_a[k], flat_b[k]), (part, k)
    assert int(b["opt_state"]["count"]) == 3 * 6       # 48 graphs, batch 8
    assert _rows(tmp_path, "resumed", "dagnn_tok") == _rows(tmp_path, "whole",
                                                            "dagnn_tok")
    assert _rows(tmp_path, "resumed", "dagnn_tok", "")[-1] == \
        _rows(tmp_path, "whole", "dagnn_tok", "")[-1]


def test_resume_matches_jax(tmp_path, jax_weights):
    """Both drivers: 1 epoch, then a rerun with --epochs 2 in the same
    directories resumes at epoch 2 from the latest checkpoint. The curves
    agree as in test_tok_matches_jax. The checkpoints left differ by
    design: the JAX driver keeps the file it resumed from beside the new
    one, the port's rotation replaces it (ROADMAP queue 3)."""
    for epochs in ("1", "2"):
        train, folds = _run_both(tmp_path, "tok", _set(SMALL, "--epochs", epochs))
    _same_curves(train, folds, 2)
    assert sorted(os.listdir(tmp_path / "jax" / "saved")) == [
        "dagnn_tok_1_1.ckpt", "dagnn_tok_1_2.ckpt"]
    assert os.listdir(tmp_path / "port" / "saved") == ["dagnn_tok_1_2.ckpt"]


def test_unported_flags_raise(tmp_path):
    """The baselines are ported (ROADMAP queue 1, item 6): --gnn gin trains
    one epoch on unleveled batches. A --gnn name the JAX driver cannot
    build either (an unknown convolution) raises ValueError, as there."""
    argv = ["--synthetic", "20", "--emb_dim", "8", "--num_vocab", "6",
            "--epochs", "1", "--folds", "1", "--cpu"]
    res = tdriver.run(_args(tdriver, argv + ["--gnn", "gin"], tmp_path, "port"), "tok")
    assert len(res) == 1 and 0.0 <= res[0]["valid"] <= 1.0
    for driver, tag in ((jdriver, "jax"), (tdriver, "port")):
        with pytest.raises(ValueError, match="gru"):
            driver.run(_args(driver, argv + ["--gnn", "gru"], tmp_path, tag), "tok")


def _kept(shape):
    """A fixed dropout mask: every tenth element dropped."""
    return np.arange(int(np.prod(shape))).reshape(shape) % 10 != 3


@pytest.mark.parametrize("task, flags, impls", [
    ("lp", ["--dagnn_agg", "gated_sum"], ("scatter", "scatter")),
    ("tok", [], ("dense", "dense")),
    ("lp", ["--dagnn_agg", "attn_h", "--dagnn_dropout", "0.1"], ("dense", "fused")),
], ids=["lp-scatter-gated_sum", "tok-dense", "lp-dropout"])
def test_flags_match_jax(tmp_path, jax_weights, monkeypatch, task, flags, impls):
    """--segment_impl dense / scatter (the port's generic branch) and
    --dagnn_dropout 0.1 against the JAX driver's curves. The two packages'
    random streams differ, so under dropout both draw one fixed mask
    (every tenth element dropped): what is held is that training drops and
    scales by 1/0.9 and evaluation does not."""
    if "--dagnn_dropout" in flags:
        monkeypatch.setattr(jax.random, "bernoulli",
                            lambda key, p, shape: jnp.asarray(_kept(shape)))
        monkeypatch.setattr(tdagnn, "_keep_mask", lambda shape, keep, rng, dev:
                            torch.as_tensor(_kept(tuple(shape)), device=dev))
    train, folds = _run_both(tmp_path, task, SMALL + flags, impls)
    _same_curves(train, folds, 2)


def test_main_lp_defaults_match_jax(tmp_path, jax_weights, monkeypatch):
    """main_lp at its defaults (gated_sum, unidirectional: the port's
    generic branch) against the JAX package's main_lp, small widths."""
    from dagnn_tpu.cli import main_lp as jmain_lp
    from dagnn_tpu_torch.cli import main_lp
    dirs = lambda tag: ["--dir_results", str(tmp_path / tag / "results"),
                        "--dir_save", str(tmp_path / tag / "saved")]
    monkeypatch.setattr(sys, "argv", ["main_lp"] + SMALL + dirs("jax"))
    jmain_lp.main()
    main_lp.main(SMALL + dirs("port"))
    train = {tag: _rows(tmp_path, tag, "dagnn_lp") for tag in ("jax", "port")}
    folds = {tag: _rows(tmp_path, tag, "dagnn_lp", "") for tag in ("jax", "port")}
    _same_curves(train, folds, 2)


def test_no_cpu_fallback(tmp_path):
    """Without --cpu the driver runs on the card, and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the driver runs there")
    args = _args(tdriver, ["--synthetic", "20", "--epochs", "1"], tmp_path, "port")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdriver.run(args, "tok")
    assert not (tmp_path / "port").exists()

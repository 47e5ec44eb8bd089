"""The port's copies of the numpy-only NA/BN modules (dagnn_tpu_torch/data/
na.py, dagnn_tpu_torch/vae/bn_score.py) against the originals, bit for bit:
the ENAS corpus parsed, shuffled and split; a BN corpus file; the
synthetic BN rows with their BIC scores; the codecs and validity checks;
and the VAE's collated batches and dense views (dagnn_vae.na_collate).
"""

import numpy as np
import pytest
import torch

from dagnn_tpu.data import na as jna
from dagnn_tpu.vae import bn_score as jbn
from dagnn_tpu.vae import dagnn_vae as jvae
from dagnn_tpu_torch.data import na as tna
from dagnn_tpu_torch.vae import bn_score as tbn
from dagnn_tpu_torch.vae import dagnn_vae as tvae

torch.set_num_threads(1)

ENAS = "data/final_structures6.txt.gz"


def _same_graphs(a, b):
    assert len(a) == len(b)
    for ga, gb in zip(a, b):
        np.testing.assert_array_equal(ga.types, gb.types)
        np.testing.assert_array_equal(ga.adj, gb.adj)
        assert ga.adj.dtype == gb.adj.dtype and ga.types.dtype == gb.types.dtype
        assert ga.y == gb.y


@pytest.fixture(scope="module")
def enas():
    import os
    path = os.path.join(os.path.dirname(__file__), "..", ENAS)
    return (jna.load_enas(path, max_count=60), tna.load_enas(path, max_count=60))


def test_load_enas_matches(enas):
    """Burn-in 1000, random.Random(0) shuffle, 90/10 split: the same
    graphs in the same order, the same GraphArgs."""
    (jtr, jte, jga), (ttr, tte, tga) = enas
    _same_graphs(jtr, ttr)
    _same_graphs(jte, tte)
    assert len(ttr) == 54 and len(tte) == 6
    assert tga == tna.GraphArgs(**vars(jga)) and tga.max_n == 8


def test_load_bn_matches(tmp_path):
    rows = jna.synthetic_bn_rows(30, seed=3, score=False)
    path = tmp_path / "bn.txt"
    path.write_text("\n".join(rows) + "\n")
    (jtr, jte, jga), (ttr, tte, tga) = (m.load_bn(str(path)) for m in (jna, tna))
    _same_graphs(jtr, ttr)
    _same_graphs(jte, tte)
    assert tga.max_n == jga.max_n == 10


def test_synthetic_bn_rows_scored_match():
    """score=True: each row's BIC against the sampled Asia data, by the
    copied bn_score."""
    j = jna.synthetic_bn_rows(20, seed=1, score=True)
    t = tna.synthetic_bn_rows(20, seed=1, score=True)
    assert t == j
    data = jbn.sample_asia(500, seed=2)
    np.testing.assert_array_equal(tbn.sample_asia(500, seed=2), data)
    adj = np.triu(np.ones((8, 8), np.int64), 1)
    assert tbn.bic_score(adj, data) == jbn.bic_score(adj, data)


def test_codecs_and_checks_match(enas):
    (jtr, _, _), (ttr, _, _) = enas
    bn = [r.split("]], ")[0] + "]]" for r in jna.synthetic_bn_rows(5, seed=4, score=False)]
    for jg, tg in zip(jtr[:10], ttr[:10]):
        assert tna.graph_to_enas_row(tg) == jna.graph_to_enas_row(jg)
        assert tna.is_valid_enas(tg) == jna.is_valid_enas(jg) is True
        assert tna.is_valid_dag(tg) == jna.is_valid_dag(jg)
    for r in bn:
        jg, tg = jna.parse_bn_row(r), tna.parse_bn_row(r)
        _same_graphs([jg], [tg])
        assert tna.graph_to_bn_adj_str(tg) == jna.graph_to_bn_adj_str(jg)
        assert tna.is_valid_bn(tg) == jna.is_valid_bn(jg)
    broken = tna.parse_enas_row(tna.graph_to_enas_row(ttr[0]))
    broken.adj[0, 1] = 0
    assert not tna.is_valid_enas(broken)


@pytest.mark.parametrize("bn", [False, True], ids=["na", "bn"])
def test_na_collate_matches(enas, bn):
    """The VAE's batches: every array of the collated DAGBatch (both
    schedules, the transpose ones included) and the dense views equal."""
    if bn:
        rows = [r.split("]], ")[0] + "]]" for r in jna.synthetic_bn_rows(5, seed=6, score=False)]
        jgs, tgs = [jna.parse_bn_row(r) for r in rows], [tna.parse_bn_row(r) for r in rows]
        kw = dict(max_n=10, nvt=10, bn=True, bidirectional=True)
    else:
        jgs, tgs = enas[0][0][:5], enas[1][0][:5]
        kw = dict(max_n=8, nvt=8)
    jout = jvae.na_collate(jgs, jvae.DAGNNVAEConfig(hs=8, nz=4, **kw))
    tout = tvae.na_collate(tgs, tvae.DAGNNVAEConfig(hs=8, nz=4, **kw))
    for a, b in zip(jout[1:], tout[1:]):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    jb, tb = jout[0], tout[0]
    for name in ("x", "graph_id", "node_mask", "graph_mask", "n_node", "n_edge"):
        np.testing.assert_array_equal(getattr(tb, name), getattr(jb, name))
    for d in ("fwd", "rev"):
        js, ts = getattr(jb, d), getattr(tb, d)
        for f in js._fields:
            a, b = getattr(js, f), getattr(ts, f)
            assert (a is None) == (b is None), (d, f)
            if a is not None:
                np.testing.assert_array_equal(b, a, err_msg=f"{d}.{f}")
    assert tb.fwd.node_ids.shape == (kw["max_n"], 5 * kw["max_n"])

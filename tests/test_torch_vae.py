"""The port's VAE stack (dagnn_tpu_torch/vae/) against the JAX package's on
the CPU, from the same inputs and weights: the teacher-forced loss over
the grid of tests/test_vae.py:39-45 and a padded-graph case, the base
D-VAE's sequential encoder both ways and for BN, the greedy decode, and
the DAGNN VAE's encoder and loss with every gradient leaf (attn_h and
gated_sum, unidirectional NA and bidirectional BN), its tied parameters,
the partial checkpoint load, the plateau schedule and the noise's law.

Sizes: hs <= 16, nz <= 6, the three ENAS rows of tests/test_vae.py (and
three synthetic BN rows). Inputs come from numpy seeds; JAX weights are
carried over with convert.params_from_numpy. Noise is off on both sides
(training=False), as the two packages' random streams differ. The JAX
side runs under jax.jit; its encoder takes segment_impl "dense" (its
default, no Pallas), the port's the plain versions of K6 and K5 on CPU
tensors. Tolerances: f32 outputs 2e-5 of their max|ref|; gradient leaves
rtol 5e-4 / atol 5e-5.
"""

import ast

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dagnn_tpu.data.na import parse_bn_row as jparse_bn
from dagnn_tpu.data.na import parse_enas_row as jparse
from dagnn_tpu.data.na import synthetic_bn_rows
from dagnn_tpu.nn.aggregators import AggregatorSpec, aggregator_init
from dagnn_tpu.train import optim as joptim
from dagnn_tpu.vae import dagnn_vae as jv
from dagnn_tpu.vae import dvae as jd
from dagnn_tpu_torch import checks, convert
from dagnn_tpu_torch.data.na import parse_bn_row, parse_enas_row
from dagnn_tpu_torch.train import checkpoint as ckpt
from dagnn_tpu_torch.train import optim as toptim
from dagnn_tpu_torch.vae import dagnn_vae as tv
from dagnn_tpu_torch.vae import dvae as td

torch.set_num_threads(1)

ROWS = [
    "[[4], [0, 1], [3, 1, 0], [3, 0, 1, 1], [1, 1, 1, 1, 1], [2, 1, 1, 0, 1, 1]]",
    "[[2], [2, 0], [4, 1, 0], [0, 1, 0, 0], [2, 1, 0, 0, 1], [3, 1, 0, 0, 0, 0]]",
    "[[1], [5, 1], [0, 0, 1], [2, 1, 1, 1], [4, 0, 1, 0, 0], [1, 0, 0, 1, 1, 0]]",
]
BN_ROWS = [ast.literal_eval(r)[0] for r in synthetic_bn_rows(3, seed=1, score=False)]
OUT_TOL = 2e-5
RTOL, ATOL = 5e-4, 5e-5


def _port(tree):
    return convert.params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _t(*arrays):
    return [torch.as_tensor(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _enas_views(max_n=8):
    return jv.na_dense_views([jparse(r) for r in ROWS], max_n)


def _z(n, nz, seed=1):
    return np.random.default_rng(seed).normal(size=(n, nz)).astype(np.float32)


def _close(got, want, what):
    rel = checks.rel_err(got, want)[0]
    assert rel <= OUT_TOL, f"{what}: {rel:.3e} of max|ref|"


def _grads_close(tgrads, jgrads, what):
    """Every leaf of the JAX gradient tree against the port's flat dict
    (a leaf the port's autograd did not reach is zero)."""
    jflat = convert.flatten_tree(jax.tree.map(np.asarray, jgrads))
    assert set(jflat) == set(tgrads), what
    for k, ref in jflat.items():
        g = tgrads[k]
        got = np.zeros_like(ref) if g is None else g.detach().numpy()
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what}: {k}")


# ------------------------------------------------------------ teacher loss

def _teacher(cfg_kw, types, adj, nv, z, seed=0):
    jcfg, tcfg = jd.DVAEConfig(**cfg_kw), td.DVAEConfig(**cfg_kw)
    dec = jd.dvae_decoder_init(jax.random.PRNGKey(seed), jcfg)
    attn = None
    if "attn" in jcfg.dec_agg:
        attn = aggregator_init(jax.random.PRNGKey(5), AggregatorSpec(
            "attn", value_dim=jcfg.hs, key_dim=jcfg.vs, query_dim=jcfg.nvt))
    want = jax.jit(lambda d, a: jd.dvae_teacher_loss(
        d, jcfg, *_j(z, types, adj, nv), attn_params=a)[0])(dec, attn)
    got, aux = td.dvae_teacher_loss(_port(dec), tcfg, *_t(z, types, adj, nv),
                                    attn_params=None if attn is None else _port(attn))
    assert aux == {} and got.dtype == torch.float32
    _close(got, float(want), f"teacher loss {cfg_kw}")


@pytest.mark.parametrize("dec_agg,vid,bn,L", [
    ("gated_sum", True, False, 1),
    ("gated_sum", True, False, 2),
    ("attn", True, False, 2),
    ("attn", False, True, 2),
    ("gated_sum", False, True, 1),
])
def test_teacher_loss_matches_jax(dec_agg, vid, bn, L):
    types, adj, nv = _enas_views()
    _teacher(dict(max_n=8, nvt=8, hs=10, nz=4, num_layers=L, vid=vid, bn=bn,
                  dec_agg=dec_agg), types, adj, nv, _z(3, 4))


def test_teacher_loss_padded_graphs():
    """Graph 1 shorter than max_n: its padded steps score START types and
    zero-target edges on both sides."""
    types, adj, nv = _enas_views()
    nv[1] = 6
    types[1, 6:] = 0
    adj[1, :, 6:] = 0
    adj[1, 6:, :] = 0
    _teacher(dict(max_n=8, nvt=8, hs=7, nz=4, num_layers=1, vid=True,
                  dec_agg="gated_sum"), types, adj, nv, _z(3, 4, seed=3), seed=2)


# ------------------------------------------------- base D-VAE and decode

@pytest.mark.parametrize("kind", ["DVAE", "DVAE bidirectional", "DVAE_BN bidirectional"])
def test_encode_sequential_matches_jax(kind):
    if kind.startswith("DVAE_BN"):
        gs = [jparse_bn(r) for r in BN_ROWS]
        kw = dict(max_n=10, nvt=10, vid=False, bn=True, pred_source="x")
    else:
        gs = [jparse(r) for r in ROWS]
        kw = dict(max_n=8, nvt=8, vid=True)
    kw.update(hs=12, nz=4, bidirectional="bidirectional" in kind)
    views = jv.na_dense_views(gs, kw["max_n"])
    jcfg, tcfg = jd.DVAEConfig(**kw), td.DVAEConfig(**kw)
    params = jd.dvae_base_init(jax.random.PRNGKey(0), jcfg)
    tp = _port(params)
    assert set(tp) == set(td.dvae_base_init(0, tcfg, device="cpu"))
    jmu, jlv = jax.jit(lambda p: jd.dvae_encode_sequential(p, jcfg, *_j(*views)))(params)
    mu, lv = td.dvae_encode_sequential(tp, tcfg, *_t(*views))
    _close(mu, jmu, f"{kind} mu")
    _close(lv, jlv, f"{kind} logvar")


@pytest.mark.parametrize("dec_agg", ["gated_sum", "attn"])
def test_greedy_decode_matches_jax(dec_agg):
    cfg_kw = dict(max_n=6, nvt=8, hs=10, nz=4, vid=True, dec_agg=dec_agg)
    jcfg, tcfg = jd.DVAEConfig(**cfg_kw), td.DVAEConfig(**cfg_kw)
    dec = jd.dvae_decoder_init(jax.random.PRNGKey(3), jcfg)
    attn = None
    if dec_agg == "attn":
        from dagnn_tpu.ops.linear import linear_init
        attn = {"attn_lin": linear_init(jax.random.PRNGKey(9), jcfg.nvt + jcfg.vs, 1)}
    z = 2.0 * _z(6, 4, seed=4)
    want = jd.dvae_decode(dec, jcfg, jnp.asarray(z), stochastic=False, attn_params=attn)
    got = td.dvae_decode(_port(dec), tcfg, torch.as_tensor(z), stochastic=False,
                         attn_params=None if attn is None else _port(attn))
    for a, b, what in zip(got, want, ("types", "adj", "nv")):
        np.testing.assert_array_equal(a, b, err_msg=what)
    assert (got[2] > 2).any() and got[1].sum() > 0       # some graphs grew edges


def test_stochastic_decode_and_noise_law():
    """The port's own draws: a stochastic decode gives valid DAGs with START
    first and END last, repeatable from one seed; the reparameterization
    noise is N(0, eps_scale^2) * std around mu."""
    cfg = td.DVAEConfig(max_n=8, nvt=8, hs=10, nz=4, vid=True)
    dec = td.dvae_decoder_init(0, cfg, device="cpu")
    z = torch.as_tensor(_z(5, 4, seed=5))
    a = td.dvae_decode(dec, cfg, z, torch.Generator().manual_seed(7))
    b = td.dvae_decode(dec, cfg, z, torch.Generator().manual_seed(7))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    types, adj, nv = a
    assert ((nv >= 2) & (nv <= 8)).all() and (types[:, 0] == 0).all()
    for i in range(5):
        assert types[i, nv[i] - 1] == 1
        s, d = np.nonzero(adj[i])
        assert (s < d).all() and (d < nv[i]).all()
    mu = torch.zeros(400, 50)
    logvar = torch.full((400, 50), 2 * np.log(3.0))        # std 3
    eps = td.reparameterize(torch.Generator().manual_seed(0), mu, logvar, 0.01)
    assert abs(float(eps.mean())) < 3 * 0.03 / np.sqrt(eps.numel())
    assert abs(float(eps.std()) / 0.03 - 1) < 0.01
    assert td.reparameterize(None, mu, logvar, training=False) is mu
    with pytest.raises(ValueError, match="Generator"):
        td.reparameterize(None, mu, logvar)


# ------------------------------------------------------------ DAGNN VAE

def _dagnn_case(agg, bn):
    if bn:
        kw = dict(max_n=10, nvt=10, bidirectional=True, bn=True)
        gs = ([jparse_bn(r) for r in BN_ROWS], [parse_bn_row(r) for r in BN_ROWS])
    else:
        kw = dict(max_n=8, nvt=8, bidirectional=False)
        gs = ([jparse(r) for r in ROWS], [parse_enas_row(r) for r in ROWS])
    kw.update(hs=16, nz=6, num_layers=2, agg=agg)
    jcfg, tcfg = jv.DAGNNVAEConfig(**kw), tv.DAGNNVAEConfig(**kw)
    jb, *views = jv.na_collate(gs[0], jcfg)
    tb = convert.batch_to_torch(tv.na_collate(gs[1], tcfg)[0], "cpu")
    return jcfg, tcfg, jb, tb, views


@pytest.mark.parametrize("agg", ["attn_h", "gated_sum"])
@pytest.mark.parametrize("bn", [False, True], ids=["na", "bn"])
def test_dagnn_vae_loss_and_grads_match_jax(agg, bn):
    """The encoder (mu, logvar), the loss (total, recon, kld) and the
    gradient of the total in every leaf, tied ones included."""
    jcfg, tcfg, jb, tb, views = _dagnn_case(agg, bn)
    params = jv.dagnn_vae_init(jax.random.PRNGKey(0), jcfg)
    tp = _port(params)
    init = tv.dagnn_vae_init(0, tcfg, device="cpu")
    assert {k: v.shape for k, v in init.items()} == {k: v.shape for k, v in tp.items()}

    def jloss(p):
        out = jv.dagnn_vae_loss(p, jcfg, jb, *_j(*views), None, training=False)
        return out[0], (out, jv.dagnn_vae_encode(p, jcfg, jb))

    (_, (jout, jenc)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    p = {k: v.detach().requires_grad_(True) for k, v in tp.items()}
    tout = tv.dagnn_vae_loss(p, tcfg, tb, *_t(*views), None, training=False)
    tenc = tv.dagnn_vae_encode(p, tcfg, tb)
    for a, b, what in zip(tenc + tout, jenc + jout,
                          ("mu", "logvar", "total", "recon", "kld")):
        _close(a, b, f"{agg} {what}")
    gs = torch.autograd.grad(tout[0], list(p.values()), allow_unused=True)
    _grads_close(dict(zip(p, gs)), jg, f"{agg} bn={bn}")


def test_tied_parameters():
    """gated_sum: the encoder's aggregators are the decoder's gate/mapper
    tensors (no enc.aggr.* keys), so a gradient through the encoder alone
    reaches dec.mapper_f, as tests/test_vae.py:121 holds in JAX (the sum
    of both uses' gradients is held to JAX's in
    test_dagnn_vae_loss_and_grads_match_jax). attn_h: the decoder's
    attention reads the encoder's aggr.0.0 tensors, and
    dagnn_vae_decode decodes with them."""
    _, tcfg, _, tb, _ = _dagnn_case("gated_sum", False)
    tp = {k: v.requires_grad_(True)
          for k, v in tv.dagnn_vae_init(0, tcfg, device="cpu").items()}
    assert not any(k.startswith("enc.aggr.") for k in tp)
    enc = tv._effective_enc_params(tp, tcfg)
    for l in range(tcfg.num_layers):
        assert enc[f"aggr.0.{l}.mapper.w"] is tp[f"dec.mapper_f.{l}.w"]
        assert enc[f"aggr.0.{l}.gate.b"] is tp[f"dec.gate_f.{l}.b"]
    mu = tv.dagnn_vae_encode(tp, tcfg, tb)[0]
    (g,) = torch.autograd.grad((mu ** 2).sum(), [tp["dec.mapper_f.0.w"]])
    assert float(g.abs().sum()) > 0.0

    _, tcfg, _, _, _ = _dagnn_case("attn_h", False)
    tp = tv.dagnn_vae_init(0, tcfg, device="cpu")
    ap = tv._decoder_attn_params(tp, tcfg)
    assert set(ap) == {"attn_lin.w", "attn_lin.b"}
    assert ap["attn_lin.w"] is tp["enc.aggr.0.0.attn_lin.w"]
    z = torch.as_tensor(2.0 * _z(4, 6, seed=8))
    got = tv.dagnn_vae_decode(tp, tcfg, z, stochastic=False)
    want = td.dvae_decode(td.sub_params(tp, "dec."), tcfg.dvae, z,
                          stochastic=False, attn_params=ap)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_vae_trees_flatten_and_back():
    """convert carries the JAX VAE trees across: flatten_tree names every
    leaf of dagnn_vae_init's {enc, dec, fc1, fc2, hg_unify, out_linear,
    pool_attn} and dvae_base_init's {dec, grue_f, grue_b, fc1, fc2,
    hg_unify} with the port's keys and shapes (the JAX trees' shapes by
    jax.eval_shape), and unflatten_tree gives the trees back (empty subtrees, the identity encoder's and gated_sum's emptied
    enc.aggr, have no leaf to carry)."""
    for kw in (dict(agg="attn_h", bidirectional=True, out_pool="attn"),
               dict(agg="gated_sum", num_layers=1)):
        kw.update(max_n=8, nvt=8, hs=6, nz=3)
        tree = jax.eval_shape(lambda: jv.dagnn_vae_init(
            jax.random.PRNGKey(0), jv.DAGNNVAEConfig(**kw)))
        flat = convert.flatten_tree(tree)
        port = tv.dagnn_vae_init(0, tv.DAGNNVAEConfig(**kw), device="cpu")
        assert {k: tuple(v.shape) for k, v in flat.items()} == \
            {k: tuple(v.shape) for k, v in port.items()}
        back = convert.unflatten_tree(flat)
        assert set(back) == set(tree) and convert.flatten_tree(back).keys() == flat.keys()
    cfg = dict(max_n=8, nvt=8, hs=6, nz=3, bidirectional=True)
    tree = jax.eval_shape(lambda: jd.dvae_base_init(jax.random.PRNGKey(0),
                                                    jd.DVAEConfig(**cfg)))
    assert set(convert.flatten_tree(tree)) == set(
        td.dvae_base_init(0, td.DVAEConfig(**cfg), device="cpu"))
    assert jax.tree_util.tree_structure(
        convert.unflatten_tree(convert.flatten_tree(tree))) == \
        jax.tree_util.tree_structure(tree)


# ------------------------------------------------ checkpoint and optimizer

def test_load_partial_state_across_architectures(tmp_path):
    """A 1-layer model's checkpoint into a 2-layer template: every key
    present with the same shape restored, the rest kept from the
    template, counts returned."""
    small = tv.dagnn_vae_init(0, tv.DAGNNVAEConfig(max_n=8, nvt=8, hs=8, nz=4,
                                                   num_layers=1), device="cpu")
    big = tv.dagnn_vae_init(1, tv.DAGNNVAEConfig(max_n=8, nvt=8, hs=8, nz=4,
                                                 num_layers=2), device="cpu")
    path = str(tmp_path / "DAGNN_0_1.ckpt")
    ckpt.create_checkpoint(path, 1, small, {}, {})
    out, n_ok, n_skip = ckpt.load_partial_state(path, big)
    same = [k for k in big if k in small and small[k].shape == big[k].shape]
    assert n_ok == len(same) and n_ok + n_skip == len(big) and n_skip > 0
    for k in big:
        want = small[k] if k in same else big[k]
        assert torch.equal(out[k], want), k
    assert "enc.cells.0.1.w_ih" not in small                 # a new layer
    assert small["enc.head.w"].shape != big["enc.head.w"].shape  # a new width
    assert out["enc.cells.0.1.w_ih"] is big["enc.cells.0.1.w_ih"]
    assert out["enc.head.w"] is big["enc.head.w"]


class _LinearLoss:
    """A stand-in for train_vae's VAEModel whose loss is sum(c * w), so
    that its gradient is c."""

    def __init__(self, c):
        self.c = c

    def loss(self, p, prepared, gen):
        total = torch.sum(p["w"] * self.c)
        return total, total, torch.zeros(())


@pytest.mark.parametrize("size", [0.01, 10.0], ids=["under_clip", "over_clip"])
def test_plateau_scales_the_gradients_as_jax(size):
    """The plateau schedule drops to 0.1 and its state round-trips; the
    VAE driver's train step multiplies the gradients by the schedule's
    scale before the clip 0.25 and Adam at the unchanged lr, as the JAX
    driver's step (dagnn_tpu/cli/train_vae.py:269-273): steps at scales 1,
    0.1, 0.1 give the parameters of JAX's optax chain fed the scaled
    gradients, for gradients under the clip and over it."""
    sched = toptim.PlateauScheduler(factor=0.1, patience=2)
    for m in (5.0, 4.0, 4.0, 4.0, 4.0):
        sched.step(m)
    assert sched.scale == pytest.approx(0.1)
    state = toptim.PlateauScheduler()
    state.load_state_dict(sched.state_dict())
    assert state.state_dict() == sched.state_dict()

    rng = np.random.default_rng(0)
    w = rng.normal(size=(4, 3)).astype(np.float32)
    c = (size * rng.normal(size=(4, 3))).astype(np.float32)
    from dagnn_tpu_torch.cli import train_vae as tdriver
    step = tdriver.make_train_step(_LinearLoss(torch.as_tensor(c)),
                                   toptim.make_optimizer(1e-2, clip=0.25))
    jopt = joptim.make_optimizer(1e-2, clip=0.25)
    tp = {"w": torch.as_tensor(w)}
    ts = toptim.make_optimizer(1e-2, clip=0.25).init(tp)
    jp = {"w": jnp.asarray(w)}
    js = jopt.init(jp)
    for scale in (1.0, 0.1, 0.1):
        tp, ts, _ = step(tp, ts, None, None, scale)
        up, js = jopt.update({"w": jnp.asarray(c) * scale}, js, jp)
        jp = {"w": jp["w"] + up["w"]}
        np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]), rtol=1e-5,
                                   atol=1e-6, err_msg=f"scale {scale}")

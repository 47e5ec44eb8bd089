"""The port's TOK train step against the JAX driver's make_step_fns:
two steps from the same weights on the same batch (shrunk flagship, f32,
the JAX side on its fused Pallas path in interpret mode), one step on a
batch with a pair plan (both packages on their pair wavefront), the
nonfinite guard, and the optax form of the global-norm clip.

Tolerances: losses f32 rtol 5e-4 / atol 5e-5 (the grads tolerance). The
parameters after each step: all but one entry in 10^4 within rtol 5e-4 /
atol 5e-5, and every entry within atol 2e-4 (a fifth of lr = 1e-3). Adam
divides each gradient by its own running magnitude, so an entry whose
gradient is near zero (an attention-score weight, |g| ~ eps = 1e-8) moves
by g / (|g| + eps) * lr: gradients that agree to 1e-9 can move it by a
visible fraction of lr (two such entries of 132k at this size).
"""

import jax
import numpy as np
import optax
import pytest
import torch

from dagnn_tpu.cli.ogb_driver import make_step_fns as jmake_step_fns
from dagnn_tpu.train.optim import make_optimizer as jmake_optimizer
from dagnn_tpu_torch import convert
from dagnn_tpu_torch.cli.ogb_driver import make_step_fns as tmake_step_fns
from dagnn_tpu_torch.train.optim import clip_by_global_norm, make_optimizer
from test_torch_dagnn import PAIR_GRAPHS, small_setup

torch.set_num_threads(1)


def _np(tree):
    return convert.flatten_tree(jax.tree.map(np.asarray, tree))


def _steps_match_jax(setup, steps):
    """`steps` train steps of both packages from the same weights on the
    same batch: losses, parameters after each step, predictions."""
    jcfg, tcfg, jparams, tparams, jb, tb = setup
    jopt, topt = jmake_optimizer(1e-3, 0.25), make_optimizer(1e-3, 0.25)
    jstep, jpredict = jmake_step_fns(jcfg, jopt, "tok")
    tstep, tpredict = tmake_step_fns(tcfg, topt, "tok")
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    for step in range(steps):
        jparams, jstate, jloss, jfin = jstep(jparams, jstate, jb,
                                             jax.random.PRNGKey(0))
        tparams, tstate, tloss, tfin = tstep(tparams, tstate, tb)
        assert bool(jfin) and bool(tfin)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=5e-4,
                                   atol=5e-5, err_msg=f"loss {step}")
        want = _np(jparams)
        n_all = n_off = 0
        for k, v in want.items():
            got = tparams[k].numpy()
            np.testing.assert_allclose(got, v, rtol=5e-4, atol=2e-4,
                                       err_msg=f"{k} step {step}")
            n_off += int((np.abs(got - v) > 5e-5 + 5e-4 * np.abs(v)).sum())
            n_all += v.size
        assert n_off <= n_all * 1e-4, (step, n_off, n_all)
    assert int(tstate["count"]) == steps
    np.testing.assert_array_equal(tpredict(tparams, tb).numpy(),
                                  np.asarray(jpredict(jparams, jb)))


def test_two_train_steps_match_jax():
    _steps_match_jax(small_setup("float32", seed=3), 2)


def test_pair_train_step_matches_jax():
    """A batch with a pair plan (pair=2, the JAX bench's default): both
    packages run their pair wavefront."""
    setup = small_setup("float32", seed=3, n_graphs=PAIR_GRAPHS, pair=2)
    assert setup[5].pair is not None
    _steps_match_jax(setup, 1)


def test_nonfinite_step_is_skipped():
    _, tcfg, _, tparams, _, tb = small_setup("float32", seed=4)
    opt = make_optimizer(1e-3, 0.25)
    step, _ = tmake_step_fns(tcfg, opt, "tok")
    params, state, loss, finite = step(tparams, opt.init(tparams), tb)
    assert bool(finite) and np.isfinite(float(loss))
    bad = dict(params)
    bad["head.b"] = params["head.b"].clone()
    bad["head.b"][0, 0] = float("inf")      # non-finite logits and grads
    p2, s2, loss2, fin2 = step(bad, state, tb)
    assert not bool(fin2) and np.isnan(float(loss2))
    for k in bad:
        assert torch.equal(p2[k], bad[k]), k
    assert torch.equal(s2["count"], state["count"])
    for part in ("mu", "nu"):
        for k in state[part]:
            assert torch.equal(s2[part][k], state[part][k]), (part, k)


@pytest.mark.parametrize("scale", [0.999, 1.001, 4.0])
def test_clip_matches_optax(scale):
    """optax's clip (g if norm < clip else g * clip / norm, no epsilon),
    and a full Adam update after it, on a norm just below / above 0.25."""
    rng = np.random.default_rng(0)
    g = {"a": rng.normal(size=(7, 5)).astype(np.float32),
         "b": rng.normal(size=(11,)).astype(np.float32)}
    norm = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in g.values()))
    g = {k: (v / norm * 0.25 * scale).astype(np.float32) for k, v in g.items()}
    want, _ = optax.clip_by_global_norm(0.25).update(g, None)
    got = clip_by_global_norm({k: torch.tensor(v) for k, v in g.items()}, 0.25)
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=0)
    params = {k: np.zeros_like(v) for k, v in g.items()}
    jopt, topt = jmake_optimizer(1e-3, 0.25), make_optimizer(1e-3, 0.25)
    js, ts = jopt.init(params), topt.init({k: torch.tensor(v) for k, v in params.items()})
    for _ in range(2):
        ju, js = jopt.update(g, js, params)
        tu, ts = topt.update({k: torch.tensor(v) for k, v in g.items()}, ts)
        for k in g:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]),
                                       rtol=1e-5, atol=1e-9)

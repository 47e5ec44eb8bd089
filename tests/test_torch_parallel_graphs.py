"""The parallel layer's train steps in their captured form
(dagnn_tpu_torch/parallel/dp.py DPStep, edge_partition.py EPStep over
train/graphs.py CapturedStep) on gloo ranks on the CPU, where a captured
step captures nothing: each call stages its inputs into the step's static
buffers (convert.batch_to_torch(out=)) and runs the step on them, the
state written back in place into buffers the step owns.

* The staged DP step and the staged EP step, in both orders (the deferred
  exchange overlapped and synchronous), equal the eager steps bit for bit
  over three Adam steps on 2 ranks: the loss, a digest of the parameters
  and of the optimizer state after every step, and the collectives issued
  (comm.issued); both ranks alike.
* One batch repeated: one staging, a replay a call. The same arrays with
  other read_rows (every row waiting before its gather): another key, a
  staging of its own.
* Against the JAX package's jitted steps, read through an optimizer that
  returns the raw gradients as its state (jobs.grads_optimizer; JAX's
  through the same optax transformation): the staged DP step's loss
  within 2e-5 and gradients within rtol 5e-4 / atol 5e-5 of
  make_dp_train_step's on the 2-device CPU mesh (test_torch_parallel.py's
  tolerances); the staged EP step's loss within 2e-5 and gradients within
  rtol 5e-4 / atol 5e-5 of make_ep_train_step's divided by D
  (test_torch_edge_partition.py's: JAX's EP gradient is D times the
  single-device one).
* With dropout (0.25 before the head), the staged DP step, which draws
  from one generator a rank reseeded from (seed, rank) at each call,
  equals the eager step bit for bit over three steps at seeds 0, 1, 2.
* The factories' rule on a gloo group: the steps run eager and say so
  ("eager (gloo: staged on the host)"), and capture=True raises.

Every rank-side run of this file is one spawn of 2 gloo ranks (module
fixture).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dagnn_tpu.nn.dagnn import dagnn_forward as jforward
from dagnn_tpu.parallel import dp as jdp
from dagnn_tpu.parallel.mesh import make_mesh as jmesh
from dagnn_tpu.train.losses import tok_loss as jtok_loss
from dagnn_tpu_torch import convert
from dagnn_tpu_torch.parallel import comm, jobs
from dagnn_tpu_torch.parallel.dp import make_dp_train_step
from dagnn_tpu_torch.parallel.mesh import init_distributed, make_mesh, spawn
from dagnn_tpu_torch.train.optim import make_optimizer
from test_torch_edge_partition import _grads_match, _jax_ep, _jax_single, _step_setup
from test_torch_parallel import _dp_setup

torch.set_num_threads(1)

D = 2
POOL = "max"          # the flagship's readout: a gather of each rank's maxima
DROPOUT = 0.25


def _np_params(jparams):
    return convert.flatten_tree(jax.tree.map(np.asarray, jparams))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Rank-side runs, one spawn of 2 gloo ranks: per rank the results of
    the DP forms (Adam, 3 steps; raw gradients, 1 step), then the EP
    forms (the same two), then the DP forms with dropout (Adam, 3
    steps)."""
    _, dcfg, djp, _, dtb = _dp_setup()
    _, ecfg, ejp, _, etb = _step_setup(D, POOL)
    todo = []
    for opt, steps in (("adam", 3), ("grads", 1)):
        todo.append((jobs.forms_job, dict(kind="dp", cfg=dcfg, params_np=_np_params(djp),
                                          batch=dtb, steps=steps, optimizer=opt)))
    for opt, steps in (("adam", 3), ("grads", 1)):
        todo.append((jobs.forms_job, dict(kind="ep", cfg=ecfg, params_np=_np_params(ejp),
                                          batch=etb, mesh_shape=(1, D), steps=steps,
                                          optimizer=opt)))
    todo.append((jobs.forms_job, dict(kind="dp", cfg=dataclasses.replace(dcfg, dropout=DROPOUT),
                                      params_np=_np_params(djp), batch=dtb, steps=3)))
    res = spawn(jobs.run_jobs, D, "gloo", "cpu",
                store_dir=str(tmp_path_factory.mktemp("store")), timeout=240,
                args=(todo,))
    return {"dp": [r[0] for r in res], "dp_raw": [r[1] for r in res],
            "ep": [r[2] for r in res], "ep_raw": [r[3] for r in res],
            "dp_dropout": [r[4] for r in res]}


def _same_forms(a, b, what):
    for k in ("losses", "params", "state", "issued"):
        assert a[k] == b[k], f"{what}: {k}"


def test_staged_dp_step_equals_eager_step(runs):
    for r in runs["dp"]:
        f = r["forms"]
        _same_forms(f["captured"], f["eager"], f"DP rank {r['rank']}")
        assert f["captured"]["issued"] == {"device": 0, "host": 3}
        assert (r["captures"], r["replays"]) == (1, 3)
        assert r["form"] == "captured" and r["eager_form"] == comm.EAGER_ON_HOST
    a, b = runs["dp"]
    assert a["forms"]["captured"] == b["forms"]["captured"]     # ranks alike
    losses = a["forms"]["captured"]["losses"]
    assert losses[2] < losses[0]


def test_staged_dp_step_with_dropout_equals_eager_step(runs):
    """Step i draws its dropout from (seed i, rank): the staged step's one
    generator, reseeded each call, draws what the eager step's draws; the
    draws reach the loss (it is not the loss without dropout)."""
    for r, plain in zip(runs["dp_dropout"], runs["dp"]):
        f = r["forms"]
        _same_forms(f["captured"], f["eager"], f"DP rank {r['rank']}, dropout")
        assert f["captured"]["issued"] == {"device": 0, "host": 3}
        assert (r["captures"], r["replays"]) == (1, 3)
        assert f["captured"]["losses"][0] != plain["forms"]["captured"]["losses"][0]


def test_staged_ep_steps_equal_eager_steps_in_both_orders(runs):
    for r in runs["ep"]:
        f = r["forms"]
        _same_forms(f["captured"], f["eager"], f"EP rank {r['rank']}, overlapped")
        _same_forms(f["captured sync"], f["eager sync"], f"EP rank {r['rank']}, sync")
        _same_forms(f["captured"], f["captured sync"], f"EP rank {r['rank']}, orders")
        assert f["captured"]["issued"]["host"] > 3 and f["captured"]["issued"]["device"] == 0
    a, b = runs["ep"]
    assert a["forms"] == b["forms"]
    assert a["form"] == "captured" and a["eager_form"] == comm.EAGER_ON_HOST


def test_one_batch_one_staging_and_read_rows_key(runs):
    """Three calls on one batch stage it once; the same arrays with other
    read_rows make a key of their own (and a new staging)."""
    for r in runs["ep"]:
        # with overlap some rows wait before their gather, not every row
        assert 0 < sum(r["read_rows"]) < sum(r["rows"])
        assert r["keys_differ"] and r["new_rows_captures"] == 1
        assert (r["captures"], r["replays"]) == (2, 4)


def test_staged_dp_step_matches_jax(runs):
    jcfg, _, jparams, jb, _ = _dp_setup()

    def loss_fn(p, b, rng):
        return jtok_loss(jforward(p, jcfg, b), b.y["y_arr"], b.graph_mask)

    capture = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))
    step, shard = jdp.make_dp_train_step(loss_fn, capture, jmesh(D, ("dp",)),
                                         donate=False)
    _, grads, loss = step(jparams, capture.init(jparams), shard(jb),
                          jax.random.PRNGKey(0))
    want = convert.flatten_tree(jax.tree.map(np.asarray, grads))
    raw = runs["dp_raw"][0]["raw"]
    np.testing.assert_allclose(raw["loss"], float(loss), rtol=2e-5, atol=2e-5)
    _grads_match(raw["grads"], want, "staged DP step vs JAX's jitted step")
    # the staged and eager raw gradients are one bit pattern
    f = runs["dp_raw"][0]["forms"]
    assert f["captured"]["state"] == f["eager"]["state"]


def test_staged_ep_step_matches_jax(runs):
    jcfg, _, jparams, jb, _ = _step_setup(D, POOL)
    raw = runs["ep_raw"][0]["raw"]
    l1, g1 = _jax_single(jcfg, jparams, jb)
    lep, gep = _jax_ep(jcfg, jparams, jb, D)
    np.testing.assert_allclose(raw["loss"], lep, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(raw["loss"], l1, rtol=2e-5, atol=2e-5)
    _grads_match(raw["grads"], {k: v / D for k, v in gep.items()},
                 "staged EP step vs JAX's EP step / D")
    _grads_match(raw["grads"], g1, "staged EP step vs JAX single device")
    f = runs["ep_raw"][0]["forms"]
    assert f["captured"]["state"] == f["eager"]["state"] == f["captured sync"]["state"]


def test_gloo_steps_run_eager_and_refuse_capture(tmp_path):
    """On a gloo group (here one rank in this process) both factories give
    the eager step and say so; capture=True raises; capture=False gives
    the eager step too. The DPStep built captured, with dropout, at seeds
    0 then 1 equals the eager step bit for bit."""
    from dagnn_tpu_torch.parallel import edge_partition as ep
    from dagnn_tpu_torch.parallel.dp import DPStep
    _, ecfg, _, _, _ = _step_setup(D, POOL)
    _, dcfg, djp, _, dtb = _dp_setup()
    init_distributed("gloo", f"file://{tmp_path}/store", 0, 1, device="cpu")
    try:
        group = torch.distributed.group.WORLD
        mesh = make_mesh(None, ("ep",))
        opt = make_optimizer()
        loss_fn = lambda p, b, rng: None
        for capture in (None, False):
            s = make_dp_train_step(loss_fn, opt, group, capture)
            assert s.captured is None and s.form == comm.EAGER_ON_HOST
            e = jobs.ep_step(ecfg, mesh, opt, capture=capture)
            assert e.captured is None and e.form == comm.EAGER_ON_HOST
        with pytest.raises(ValueError, match="gloo"):
            make_dp_train_step(loss_fn, opt, group, capture=True)
        with pytest.raises(ValueError, match="gloo"):
            ep.make_ep_train_step(ecfg, mesh, jobs.loss_of("tok"), opt, capture=True)
        assert comm.capture_rule([group]) is False
        params = {k: torch.tensor(v) for k, v in _np_params(djp).items()}
        seen = []
        for capture in (True, False):
            s = DPStep(jobs.dp_loss(dataclasses.replace(dcfg, dropout=DROPOUT)), opt,
                       group, capture)
            batch = s.shard(dtb, "cpu")      # world size 1: the first shard
            p, st = params, opt.init(params)
            run = []
            for seed in (0, 1):
                p, st, loss = s(p, st, batch, seed=seed)
                run.append((float(loss), jobs.digest(p), jobs.digest(st["mu"])))
            seen.append(run)
        assert seen[0] == seen[1] and seen[0][0][1] != seen[0][1][1]
    finally:
        torch.distributed.destroy_process_group()

"""Captured steps (dagnn_tpu_torch/train/graphs.py) on the CPU, where
nothing is captured but every call stages its inputs into the static
buffers and runs the step on them, writing the state back in place:

- the driver's captured DAGNN train step and predict over four batches of
  one loader bucket equal the eager step's, leaf by leaf, bit for bit (a
  stale buffer, an output not written back or a generator not handed
  through would show); one capture, four replays;
- the VAE driver's captured step with a learning rate that changes every
  call equals the eager step's bit for bit (an lr frozen at the capture
  would show); optim.update with a 0-d tensor lr is the float lr's bits;
- keys: two batches of one bucket share one; another bucket's shapes, or
  pair blocks of other widths, do not; widened output-slot lists read
  the same logits;
- graph_nodes reads a graph's kernel and copy nodes from a debug dump in
  the format the CUDA runtime writes, and kernel_name reads a mangled
  symbol and the profiler's demangled signature alike;
- train_vae's epoch with a short tail: every step one replay, the tail
  under a key of its own, one capture a key over two epochs, bit for bit
  the eager epochs (parameters, Adam's state, the loss sums);
- train_vae with --scan-chunk 3 and a short tail against the JAX driver's
  step_scan epochs (f32 tolerances, rtol 5e-4 / atol 5e-5, as
  test_torch_vae_driver.py); with a plateau drop forced after epoch 1,
  the captured run equals the all-eager run bit for bit and its epoch 2
  differs from the run without the drop. (After a drop the JAX driver
  scales the gradients, which Adam undoes, where the port lowers the
  learning rate, ROADMAP queue 3: the runs with a drop are held to the
  port's eager steps, not to JAX.)
"""

import csv
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from dagnn_tpu.cli import train_vae as jdriver
from dagnn_tpu.train import optim as joptim
from dagnn_tpu.vae import dagnn_vae as jvae
from dagnn_tpu_torch import convert, flagship
from dagnn_tpu_torch.cli import ogb_driver
from dagnn_tpu_torch.cli import train_vae as tdriver
from dagnn_tpu_torch.dag.batch import collate
from dagnn_tpu_torch.data.dataloader import DAGLoader
from dagnn_tpu_torch.data.synthetic import synthetic_ast_batch
from dagnn_tpu_torch.nn.dagnn import dagnn_forward, dagnn_init
from dagnn_tpu_torch.train import optim
from dagnn_tpu_torch.vae import dagnn_vae as tvae

torch.set_num_threads(1)

VOCAB, SEQ = 23, 3


def _cfg(**kw):
    return dataclasses.replace(
        flagship.flagship_cfg(emb=16, hidden=16, vocab=VOCAB, seq=SEQ,
                              compute_dtype="float32", num_attrs=40), **kw)


def _graphs(n=24, seed=0):
    return synthetic_ast_batch(seed, n, mean_nodes=12, vocab=VOCAB, seq_len=SEQ,
                               num_attrs=40)


def _bucket(graphs, batch_size=6):
    """A loader's batches of one epoch, widened to its out-slot width."""
    loader = DAGLoader(graphs, batch_size, shuffle=True, seed=3, chunk_size=8,
                       prefetch=0)
    return [convert.widen_out_slots(b, loader.out_per_graph) for b in loader]


def _equal(a, b, what):
    fa = convert.flatten_tree(a)
    fb = convert.flatten_tree(b)
    assert fa.keys() == fb.keys(), what
    for k in fa:
        assert torch.equal(fa[k], fb[k]), f"{what}: {k}"


def test_staged_steps_equal_eager_steps():
    cfg = _cfg(dropout=0.2)
    batches = _bucket(_graphs())
    assert len(batches) == 4
    assert len({convert.batch_key(b) for b in batches}) == 1
    opt = optim.make_optimizer(1e-2, 0.25)
    params = dagnn_init(0, cfg, device="cpu")
    ref = {k: v.clone() for k, v in params.items()}
    steps = {c: ogb_driver.make_step_fns(cfg, opt, "tok", capture=c)
             for c in (True, False)}
    runs = {}
    for c, (train_step, predict) in steps.items():
        p, s = params, opt.init(params)
        gen = torch.Generator().manual_seed(7)
        seen = []
        for b in batches:
            p, s, loss, finite = train_step(p, s, b, gen)
            assert bool(finite)
            # copies taken now: the captured step's state is overwritten
            # by its next call
            seen.append((float(loss), {k: v.clone() for k, v in p.items()},
                         convert.tree_map(torch.clone, s),
                         predict(p, batches[0])))
        runs[c] = seen
    for i, (cap, eag) in enumerate(zip(runs[True], runs[False])):
        assert cap[0] == eag[0], f"loss of step {i}"
        _equal(cap[1], eag[1], f"params after step {i}")
        _equal({"count": cap[2]["count"], **cap[2]["mu"]},
               {"count": eag[2]["count"], **eag[2]["mu"]}, f"mu, step {i}")
        _equal(cap[2]["nu"], eag[2]["nu"], f"nu, step {i}")
        assert torch.equal(cap[3], eag[3]), f"predict after step {i}"
    train_step, predict = steps[True]
    assert (train_step.captured.captures, train_step.captured.replays) == (1, 4)
    assert (predict.captured.captures, predict.captured.replays) == (1, 4)
    # the caller's tensors are never written: the first call cloned them
    _equal(params, ref, "the initial parameters")


def test_state_given_again_is_copied_in():
    """A state that is not the captured step's own buffers (a checkpoint
    loaded) is copied into them: the step then runs from it."""
    cfg = _cfg()
    b = _bucket(_graphs(12), 6)[0]
    opt = optim.make_optimizer(1e-2, 0.25)
    params = dagnn_init(1, cfg, device="cpu")
    train_step, _ = ogb_driver.make_step_fns(cfg, opt, "tok")
    eager, _ = ogb_driver.make_step_fns(cfg, opt, "tok", capture=False)
    p1, s1, _, _ = train_step(params, opt.init(params), b)
    p2, s2, loss2, _ = train_step(params, opt.init(params), b)
    assert p2 is p1 and s2 is s1
    pe, se, loss_e, _ = eager(params, opt.init(params), b)
    assert float(loss2) == float(loss_e)
    _equal(p2, pe, "params from the state given again")


def test_vae_step_stages_the_learning_rate(tmp_path):
    """The VAE's captured step (its state the parameters, Adam's and the
    loss sums; its inputs the host batch, the plateau scale the gradients
    are multiplied by, and the noise generator) with the scale changed
    every call, against the eager step."""
    args = tdriver.parse_args(["--cpu", "--max-count", "40", "--hs", "8",
                               "--nz", "4", "--res_dir", str(tmp_path)])
    train, _, ga = tdriver.load_data(args)
    model = tdriver.VAEModel(args, ga, torch.device("cpu"))
    params = model.init(0)
    opt = optim.make_optimizer(1e-3, 0.25)
    step = tdriver.make_train_step(model, opt)
    captured = tdriver.make_captured_step(step)
    hosts = [model.prepare_host(train[i:i + 8]) for i in range(0, 32, 8)]
    rates = [1e-3, 1e-4, 3e-3, 1e-5]
    ga_, gb = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    pc, sc, sums = params, opt.init(params), torch.zeros(3)
    pe, se, sums_e = params, opt.init(params), torch.zeros(3)
    for host, lr in zip(hosts, rates):
        inputs = (host, np.asarray(lr, np.float32), ga_)
        (pc, sc, sums), _ = captured(("vae", convert.batch_key(inputs)),
                                     (pc, sc, sums), inputs, (ga_,))
        pe, se, stats = step(pe, se, convert.batch_to_torch(host, "cpu"), gb, lr)
        sums_e = sums_e + stats
        _equal(pc, pe, f"params at lr {lr}")
        assert torch.equal(sums, sums_e)
    assert (captured.captures, captured.replays) == (1, 4)


def test_tensor_lr_is_the_float_lr():
    rng = np.random.default_rng(0)
    g = {k: torch.as_tensor(rng.normal(size=s).astype(np.float32))
         for k, s in (("a", (7, 5)), ("b", (11,)))}
    opt = optim.make_optimizer(1e-3, 0.25)
    state = opt.init(g)
    for lr in (1e-3, 1e-4 * 0.1, 3.3e-5):
        uf, sf = opt.update(g, state, lr)
        ut, st = opt.update(g, state, torch.tensor(lr, dtype=torch.float32))
        _equal(uf, ut, f"updates at lr {lr}")
        _equal(sf["mu"], st["mu"], "mu")


def test_keys_follow_the_bucket_and_the_pair_blocks():
    graphs = _graphs(24)
    a, b = _bucket(graphs)[:2]
    assert convert.batch_key(a) == convert.batch_key(b)
    other = collate(graphs[:6], flagship.pad_for(graphs[:6], chunk=8,
                                                 edge_budget=16))
    assert convert.batch_key(other) != convert.batch_key(a)
    pair = collate(graphs[:6], flagship.pad_for(graphs[:6], chunk=8,
                                                edge_budget=16, pair=2))
    blocks = pair.pair.bshape
    wider = pair._replace(pair=pair.pair._replace(bshape=(
        np.zeros((blocks[0].shape[0] + 8, 0), blocks[0].dtype), *blocks[1:])))
    assert wider.pair.blocks != pair.pair.blocks
    assert convert.batch_key(wider) != convert.batch_key(pair)
    cfg = _cfg()
    assert (ogb_driver.step_key("train", cfg, pair)[1],
            ogb_driver.step_key("train", cfg, a)[1]) == ("pair", "merged")


# Five nodes of a graph's debug dump (cudaGraphDebugDotPrint, verbose), as
# an H100 with CUDA 12.8 wrote it: a K6 forward, three ATen kernels, a copy
_DUMP = r"""digraph dot {
subgraph cluster_1 {
label="graph_1" graph[style="dashed"];
"graph_1_node_0"[style="bold" shape="record" label="{KERNEL
| {ID | 0 (topoId: 5) | _Z13sa_fwd_kernelIfLi2EEviiiPKT_S2_PKiPKfPS0_\<\<\<4,128,0\>\>\>}
| {{node handle | func handle} | {0x000000000A0DB210 | 0x000000000A0B6E20}}
| {cooperative | 0}
}"];

"graph_1_node_1"[style="bold" shape="record" label="{KERNEL
| {ID | 1 (topoId: 4) | _ZN2at6native29vectorized_elementwise_kernelILi4ENS0_13AUnaryFunctorIfffNS0_15binary_internal10MulFunctorIfEEEESt5arrayIPcLm2EEEEviT0_T1_\<\<\<1,128,0\>\>\>}
| {priority | 0}
}"];

"graph_1_node_2"[style="bold" shape="record" label="{KERNEL
| {ID | 2 (topoId: 3) | _ZN2at6native13reduce_kernelILi128ELi4ENS0_8ReduceOpIfNS0_14func_wrapper_tIfZNS0_11sum_functorIfffEclERNS_14TensorIteratorEEUlffE_EEjfLi4ELi4EEEEEvT1_\<\<\<1,\{8,16\},0\>\>\>}
| {priority | 0}
}"];

"graph_1_node_3"[style="bold" shape="record" label="{KERNEL
| {ID | 3 (topoId: 2) | _ZN2at6native29vectorized_elementwise_kernelILi4ENS0_21CUDAFunctorOnSelf_addIfEESt5arrayIPcLm2EEEEviT0_T1_\<\<\<1,128,0\>\>\>}
| {priority | 0}
}"];

"graph_1_node_4"[style="solid" shape="record" label="{
MEMCPY
| {{ID | node handle} | {4 (topoId: 1) | 0x000000000A0DCFB0}}
| {kind | DtoD (DEVICE to DEVICE)}
}"];

"graph_1_node_0" -> "graph_1_node_1" [headlabel=0];
}
}
"""


class _Dumped:
    """A stand-in for a kept CUDAGraph in debug mode: debug_dump writes
    `text` where it is asked to."""

    def __init__(self, text):
        self.text = text

    def debug_dump(self, path):
        with open(path, "w") as f:
            f.write(self.text)


def test_graph_nodes_read_a_debug_dump():
    from dagnn_tpu_torch.train.graphs import graph_nodes, kernel_name
    nodes = graph_nodes(_Dumped(_DUMP))
    assert sum(nodes.values()) == 5 and nodes["memcpy"] == 1
    names = sorted(kernel_name(k) for k, v in nodes.items() for _ in range(v)
                   if k != "memcpy")
    assert names == ["reduce_kernel", "sa_fwd_kernel",
                     "vectorized_elementwise_kernel",
                     "vectorized_elementwise_kernel"]
    # the profiler's demangled signatures read as the graph's symbols do
    assert kernel_name("void sa_fwd_kernel<float, 2>(int, int, int, float "
                       "const*, float const*, int const*, float const*, "
                       "float*)") == "sa_fwd_kernel"
    assert kernel_name("void at::native::(anonymous namespace)::"
                       "multi_tensor_apply_kernel<at::native::(anonymous "
                       "namespace)::TensorListMetadata<2> >(...)") == \
        "multi_tensor_apply_kernel"
    assert kernel_name("_ZN2at6native12_GLOBAL__N_125multi_tensor_apply_"
                       "kernelINS1_18TensorListMetadataILi2EEEEEvT_") == \
        "multi_tensor_apply_kernel"
    assert kernel_name("nvjet_tst_128x64_64x6_1x2_h_bz_TNT") == \
        "nvjet_tst_128x64_64x6_1x2_h_bz_TNT"
    # a graph that was not kept (no debug mode) dumps nothing
    with pytest.raises(ValueError, match="no node"):
        graph_nodes(_Dumped(""))


def test_widened_out_slots_read_the_same_logits():
    cfg = _cfg()
    graphs = _graphs(6)
    host = collate(graphs, flagship.pad_for(graphs, chunk=8, edge_budget=16))
    om = host.out_slots_fwd.shape[1]
    wide = convert.widen_out_slots(host, om + 5)
    assert wide.out_slots_mask_rev.shape[1] == om + 5
    params = dagnn_init(2, cfg, device="cpu")
    with torch.no_grad():
        got = dagnn_forward(params, cfg, convert.batch_to_torch(wide, "cpu"))
        want = dagnn_forward(params, cfg, convert.batch_to_torch(host, "cpu"))
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="wider"):
        convert.widen_out_slots(host, om - 1)


# ------------------------------------------------------------- train_vae

FLAGS = ["--max-count", "30", "--hs", "8", "--nz", "4", "--batch-size", "8",
         "--scan-chunk", "3", "--epochs", "2", "--save-interval", "10",
         "--no-test", "--cpu"]
RTOL, ATOL = 5e-4, 5e-5


@pytest.fixture
def no_noise(monkeypatch):
    mu_only = lambda rng, mu, logvar, eps_scale=0.01, training=True: mu
    for m in (jvae, jdriver, tvae, tdriver):
        monkeypatch.setattr(m, "reparameterize", mu_only)


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


class _DropAfterEpoch1(optim.PlateauScheduler):
    """A drop after epoch 1 to scale 0: the gradients then reach the clip
    and Adam as zeros, so that the drop shows in epoch 2 (a drop to 0.1
    is one Adam all but undoes)."""

    def step(self, metric):
        self.scale = 0.0
        return self.scale


class _JaxDropAfterEpoch1(joptim.PlateauScheduler):
    def step(self, metric):
        self.scale = 0.0
        return self.scale


def test_captured_epochs_replay_the_tail(tmp_path):
    """Two epochs of 43 graphs in batches of 8 and chunks of 2 (five full
    batches and a tail of 3) through train_epoch, staged against eager
    from the same weights, permutations and noise seeds."""
    args = tdriver.parse_args(["--cpu", "--max-count", "48", "--hs", "8", "--nz",
                               "4", "--batch-size", "8", "--scan-chunk", "2",
                               "--res_dir", str(tmp_path)])
    train, _, ga = tdriver.load_data(args)
    assert len(train) == 43
    model = tdriver.VAEModel(args, ga, torch.device("cpu"))
    params = model.init(0)
    opt = optim.make_optimizer(1e-3, 0.25)
    step = tdriver.make_train_step(model, opt)
    captured = tdriver.make_captured_step(step)
    runs = {}
    for tag, cap in (("captured", captured), ("eager", None)):
        rnd, gen = np.random.default_rng(1), torch.Generator()
        state, sums = (params, opt.init(params)), []
        for epoch in (1, 2):
            gen.manual_seed(100 + epoch)
            *state, total = tdriver.train_epoch(
                args, model, step, *state, train, rnd.permutation(len(train)), gen,
                1.0, epoch, 0.0, cap)
            sums.append(total.clone())
        runs[tag] = (convert.tree_map(torch.clone, tuple(state)), sums)
    (sc, uc), (se, ue) = runs["captured"], runs["eager"]
    _equal(sc, se, "parameters and Adam's state after two epochs")
    assert all(torch.equal(a, b) for a, b in zip(uc, ue))
    assert (captured.captures, captured.replays) == (2, 12)
    assert len(captured.graphs) == 2


def test_scan_chunk_epochs_match_jax_and_a_plateau_drop_reaches_the_replay(
        tmp_path, no_noise, jax_weights, monkeypatch):
    """27 train graphs in batches of 8: one chunk of 3 full batches (three
    replays) and a tail of 3 (a replay under its own key), as JAX's
    step_scan of 3 and its single step. Then a forced plateau drop after
    epoch 1, its scale staged into the replays: captured equals eager bit
    for bit, epoch 2 moves, and both follow the JAX driver under the same
    drop (the gradients scaled before the clip and Adam)."""
    d = lambda tag: ["--res_dir", str(tmp_path / tag)]
    jdriver.main(FLAGS + d("jax"))
    tdriver.main(FLAGS + d("port"))
    jrows, trows = _rows(tmp_path / "jax"), _rows(tmp_path / "port")
    assert len(jrows) == len(trows) == 2
    for j, t in zip(jrows, trows):
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)

    monkeypatch.setattr(tdriver, "PlateauScheduler", _DropAfterEpoch1)
    monkeypatch.setattr(jdriver, "PlateauScheduler", _JaxDropAfterEpoch1)
    jdriver.main(FLAGS + d("jax_drop"))
    tdriver.main(FLAGS + d("drop"))
    monkeypatch.setattr(tdriver, "CAPTURED", ())
    tdriver.main(FLAGS + d("drop_eager"))
    drop, eager = _rows(tmp_path / "drop"), _rows(tmp_path / "drop_eager")
    assert drop == eager
    assert drop[0] == trows[0] and drop[1] != trows[1]
    for j, t in zip(_rows(tmp_path / "jax_drop"), drop):
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)
    ckpt = lambda tag: torch.load(tmp_path / tag / "DAGNN_0_2.ckpt",
                                  weights_only=True)["params"]
    _equal(ckpt("drop"), ckpt("drop_eager"), "parameters after the drop")

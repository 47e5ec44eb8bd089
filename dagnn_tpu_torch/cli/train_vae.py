"""NA/BN VAE training driver.

Counterpart of dagnn_tpu/cli/train_vae.py (reference: dvae/train.py), with
the same flags: load ENAS or BN graphs (cached), train a DAGNN, DAGNN_BN,
DVAE or DVAE_BN VAE with Adam, ReduceLROnPlateau(0.1, 10) and gradient
clipping, checkpoint and extract latent representations every
--save-interval epochs (.pkl and .mat, which the sparse-GP/BO step reads),
report the test reconstruction NLL, resume from a checkpoint. Every
--model of the JAX driver runs: the DAGNN-coupled VAEs (DAGNN, DAGNN_BN),
the base D-VAEs (DVAE, DVAE_BN), the S-VAEs (SVAE, SVAE_oneshot,
SVAE_GraphRNN, SVAE_GraphRNN_BFS, over string tensors) and the D-VAE
variants (DVAE_GCN, DVAE_fast, DVAE_DeepGMG).

    python -m dagnn_tpu_torch.cli.train_vae --cpu --max-count 200 \\
        --epochs 2 --hs 16 --nz 6

It runs on the CUDA device unless --cpu is given, and raises without a
card (no CPU fallback). Each batch is collated on the host; the DAGNN
encoders run the port's generic wavefront (K6 and K5), every other model
no kernel of the port (plain tensor code, as in JAX, where none of them
reaches a Pallas kernel).

--scan-chunk is the JAX driver's: the full batches of an epoch go in
chunks of --scan-chunk, each chunk's batches prepared on the host, then
run as one replay of the captured train step each (train/graphs.py: one
CUDA graph, its inputs copied in from pinned memory, the loss sums kept on
the device inside the graph), the host reading the sums once a chunk;
the short tail batch, prepared the same way, replays the same captured
step under its own key (JAX's single jitted step): its shape is the same
every epoch, so a run captures it once. Every --model's step is captured
(CAPTURED), as JAX's step_scan runs every model.

The plateau schedule is the JAX driver's (dagnn_tpu/cli/train_vae.py:
269-273): the gradients are multiplied by the schedule's scale before the
clip and Adam, whose learning rate stays --lr; the scale is staged into
the captured step as a 0-d float32 array, as the JAX driver passes it.

Where it differs from the JAX driver, on purpose (ROADMAP queue 3):
  * a resumed run is the uninterrupted run: the permutation generator is
    fast-forwarded through the finished epochs, the reparameterization
    noise and the S-VAEs' host generator (the BFS orders of
    SVAE_GraphRNN_BFS; JAX draws them from one default_rng(0) a process)
    are seeded from (--seed, epoch), and the scheduler's state rides in
    the checkpoint's results;
  * the corpus cache is the port's own file, `<res_dir>/<data-name>_torch.npz`
    of plain arrays (the JAX driver's `<data-name>.pkl` pickles its
    NAGraph objects and is not read here); it records the flags that built
    it and is rebuilt when they differ, where the JAX driver reads its
    cache whatever --max-count says; checkpoints are the port's own format
    (train/checkpoint.py).
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import time
from typing import List

import numpy as np
import scipy.io
import torch

from dagnn_tpu_torch import resolve_device
from dagnn_tpu_torch import convert, ops
from dagnn_tpu_torch.data.na import (GraphArgs, NAGraph, load_bn, load_enas,
                                     synthetic_bn_corpus)
from dagnn_tpu_torch.train import checkpoint as ckpt, graphs
from dagnn_tpu_torch.train.metrics import CSVLogger
from dagnn_tpu_torch.train.optim import PlateauScheduler, make_optimizer
from dagnn_tpu_torch.vae.dagnn_vae import (DAGNNVAEConfig, dagnn_vae_encode,
                                           dagnn_vae_init, dagnn_vae_loss,
                                           na_collate, na_dense_views)
from dagnn_tpu_torch.vae.dvae import (DVAEConfig, dvae_base_init,
                                      dvae_encode_sequential, dvae_teacher_loss,
                                      kld, reparameterize, sub_params)
from dagnn_tpu_torch.vae.dvae_variants import (DeepGMGConfig, DVAEGCNConfig,
                                               deepgmg_encode, deepgmg_init,
                                               deepgmg_loss, dvae_fast_init,
                                               dvae_fast_loss, dvae_gcn_encode,
                                               dvae_gcn_init, dvae_gcn_loss)
from dagnn_tpu_torch.vae.svae import (SVAEConfig, graph_to_string_tensor,
                                      svae_encode, svae_init, svae_loss)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    # mirrors dvae/train.py:25-98
    p.add_argument("--data-name", default="final_structures6")
    p.add_argument("--data-path", default=None,
                   help="graph corpus txt; defaults by data-type")
    p.add_argument("--data-type", default="ENAS", choices=["ENAS", "BN"])
    p.add_argument("--nvt", type=int, default=6)
    p.add_argument("--model", default="DAGNN",
                   choices=["DAGNN", "DAGNN_BN", "DVAE", "DVAE_BN",
                            "SVAE", "SVAE_oneshot", "SVAE_GraphRNN",
                            "SVAE_GraphRNN_BFS", "DVAE_GCN", "DVAE_fast",
                            "DVAE_DeepGMG"])
    p.add_argument("--hs", type=int, default=501)
    p.add_argument("--nz", type=int, default=56)
    p.add_argument("--bidirectional", action="store_true")
    p.add_argument("--dagnn_layers", type=int, default=2)
    p.add_argument("--dagnn_agg", default="attn_h")
    p.add_argument("--dagnn_out_pool_all", type=int, default=0)
    p.add_argument("--dagnn_out_pool", default="max")
    p.add_argument("--dagnn_dropout", type=float, default=0.0)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--infer-batch-size", type=int, default=128)
    p.add_argument("--clip", type=float, default=0.25)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--save-interval", type=int, default=10)
    p.add_argument("--res_dir", default="results/vae")
    p.add_argument("--load-latest-model", action="store_true")
    p.add_argument("--continue-from", type=int, default=None)
    p.add_argument("--load-partial", default=None, metavar="CKPT",
                   help="partial state load from a checkpoint with a "
                        "possibly different architecture (reference "
                        "load_module_state, dvae/util.py:41-63)")
    p.add_argument("--no-test", action="store_true")
    p.add_argument("--small-train", action="store_true")
    p.add_argument("--scan-chunk", type=int, default=128,
                   help="full batches a chunk: prepared together, one "
                        "captured-step replay each, the loss sums read once")
    p.add_argument("--max-count", type=int, default=None)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (smoke/debug runs)")
    return p.parse_args(argv)


# ---------------------------------------------------------------- data

def _pack(graphs: List[NAGraph]):
    """NAGraphs as plain arrays: node counts, padded types and adjacency,
    scores."""
    n = np.array([g.num_nodes for g in graphs], np.int64)
    m = int(n.max(initial=1))
    types = np.zeros((len(graphs), m), np.int32)
    adj = np.zeros((len(graphs), m, m), np.uint8)
    for i, g in enumerate(graphs):
        types[i, :n[i]] = g.types
        adj[i, :n[i], :n[i]] = g.adj
    return n, types, adj, np.array([g.y for g in graphs], np.float64)


def _unpack(n, types, adj, y):
    return [NAGraph(types=types[i, :k].copy(), adj=adj[i, :k, :k].copy(),
                    y=float(y[i])) for i, k in enumerate(n)]


def _corpus_key(args) -> str:
    """The flags that decide the corpus, as the cache records them."""
    return json.dumps([args.data_type, args.nvt, args.max_count,
                       args.data_path, args.seed])


def load_data(args):
    """Load and cache the corpus (dvae/train.py:119-142). The cache holds
    the flags that built it and is read only when they are this run's;
    otherwise the corpus is built anew and the cache overwritten."""
    os.makedirs(args.res_dir, exist_ok=True)
    cache = os.path.join(args.res_dir, f"{args.data_name}_torch.npz")
    if os.path.exists(cache):
        with np.load(cache, allow_pickle=False) as z:
            if "key" in z and str(z["key"]) == _corpus_key(args):
                ga = GraphArgs(*[int(v) for v in z["graph_args"]])
                return (_unpack(*[z[f"train_{k}"] for k in "ntay"]),
                        _unpack(*[z[f"test_{k}"] for k in "ntay"]), ga)
    if args.data_type == "ENAS":
        # the ENAS corpus ships with the repo (gzipped dataset asset)
        path = args.data_path or os.path.join(
            os.path.dirname(__file__), "..", "..", "data",
            "final_structures6.txt.gz")
        tr, te, ga = load_enas(path, n_types=args.nvt, max_count=args.max_count)
    elif args.data_path and os.path.exists(args.data_path):
        tr, te, ga = load_bn(args.data_path, n_types=args.nvt,
                             max_count=args.max_count)
    else:
        # asia_200k.txt is absent from the reference checkout: a synthetic
        # corpus in the same format
        tr, te, ga = synthetic_bn_corpus(args.max_count or 2000, n_types=args.nvt,
                                         seed=args.seed)
    arrays = {"key": np.array(_corpus_key(args)),
              "graph_args": np.array([ga.num_vertex_type, ga.max_n,
                                      ga.start_type, ga.end_type,
                                      ga.num_class], np.int64)}
    for tag, gs in (("train", tr), ("test", te)):
        arrays.update({f"{tag}_{k}": a for k, a in zip("ntay", _pack(gs))})
    np.savez(cache, **arrays)
    return tr, te, ga


# --------------------------------------------------------------- model

class VAEModel:
    """One facade over every VAE of the driver, on one device (the JAX
    driver's VAEModel, dagnn_tpu/cli/train_vae.py:129-226)."""

    def __init__(self, args, ga: GraphArgs, device):
        self.kind = args.model
        self.device = device
        dims = dict(max_n=ga.max_n, nvt=ga.num_vertex_type, hs=args.hs,
                    nz=args.nz, bidirectional=args.bidirectional)
        if self.kind.startswith("SVAE"):
            self.cfg = SVAEConfig(**dims, oneshot="oneshot" in self.kind,
                                  graphrnn="GraphRNN" in self.kind,
                                  bfs="BFS" in self.kind)
            self.host_rng = np.random.default_rng(0)
        elif self.kind == "DVAE_GCN":
            self.cfg = DVAEGCNConfig(**dims)
        elif self.kind == "DVAE_DeepGMG":
            self.cfg = DeepGMGConfig(**dims)
        elif self.kind == "DVAE_fast":
            self.cfg = DVAEConfig(**dims, num_layers=1, vid=True)
        elif self.kind.startswith("DAGNN"):
            self.cfg = DAGNNVAEConfig(
                **dims, num_layers=args.dagnn_layers, agg=args.dagnn_agg,
                out_pool_all=bool(args.dagnn_out_pool_all),
                out_pool=args.dagnn_out_pool, dropout=args.dagnn_dropout,
                bn=self.kind == "DAGNN_BN")
        else:
            self.cfg = DVAEConfig(
                **dims, num_layers=1, vid=self.kind == "DVAE",
                bn=self.kind == "DVAE_BN", dec_agg="gated_sum",
                pred_source="x" if self.kind == "DVAE_BN" else "h")

    def init(self, seed: int):
        """Initial parameters from `seed` (the port's own random stream)."""
        if self.kind.startswith("SVAE"):
            init = svae_init
        elif self.kind.startswith("DAGNN"):
            init = dagnn_vae_init
        else:
            init = {"DVAE_GCN": dvae_gcn_init, "DVAE_DeepGMG": deepgmg_init,
                    "DVAE_fast": dvae_fast_init}.get(self.kind, dvae_base_init)
        return init(seed, self.cfg, device=self.device)

    def seed_host(self, seed: int, epoch: int):
        """Reseed the host generator the S-VAE codec draws from (the BFS
        orders) from (seed, epoch), so a resumed epoch draws what the
        uninterrupted run draws."""
        if self.kind.startswith("SVAE"):
            self.host_rng = np.random.default_rng([seed, epoch])

    def prepare_host(self, graphs: List[NAGraph]):
        """(batch or None, types, adj, nv) as host arrays: the DAGNN
        encoder's collated batch (its output-slot lists, which the VAE
        reads nowhere, widened to a graph's nodes, so that every batch of
        one size has one shape) and the decoder's dense views; for the
        S-VAEs (None, string tensors [B, steps, xs], None, zeros)."""
        if self.kind.startswith("SVAE"):
            G = np.stack([graph_to_string_tensor(g, self.cfg, self.host_rng)
                          for g in graphs])
            return None, G, None, np.zeros(len(graphs), np.int32)
        if self.kind.startswith("DAGNN"):
            batch, types, adj, nv = na_collate(graphs, self.cfg)
            return (convert.widen_out_slots(batch, self.cfg.num_nodes), types,
                    adj, nv)
        return (None, *na_dense_views(graphs, self.cfg.max_n))

    def prepare(self, graphs: List[NAGraph]):
        """prepare_host's arrays on the device."""
        return convert.batch_to_torch(self.prepare_host(graphs), self.device)

    def loss(self, params, prepared, gen, training=True, impl=None):
        """(total, recon, kld); gen draws the reparameterization noise.
        impl: the DAGNN encoder's segment functions (SEG_KERNELS when
        None, or SEG_PLAIN)."""
        batch, types, adj, nv = prepared
        if self.kind.startswith("SVAE"):
            return svae_loss(params, self.cfg, types, gen, training)
        if self.kind.startswith("DAGNN"):
            return dagnn_vae_loss(params, self.cfg, batch, types, adj, nv, gen,
                                  training, impl)
        variant = {"DVAE_GCN": dvae_gcn_loss, "DVAE_DeepGMG": deepgmg_loss,
                   "DVAE_fast": dvae_fast_loss}.get(self.kind)
        if variant is not None:
            return variant(params, self.cfg, types, adj, nv, gen, training)
        mu, logvar = dvae_encode_sequential(params, self.cfg, types, adj, nv)
        z = reparameterize(gen, mu, logvar, self.cfg.eps_scale, training)
        recon, _ = dvae_teacher_loss(sub_params(params, "dec."), self.cfg, z,
                                     types, adj, nv)
        k = kld(mu, logvar)
        return recon + self.cfg.beta * k, recon, k

    def encode_mu(self, params, prepared, impl=None):
        batch, types, adj, nv = prepared
        if self.kind.startswith("SVAE"):
            return svae_encode(params, self.cfg, types)[0]
        if self.kind.startswith("DAGNN"):
            return dagnn_vae_encode(params, self.cfg, batch, impl)[0][: len(types)]
        encode = {"DVAE_GCN": dvae_gcn_encode,
                  "DVAE_DeepGMG": deepgmg_encode}.get(self.kind, dvae_encode_sequential)
        return encode(params, self.cfg, types, adj, nv)[0]


def make_train_step(model: VAEModel, opt):
    """train_step(params, opt_state, prepared, gen, scale) -> (params,
    opt_state, [total, recon, kld] on the device): one loss and backward,
    the gradients multiplied by the plateau schedule's scale (a float or
    a 0-d float32 tensor), then the clip and Adam at opt's learning rate,
    as the JAX driver's step. Parameters the loss does not reach (the
    encoder's dummy head; the gate/mapper pairs an attention model does
    not use) get zero gradients, as jax.grad gives them."""

    def train_step(params, opt_state, prepared, gen, scale):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        total, recon, kl = model.loss(p, prepared, gen)
        gs = torch.autograd.grad(total, list(p.values()), allow_unused=True)
        with torch.no_grad():
            grads = {k: torch.zeros_like(v) if g is None else g * scale
                     for (k, v), g in zip(p.items(), gs)}
            updates, opt_state = opt.update(grads, opt_state)
            params = {k: params[k] + updates[k] for k in params}
        return params, opt_state, torch.stack([total, recon, kl]).detach()

    return train_step


# The --model values whose train step is captured (train/graphs.py): all
# of them, the DAGNN VAEs, the base D-VAEs, the S-VAEs and the D-VAE
# variants.
CAPTURED = ("DAGNN", "DAGNN_BN", "DVAE", "DVAE_BN", "SVAE", "SVAE_oneshot",
            "SVAE_GraphRNN", "SVAE_GraphRNN_BFS", "DVAE_GCN", "DVAE_fast",
            "DVAE_DeepGMG")


def make_captured_step(train_step):
    """train_step as a captured step: its state (params, opt_state, the
    epoch's [total, recon, kld] sums, which the graph adds each step's
    into), its inputs (prepare_host's arrays, the plateau scale as a 0-d
    float32 array, the noise generator). It keeps two graphs, the full
    batches' and the tail's, so that neither evicts the other each
    epoch."""

    def fn(state, inputs):
        params, opt_state, sums = state
        prepared, scale, gen = inputs
        params, opt_state, stats = train_step(params, opt_state, prepared, gen, scale)
        return (params, opt_state, sums + stats), None

    return graphs.CapturedStep(fn, keep=2)


def train_epoch(args, model, train_step, params, opt_state, data, order,
                gen, scale, epoch, t0, captured=None):
    """One epoch's batches in `order` (the reference's exact batches,
    dvae/train.py:228-235, the tail one short), as the JAX driver runs
    them: the full batches in chunks of --scan-chunk, each chunk's batches
    prepared on the host and then stepped, the loss sums read once a chunk
    for the progress line; then the tail batch. Each step is one replay of
    `captured` (the tail under a key of its own), or the eager train_step
    without it, its gradients multiplied by the plateau `scale`. The sums
    stay on the device. Returns (params, opt_state, [total, recon, kld]
    sums)."""
    bs = args.batch_size
    starts = range(0, len(order), bs)
    full = [i for i in starts if i + bs <= len(order)]
    tail = [i for i in starts if i + bs > len(order)]
    K = max(1, min(args.scan_chunk, len(full)))
    sums = torch.zeros(3, device=model.device)
    rate = np.asarray(scale, np.float32)
    batch_of = lambda i: [data[j] for j in order[i:i + bs]]

    def step(host, state):
        params, opt_state, sums = state
        if captured is None:
            params, opt_state, stats = train_step(
                params, opt_state, convert.batch_to_torch(host, model.device),
                gen, scale)
            return params, opt_state, sums + stats
        inputs = (host, rate, gen)
        return captured(("vae", model.kind, convert.batch_key(inputs)),
                        state, inputs, (gen,))[0]

    state = (params, opt_state, sums)
    for c in range(0, len(full), K):
        chunk = [model.prepare_host(batch_of(i)) for i in full[c:c + K]]
        for host in chunk:
            state = step(host, state)
        print(f"  epoch {epoch} step {c + len(chunk)}/{len(starts)} "
              f"[{time.time() - t0:.0f}s] loss sum {float(state[2][0]):.4f}",
              flush=True)
    for i in tail:
        state = step(model.prepare_host(batch_of(i)), state)
    return state


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")
    train_data, test_data, ga = load_data(args)
    if args.small_train:
        train_data = train_data[:100]
    print(f"{len(train_data)} train / {len(test_data)} test, "
          f"nvt={ga.num_vertex_type} max_n={ga.max_n}, on {device}")

    model = VAEModel(args, ga, device)
    params = model.init(args.seed)
    opt = make_optimizer(args.lr, args.clip)
    opt_state = opt.init(params)
    sched = PlateauScheduler(factor=0.1, patience=10)
    loss_log = CSVLogger(os.path.join(args.res_dir, "train_loss.txt"),
                         ["epoch", "loss", "recon", "kld"])
    name = args.model

    start_epoch = 1
    if args.load_partial:
        params, n_ok, n_skip = ckpt.load_partial_state(args.load_partial, params)
        print(f"partial load from {args.load_partial}: "
              f"{n_ok} leaves restored, {n_skip} kept from init")
    path = None
    if args.continue_from is not None:
        path = ckpt.checkpoint_name(args.res_dir, name, 0, args.continue_from)
    elif args.load_latest_model:
        path = ckpt.find_latest_checkpoint(args.res_dir, name)
    if path:
        results, ep, params, opt_state = ckpt.load_checkpoint(path, params,
                                                              opt_state)
        if results and "scheduler" in results:
            sched.load_state_dict(results["scheduler"])
        start_epoch = ep + 1
        print(f"resumed from {path}")

    train_step = make_train_step(model, opt)
    captured = make_captured_step(train_step) if model.kind in CAPTURED else None
    rnd = np.random.default_rng(args.seed)
    for _ in range(1, start_epoch):        # the finished epochs' draws
        rnd.permutation(len(train_data))
    gen = torch.Generator(device=device)
    for epoch in range(start_epoch, args.epochs + 1):
        t0 = time.time()
        order = rnd.permutation(len(train_data))
        gen.manual_seed(args.seed * 100003 + epoch)
        model.seed_host(args.seed, epoch)
        before = ops.read_launch_counts()
        params, opt_state, sums = train_epoch(
            args, model, train_step, params, opt_state, train_data, order, gen,
            sched.scale, epoch, t0, captured)
        tot, rec, kl = (float(x) for x in sums.cpu())
        n = len(train_data)
        print(f"====> Epoch: {epoch} Average loss: {tot / n:.4f} "
              f"(recon {rec / n:.4f}, kld {kl / n:.4f}) [{time.time() - t0:.1f}s]")
        launched = {k: v - before[k] for k, v in ops.read_launch_counts().items()
                    if v != before[k]}
        if launched:
            print("  kernel launches this epoch: " + ", ".join(
                f"{k} {v}" for k, v in sorted(launched.items())))
        loss_log.append([epoch, tot / n, rec / n, kl / n])
        sched.step(tot / n)

        if epoch % args.save_interval == 0 or epoch == args.epochs:
            ckpt.create_checkpoint(
                ckpt.checkpoint_name(args.res_dir, name, 0, epoch), epoch,
                params, opt_state, {"scheduler": sched.state_dict()})
            save_latent_representations(args, model, params, train_data,
                                        test_data, epoch)

    if captured is not None:
        print(f"captured train step (captures / replays) this run: "
              f"{captured.captures} / {captured.replays}")
    if not args.no_test:
        nll = test_nll(args, model, params, test_data)
        with open(os.path.join(args.res_dir, "test_results.txt"), "a") as f:
            f.write(f"epoch {args.epochs} Test average recon loss: {nll}\n")
    return params


def _batched(graphs, size):
    for i in range(0, len(graphs), size):
        yield graphs[i: i + size]


@torch.no_grad()
def extract_latent(args, model, params, data):
    """(Z [n, nz] float32, Y [n]): mu of every graph, in batches of
    --infer-batch-size."""
    Z, Y = [], []
    for chunk in _batched(data, args.infer_batch_size):
        Z.append(model.encode_mu(params, model.prepare(chunk)).cpu().numpy())
        Y.extend(g.y for g in chunk)
    return np.concatenate(Z, 0), np.asarray(Y)


def save_latent_representations(args, model, params, train_data, test_data,
                                epoch):
    """.pkl + .mat latent dumps (dvae/train.py:338-355)."""
    t0 = time.time()
    Z_train, Y_train = extract_latent(args, model, params, train_data)
    Z_test, Y_test = extract_latent(args, model, params, test_data)
    base = os.path.join(args.res_dir, f"{args.data_name}_latent_epoch{epoch}")
    with open(base + ".pkl", "wb") as f:
        pickle.dump((Z_train, Y_train, Z_test, Y_test), f)
    scipy.io.savemat(base + ".mat", mdict={
        "Z_train": Z_train, "Z_test": Z_test,
        "Y_train": Y_train, "Y_test": Y_test,
    })
    print(f"saved latent representations to {base}.pkl/.mat "
          f"[{time.time() - t0:.1f}s]")


@torch.no_grad()
def test_nll(args, model, params, test_data):
    """Held-out teacher-forced reconstruction NLL (dvae/train.py:276-311),
    without noise."""
    t0 = time.time()
    nll = 0.0
    for chunk in _batched(test_data, args.infer_batch_size):
        _, recon, _ = model.loss(params, model.prepare(chunk), None,
                                 training=False)
        nll += float(recon)
    nll /= len(test_data)
    print(f"Test average recon loss: {nll} [{time.time() - t0:.1f}s]")
    return nll


if __name__ == "__main__":
    main()

"""Shared ogbg-code2 experiment driver: fold loop, train/eval, checkpoint,
resume, CSV metrics, early stopping.

Counterpart of dagnn_tpu/cli/ogb_driver.py (reference:
ogbg-code/main_pyg.py:39-126 train/eval, :249-343 fold loop with
checkpoint-resume fast-forward and patience early-stop; main_pyg_lp.py for
the LP task), with the same flags and defaults. Data comes from a real
ogbg-code2 raw directory when available, or from the synthetic AST
generator.

--gnn selects the model as the JAX driver does: dagnn (DAGNNConfig), the
pooling baselines dgcnn | diffpool | unet | sagpool | asap (HPoolConfig,
nn/pooling_baselines.py), the gnn2.py family ggnns | ggnn (GGNN_Simple) |
ggnn-etype (the edge-typed GGNN) | gat (GNN2Config, nn/gnn2_models.py),
and every other name gin | gcn | gat | ggnn with an optional -virtual
(MPNNConfig, nn/baselines.py; the gnn2 names above take precedence). The
baselines run on unleveled batches (DAGLoader(schedules=False)) and
compute in float32 on the card and the CPU alike, whatever
--compute_dtype says, as the JAX package's baselines do.

It runs on the CUDA device unless --cpu is given, and raises without a
card (no CPU fallback). --segment_impl auto is "fused" (the row kernels
where the config takes them, the generic branch otherwise: LP's gated_sum
default runs there) and --compute_dtype auto is bfloat16 on the card,
float32 with --cpu, as the JAX driver chooses by backend; "dense" and
"scatter" run the generic branch. Each fold's parameters come from
`init_params`. Every model's train step and predict are captured steps
(make_step_fns, train/graphs.py): each host batch, its output-slot lists
widened to the loader's widest (convert.widen_out_slots, so that a bucket
has one shape; the baselines' unleveled batches have none), is copied
into the graph's buffers and the graph replayed, one dispatch a step as
the JAX driver's jitted step.
Dropout (--dagnn_dropout) draws from one torch.Generator per fold on the
run's device, reseeded at each epoch from --seed, the fold and the epoch,
so a resumed epoch draws the masks an uninterrupted run draws; the
baselines' dropout (--dagnn_dropout, as in JAX) draws from it the same
way. Checkpoints are the port's own format (train/checkpoint.py).

The train step keeps the JAX driver's nonfinite-step guard: when the loss
or any gradient is not finite, the update is skipped, parameters and
optimizer state stay as they were, and the step returns NaN as its loss
(the mixed-precision skip, torch GradScaler's equivalent). The guard runs
on the device with torch.where, without a host sync.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from dagnn_tpu_torch import convert, resolve_device
from dagnn_tpu_torch.convert import batch_to_torch
from dagnn_tpu_torch.data import code2
from dagnn_tpu_torch.data.dataloader import DAGLoader
from dagnn_tpu_torch.data.synthetic import synthetic_ast_batch
from dagnn_tpu_torch.nn import dagnn
from dagnn_tpu_torch.nn.baselines import MPNNConfig, mpnn_forward, mpnn_init
from dagnn_tpu_torch.nn.dagnn import DAGNNConfig, dagnn_forward, dagnn_init
from dagnn_tpu_torch.nn.encoders import EncoderSpec
from dagnn_tpu_torch.nn.gnn2_models import GNN2Config, gnn2_forward, gnn2_init
from dagnn_tpu_torch.nn.pooling_baselines import (HPoolConfig, hpool_forward,
                                                  hpool_init)
from dagnn_tpu_torch.train import checkpoint as ckpt, graphs
from dagnn_tpu_torch.train.losses import class_loss, tok_loss
from dagnn_tpu_torch.train.metrics import RunLogger, summary_report
from dagnn_tpu_torch.train.optim import make_optimizer

LP_NUM_CLASSES = 275  # reference main_pyg_lp.py:341-343


def add_common_args(p: argparse.ArgumentParser):
    # mirrors main_pyg.py:129-189 flag surface
    p.add_argument("--gnn", default="dagnn")
    p.add_argument("--emb_dim", type=int, default=300)
    p.add_argument("--batch_size", type=int, default=160)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--clip", type=float, default=0.25)
    p.add_argument("--folds", type=int, default=5)
    p.add_argument("--patience", type=int, default=10)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--num_vocab", type=int, default=5000)
    p.add_argument("--max_seq_len", type=int, default=5)
    p.add_argument("--dagnn_layers", type=int, default=2)
    p.add_argument("--dagnn_agg", default="attn_h")
    p.add_argument("--dagnn_bidir", type=int, default=1)
    p.add_argument("--dagnn_out_wx", type=int, default=0)
    p.add_argument("--dagnn_out_pool_all", type=int, default=0)
    p.add_argument("--dagnn_out_pool", default="max")
    p.add_argument("--dagnn_dropout", type=float, default=0.0)
    p.add_argument("--w_edge_attr", type=int, default=1)
    p.add_argument("--data_root", default=None,
                   help="ogbg-code2 root with raw/ and split/project/")
    p.add_argument("--train_idx", default=None,
                   help="train subset csv.gz (train10/15/20)")
    p.add_argument("--synthetic", type=int, default=0,
                   help="use N synthetic AST graphs instead of real data")
    p.add_argument("--synthetic_targets", default="random",
                   choices=["random", "structural"],
                   help="synthetic TOK targets: random (memorization "
                        "ceiling) or structure-derived (generalization)")
    p.add_argument("--synthetic_mean_nodes", type=int, default=60)
    p.add_argument("--synthetic_num_attrs", type=int, default=10030,
                   help="attr-vocab size of synthetic nodes; SMALL values "
                        "remove the per-graph identification channel so "
                        "val/test accuracy measures structural "
                        "generalization, not memorization")
    p.add_argument("--smoke", action="store_true",
                   help="tiny 50/10/10 split (reference CPU smoke mode)")
    p.add_argument("--checkpointing", type=int, default=1)
    p.add_argument("--checkpoint", default="")
    p.add_argument("--dir_results", default="results")
    p.add_argument("--dir_save", default="saved_models")
    p.add_argument("--name", default=None)
    p.add_argument("--chunk_size", type=int, default=256)
    p.add_argument("--prefetch", type=int, default=2)
    p.add_argument("--segment_impl", default="auto",
                   choices=["auto", "dense", "scatter", "fused"],
                   help="auto: fused (the row kernels where the config takes "
                        "them); dense and scatter: the generic branch")
    p.add_argument("--compute_dtype", default="auto",
                   choices=["auto", "float32", "bfloat16"],
                   help="auto: bfloat16 on the card, float32 with --cpu")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (smoke/debug runs)")
    return p


def build_model_cfg(args, task: str, num_nodetypes=98, num_nodeattributes=10030):
    """Model config for TOK/LP (reference init_model, main_pyg.py:370-405):
    --gnn selects dagnn or a baseline, as the JAX driver routes it."""
    enc = EncoderSpec("ast", emb_dim=args.emb_dim,
                      num_nodetypes=num_nodetypes,
                      num_nodeattributes=num_nodeattributes,
                      max_depth=20)
    heads = dict(num_vocab=args.num_vocab + 2 if task == "tok" else 0,
                 max_seq_len=args.max_seq_len,
                 num_class=LP_NUM_CLASSES if task == "lp" else 0)
    if args.gnn in ("dgcnn", "diffpool", "unet", "sagpool", "asap"):
        return HPoolConfig(kind=args.gnn, emb_dim=args.emb_dim,
                           dropout=args.dagnn_dropout, encoder=enc, **heads)
    if args.gnn in ("ggnns", "ggnn", "ggnn-etype", "gat"):
        # the gnn2.py family (reference 'ggnns'/'ggnn' = GGNN_Simple,
        # main_pyg.py:387 / main_pyg_lp.py:361; 'ggnn-etype' = the
        # edge-typed GGNN of gnn2.py:80, which the JAX driver keeps runnable)
        kind = {"ggnns": "ggnn_simple", "ggnn": "ggnn_simple",
                "ggnn-etype": "ggnn", "gat": "gat"}[args.gnn]
        return GNN2Config(
            kind=kind, emb_dim=args.emb_dim,
            num_layers=args.dagnn_layers if args.dagnn_layers > 2 else 3,
            encoder=enc, **heads)
    if args.gnn != "dagnn":
        return MPNNConfig(
            gnn_type=args.gnn.replace("-virtual", ""),
            virtual_node="virtual" in args.gnn,
            num_layers=args.dagnn_layers if args.dagnn_layers > 2 else 5,
            emb_dim=args.emb_dim, dropout=args.dagnn_dropout, encoder=enc,
            **heads)
    return DAGNNConfig(
        emb_dim=args.emb_dim,
        hidden_dim=args.emb_dim,
        num_rels=2,
        w_edge_attr=bool(args.w_edge_attr),
        num_layers=args.dagnn_layers,
        bidirectional=bool(args.dagnn_bidir),
        agg=args.dagnn_agg,
        out_wx=args.dagnn_out_wx > 0,
        out_pool_all=bool(args.dagnn_out_pool_all),
        out_pool=args.dagnn_out_pool,
        dropout=args.dagnn_dropout,
        encoder=enc,
        segment_impl=_impl_for(args),
        compute_dtype=_dtype_for(args),
        **heads,
    )


def _impl_for(args):
    # the kernels on the card and (their plain versions) on the CPU
    return "fused" if args.segment_impl == "auto" else args.segment_impl


def _dtype_for(args):
    if args.compute_dtype != "auto":
        return args.compute_dtype
    return "float32" if args.cpu else "bfloat16"


def load_dataset(args, task: str):
    """Returns (train, valid, test, idx2vocab).

    Data source, in order: a processed/raw ogbg-code2 tree under
    --data_root (downloaded + cached by Code2Dataset on first use,
    dataset_pyg.py:106-166 equivalent), else the synthetic AST generator.
    """
    if args.data_root and os.path.isdir(os.path.join(args.data_root, "raw")):
        # --data_root pointing directly at an extracted dataset dir
        raws = code2.read_code2_raw(os.path.join(args.data_root, "raw"))
        split = code2.read_split(os.path.join(args.data_root, "split", "project"))
        return _split_and_convert(args, raws, split)
    if args.data_root:
        # --data_root as a dataset root: download + process-cache on first use
        from dagnn_tpu_torch.data.code2_dataset import Code2Dataset
        try:
            ds = Code2Dataset(args.data_root)
            return _split_and_convert(args, ds, ds.split_idx)
        except (RuntimeError, FileNotFoundError) as e:
            print(f"real ogbg-code2 unavailable: {e}\n"
                  f"-> falling back to synthetic AST data")
    n = args.synthetic or 300
    # getattr defaults: drivers with reduced flag surfaces (main_basic)
    # share this loader
    graphs = synthetic_ast_batch(
        args.seed, n,
        mean_nodes=getattr(args, "synthetic_mean_nodes", 60),
        targets=getattr(args, "synthetic_targets", "random"),
        num_attrs=getattr(args, "synthetic_num_attrs", 10030),
        vocab=args.num_vocab + 2,
        seq_len=args.max_seq_len)
    for g in graphs:
        g.y["len_longest_path"] = np.asarray(
            min(g.len_longest_path, LP_NUM_CLASSES - 1), np.int32)
    k = n // 10
    tr, va, te = graphs[: n - 2 * k], graphs[n - 2 * k: n - k], graphs[n - k:]
    idx2vocab = [f"tok{i}" for i in range(args.num_vocab + 1)] + [code2.EOS]
    if args.smoke:
        tr, va, te = tr[:50], va[:10], te[:10]  # main_pyg.py:225-229
    return tr, va, te, idx2vocab


def _split_and_convert(args, raws, split):
    train_idx = split["train"]
    if args.train_idx:
        # dataset-level indices REPLACE the train split (main_pyg.py:216-219)
        train_idx = code2.read_train_subset_idx(args.train_idx)
    valid_idx, test_idx = split["valid"], split["test"]
    # vocab reflects the (possibly --train_idx-restricted) train split —
    # the reference replaces split_idx['train'] BEFORE get_vocab_mapping
    # (main_pyg.py:216-223); the smoke shrink comes after (:225-229)
    vocab2idx, idx2vocab = code2.get_vocab_mapping(
        [raws[i]["y"] for i in train_idx], args.num_vocab)
    if args.smoke:  # main_pyg.py:225-229
        train_idx, valid_idx, test_idx = (
            train_idx[:50], valid_idx[:10], test_idx[:10])
    conv = lambda idxs: [code2.raw_to_dag(raws[i], vocab2idx, args.max_seq_len)
                         for i in idxs]
    tr, va, te = conv(train_idx), conv(valid_idx), conv(test_idx)
    return tr, va, te, idx2vocab


# each model config's (init, forward)
MODELS = {DAGNNConfig: (dagnn_init, dagnn_forward),
          MPNNConfig: (mpnn_init, mpnn_forward),
          GNN2Config: (gnn2_init, gnn2_forward),
          HPoolConfig: (hpool_init, hpool_forward)}


def make_step_fns(cfg, opt, task: str = "tok", capture: bool = True):
    """(train_step, predict) for a model config (DAGNNConfig or a
    baseline's, see MODELS) on the TOK or LP task.

    train_step(params, opt_state, batch, rng=None) ->
        (params, opt_state, loss, finite); rng: a torch.Generator on the
        parameters' device, for dropout
    predict(params, batch) -> argmax ids ([G, S] tokens, or [G] classes)

    `batch` is a collated batch, its arrays on the host (numpy) or on the
    parameters' device. For every config of CAPTURED both functions are
    captured steps (train/graphs.py), as the JAX driver jits them: on the
    card one CUDA graph replay a step for each bucket of batch shapes, the
    state written in place into the persistent buffers the train step
    returns (a later call overwrites what an earlier one returned);
    predict keeps a graph for each of the driver's three evaluation
    buckets. With capture=False (the bench's --eager, and its chained
    steps, which it captures as one group) each call issues its launches
    from Python and returns new tensors."""
    fwd = MODELS[type(cfg)][1]

    def loss_fn(params, batch, rng):
        logits = fwd(params, cfg, batch, rng=rng, train=cfg.dropout > 0)
        dev = logits.device
        mask = torch.as_tensor(batch.graph_mask, device=dev)
        if task == "tok":
            return tok_loss(logits, torch.as_tensor(batch.y["y_arr"], device=dev),
                            mask)
        return class_loss(logits, torch.as_tensor(
            batch.y["len_longest_path"], device=dev), mask)

    def step(params, opt_state, batch, rng=None):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = loss_fn(p, batch, rng)
        gs = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
        with torch.no_grad():
            grads = {k: torch.zeros_like(v) if g is None else g
                     for (k, v), g in zip(p.items(), gs)}
            loss = loss.detach()
            finite = torch.isfinite(loss)
            for g in grads.values():
                finite = finite & torch.isfinite(g).all()
            updates, new_state = opt.update(grads, opt_state)
            params_out = {k: torch.where(finite, params[k] + updates[k],
                                         params[k]) for k in params}
            keep = lambda new, old: torch.where(finite, new, old)
            state_out = {
                "count": keep(new_state["count"], opt_state["count"]),
                "mu": {k: keep(v, opt_state["mu"][k])
                       for k, v in new_state["mu"].items()},
                "nu": {k: keep(v, opt_state["nu"][k])
                       for k, v in new_state["nu"].items()},
            }
            loss = torch.where(finite, loss, torch.full_like(loss, float("nan")))
        return params_out, state_out, loss, finite

    @torch.no_grad()
    def infer(params, batch):
        logits = fwd(params, cfg, batch)
        return torch.argmax(logits, dim=-1)

    if not (capture and isinstance(cfg, CAPTURED)):
        on = lambda params, batch: batch_to_torch(
            batch, next(iter(params.values())).device)
        return ((lambda params, opt_state, batch, rng=None:
                 step(params, opt_state, on(params, batch), rng)),
                lambda params, batch: infer(params, on(params, batch)))

    def train_fn(state, inputs):
        batch, rng = inputs
        params, opt_state, loss, finite = step(*state, batch, rng)
        return (params, opt_state), (loss, finite)

    captured_train = graphs.CapturedStep(train_fn)
    captured_predict = graphs.CapturedStep(
        lambda params, batch: (None, infer(params, batch)),
        writes_state=False, keep=3)

    def train_step(params, opt_state, batch, rng=None):
        gens = () if rng is None else (rng,)
        (params, opt_state), (loss, finite) = captured_train(
            step_key("train", cfg, batch), (params, opt_state), (batch, rng),
            gens)
        return params, opt_state, loss, finite

    def predict(params, batch):
        return captured_predict(step_key("predict", cfg, batch), params,
                                batch)[1]

    train_step.captured, predict.captured = captured_train, captured_predict
    return train_step, predict


# The configs whose steps are captured (train/graphs.py): every model of
# MODELS, DAGNN on each wavefront and every baseline.
CAPTURED = (DAGNNConfig, MPNNConfig, GNN2Config, HPoolConfig)


def step_key(what, cfg, batch):
    """A captured step's key: what it is and the batch's shapes and host
    values (convert.batch_key); for a DAGNN, the route and impl the batch
    takes (dagnn._route; the merged path's form follows
    DAGNN_NO_RES_STREAM, read at each call), for a baseline its config's
    type (a baseline's forward bakes no host value of the batch into a
    launch: every count it needs is computed on the device)."""
    if not isinstance(cfg, DAGNNConfig):
        return (what, type(cfg).__name__, convert.batch_key(batch))
    route, impl = dagnn._route(cfg, batch, None)
    return (what, route, impl, dagnn._NO_RES_STREAM, convert.batch_key(batch))


def init_params(cfg, seed, device):
    """One fold's initial parameters (the port's own random stream)."""
    return MODELS[type(cfg)][0](seed, cfg, device=device)


def evaluate(predict, params, loader, task: str, idx2vocab) -> float:
    """Greedy decode + metric (main_pyg.py:69-88 / main_pyg_lp.py:77-110)."""
    refs, preds = [], []
    yt, yp = [], []
    for batch in loader:
        batch = convert.widen_out_slots(batch, loader.out_per_graph)
        out = predict(params, batch).cpu().numpy()
        g = int(batch.n_graph)
        if task == "tok":
            for i in range(g):
                preds.append(code2.decode_arr_to_seq(out[i], idx2vocab))
                refs.append(code2.decode_arr_to_seq(batch.y["y_arr"][i], idx2vocab))
        else:
            yp.append(out[:g])
            yt.append(np.asarray(batch.y["len_longest_path"])[:g])
    if task == "tok":
        return code2.eval_f1(refs, preds)["F1"]
    return code2.eval_acc(np.concatenate(yt), np.concatenate(yp))["acc"]


def run(args, task: str):
    """Train `args.folds` folds of `args.epochs` epochs; returns each
    fold's best {epoch, train, valid, test}."""
    device = resolve_device("cpu" if args.cpu else "cuda")
    name = args.name or f"{args.gnn}_{task}"
    train, valid, test, idx2vocab = load_dataset(args, task)
    print(f"dataset: {len(train)} train / {len(valid)} valid / {len(test)} test")
    # head size = actual vocab incl. UNK/EOS (reference main_pyg.py:396
    # passes len(vocab2idx); smaller corpora yield < num_vocab words)
    args.num_vocab = len(idx2vocab) - 2
    cfg = build_model_cfg(args, task)
    opt = make_optimizer(args.lr, args.clip)
    train_step, predict = make_step_fns(cfg, opt, task)
    logger = RunLogger(args.dir_results, name)
    os.makedirs(args.dir_save, exist_ok=True)

    # resume (main_pyg.py:254-266): fast-forward completed folds
    start_fold, resume_path = 1, None
    if args.checkpoint:
        resume_path = args.checkpoint
    elif args.checkpointing:
        resume_path = ckpt.find_latest_checkpoint(args.dir_save, name)
    if resume_path:
        start_fold, _ = ckpt.parse_fold_epoch(resume_path)
        print(f"resuming from {resume_path} (fold {start_fold})")

    fold_results = []
    for fold in range(start_fold, args.folds + 1):
        params = init_params(cfg, args.seed + fold, device)
        gen = torch.Generator(device=device)        # dropout's draws
        opt_state = opt.init(params)
        start_epoch = 1
        best = {"epoch": 0, "train": 0.0, "valid": -1.0, "test": 0.0}
        patience_left = args.patience
        prev_ckpt = None

        if resume_path and fold == start_fold:
            results, epoch, params, opt_state = ckpt.load_checkpoint(
                resume_path, params, opt_state)
            start_epoch = epoch + 1
            if results:
                best = results.get("best", best)
                patience_left = results.get("patience", patience_left)
            # the found file is this run's rotating checkpoint: the next
            # epoch's replaces it (a --checkpoint file given is kept)
            if not args.checkpoint:
                prev_ckpt = resume_path
            resume_path = None

        mk_loader = lambda gs, sh, seed: DAGLoader(
            gs, args.batch_size, shuffle=sh, seed=seed,
            chunk_size=args.chunk_size, prefetch=args.prefetch,
            schedules=isinstance(cfg, DAGNNConfig))
        valid_loader = mk_loader(valid, False, 0)
        test_loader = mk_loader(test, False, 0)
        # the JAX driver's deliberate deviation from the reference: the
        # train column is a fixed 4x-valid-sized subset (same graphs every
        # epoch), not the full train loader; valid/test are evaluated in
        # full, and early stopping/model selection use valid only
        train_eval_loader = mk_loader(train[: len(valid) * 4], False, 0)

        for epoch in range(start_epoch, args.epochs + 1):
            t0 = time.time()
            losses = []
            skipped = 0
            loader = mk_loader(train, True, args.seed + fold * 1000 + epoch)
            gen.manual_seed(args.seed + fold * 1000 + epoch)
            for batch in loader:
                # host arrays: a captured step copies them into its buffers
                params, opt_state, loss, finite = train_step(
                    params, opt_state,
                    convert.widen_out_slots(batch, loader.out_per_graph), gen)
                lv = float(loss)
                if np.isfinite(lv):
                    losses.append(lv)
                else:
                    skipped += 1
            if skipped:
                print(f"  nonfinite-grad steps skipped: {skipped}")
            train_time = time.time() - t0

            m_tr = evaluate(predict, params, train_eval_loader, task, idx2vocab)
            m_va = evaluate(predict, params, valid_loader, task, idx2vocab)
            m_te = evaluate(predict, params, test_loader, task, idx2vocab)
            mloss = float(np.mean(losses)) if losses else 0.0
            logger.log_epoch(fold, epoch, mloss, m_tr, m_va, m_te, train_time)
            print(f"fold {fold} epoch {epoch}: loss {mloss:.4f} "
                  f"train {m_tr:.4f} valid {m_va:.4f} test {m_te:.4f} "
                  f"({train_time:.1f}s)")

            if m_va > best["valid"]:
                best = {"epoch": epoch, "train": m_tr, "valid": m_va, "test": m_te}
                patience_left = args.patience
            else:
                patience_left -= 1

            if args.checkpointing:
                path = ckpt.checkpoint_name(args.dir_save, name, fold, epoch)
                ckpt.create_checkpoint(path, epoch, params, opt_state,
                                       {"best": best, "patience": patience_left})
                if prev_ckpt:
                    ckpt.remove_checkpoint(prev_ckpt)
                prev_ckpt = path

            if patience_left <= 0:  # main_pyg.py:340-343
                print(f"early stop at epoch {epoch}")
                break

        logger.log_fold(fold, best["epoch"], best["train"], best["valid"], best["test"])
        fold_results.append(best)
        print(f"fold {fold} best: {best}")

    vals = [b["valid"] for b in fold_results]
    tests = [b["test"] for b in fold_results]
    if vals:
        mv, sv = summary_report(vals)
        mt, st = summary_report(tests)
        print(f"final: valid {mv:.4f}±{sv:.4f} test {mt:.4f}±{st:.4f}")
    return fold_results

"""Latent-space scoring + Bayesian optimization.

Counterpart of dagnn_tpu/cli/run_bo.py (reference:
dvae/bayesian_optimization/bo.py), with the same flags: load the saved
latent .mat of a trained VAE, run `--seeds` independent sparse-GP fits
(M=500 inducing points) reporting test RMSE / log-likelihood / Pearson r to
Test_RMSE_ll.txt, and optionally run BO rounds: batched greedy-EI
candidate selection, decoding with a majority vote over repeated attempts
(dvae/util.py:408-466), validity checking, and scoring: ENAS architectures
by corpus lookup and the learned surrogate (vae/enas_eval.py; the
reference's ENAS evaluator is commented out upstream, bo.py:154), BNs by
the BIC scorer (vae/bn_score.py).

    python -m dagnn_tpu_torch.cli.run_bo \\
        --latent results/vae/final_structures6_latent_epoch5.mat \\
        --checkpoint results/vae/DAGNN_0_5.ckpt --data-type ENAS --seeds 3

It runs on the CUDA device unless --cpu is given, and raises without a
card. The GP, the greedy EI and the decode run there; all `attempts x
bo-batch` latents of a round decode in one batch. Checkpoints are the
port's own (train/checkpoint.py, as the port's train_vae writes them).
Each BO round's line ends with its seconds: GP fit, greedy EI, decode
(with the vote) and scoring.

On the card each program the JAX package compiles replays a CUDA graph
(CAPTURED: the GP fit's Adam steps, each greedy-EI candidate, the decode,
the surrogate's train step and its MLP), captured once a key and
replayed by every later fit, round and seed; the run's last line counts
the captures and replays. main(capture=False) runs them eagerly.
"""

from __future__ import annotations

import argparse
import os
import time
from collections import Counter
from typing import List, Optional

import numpy as np
import scipy.io
import scipy.stats as sps
import torch

from dagnn_tpu_torch import resolve_device
from dagnn_tpu_torch.data.na import (NAGraph, graph_to_bn_adj_str,
                                     graph_to_enas_row, is_valid_bn,
                                     is_valid_enas, load_enas)
from dagnn_tpu_torch.vae import dvae, enas_eval, sparse_gp
from dagnn_tpu_torch.vae.bn_score import EvalBN
from dagnn_tpu_torch.vae.sparse_gp import (batched_greedy_ei, fit_sparse_gp,
                                           predict)

# the programs a BO run captures (train/graphs.CapturedStep)
CAPTURED = {"GP fit": sparse_gp.FIT, "greedy EI": sparse_gp.EI,
            "decode": dvae.DECODE, "surrogate fit": enas_eval.FIT,
            "surrogate predict": enas_eval.PREDICT}


def graph_counts():
    """{program: (captures, replays)} so far in this process."""
    return {k: (c.captures, c.replays) for k, c in CAPTURED.items()}


def release_graphs():
    """Free every graph and buffer of CAPTURED."""
    for c in CAPTURED.values():
        c.graphs.clear()


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--latent", required=True, help="latent .mat from train_vae")
    p.add_argument("--checkpoint", default=None, help="VAE ckpt (needed for --bo)")
    p.add_argument("--model", default="DAGNN")
    p.add_argument("--data-type", default="ENAS", choices=["ENAS", "BN"])
    p.add_argument("--res_dir", default="results/bo")
    p.add_argument("--seeds", type=int, default=10)
    p.add_argument("--M", type=int, default=500)
    p.add_argument("--gp-iters", type=int, default=100)
    p.add_argument("--gp-lr", type=float, default=5e-4)
    p.add_argument("--bo", action="store_true")
    p.add_argument("--BO_rounds", type=int, default=10)
    p.add_argument("--bo-batch", type=int, default=50)
    p.add_argument("--decode-attempts", type=int, default=100)
    p.add_argument("--sample-dist", default="normal")
    p.add_argument("--refine-iters", type=int, default=50,
                   help="EI gradient-refinement steps; 0 keeps candidates "
                        "on the sampled grid")
    p.add_argument("--enas-corpus", default=os.path.join(
        os.path.dirname(__file__), "..", "..", "data",
        "final_structures6.txt.gz"))
    p.add_argument("--scorer", default="surrogate",
                   choices=["surrogate", "lookup"],
                   help="ENAS arc scorer: corpus lookup + learned surrogate "
                        "for unseen architectures, or strict lookup-only")
    p.add_argument("--hs", type=int, default=501)
    p.add_argument("--nz", type=int, default=56)
    p.add_argument("--dagnn_layers", type=int, default=2)
    p.add_argument("--dagnn_agg", default="attn_h")
    p.add_argument("--bidirectional", action="store_true")
    p.add_argument("--cpu", action="store_true")
    return p.parse_args(argv)


def enas_lookup_scorer(corpus_path):
    """Score an ENAS flat row by exact corpus lookup (the only oracle the
    repo ships: final_structures6.txt maps architectures to accuracies)."""
    table = {}
    if os.path.exists(corpus_path):
        train, test, _ = load_enas(corpus_path, burn_in=0)
        for g in train + test:
            table[str(graph_to_enas_row(g))] = g.y

    def score(arc_key: str) -> Optional[float]:
        return table.get(arc_key)

    return score


def majority_vote(types, adj, nv, n: int, attempts: int, data_type: str,
                  max_n: int, nvt: int) -> List[Optional[str]]:
    """The vote over `attempts` decodes of n latents (decoded row
    a * n + i is attempt a of latent i; numpy types [R, max_n], adj
    [R, max_n, max_n], nv [R]): per latent, the most common encoding of
    its valid graphs (ENAS: valid with max_n vertices; BN: valid), or
    None when none is valid."""
    votes: List[Counter] = [Counter() for _ in range(n)]
    for a in range(attempts):
        for i in range(n):
            r = a * n + i
            g = NAGraph(types=types[r][: nv[r]],
                        adj=adj[r][: nv[r], : nv[r]].astype(np.uint8))
            if data_type == "ENAS":
                if is_valid_enas(g) and g.num_nodes == max_n:
                    votes[i][str(graph_to_enas_row(g))] += 1
            elif is_valid_bn(g, nvt=nvt):
                votes[i][graph_to_bn_adj_str(g)] += 1
    return [v.most_common(1)[0][0] if v else None for v in votes]


def decode_from_latent(model_bundle, z, attempts, data_type, gen, capture=True):
    """Majority-vote decoding (dvae/util.py:408-466): decode each latent
    `attempts` times in one batch (z tiled to [attempts * n] rows on the
    model's device), keep valid graphs, return the most common encoding.
    gen: a torch.Generator on that device; capture: dvae_decode's."""
    from dagnn_tpu_torch.vae.dagnn_vae import DAGNNVAEConfig, dagnn_vae_decode
    from dagnn_tpu_torch.vae.dvae import dvae_decode, sub_params
    cfg, params = model_bundle
    dev = next(iter(params.values())).device
    z = torch.as_tensor(z, dtype=torch.float32).to(dev)
    z_tiled = z.repeat(attempts, 1)
    if isinstance(cfg, DAGNNVAEConfig):
        types, adj, nv = dagnn_vae_decode(params, cfg, z_tiled, gen, capture=capture)
    else:  # base D-VAE bundle (gated_sum decoder, no attention params)
        types, adj, nv = dvae_decode(sub_params(params, "dec."), cfg, z_tiled, gen,
                                     capture=capture)
    return majority_vote(types, adj, nv, len(z), attempts, data_type,
                         cfg.max_n, cfg.nvt)


def load_model(args, device):
    """Rebuild the trained VAE (reference bo.py:184-209 re-parses
    cmd_input.txt; here the hyperparameters come from flags) from the
    port's checkpoint, on `device`.

    Supports the DAGNN-coupled VAEs and the base D-VAE family, the models
    whose decoders emit DAGs that the BO loop can check and score. The
    S-VAE string decoders and the DVAE_GCN/fast/DeepGMG variants are
    latent-scored by the GP path (no --bo); asking for BO with one exits.
    """
    if not args.checkpoint:
        return None
    known = ("DAGNN", "DVAE", "DVAE_BN")
    if args.model not in known:
        raise SystemExit(
            f"--bo supports models {known}; {args.model!r} checkpoints can "
            f"only be latent-scored (omit --bo)")
    from dagnn_tpu_torch.train import checkpoint as ckpt
    from dagnn_tpu_torch.train.optim import make_optimizer
    nvt = 8 if args.data_type == "ENAS" else 10
    if args.model.startswith("DVAE"):
        from dagnn_tpu_torch.vae.dvae import DVAEConfig, dvae_base_init
        cfg = DVAEConfig(max_n=nvt, nvt=nvt, hs=args.hs, nz=args.nz,
                         num_layers=1, bidirectional=args.bidirectional,
                         vid=args.model == "DVAE", bn=args.model == "DVAE_BN",
                         dec_agg="gated_sum",
                         pred_source="x" if args.model == "DVAE_BN" else "h")
        params = dvae_base_init(0, cfg, device=device)
    else:
        from dagnn_tpu_torch.vae.dagnn_vae import DAGNNVAEConfig, dagnn_vae_init
        cfg = DAGNNVAEConfig(max_n=nvt, nvt=nvt, hs=args.hs, nz=args.nz,
                             num_layers=args.dagnn_layers, agg=args.dagnn_agg,
                             bidirectional=args.bidirectional,
                             bn=args.data_type == "BN")
        params = dagnn_vae_init(0, cfg, device=device)
    opt = make_optimizer()
    _, _, params, _ = ckpt.load_checkpoint(args.checkpoint, params,
                                           opt.init(params))
    return cfg, params


def load_latents(path):
    """(X_train, y_train, X_test, y_test, mean_y, std_y) from a latent
    .mat: the scores negated (bo.py:213: BO minimizes) and normalized by
    the train scores' mean and std; y as [n, 1] columns."""
    mat = scipy.io.loadmat(path)
    X_train, X_test = mat["Z_train"], mat["Z_test"]
    y_train = -mat["Y_train"].reshape(-1, 1)
    y_test = -mat["Y_test"].reshape(-1, 1)
    mean_y, std_y = float(np.mean(y_train)), float(np.std(y_train)) or 1.0
    return (X_train, (y_train - mean_y) / std_y, X_test,
            (y_test - mean_y) / std_y, mean_y, std_y)


def score_gp(gp, X_test, y_test):
    """(test RMSE, test log-likelihood, Pearson r) of a fitted GP."""
    pred, var = (t.cpu().double().numpy() for t in predict(gp, X_test))
    y = y_test.reshape(-1)
    err = float(np.sqrt(np.mean((pred - y) ** 2)))
    sn2 = float(torch.exp(gp.params["log_sn2"]))
    testll = float(np.mean(sps.norm.logpdf(pred - y, scale=np.sqrt(var + sn2))))
    return err, testll, float(sps.pearsonr(pred, y)[0])


def main(argv=None, capture: bool = True):
    """Returns {"gp": [(rmse, ll, pearson, refit_f64) per seed], "rounds":
    [{"seed", "round", "valid", "n", "best", "fit_s", "ei_s", "decode_s",
    "score_s"}], "scorer_quality": str or None, "graphs": {program:
    (captures, replays)} of this run}. capture=False: every program
    eager."""
    args = parse_args(argv)
    before = graph_counts()
    dev = resolve_device("cpu" if args.cpu else "cuda")
    os.makedirs(args.res_dir, exist_ok=True)
    X_train, y_train, X_test, y_test, mean_y, std_y = load_latents(args.latent)
    print(f"latents: {len(X_train)} train / {len(X_test)} test, on {dev}")

    rmse_file = os.path.join(args.res_dir, "Test_RMSE_ll.txt")
    arcs_file = os.path.join(args.res_dir, "best_arc_scores.txt")
    for f in (rmse_file, arcs_file):
        if os.path.exists(f):
            os.remove(f)

    model_bundle = load_model(args, dev) if args.bo else None
    scorer, quality = None, None
    if args.data_type == "ENAS":
        if args.scorer == "surrogate" and args.bo:
            from dagnn_tpu_torch.vae.enas_eval import EvalENAS
            eva_enas = EvalENAS(args.enas_corpus, device=dev, capture=capture)
            quality = eva_enas.quality()
            print("ENAS scorer:", quality)
            with open(os.path.join(args.res_dir, "scorer_quality.txt"), "w") as f:
                f.write(quality + "\n")
            scorer = eva_enas.score
        else:
            scorer = enas_lookup_scorer(args.enas_corpus)
    eva = EvalBN() if args.data_type == "BN" else None

    out = {"gp": [], "rounds": [], "scorer_quality": quality}
    # one generator reseeded each seed: a decode graph draws from it
    gen = torch.Generator(device=dev)
    for seed in range(args.seeds):
        gp = fit_sparse_gp(X_train, y_train, M=args.M, iters=args.gp_iters,
                           lr=args.gp_lr, seed=seed, device=dev, capture=capture)
        err, testll, pearson = score_gp(gp, X_test, y_test)
        out["gp"].append((err, testll, pearson, gp.refit_f64))
        print(f"seed {seed}: Test RMSE {err:.4f}, ll {testll:.4f}, "
              f"Pearson r {pearson:.4f}")
        with open(rmse_file, "a") as f:
            f.write(f"Test RMSE: {err:.4f}, ll: {testll:.4f}, "
                    f"Pearson r: {pearson:.4f}\n")

        if not args.bo:
            continue

        # --- BO rounds (bo.py:248-328) ---
        Xa = np.asarray(X_train, np.float64).copy()
        ya = np.asarray(y_train, np.float64).reshape(-1, 1).copy()
        best_score, best_arc = 1e15, None
        gen.manual_seed(seed)
        # one padded shape for every refit of the growing set
        pad_rows = len(Xa) + args.BO_rounds * args.bo_batch
        for it in range(args.BO_rounds):
            t0 = time.perf_counter()
            gp_it = fit_sparse_gp(Xa, ya, M=args.M, iters=args.gp_iters,
                                  lr=args.gp_lr, seed=seed * 100 + it,
                                  pad_to=pad_rows, device=dev, capture=capture)
            t1 = time.perf_counter()
            cand = batched_greedy_ei(
                gp_it, args.bo_batch,
                Xa.min(0), Xa.max(0), Xa.mean(0), Xa.std(0),
                sample=args.sample_dist, seed=seed * 100 + it,
                refine_iters=args.refine_iters, capture=capture)
            cand_np = cand.cpu().double().numpy()
            t2 = time.perf_counter()
            arcs = decode_from_latent(model_bundle, cand, args.decode_attempts,
                                      args.data_type, gen, capture)
            t3 = time.perf_counter()
            scores = []
            for arc in arcs:
                raw = None
                if arc is not None:
                    raw = (scorer(arc) if args.data_type == "ENAS"
                           else eva.eval(arc))
                if raw is None:
                    s = float(np.max(ya))  # invalid/unknown -> worst
                else:
                    s = (-raw - mean_y) / std_y
                    if s < best_score:
                        best_score, best_arc = s, arc
                scores.append(s)
            t4 = time.perf_counter()
            Xa = np.concatenate([Xa, cand_np], 0)
            ya = np.concatenate([ya, np.asarray(scores)[:, None]], 0)
            if best_arc is not None:
                with open(arcs_file, "a") as f:
                    f.write(f"{best_arc}, {-best_score * std_y - mean_y:.4f}\n")
            n_valid = sum(a is not None for a in arcs)
            secs = (f" [GP fit {t1 - t0:.2f} s, greedy EI {t2 - t1:.2f} s, "
                    f"decode {t3 - t2:.2f} s, scoring {t4 - t3:.2f} s]")
            print((f"  BO round {it}: {n_valid}/{len(arcs)} valid, best "
                   f"{-best_score * std_y - mean_y:.4f}" if best_arc
                   else f"  BO round {it}: no valid arcs yet") + secs)
            out["rounds"].append(dict(
                seed=seed, round=it, valid=n_valid, n=len(arcs),
                best=(-best_score * std_y - mean_y) if best_arc else None,
                fit_s=t1 - t0, ei_s=t2 - t1, decode_s=t3 - t2, score_s=t4 - t3))
    now = graph_counts()
    out["graphs"] = {k: tuple(a - b for a, b in zip(now[k], before[k])) for k in now}
    print("captured programs (captures / replays) this run: " + ", ".join(
        f"{k} {c} / {r}" for k, (c, r) in out["graphs"].items()))
    return out


if __name__ == "__main__":
    main()

"""Where BO on a trained NA VAE loses its valid decodes, stage by stage.

Reads what the port's train_vae writes (a latent .mat and the checkpoint
of the same epoch) and prints, for seed 0 of run_bo:

  a. the training latents: 50 rows of Z_train decoded as
     run_bo.decode_from_latent decodes them (100 stochastic decodes each
     in one batch, and run_bo's vote): the valid share, and
     the share equal to that graph's own graph_to_enas_row (the corpus's
     train split, as train_vae loads it, in the .mat's row order), of the
     votes and of the single decodes;
  b. the greedy-EI candidates of rounds 0 and 1, each round run by
     run_bo.main itself (run_bo's defaults): their valid share, their distance to the
     nearest training latent in units of the median nearest-neighbour
     distance among training latents, the share of their coordinates on
     the clip box's bounds, and how many are not finite;
  c. each round's GP: its dtype, whether its float32 fit went non-finite
     and was redone in float64, the range of its length scales, sf2, sn2;
  d. b. and c. again with the candidates kept on the grid (run_bo
     --refine-iters 0).

If a. fails, the latents and the decoder do not pair; if a. holds and b.
fails, the GP or the EI departs.

    python -m dagnn_tpu_torch.scripts.bo_diagnose \\
        --latent results/torch_na/final_structures6_latent_epoch10.mat \\
        --checkpoint results/torch_na/DAGNN_0_10.ckpt
    # CPU, a small model: --cpu --hs 16 --nz 6 --max-count 300 --M 50 --gp-iters 5

It runs on the card unless --cpu is given. main() returns the numbers as
a dict (chip_smoke.py phase 21b gates on them).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import scipy.io
import torch

from dagnn_tpu_torch import resolve_device
from dagnn_tpu_torch.cli import run_bo
from dagnn_tpu_torch.data.na import graph_to_enas_row, load_enas

DEFAULT_CORPUS = os.path.join(os.path.dirname(__file__), "..", "..", "data",
                              "final_structures6.txt.gz")
# run_bo's seed 0, its rounds 0-1 refined (run_bo's 50 steps) and on the
# grid; 50 training latents (and the NN scale's sample) drawn with numpy
# seed 0; run_bo's 100 decode attempts
SEED, ROUNDS, REFINE, ROWS, ATTEMPTS = 0, 2, (50, 0), 50, 100


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--latent", required=True)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--hs", type=int, default=501)
    p.add_argument("--nz", type=int, default=56)
    p.add_argument("--data-path", default=DEFAULT_CORPUS)
    p.add_argument("--nvt", type=int, default=6)
    p.add_argument("--max-count", type=int, default=None,
                   help="train_vae's --max-count of the run that wrote --latent")
    p.add_argument("--M", type=int, default=500)
    p.add_argument("--gp-iters", type=int, default=100)
    p.add_argument("--json", default=None, help="also write the numbers here")
    p.add_argument("--cpu", action="store_true")
    return p.parse_args(argv)


def _dist(a: torch.Tensor, b: torch.Tensor, chunk: int = 2048) -> torch.Tensor:
    """[len(a), len(b)] Euclidean distances in float64, a in chunks."""
    return torch.cat([torch.cdist(a[i:i + chunk], b) for i in range(0, len(a), chunk)])


def nn_scale(X: torch.Tensor, sample: int = 2000, seed: int = 0) -> float:
    """The median distance from a training latent to its nearest other
    training latent, over `sample` rows drawn with a numpy seed."""
    rows = np.random.default_rng(seed).choice(len(X), min(sample, len(X)), replace=False)
    d = _dist(X[torch.as_tensor(rows, device=X.device)], X)
    d[torch.arange(len(rows)), torch.as_tensor(rows, device=X.device)] = float("inf")
    return float(d.min(1).values.median())


def train_graphs(args, Y_train):
    """The corpus's train split as train_vae loads it, checked against the
    .mat's scores row by row."""
    graphs, _, _ = load_enas(args.data_path, n_types=args.nvt, max_count=args.max_count)
    ys = np.asarray([g.y for g in graphs])
    if len(graphs) != len(Y_train) or not np.allclose(ys, Y_train):
        raise SystemExit(f"{args.latent}: its {len(Y_train)} train rows are not the "
                         f"corpus's train split ({len(graphs)} graphs); pass the "
                         "corpus and --max-count of its train_vae run")
    return graphs


def latent_stats(bundle, Z, graphs, attempts: int, gen) -> dict:
    """a.: `attempts` decodes of each row of Z in one batch, as
    run_bo.decode_from_latent decodes them, and their vote: the valid share
    and the share equal to that graph's own encoding, of the votes
    ("valid", "own") and of the single decodes ("valid_1", "own_1")."""
    from dagnn_tpu_torch.vae.dagnn_vae import dagnn_vae_decode
    cfg, params = bundle
    dev = next(iter(params.values())).device
    z = torch.as_tensor(np.asarray(Z), dtype=torch.float32).to(dev)
    types, adj, nv = dagnn_vae_decode(params, cfg, z.repeat(attempts, 1), gen)
    arcs = run_bo.majority_vote(types, adj, nv, len(z), attempts, "ENAS", cfg.max_n,
                                cfg.nvt)
    own = [str(graph_to_enas_row(g)) for g in graphs]
    single = [run_bo.majority_vote(types[r:r + 1], adj[r:r + 1], nv[r:r + 1], 1, 1,
                                   "ENAS", cfg.max_n, cfg.nvt)[0]
              for r in range(len(nv))]
    own_1 = [a == own[r % len(z)] for r, a in enumerate(single)]
    return dict(n=len(arcs), valid=float(np.mean([a is not None for a in arcs])),
                own=float(np.mean([a == o for a, o in zip(arcs, own)])),
                valid_1=float(np.mean([a is not None for a in single])),
                own_1=float(np.mean(own_1)))


def candidate_stats(cand: torch.Tensor, X: np.ndarray, arcs, X_train: torch.Tensor,
                    scale: float) -> dict:
    """b.: valid share, nearest-training-latent distance over `scale`
    (min, median, max), the share of coordinates on the box of the rows
    the round fitted (X), the non-finite candidates."""
    c = cand.detach().to(X_train.device, torch.float64)
    finite = torch.isfinite(c).all(1)
    near = _dist(c[finite], X_train).min(1).values / scale if bool(finite.any()) \
        else torch.full((1,), float("nan"), dtype=torch.float64)
    lo, hi = (torch.as_tensor(v, dtype=c.dtype, device=c.device)
              for v in (X.min(0), X.max(0)))
    on = ((c == lo) | (c == hi)).double().mean()
    return dict(valid=float(np.mean([a is not None for a in arcs])),
                near_min=float(near.min()), near_med=float(near.median()),
                near_max=float(near.max()), on_bounds=float(on),
                nonfinite=int((~finite).sum()))


def gp_stats(gp) -> dict:
    """c.: the fit's dtype and refit, length-scale range, sf2, sn2."""
    p = gp.params
    ls = torch.exp(p["log_ls"])
    return dict(dtype=str(gp.X.dtype).replace("torch.", ""), refit_f64=gp.refit_f64,
                ls_min=float(ls.min()), ls_max=float(ls.max()),
                sf2=float(torch.exp(p["log_sf2"])), sn2=float(torch.exp(p["log_sn2"])))


def recorder(found: list, X_train: torch.Tensor, scale: float):
    """run_bo.main's observe hook: appends each round's {"round", "gp":
    c., **b.} to `found`."""
    def observe(r):
        found.append(dict(round=r["round"], gp=gp_stats(r["gp"]),
                          **candidate_stats(r["cand"], r["X"], r["arcs"], X_train, scale)))
    return observe


def describe_a(a) -> str:
    return (f"{a['n']} training latents: the vote valid {a['valid']:.2f}, its own graph "
            f"{a['own']:.2f}; a single decode valid {a['valid_1']:.3f}, its own graph "
            f"{a['own_1']:.3f}")


def describe_b(b) -> str:
    return (f"valid {b['valid']:.2f}; nearest training latent / median NN "
            f"{b['near_min']:.3g} / {b['near_med']:.3g} / {b['near_max']:.3g} (min / "
            f"median / max); on the box's bounds {b['on_bounds']:.3f} of coordinates; "
            f"not finite {b['nonfinite']}")


def describe_c(c) -> str:
    return (f"GP {c['dtype']}, float64 refit {c['refit_f64']}, length scales "
            f"{c['ls_min']:.4g}-{c['ls_max']:.4g}, sf2 {c['sf2']:.4g}, sn2 {c['sn2']:.4g}")


def main(argv=None):
    """{"train": a., "scale": the median NN distance, "rounds": {refine
    iterations: [per round {"round", "gp": c., **b.}]}}."""
    args = parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")
    mat = scipy.io.loadmat(args.latent)
    graphs = train_graphs(args, mat["Y_train"].reshape(-1))
    X_train = torch.as_tensor(np.asarray(mat["Z_train"], np.float64), device=dev)
    scale = nn_scale(X_train, seed=SEED)
    bo_flags = ["--latent", args.latent, "--checkpoint", args.checkpoint, "--bo",
                "--seeds", "1", "--BO_rounds", str(ROUNDS), "--hs", str(args.hs),
                "--nz", str(args.nz), "--M", str(args.M), "--gp-iters",
                str(args.gp_iters), "--decode-attempts", str(ATTEMPTS)] + (
                    ["--cpu"] if args.cpu else [])
    bundle = run_bo.load_model(run_bo.parse_args(bo_flags), dev)
    rows = np.random.default_rng(SEED).choice(len(graphs), ROWS, replace=False)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    a = latent_stats(bundle, mat["Z_train"][rows], [graphs[i] for i in rows], ATTEMPTS,
                     gen)
    print(f"a. {describe_a(a)} ({ATTEMPTS} attempts each); the median nearest-"
          f"neighbour distance among training latents {scale:.4g}")
    out = {"train": a, "scale": scale, "rounds": {}}
    for iters in REFINE:
        found = []
        with tempfile.TemporaryDirectory() as res:
            run_bo.main(bo_flags + ["--refine-iters", str(iters), "--res_dir", res],
                        observe=recorder(found, X_train, scale))
        for r in found:
            print(f"{'b' if iters else 'd'}. refine {iters}, round {r['round']}: "
                  f"{describe_b(r)}")
            print(f"c. refine {iters}, round {r['round']}: {describe_c(r['gp'])}")
        out["rounds"][iters] = found
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()

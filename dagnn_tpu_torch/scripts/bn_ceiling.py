"""BN latent-quality diagnosis: the sparse GP on RAW structure features, a
ceiling on what any encoder's latents could let it predict.

Counterpart of scripts/bn_ceiling.py: the same features (each graph's
flattened adjacency and one-hot node types, n x n bits each) and the same
protocol as cli/run_bo (y sign-flipped and standardised on the train
split, M 500, 100 Adam iterations at lr 5e-3, one fit a seed), through the
port's vae/sparse_gp.py on the card. --pkl reads a pickled (train graphs,
test graphs, graph args) as the JAX script does; where that file is
absent the input is the synthetic BN corpus train_vae --data-type BN uses
(data/na.synthetic_bn_corpus: 2,000 scored rows, 8 types, seed 0).

    python -m dagnn_tpu_torch.scripts.bn_ceiling [--seeds 5] [--pkl FILE]
    python -m dagnn_tpu_torch.scripts.bn_ceiling --cpu
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import pickle

import numpy as np
import scipy.stats as sps

M, ITERS, LR = 500, 100, 5e-3
SYNTHETIC_ROWS = 2000


def features(graphs):
    """[n_graphs, 2 n^2]: each graph's adjacency, then its n x n one-hot
    of node types (type mod n), as float64."""
    feats = []
    for g in graphs:
        n = len(g.types)
        onehot = np.zeros((n, n), np.float64)
        onehot[np.arange(n), np.asarray(g.types) % n] = 1.0
        feats.append(np.concatenate(
            [np.asarray(g.adj, np.float64).ravel(), onehot.ravel()]))
    return np.stack(feats)


def load_graphs(pkl: str):
    """(train, test) graphs: the pickle's, or the synthetic BN corpus."""
    if osp.exists(pkl):
        with open(pkl, "rb") as f:
            train_g, test_g, _ = pickle.load(f)
        return train_g, test_g, pkl
    from dagnn_tpu_torch.data.na import synthetic_bn_corpus
    train_g, test_g, _ = synthetic_bn_corpus(SYNTHETIC_ROWS)
    return train_g, test_g, f"synthetic BN corpus ({SYNTHETIC_ROWS} rows, seed 0)"


def fit_scores(X_train, y_train, X_test, y_test, seed, device, m=M, iters=ITERS):
    """One fit's test RMSE, log-likelihood and Pearson r (run_bo's)."""
    from dagnn_tpu_torch.vae.sparse_gp import fit_sparse_gp, predict
    gp = fit_sparse_gp(X_train, y_train, M=m, iters=iters, lr=LR, seed=seed,
                       device=device)
    pred, var = (t.double().cpu().numpy() for t in predict(gp, X_test))
    y = y_test.reshape(-1)
    err = float(np.sqrt(np.mean((pred - y) ** 2)))
    sn2 = float(np.exp(gp.params["log_sn2"].double().cpu().numpy()))
    ll = float(np.mean(sps.norm.logpdf(pred - y, scale=np.sqrt(var + sn2))))
    r = float(sps.pearsonr(pred, y)[0])
    return {"rmse": err, "ll": ll, "pearson_r": r, "refit_f64": gp.refit_f64}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--pkl", default="results/bn/asia_200k.pkl")
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--out", default="results/torch_bo_bn/ceiling_raw_features.txt")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    from dagnn_tpu_torch import resolve_device
    dev = resolve_device("cpu" if args.cpu else "cuda")

    train_g, test_g, source = load_graphs(args.pkl)
    X_train, X_test = features(train_g), features(test_g)
    # run_bo's protocol: sign, then the train split's standardisation
    y_train = -np.array([g.y for g in train_g]).reshape(-1, 1)
    y_test = -np.array([g.y for g in test_g]).reshape(-1, 1)
    mean_y, std_y = float(np.mean(y_train)), float(np.std(y_train)) or 1.0
    y_train = (y_train - mean_y) / std_y
    y_test = (y_test - mean_y) / std_y

    lines = [f"# sparse GP on raw structure features ({X_train.shape[1]}-d adj+type "
             f"one-hot) of {source}, {len(train_g)} train / {len(test_g)} test, "
             f"protocol of cli/run_bo (M={M}, iters={ITERS}), on {dev}"]
    scores = []
    for seed in range(args.seeds):
        s = fit_scores(X_train, y_train, X_test, y_test, seed, dev)
        line = (f"Test RMSE: {s['rmse']:.4f}, ll: {s['ll']:.4f}, "
                f"Pearson r: {s['pearson_r']:.4f}")
        print("seed", seed, line)
        lines.append(line)
        scores.append(s)
    os.makedirs(osp.dirname(osp.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print("->", args.out)
    return scores


if __name__ == "__main__":
    main()

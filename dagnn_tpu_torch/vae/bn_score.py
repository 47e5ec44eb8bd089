"""Bayesian-network BIC scoring, natively.

A copy of dagnn_tpu/vae/bn_score.py (numpy only): the synthetic BN corpus
(data/na.synthetic_bn_rows) scores its rows with it.

Replaces the reference's R subprocess (reference:
dvae/bayesian_optimization/evaluate_BN.py:4-21 shells out to
`Rscript compute_score.R` — a script absent from the repo) with a direct
BIC computation for discrete BNs, matching bnlearn's definition:

    BIC(G; D) = sum_v [ loglik_ML(v | parents(v)) - (r_v - 1) * q_v / 2 * log N ]

where r_v = #states of v and q_v = prod of parent state counts. Includes a
sampler for the classic 8-node Asia network so a scoring dataset exists
even though asia_200k.txt is stripped from the reference checkout.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

# Asia network (Lauritzen & Spiegelhalter 1988), variables in bnlearn order:
# asia, tub, smoke, lung, bronc, either, xray, dysp — all binary.
ASIA_VARS = ["asia", "tub", "smoke", "lung", "bronc", "either", "xray", "dysp"]
_ASIA_EDGES = [(0, 1), (2, 3), (2, 4), (1, 5), (3, 5), (5, 6), (5, 7), (4, 7)]


def sample_asia(n: int, seed: int = 0) -> np.ndarray:
    """Sample n records from the Asia network (1 = yes, 0 = no)."""
    rng = np.random.default_rng(seed)
    u = lambda p: (rng.random(n) < p).astype(np.int8)
    asia = u(0.01)
    smoke = u(0.5)
    tub = np.where(asia == 1, u(0.05), u(0.01))
    lung = np.where(smoke == 1, u(0.1), u(0.01))
    bronc = np.where(smoke == 1, u(0.6), u(0.3))
    either = ((tub == 1) | (lung == 1)).astype(np.int8)
    xray = np.where(either == 1, u(0.98), u(0.05))
    dysp = np.where(
        (bronc == 1) & (either == 1), u(0.9),
        np.where((bronc == 1), u(0.8), np.where(either == 1, u(0.7), u(0.1))),
    ).astype(np.int8)
    return np.stack([asia, tub, smoke, lung, bronc, either, xray, dysp], 1)


def bic_score(adj: np.ndarray, data: np.ndarray) -> float:
    """BIC of DAG `adj` (adj[i, j] = edge i->j, variables = data columns)."""
    data = np.asarray(data)
    n, d = data.shape
    adj = np.asarray(adj).reshape(d, d)
    cards = np.array([int(data[:, v].max()) + 1 for v in range(d)])
    total = 0.0
    logn = np.log(n)
    for v in range(d):
        parents = np.flatnonzero(adj[:, v])
        rv = cards[v]
        if parents.size == 0:
            counts = np.bincount(data[:, v], minlength=rv).astype(np.float64)
            probs = counts / n
            ll = float(np.sum(counts[counts > 0] * np.log(probs[counts > 0])))
            qv = 1
        else:
            # parent configuration index
            mult = np.cumprod([1] + [cards[p] for p in parents[:-1]])
            cfg = (data[:, parents] * mult).sum(1)
            qv = int(np.prod(cards[parents]))
            joint = np.zeros((qv, rv), np.float64)
            np.add.at(joint, (cfg, data[:, v]), 1.0)
            row = joint.sum(1, keepdims=True)
            with np.errstate(divide="ignore", invalid="ignore"):
                logp = np.where(joint > 0, np.log(joint / row), 0.0)
            ll = float((joint * logp).sum())
        total += ll - 0.5 * logn * (rv - 1) * qv
    return total


class EvalBN:
    """Drop-in scorer for the BO loop (reference Eval_BN.eval takes the
    flattened inner 8x8 adjacency string, evaluate_BN.py:15-21)."""

    def __init__(self, data: Optional[np.ndarray] = None, n: int = 10000,
                 seed: int = 0):
        self.data = data if data is not None else sample_asia(n, seed)

    def eval(self, adj_str: str) -> float:
        vals = np.array([int(x) for x in adj_str.split()])
        d = int(np.sqrt(len(vals)))
        return bic_score(vals.reshape(d, d), self.data)

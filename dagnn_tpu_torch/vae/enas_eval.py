"""ENAS architecture evaluator: exact corpus lookup + learned surrogate.

Counterpart of dagnn_tpu/vae/enas_eval.py. The reference's BO chain scores
decoded ENAS architectures with an external weight-sharing evaluator that
is commented out upstream and not shipped (reference:
dvae/bayesian_optimization/bo.py:151-154), so the BO loop scores them
offline here:

* exact corpus lookup when the architecture is in the 20k-row table
  (data/final_structures6.txt: weight-sharing accuracies, ground truth),
* otherwise a surrogate MLP 256-256-1 trained on the full corpus
  (structure features: op-type one-hots + connection bits -> accuracy),
  independent of the VAE/GP latent space being optimized. Its validation
  quality is reported beside every artifact.

`featurize_row` is a numpy copy of the JAX package's. The surrogate trains
full-batch with Adam 1e-3 (optax's formula, no clip) for 400 epochs on the
device it is given (the card by default); `init_params` is separate from
`_fit`, so a caller can hand it other initial weights.

As the JAX package jits them, on a CUDA device the train step replays one
CUDA graph an epoch (FIT) and the MLP one graph a row count (PREDICT),
train/graphs.py; capture=False keeps them eager. A replay launches what
the eager step launches: the same bits.
"""

from __future__ import annotations

import ast
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from dagnn_tpu_torch import resolve_device
from dagnn_tpu_torch.data.na import graph_to_enas_row, load_enas
from dagnn_tpu_torch.train.graphs import CapturedStep
from dagnn_tpu_torch.train.optim import make_optimizer


def featurize_row(row, n: int = 6, n_types: int = 6) -> np.ndarray:
    """Nested ENAS row -> flat feature vector (type one-hots + edge bits)."""
    if isinstance(row, str):
        row = ast.literal_eval(row)
    f_types = np.zeros((n, n_types), np.float32)
    bits = np.zeros(n * (n - 1) // 2, np.float32)
    k = 0
    for i, node in enumerate(row):
        f_types[i, int(node[0]) % n_types] = 1.0
        for flag in node[1:]:
            bits[k] = float(flag)
            k += 1
    return np.concatenate([f_types.ravel(), bits])


def _mlp(p, x):
    h = torch.relu(x @ p["w1"] + p["b1"])
    h = torch.relu(h @ p["w2"] + p["b2"])
    return h @ p["w3"] + p["b3"]


def _train_step(lr: float):
    """One full-batch Adam step (no clip) on the mean squared error, as
    fn((params, Adam state), (X, y)) -> ((params, Adam state), None)."""
    opt = make_optimizer(lr, clip=0.0)

    def fn(carry, data):
        params, state = carry
        X, y = data
        q = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        with torch.enable_grad():
            loss = torch.mean((_mlp(q, X) - y) ** 2)
            gs = torch.autograd.grad(loss, list(q.values()))
        with torch.no_grad():
            updates, state = opt.update(dict(zip(q, gs)), state)
            params = {k: params[k] + updates[k] for k in params}
        return (params, state), None

    return fn


class _Key(NamedTuple):
    device: str
    X: Tuple[int, int]           # the rows' [B, F]
    hidden: int


# the captured programs: a train step (one graph a key, replayed an
# epoch) and the MLP (its parameters read where they lie: one graph a
# key and parameters, the validation rows' and a round's)
FIT = CapturedStep(_train_step(1e-3))
PREDICT = CapturedStep(lambda p, x: (p, _mlp(p, x)), writes_state=False, keep=2)


class EvalENAS:
    """Corpus-lookup + surrogate ENAS scorer (Eval_NN stand-in).

    score(arc_key) returns the weight-sharing accuracy for a stringified
    nested row: exact where known, surrogate elsewhere, None only if the
    row fails to parse.
    """

    def __init__(self, corpus_path: str, hidden: int = 256,
                 epochs: int = 400, seed: int = 0, val_frac: float = 0.1,
                 device="cuda", capture: bool = True):
        self.device = resolve_device(device)
        self.capture = capture
        train, test, _ = load_enas(corpus_path, burn_in=0)
        rows, ys = [], []
        self.table = {}
        for g in train + test:
            row = graph_to_enas_row(g)
            self.table[str(row)] = float(g.y)
            rows.append(featurize_row(row))
            ys.append(float(g.y))
        X = np.stack(rows).astype(np.float32)
        y = np.asarray(ys, np.float32)[:, None]
        rng = np.random.RandomState(seed)
        perm = rng.permutation(len(X))
        n_val = max(1, int(len(X) * val_frac))
        vi, ti = perm[:n_val], perm[n_val:]
        # the train and validation rows and targets
        self.split = (X[ti], y[ti], X[vi], y[vi])
        self._fit(*self.split, self.init_params(X.shape[1], hidden, seed), epochs)

    def init_params(self, d: int, hidden: int, seed: int) -> Dict[str, torch.Tensor]:
        """He-normal weights, zero biases (the JAX scales), from a
        torch.Generator seeded `seed`, on the scorer's device."""
        gen = torch.Generator().manual_seed(seed)
        rn = lambda *s: torch.randn(s, generator=gen)
        p = {"w1": rn(d, hidden) * (2.0 / d) ** 0.5, "b1": torch.zeros(hidden),
             "w2": rn(hidden, hidden) * (2.0 / hidden) ** 0.5,
             "b2": torch.zeros(hidden),
             "w3": rn(hidden, 1) * (1.0 / hidden) ** 0.5, "b3": torch.zeros(1)}
        return {k: v.to(self.device) for k, v in p.items()}

    def _fit(self, Xt, yt, Xv, yv, params, epochs):
        self.mu, self.sd = float(yt.mean()), float(yt.std()) or 1.0
        dev = lambda a: torch.as_tensor(a, device=self.device)
        data = (dev(Xt), dev((yt - self.mu) / self.sd))
        carry = (params, make_optimizer(1e-3, clip=0.0).init(params))
        if self.capture:
            key = _Key(str(self.device), tuple(Xt.shape), params["w1"].shape[1])
            step = lambda c: FIT(key, c, data)[0]
        else:
            eager = _train_step(1e-3)
            step = lambda c: eager(c, data)[0]
        for _ in range(epochs):
            carry = step(carry)
        # the fit's own tensors, not the graph's buffers
        self._params = {k: v.clone() for k, v in carry[0].items()}
        pv = self.predict(Xv) * self.sd + self.mu
        self.val_rmse = float(np.sqrt(np.mean((pv - yv.ravel()) ** 2)))
        self.val_pearson = float(np.corrcoef(pv, yv.ravel())[0, 1])

    @torch.no_grad()
    def predict(self, X: np.ndarray) -> np.ndarray:
        """The surrogate's normalized outputs for feature rows X [B, F]."""
        x = torch.as_tensor(np.asarray(X, np.float32), device=self.device)
        if self.capture:
            key = _Key(str(self.device), tuple(x.shape), self._params["w1"].shape[1])
            out = PREDICT(key, self._params, x)[1]
        else:
            out = _mlp(self._params, x)
        return out.cpu().numpy().ravel()

    def quality(self) -> str:
        return (f"surrogate val RMSE {self.val_rmse:.4f}, "
                f"Pearson r {self.val_pearson:.4f}")

    def score(self, arc_key: str) -> Optional[float]:
        exact = self.table.get(arc_key)
        if exact is not None:
            return exact
        try:
            f = featurize_row(arc_key)
        except (ValueError, SyntaxError, IndexError):
            return None
        return float(self.predict(f[None])[0] * self.sd + self.mu)

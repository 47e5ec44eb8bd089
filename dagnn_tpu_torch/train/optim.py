"""Adam with global-norm clipping, as optax computes it, and the VAE
driver's plateau schedule.

Counterpart of dagnn_tpu/train/optim.py: make_optimizer is the OGB
drivers' Adam(lr) + grad-norm clip 0.25 (reference: main_pyg.py:63-64,
297), as the optax chain clip_by_global_norm(clip) -> adam(lr); its update
takes an `lr` that replaces the one it was made with (optax's
inject_hyperparams): a float, or a 0-d float32 tensor on the gradients'
device, which a captured step (train/graphs.py; the GP fit's) stages
before each replay, where a float would be frozen into the graph at its
capture. The two give the same bits.
PlateauScheduler is ReduceLROnPlateau(factor 0.1, patience 10) of the dvae
driver (dvae/train.py:193-194). Two details differ from torch's own tools
and are kept on purpose:
  * the clip is optax's: g if norm < clip else g * clip / norm, with no
    epsilon (torch.nn.utils.clip_grad_norm_ adds 1e-6 to the norm);
  * Adam's bias correction divides the moments (mu / (1 - b1^t),
    nu / (1 - b2^t)) before the update mu_hat / (sqrt(nu_hat) + eps).
Parameters, gradients and state are dicts of tensors keyed alike.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable
    update: Callable   # (grads, state[, lr]) -> (updates, new_state)


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g.float() * g.float())
                          for g in tree.values()))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    trigger = norm < max_norm
    return {k: torch.where(trigger, g, (g / norm.to(g.dtype)) * max_norm)
            for k, g in grads.items()}


def make_optimizer(lr: float = 1e-3, clip: float = 0.25, b1: float = 0.9,
                   b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    def init(params):
        dev = next(iter(params.values())).device
        return {
            "count": torch.zeros((), dtype=torch.int32, device=dev),
            "mu": {k: torch.zeros_like(p) for k, p in params.items()},
            "nu": {k: torch.zeros_like(p) for k, p in params.items()},
        }

    def update(grads, state, lr=lr):
        if clip and clip > 0:
            grads = clip_by_global_norm(grads, clip)
        count = state["count"] + 1
        c = count.to(torch.float32)
        # a Python-scalar base: no host-to-device copy (which would sync)
        bc1 = 1.0 - torch.pow(b1, c)
        bc2 = 1.0 - torch.pow(b2, c)
        mu, nu, updates = {}, {}, {}
        for k, g in grads.items():
            mu[k] = (1.0 - b1) * g + b1 * state["mu"][k]
            nu[k] = (1.0 - b2) * (g * g) + b2 * state["nu"][k]
            mu_hat = mu[k] / bc1.to(g.dtype)
            nu_hat = nu[k] / bc2.to(g.dtype)
            updates[k] = -lr * (mu_hat / (torch.sqrt(nu_hat) + eps))
        return updates, {"count": count, "mu": mu, "nu": nu}

    return Optimizer(init, update)


class PlateauScheduler:
    """ReduceLROnPlateau(mode='min') on the host: after more than
    `patience` epochs without a new best metric, scale *= factor. The VAE
    driver multiplies its gradients by scale before the clip and Adam, as
    the JAX driver does. state_dict() holds plain numbers, so a
    checkpoint's results can carry it."""

    def __init__(self, factor: float = 0.1, patience: int = 10):
        self.factor = factor
        self.patience = patience
        self.best = float("inf")
        self.bad_epochs = 0
        self.scale = 1.0

    def step(self, metric: float) -> float:
        if metric < self.best:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.scale *= self.factor
                self.bad_epochs = 0
        return self.scale

    def state_dict(self):
        return {"best": self.best, "bad_epochs": self.bad_epochs,
                "scale": self.scale}

    def load_state_dict(self, state):
        self.best = float(state["best"])
        self.bad_epochs = int(state["bad_epochs"])
        self.scale = float(state["scale"])

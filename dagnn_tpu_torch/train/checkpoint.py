"""Checkpointing with the reference's rotation + resume semantics.

Counterpart of dagnn_tpu/train/checkpoint.py, with the same names and
file naming: one rotating file per run holding {epoch, params, opt_state,
results} (reference: ogbg-code/utils2.py:86-108; main_pyg.py:334-338
writes every epoch and deletes the previous; resume fast-forwards
completed folds, main_pyg.py:254-266), written to `<path>.tmp` and then
renamed over `<path>`, so a crash never leaves a torn checkpoint.

The format is the port's own and the JAX package does not read it (the
JAX files are flax msgpack inside a pickle): `torch.save` of a dict whose
params are the flat dotted-path dict of CPU tensors, opt_state the
optimizer's {count, mu, nu} as CPU tensors, and results plain numbers and
strings. `load_checkpoint` reads it with `torch.load(weights_only=True)`,
which accepts only tensors, dicts, lists, numbers and strings, so loading
a file runs no code from it. `load_partial_state` is the VAE driver's
model-surgery load (--load-partial) on the same format.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch


def checkpoint_name(directory: str, name: str, fold: int, epoch: int) -> str:
    return os.path.join(directory, f"{name}_{fold}_{epoch}.ckpt")


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


def _like(saved, template, what: str):
    """`saved` on the template's devices, after checking that every tensor
    has the template's key, shape and dtype."""
    if isinstance(template, torch.Tensor):
        if (not isinstance(saved, torch.Tensor) or saved.shape != template.shape
                or saved.dtype != template.dtype):
            raise ValueError(f"checkpoint {what}: {_desc(saved)} where the "
                             f"model has {_desc(template)}")
        return saved.to(template.device)
    if isinstance(template, dict):
        if not isinstance(saved, dict) or set(saved) != set(template):
            missing = sorted(set(template) - set(saved or {}))
            extra = sorted(set(saved or {}) - set(template))
            raise ValueError(f"checkpoint {what}: keys differ from the model's "
                             f"(missing {missing[:5]}, unexpected {extra[:5]})")
        return {k: _like(saved[k], v, f"{what}.{k}") for k, v in template.items()}
    return saved


def _desc(t):
    if isinstance(t, torch.Tensor):
        return f"{tuple(t.shape)} {t.dtype}"
    return type(t).__name__


def create_checkpoint(path: str, epoch: int, params: Dict[str, torch.Tensor],
                      opt_state, results) -> None:
    payload = {"epoch": int(epoch), "params": _to_cpu(params),
               "opt_state": _to_cpu(opt_state), "results": results}
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _load(path: str, device="cpu") -> Dict[str, Any]:
    return torch.load(path, map_location=device, weights_only=True)


def load_checkpoint(path: str, params_template, opt_state_template
                    ) -> Tuple[Any, int, Any, Any]:
    """(results, epoch, params, opt_state), each tensor on the device of
    its template's counterpart; raises ValueError when a key, shape or
    dtype differs from the templates'."""
    payload = _load(path)
    params = _like(payload["params"], params_template, "params")
    opt_state = _like(payload["opt_state"], opt_state_template, "opt_state")
    return payload["results"], payload["epoch"], params, opt_state


def load_partial_state(path: str, params_template: Dict[str, torch.Tensor]
                       ) -> Tuple[Dict[str, torch.Tensor], int, int]:
    """Model-surgery-tolerant load (reference load_module_state,
    dvae/util.py:41-63): every dotted key of the template that the
    checkpoint's params hold with the same shape is restored (in the
    template's dtype, on its device); every other keeps the template's
    tensor. Returns (params, n_loaded, n_skipped)."""
    saved = _load(path)["params"]
    out, n_loaded = {}, 0
    for k, t in params_template.items():
        s = saved.get(k)
        if isinstance(s, torch.Tensor) and s.shape == t.shape:
            out[k] = s.to(dtype=t.dtype, device=t.device)
            n_loaded += 1
        else:
            out[k] = t
    return out, n_loaded, len(params_template) - n_loaded


def load_checkpoint_results(path: str):
    return _load(path)["results"]


def remove_checkpoint(path: str) -> None:
    if os.path.exists(path):
        os.remove(path)


def find_latest_checkpoint(directory: str, name: str) -> Optional[str]:
    """Checkpoint auto-discovery (scripts/ogb_tok.sh:53-60 glob): pick the
    `name_<fold>_<epoch>.ckpt` with the largest (fold, epoch)."""
    if not os.path.isdir(directory):
        return None
    best = None
    best_key = (-1, -1)
    for fn in os.listdir(directory):
        if not (fn.startswith(name + "_") and fn.endswith(".ckpt")):
            continue
        parts = fn[len(name) + 1: -5].split("_")
        if len(parts) != 2:
            continue
        try:
            key = (int(parts[0]), int(parts[1]))
        except ValueError:
            continue
        if key > best_key:
            best_key = key
            best = os.path.join(directory, fn)
    return best


def parse_fold_epoch(path: str) -> Tuple[int, int]:
    """Recover (fold, epoch) from `name_<fold>_<epoch>.ckpt`
    (main_pyg.py:257-259)."""
    stem = os.path.basename(path)[:-5]
    fold, epoch = stem.rsplit("_", 2)[-2:]
    return int(fold), int(epoch)

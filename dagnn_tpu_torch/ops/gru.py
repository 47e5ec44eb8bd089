"""GRU cell with torch.nn.GRUCell's parameter layout and gate math.

Counterpart of dagnn_tpu/ops/gru.py:
    r = sigmoid(x W_ir^T + b_ir + h W_hr^T + b_hr)
    z = sigmoid(x W_iz^T + b_iz + h W_hz^T + b_hz)
    n = tanh  (x W_in^T + b_in + r * (h W_hn^T + b_hn))
    h' = (1 - z) * n + z * h
with stacked w_ih = [W_ir; W_iz; W_in] ([3H, In]) and w_hh ([3H, H]).

`gru_cell` is that math in plain torch.matmul, in the operands' dtype, as
the JAX function computes it: the per-direction wavefront's generic branch
runs it (in JAX these products lie outside every Pallas kernel).

`gru_gates` is that math over the row kernels' weight views (fused r/z
weight w_rz = [w_ih[:2H] | w_hh[:2H]], n-gate parts w_in / w_hn, combined
biases), with float32 accumulation whatever the operand type: it is the
plain version of the GEMM the row kernels run (ops/row_step.py), whose
caller forms h'.
"""

from __future__ import annotations

import math

import torch

from dagnn_tpu_torch.ops.linear import _uniform


def gru_init(gen: torch.Generator, in_dim: int, hidden_dim: int,
             dtype=torch.float32):
    bound = 1.0 / math.sqrt(hidden_dim)
    return {
        "w_ih": _uniform(gen, (3 * hidden_dim, in_dim), bound, dtype),
        "w_hh": _uniform(gen, (3 * hidden_dim, hidden_dim), bound, dtype),
        "b_ih": _uniform(gen, (3 * hidden_dim,), bound, dtype),
        "b_hh": _uniform(gen, (3 * hidden_dim,), bound, dtype),
    }


def gru_cell(params, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """One GRU step. x: [..., In], h: [..., H] -> [..., H]."""
    gi = x @ params["w_ih"].T + params["b_ih"]
    gh = h @ params["w_hh"].T + params["b_hh"]
    H = h.shape[-1]
    i_r, i_z, i_n = gi[..., :H], gi[..., H:2 * H], gi[..., 2 * H:]
    h_r, h_z, h_n = gh[..., :H], gh[..., H:2 * H], gh[..., 2 * H:]
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def gru_gates(cellp, cur: torch.Tensor, agg: torch.Tensor, hdim: int):
    """Gate pre-activations and gates of one GRU step in float32.

    cellp holds the row kernels' views (w_rz [2H, In+H], w_in [H, In],
    w_hn [H, H], b_rz [1, 2H], b_in [1, H], b_hn [1, H]). Operands of any
    float type are widened to float32 first, so the products are exact and
    the sums run in float32 (the kernels' f32 accumulation).
    Returns (r, z, n, h_n), all float32."""
    f = lambda t: t.float()
    ca = torch.cat([f(cur), f(agg)], dim=1)
    grz = ca @ f(cellp["w_rz"]).T + f(cellp["b_rz"])
    i_n = f(cur) @ f(cellp["w_in"]).T + f(cellp["b_in"])
    h_n = f(agg) @ f(cellp["w_hn"]).T + f(cellp["b_hn"])
    r = torch.sigmoid(grz[:, :hdim])
    z = torch.sigmoid(grz[:, hdim:])
    n = torch.tanh(i_n + r * h_n)
    return r, z, n, h_n

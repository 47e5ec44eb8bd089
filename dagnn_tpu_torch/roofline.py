"""The port's cost model: the flagship train step's analytic FLOPs and
bytes (the JAX package's bench.py `_roofline`, formula for formula), the
per-launch bytes and operations of each kernel, and the cards' peaks.

Read by the bench (`dagnn_tpu_torch.bench --roofline`) and by
chip_smoke.py, which prints each kernel's bound from `bound_ms`.

- Model FLOPs count the work of the model, whatever implements it:
  3 x (the GRU's gate products over the real nodes + the attention's
  edge encode, score and weighted sum over the real edges + the head).
- Executed FLOPs are the port's own census: the operations of each kernel
  launch of one step (`row_ops`, the same count `kernel_costs` bounds a
  launch by), summed over the launches the wrappers counted, plus the
  head's 3 x. The JAX bench counts its Pallas one-hot passes there, which
  the CUDA kernels do not run.
- Peaks are per card, keyed by `torch.cuda.get_device_name()`; a card
  without an entry raises (no card's peaks stand in for another's).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

H100_SXM = "NVIDIA H100 80GB HBM3"
# NVIDIA's data sheet, SXM part at 700 W, dense rates: bf16 on the tensor
# cores, float32 outside them, HBM3 bytes/s
PEAKS = {H100_SXM: {"bf16_flops": 989e12, "f32_flops": 67e12,
                    "hbm_bytes": 3.35e12}}
PEAK_BYTES = PEAKS[H100_SXM]["hbm_bytes"]
PEAK_OPS = {torch.bfloat16: PEAKS[H100_SXM]["bf16_flops"],
            torch.float32: PEAKS[H100_SXM]["f32_flops"]}
# K5 and K6 do their arithmetic in float32 on the CUDA cores whatever the
# operands' type, so their operations are bounded at the float32 rate


def peaks(card: str) -> Dict[str, float]:
    """The peaks of the card named `card` (torch.cuda.get_device_name())."""
    if card not in PEAKS:
        raise ValueError(f"no peaks are known for the card {card!r} "
                         f"(known: {sorted(PEAKS)})")
    return PEAKS[card]


def bound_ms(nbytes, ops, dt):
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_OPS[dt] * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# ------------------------------------------------------- one kernel launch

def row_ops(kn2, emb, H, nl, R, ne, nt, n_near=0):
    """(forward ops, backward ops) of one row (K1/K2, K7) or pair (K3/K4)
    call over kn2 node slots: the gate GEMMs over every slot, the
    attention's arithmetic over the ne valid edges, the backward's
    transpose-grad adds over the nt valid transpose edges (and K7's
    n_near near-grad sums)."""
    f_ops = 0
    b_ops = nt * nl * H + n_near * nl * H
    for l in range(nl):
        din = emb if l == 0 else H
        f_ops += 2 * kn2 * 3 * H * (din + H)                   # gates
        f_ops += kn2 * din * 2 + ne * H * (2 * R + 2 + 2 + 2)  # q/k scores, agg
        b_ops += 2 * kn2 * 3 * H * (2 * din + 2 * H) + 2 * kn2 * H * H
        b_ops += ne * H * (4 * R + 12) + kn2 * din * 4
    return f_ops, b_ops


def kernel_costs(static, d, weights, dt):
    """(forward bytes, forward ops, backward bytes, backward ops) of one row
    (K1/K2) or pair (K3/K4) call: each input read once, each output written
    once; operations counted on this call's valid edges."""
    has_ea, H, nl = static
    es = torch.tensor([], dtype=dt).element_size()
    kn2, emb = d["xin"].shape
    ke2 = d["edst"].shape[0]
    R = d["ea"].shape[1]
    ne = int((d["emask"] > 0).sum())
    nt = int((d["tmask"] > 0).sum())
    nb = lambda t: t.numel() * t.element_size()
    wsum = lambda names: sum(nb(weights[k]) for k in names)
    fwd_w = [k for k in weights if k.split("_", 1)[1] in
             ("wq", "wk", "b", "we", "be", "w_ih", "w_hh", "b_ih", "b_hh")]
    bwd_w = [k for k in weights if k.split("_", 1)[1] in
             ("wqr", "wkr", "we", "be", "w_ih", "w_hh", "b_hh")]
    idx = sum(nb(d[k]) for k in ("edst", "emask", "nmask", "nsrc") if k in d)
    # K7: the previous row's outputs (read by the near edges)
    row_in = nb(d["xin"]) + nb(d["vals"]) + nb(d["ea"]) + idx \
        + (nb(d["prev_out"]) if "prev_out" in d else 0)
    out1 = kn2 * nl * H * es + ke2 * nl * 4 + kn2 * 4 * nl * H * es
    f_bytes = row_in + wsum(fwd_w) + out1
    res = ke2 * nl * 4 + kn2 * 4 * nl * H * es
    # K7: the next row's near grads in, this row's out (near_g_out)
    near = 2 * nb(d["near_g"]) if "near_g" in d else 0
    b_in = row_in + wsum(bwd_w) + nb(d["g"]) + nb(d["tg"]) + nb(d["tdst"]) \
        + nb(d["tmask"]) + res
    dw = sum(weights[k].numel() * 4 for k in weights
             if k.split("_", 1)[1] in ("wq", "wk", "b", "we", "be", "w_ih",
                                       "w_hh", "b_ih", "b_hh"))
    b_out = nb(d["xin"]) + nb(d["vals"]) + nb(d["ea"]) + dw
    b_bytes = b_in + b_out + near
    # K7's near-grad sums (a merged row: Kn = kn2 / 2)
    n_near = int((d["nsrc"] < kn2 // 2).sum()) if "near_g" in d else 0
    f_ops, b_ops = row_ops(kn2, emb, H, nl, R, ne, nt, n_near)
    return f_bytes, f_ops, b_bytes, b_ops


def recompute_costs(static, d, weights, dt):
    """(bytes, ops) of one K2r call: K2's inputs and outputs without the
    residual streams, plus the forward weights K2 does not read; K1's and
    K2's operations."""
    has_ea, H, nl = static
    f_bytes, f_ops, b_bytes, b_ops = kernel_costs(static, d, weights, dt)
    es = torch.tensor([], dtype=dt).element_size()
    kn2, ke2 = d["xin"].shape[0], d["edst"].shape[0]
    res = ke2 * nl * 4 + kn2 * 4 * nl * H * es
    fwd_only = sum(weights[k].numel() * weights[k].element_size() for k in weights
                   if k.split("_", 1)[1] in ("wq", "wk", "b", "b_ih"))
    return b_bytes - res + fwd_only, f_ops + b_ops


def segment_costs(ke, ne, ns, S, H, es):
    """(forward bytes, forward ops, backward bytes, backward ops) of one K6
    call at es bytes an element. Read once: dst and mask of all ke edges,
    the scores and value rows of the ne valid edges only (the masked ones
    do not enter the function), and in the backward the cotangent rows of
    the ns slots that have a valid edge. Written once: the full output
    [S, H] (forward), d_scores [ke] and d_values [ke, H] (backward).
    Operations on the ne valid edges (the weighted sum; the dot, the value
    grads and the score grad)."""
    in_b = ke * 8 + ne * es + ne * H * es
    return (in_b + S * H * es, ne * (2 * H + 5),
            in_b + ns * H * es + ke * es + ke * H * es, ne * (3 * H + 8))


def tg_costs(kn, kt, nt, c, es):
    """(bytes, ops) of one K5 call: g read and the output written [Kn, C],
    tdst and tmask of all kt rows, the tg rows of the nt valid transpose
    edges only; an add per element of g and of each valid tg row."""
    return 2 * kn * c * es + nt * c * es + kt * 8, (nt + kn) * c


# ------------------------------------------------ the flagship train step

def _widths(batch, dirs):
    """(L rows, Kn, Ke, Kt) of a host batch; on a pair plan its per-pair
    widths as equivalent per-row-per-direction ones (bench.py:72-78)."""
    L, kn = batch.fwd.node_ids.shape
    ke = batch.fwd.edge_src.shape[1]
    kt = batch.fwd.tgrad_eslot.shape[1]
    plan = getattr(batch, "pair", None)
    if plan is not None:
        ke = plan.edst.shape[1] / (2 * dirs)
        kt = plan.teslot.shape[1] / (2 * dirs)
    return int(L), int(kn), ke, kt


def head_flops(cfg, batch) -> int:
    """The token heads' forward FLOPs over the batch's graph slots."""
    G = batch.y["y_arr"].shape[0]
    return 2 * G * cfg.max_seq_len * cfg.num_vocab * cfg.out_hidden_dim


def model_flops(cfg, batch) -> int:
    """Analytic FLOPs of one train step (forward + 2x backward) over the
    real nodes and edges: bench.py:81-91."""
    H, E_dim = cfg.hidden_dim, cfg.emb_dim
    dirs, nl = len(cfg.dirs), cfg.num_layers
    gru = int(batch.n_node) * dirs * nl * 2 * (3 * H * E_dim + 3 * H * H)
    attn = int(batch.n_edge) * dirs * nl * 2 * (cfg.num_rels * H + H + H)
    return 3 * (gru + attn + head_flops(cfg, batch))


def hbm_bytes_est(cfg, batch, n_params: int) -> float:
    """bench.py:112-119's traffic estimate of one bf16 train step: the x
    stream, state buffers, value stream, edge-grad buffer, weight-grad
    read-modify-writes per row, and the optimizer's f32 state."""
    H, E_dim = cfg.hidden_dim, cfg.emb_dim
    dirs, nl = len(cfg.dirs), cfg.num_layers
    L, Kn, Ke, _ = _widths(batch, dirs)
    bpe = 2
    streams = L * Kn * E_dim * bpe * dirs
    h_buf = (L * Kn + 1) * nl * H * bpe * dirs
    vals_s = L * Ke * nl * H * bpe * dirs
    acc = (L * Ke + 1) * nl * H * bpe * dirs
    dw = L * dirs * nl * (2 * 3 * H * (E_dim + H)) * bpe * 3
    opt = n_params * 4 * 8
    return 2 * streams + 3 * h_buf + 2 * vals_s + 3 * acc + dw + opt


def _step_ops(cfg, batch):
    """(forward, backward) ops of each step of the batch's fused plan, and
    the wrappers' launch-count names: the pair plan's steps (K3/K4, 4 Kn
    slots) or the merged rows (K1/K2, 2 Kn slots)."""
    plan = getattr(batch, "pair", None)
    dirs = (batch.fwd, batch.rev)
    kn = batch.fwd.node_ids.shape[1]
    if plan is not None:
        kn2, names = 4 * kn, ("pair_forward", "pair_backward")
        ne = np.asarray(plan.emask).reshape(len(plan.emask), -1).sum(1)
        nt = np.asarray(plan.tmask).reshape(len(plan.tmask), -1).sum(1)
    else:
        kn2, names = 2 * kn, ("row_forward", "row_backward")
        ne = sum(np.asarray(s.edge_mask).sum(1) for s in dirs)
        nt = sum(np.asarray(s.tgrad_mask).sum(1) for s in dirs)
    ops = [row_ops(kn2, cfg.emb_dim, cfg.hidden_dim, cfg.num_layers,
                   cfg.num_rels, int(a), int(b)) for a, b in zip(ne, nt)]
    return ops, names


def executed_flops(cfg, batch, launches: Dict[str, int]) -> float:
    """The port's census of one train step: each launch's operations
    (row_ops on its step's valid edges), summed over the launches the
    wrappers counted in that step (`launches`, a read_launch_counts()
    difference), plus the head's forward and backward."""
    ops, (fwd, bwd) = _step_ops(cfg, batch)
    n = len(ops)
    f = sum(o[0] for o in ops) * launches.get(fwd, 0) / n
    b = sum(o[1] for o in ops) * launches.get(bwd, 0) / n
    return f + b + 3 * head_flops(cfg, batch)


def roofline(cfg, batch, dt: float, n_params: int, card_peaks: Optional[dict] = None,
             launches: Optional[Dict[str, int]] = None,
             busy_share: Optional[float] = None) -> dict:
    """bench.py's accounting line of one train step of `dt` seconds on the
    host batch `batch` (unrounded): model and executed TFLOP, their share
    of the card's bf16 peak, the HBM estimate and its share of the card's
    rate, the sequential units (rows of both directions, and the scan's
    steps: L merged, L/2 on a pair plan) and the time each takes, and the
    device's busy share of a profiled step. Without `card_peaks` (the
    CPU) the shares of a peak are None; without `launches` (no kernel
    launched) the executed count is None."""
    dirs = len(cfg.dirs)
    L = _widths(batch, dirs)[0]
    steps = L // 2 if getattr(batch, "pair", None) is not None else L
    model = model_flops(cfg, batch)
    execd = executed_flops(cfg, batch, launches) if launches else None
    nbytes = hbm_bytes_est(cfg, batch, n_params)
    share = (lambda v, peak: None if card_peaks is None or v is None
             else v / dt / card_peaks[peak])
    return dict(
        model_tflops=model / 1e12,
        executed_tflops=None if execd is None else execd / 1e12,
        mfu=share(model, "bf16_flops"),
        executed_vs_peak=share(execd, "bf16_flops"),
        hbm_gb_est=nbytes / 1e9,
        hbm_util_est=share(nbytes, "hbm_bytes"),
        seq_rows=int(L * dirs),
        us_per_row=dt / (L * dirs) * 1e6,
        seq_steps=int(steps),
        us_per_step=dt / steps * 1e6,
        device_busy_share=busy_share,
    )

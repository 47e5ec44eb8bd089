"""Microbenchmark: the row kernels K1 (forward) and K2 (backward) alone at
the bench's row shape, H = 300 against 384 and 256.

Counterpart of scripts/microbench_row_kernel.py: one direction-merged row
(Kn 256, Ke 512, Kt 576 a direction, 8 edge types, 2 layers, 2
directions, bf16; emb = H) with inputs and weights drawn from one seeded
normal stream, in the JAX script's order (the weights at torch's init
scale, see make_inputs). The JAX script chains 82 calls
in one jitted scan to hide dispatch; here 82 calls are replayed from one
CUDA graph (utils/timing.timings: the median of three windows), and the
eager per-call time (host issue included) is printed beside. Output: µs
a row, forward and backward, the bound of each call (roofline.kernel_costs
at the card's peaks), and H 384's time over H 300's against their FLOP
ratio, and H 256's. The question it answers (ROADMAP queue 2 item 4): do
H 300's 600-byte bf16 rows, which are not 16-byte aligned, cost more than
H 384's 768-byte rows by more than the FLOP ratio says?

    python -m dagnn_tpu_torch.scripts.microbench_row_kernel          # the card
    python -m dagnn_tpu_torch.scripts.microbench_row_kernel --cpu    # plain, host clock
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

KN, KE, KT, R, NL, NDIRS = 256, 512, 576, 8, 2, 2
ROWS = 82
WIDTHS = (("H=300 (production)", 300), ("H=384 (3x128, aligned rows)", 384),
          ("H=256 (2x128)", 256))


def make_inputs(h, emb, kn=KN, ke=KE, kt=KT, r=R, nl=NL, ndirs=NDIRS,
                dtype=torch.bfloat16, device="cpu", seed=0):
    """(static, inputs, weights) of one row: every float drawn from
    np.random.default_rng(seed).normal in the JAX script's order (each
    direction's weights, then xin, vals, ea, the sorted destinations, g,
    tg, tdst), rounded to `dtype`; masks all ones. Each weight and bias is
    scaled by 1/sqrt(its layer's fan-in), torch's init scale: the JAX
    script's unit-normal weights give gate pre-activations of order 25,
    where one bf16 rounding step (0.125) taken at another point moves a
    tanh by more than phase 3's bf16 gate allows. The times do not depend
    on the values."""
    from dagnn_tpu_torch.ops import row_step
    rng = np.random.default_rng(seed)

    def t(*shape, fan=1):
        return torch.as_tensor((rng.normal(size=shape) / np.sqrt(fan))
                               .astype(np.float32)).to(dtype)

    qdims = [emb] + [h] * (nl - 1)
    ws = []
    for _ in range(ndirs):
        aggr, cells = [], []
        for l in range(nl):
            fa = qdims[l] + h
            aggr.append({
                "attn_lin": {"w": t(1, fa, fan=fa), "b": t(1, fan=fa)},
                "edge_encoder": {"w": t(h, r, fan=r), "b": t(h, fan=r)},
            })
            cells.append({"w_ih": t(3 * h, qdims[l], fan=h), "w_hh": t(3 * h, h, fan=h),
                          "b_ih": t(3 * h, fan=h), "b_hh": t(3 * h, fan=h)})
        ws.append(row_step.flatten_row_weights(aggr, cells, qdims, True))
    weights = row_step.stack_row_weights(ws) if ndirs > 1 else ws[0]
    KN_, KE_, KT_ = kn * ndirs, ke * ndirs, kt * ndirs
    d = dict(xin=t(KN_, emb), vals=t(KE_, nl * h), ea=t(KE_, r))
    d["edst"] = torch.as_tensor(np.concatenate(
        [np.sort(rng.integers(0, kn, ke)) for _ in range(ndirs)]).astype(np.int32))
    d["emask"] = torch.ones(KE_)
    d["nmask"] = torch.ones(KN_)
    d["g"] = t(KN_, nl * h)
    d["tg"] = t(KT_, nl * h)
    d["tdst"] = torch.as_tensor(rng.integers(0, kn, KT_).astype(np.int32))
    d["tmask"] = torch.ones(KT_)
    dev = torch.device(device)
    return ((True, h, nl), {k: v.to(dev) for k, v in d.items()},
            {k: v.to(dev) for k, v in weights.items()})


def calls(static, d, w, ndirs=NDIRS, plain=False):
    """(forward, backward) of the row as zero-argument calls: the
    wrappers (K1/K2 on card tensors), or the plain versions. The backward
    reads the residual streams of one forward made here."""
    from dagnn_tpu_torch.ops import row_step as rs
    f, b = ((rs.row_forward_plain, rs.row_backward_plain) if plain
            else (rs.row_forward, rs.row_backward))
    fargs = (static, d["xin"], d["vals"], d["ea"], d["edst"], d["emask"],
             d["nmask"], w)
    res = f(*fargs, emit_res=True, ndirs=ndirs)[1:]
    return (lambda: f(*fargs, emit_res=True, ndirs=ndirs),
            lambda: b(*fargs, d["g"], d["tg"], d["tdst"], d["tmask"], res, ndirs=ndirs))


def host_ms(fn, reps=3):
    """Mean host-clock ms of fn() (the CPU run: no device is timed)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def bench_shape(label, h, device="cuda", rows=ROWS):
    """One width: K1 and K2 timed (device ms from a CUDA graph of `rows`
    calls, and per eager call), their bounds and FLOPs. On the CPU the
    plain versions on the host clock."""
    from dagnn_tpu_torch import roofline
    from dagnn_tpu_torch.utils.timing import timings
    st, d, w = make_inputs(h, h, device=device)
    fwd, bwd = calls(st, d, w)
    fb, fo, bb, bo = roofline.kernel_costs(st, d, w, torch.bfloat16)
    out = dict(label=label, H=h, fwd_ops=fo, bwd_ops=bo,
               fwd_bound_ms=roofline.bound_ms(fb, fo, torch.bfloat16)[0],
               bwd_bound_ms=roofline.bound_ms(bb, bo, torch.bfloat16)[0])
    if d["xin"].device.type == "cpu":
        out.update(fwd_host_ms=host_ms(fwd), bwd_host_ms=host_ms(bwd))
        print(f"{label:30s} cpu, plain versions: fwd {out['fwd_host_ms']:9.2f} ms, "
              f"bwd {out['bwd_host_ms']:9.2f} ms a row (host clock)")
        return out
    tf, tb = timings(fwd, reps=rows), timings(bwd, reps=rows)
    out.update(fwd_ms=tf["ms"], bwd_ms=tb["ms"], fwd_call_ms=tf["call_ms"],
               bwd_call_ms=tb["call_ms"], fwd_windows=tf["windows"],
               bwd_windows=tb["windows"])
    print(f"{label:30s} fwd {tf['ms'] * 1e3:7.1f} us/row  bwd {tb['ms'] * 1e3:7.1f} "
          f"us/row (CUDA graph of {rows}); eager fwd {tf['call_ms'] * 1e3:7.1f} bwd "
          f"{tb['call_ms'] * 1e3:7.1f} us/call; bounds {out['fwd_bound_ms'] * 1e3:.2f} / "
          f"{out['bwd_bound_ms'] * 1e3:.2f} us; scan est fwd {tf['ms'] * rows:.2f} ms "
          f"bwd {tb['ms'] * rows:.2f} ms")
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    from dagnn_tpu_torch import resolve_device
    dev = resolve_device("cpu" if "--cpu" in argv else "cuda")
    name = "cpu" if dev.type == "cpu" else torch.cuda.get_device_name(dev)
    print(f"device: {name}; Kn {KN}, Ke {KE}, Kt {KT} a direction, R {R}, "
          f"{NL} layers, {NDIRS} directions, bf16")
    res = [bench_shape(label, h, device=dev) for label, h in WIDTHS]
    if dev.type == "cuda":
        a = res[0]
        for b in res[1:]:
            t = (b["fwd_ms"] + b["bwd_ms"]) / (a["fwd_ms"] + a["bwd_ms"])
            f = (b["fwd_ops"] + b["bwd_ops"]) / (a["fwd_ops"] + a["bwd_ops"])
            print(f"{b['label']} / {a['label']}: time {t:.3f}x (fwd "
                  f"{b['fwd_ms'] / a['fwd_ms']:.3f}x, bwd {b['bwd_ms'] / a['bwd_ms']:.3f}x), "
                  f"FLOPs {f:.3f}x")
    return res


if __name__ == "__main__":
    main()

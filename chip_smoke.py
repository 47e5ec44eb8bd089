"""Smoke run of the PyTorch/CUDA port on one GPU: the flagship TOK train step.

Drives dagnn_tpu_torch (never the JAX package) through the entry points a
user calls, at the flagship's full width (emb/hidden 300, 160 synthetic
ASTs, bf16), on both wavefronts the port runs, with the hand-written
kernels of dagnn_tpu_torch/csrc/wavefront.cu: the direction-merged
wavefront (row kernels K1 forward, K2 backward) and the pair-scheduled
wavefront (pair kernels K3 forward, K4 backward; pair=2, the JAX bench's
default):

  1.  the card's name and power limit (nvidia-smi)
  2.  build the kernels from the checkout's sources (nvcc, sm_90a)
  3.  K1 and K2 against their plain PyTorch versions on one merged row at
      the flagship shapes, bf16 and f32, with timings and bounds
  3b. K3 and K4 the same way on one pair step of the flagship pair batch
  4.  the merged workload (synthetic batch, flagship.pad_for, no pair plan)
  4b. the pair workload (the same graphs, flagship.pad_for(pair=2))
  the merged path (launch counts set to 0 before, read after):
  5.  one train step's loss, gradient norm and every parameter's gradient,
      kernels against the plain versions, from the same weights
  6.  a warm-up step, then 5 timed train steps on the same batch: finite,
      decreasing losses; edges/s fwd+bwd
  7.  one predict
  8.  launch counts: K1/K2 L per pass, K3/K4 none
  5c. f32, the pair path at pair=1 against the merged path on the same
      packing, kernels on both sides
  the pair path (counts set to 0 before, read after): 5b, 6b, 7b as 5-7,
  8b. launch counts: K3/K4 P per pass, K1/K2 none

The second-to-last line is the kernel table as JSON, the last line
{"ok": true, "device": {...}}. Any failed check exits non-zero.

    python3 chip_smoke.py              # needs one CUDA device
    python3 chip_smoke.py --profile    # adds a profiled train step per path
                                       # (traces in traces/, or --trace-dir DIR)
"""

import dataclasses
import json
import re
import subprocess
import sys
import time

import torch

# tolerances, as max|kernel - plain| on the output's or weight grad's own
# max|plain| (dagnn_tpu_torch.checks):
#   bf16 3e-2: one bf16 rounding step (2^-8 relative) taken at a different
#     point when an f32 sum in another order lands near a rounding boundary
#   f32 1e-4: the same sums in another order (up to 1024 terms), carried
#     through two GRU layers and the softmax
# Gradient elements that are zero in exact arithmetic (checks.ZERO: a score
# grad of a destination with one edge, softmax-invariant weights) hold only
# rounding noise in both versions; the kernel's may be at most NOISE_TOL
# times the plain version's.
TOL = {torch.bfloat16: 3e-2, torch.float32: 1e-4}
NOISE_TOL = 8.0
# phases 5 and 5b, the whole bf16 step, kernels against plain:
#   loss and global grad norm 1e-5: both read 2.2e-7 on the H100 (merged)
#   each grad leaf 6e-2 of its own max|plain|: the merged readings are at
#     most 1.6e-2, except 2.7e-2 on the edge encoder's weight of layer 1 in
#     direction 0, a nearly cancelling sum (2.7e-6 against leaves of 1e-3
#     and more); the plain version's index_add_ sums in no fixed order
STEP_TOL = {"loss": 1e-5, "leaf": 6e-2}
# phase 5c, f32 pair=1 against merged (the JAX package's own layout test,
# tests/test_pair.py:105-112): loss and norm 1e-5 relative; every grad leaf
# within rtol / atol
PAIR1_TOL = {"loss": 1e-5, "rtol": 5e-4, "atol": 5e-5}
PEAK_BYTES = 3.35e12                     # H100 SXM HBM3, bytes/s
PEAK_OPS = {torch.bfloat16: 989e12,      # dense tensor-core bf16
            torch.float32: 67e12}        # float32 outside the tensor cores
FLAGSHIP = dict(kn=256, ke=512, kt=512, H=300, emb=300, nl=2, R=2, nd=2)
WIDTH = dict(H=300, emb=300, nl=2, R=2)


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def gpu_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"


def time_ms(fn, reps):
    """Mean device time of fn() in ms (CUDA events around reps calls)."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def short(dt):
    return str(dt)[6:]


def ptxas_summary(log):
    """One line per compiled kernel from nvcc's -Xptxas -v output: its name
    and type, registers, spills and static shared memory."""
    out, name, spill = [], "?", ""
    for line in log.splitlines():
        m = re.search(r"Function properties for _Z(\d+)(\w+)", line)
        if m:
            n = int(m.group(1))
            name = m.group(2)[:n] + ("[bf16]" if "bfloat16" in m.group(2) else "[f32]")
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
    return out


# ------------------------------------------------- kernels alone, one step

def rand_weights(g, dt, dev, H, emb, nl, R, nd):
    """Stacked [nd, ...] kernel weights at torch's default init scale."""
    from dagnn_tpu_torch.ops import row_step
    u = lambda *s, b=1.0: ((torch.rand(s, generator=g) * 2 - 1) * b)
    qd = [emb] + [H] * (nl - 1)
    dirs = []
    for _ in range(nd):
        aggr, cells = [], []
        for l in range(nl):
            b = (qd[l] + H) ** -0.5
            aggr.append({"attn_lin": {"w": u(1, qd[l] + H, b=b), "b": u(1, b=b)},
                         "edge_encoder": {"w": u(H, R, b=R ** -0.5),
                                          "b": u(H, b=R ** -0.5)}})
            b = H ** -0.5
            cells.append({"w_ih": u(3 * H, qd[l], b=b), "w_hh": u(3 * H, H, b=b),
                          "b_ih": u(3 * H, b=b), "b_hh": u(3 * H, b=b)})
        cast = lambda t: {k: (cast(v) if isinstance(v, dict) else v.to(dt))
                          for k, v in t.items()}
        dirs.append(row_step.flatten_row_weights(
            [cast(a) for a in aggr], [cast(c) for c in cells], qd, True))
    return {k: v.to(dev) for k, v in row_step.stack_row_weights(dirs).items()}


def _to_dev(d, dt, dev):
    return {k: (v.to(dt) if v.is_floating_point() and k not in
                ("emask", "nmask", "tmask") else v).to(dev) for k, v in d.items()}


def _one_hot(g, n, R):
    ea = torch.zeros(n, R)
    ea[torch.arange(n), torch.randint(0, R, (n,), generator=g)] = 1
    return ea


def row_inputs(dt, dev, seed=0, kn=256, ke=512, kt=512, H=300, emb=300, nl=2,
               R=2, nd=2):
    """One direction-merged row at the given shapes, from a seed: sorted
    destination slots, ~10% pad edges, one-hot edge types, weights at
    torch's default init scale."""
    g = torch.Generator().manual_seed(seed)
    u = lambda *s: (torch.rand(s, generator=g) * 2 - 1)
    n = lambda *s: torch.randn(s, generator=g)
    weights = rand_weights(g, dt, dev, H, emb, nl, R, nd)
    edst = torch.cat([torch.sort(torch.randint(0, kn, (ke,), generator=g))[0]
                      for _ in range(nd)])
    emask = torch.rand(nd * ke, generator=g) > 0.1
    edst[~emask] = kn
    ea = _one_hot(g, nd * ke, R)
    tdst = torch.randint(0, kn, (nd * kt,), generator=g)
    tmask = torch.rand(nd * kt, generator=g) > 0.1
    tdst[~tmask] = kn
    d = dict(xin=n(nd * kn, emb), vals=u(nd * ke, nl * H), ea=ea,
             edst=edst.int(), emask=emask.float(),
             nmask=(torch.rand(nd * kn, generator=g) > 0.05).float(),
             g=0.1 * n(nd * kn, nl * H), tg=0.1 * n(nd * kt, nl * H),
             tdst=tdst.int(), tmask=tmask.float())
    return (True, H, nl), _to_dev(d, dt, dev), weights


def pair_step_index(plan, kn):
    """The pair step with the most intra-pair edges among those whose A rows
    and B far regions have edges too (the first step's A row is leaves)."""
    import numpy as np
    w = plan.widths
    ka = w["keA"][0] + w["keA"][1]
    intra = (plan.nsrc < kn).sum(1)
    far = (plan.emask[:, ka:] & (plan.nsrc[:, ka:] >= kn)).sum(1)
    score = np.where((plan.emask[:, :ka].sum(1) > 0) & (far > 0), intra, -1)
    return int(np.argmax(score))


def pair_inputs(dt, dev, plan, kn, p, seed=1, H=300, emb=300, nl=2, R=2):
    """Pair step p of a host pair plan at the flagship width: the plan's own
    indices and masks, random xin / vals / g / tg and one-hot edge types."""
    g = torch.Generator().manual_seed(seed)
    u = lambda *s: (torch.rand(s, generator=g) * 2 - 1)
    n = lambda *s: torch.randn(s, generator=g)
    weights = rand_weights(g, dt, dev, H, emb, nl, R, 2)
    a = lambda k: torch.as_tensor(getattr(plan, k)[p])
    W, T = plan.edst.shape[1], plan.tdst.shape[1]
    d = dict(xin=n(4 * kn, emb), vals=u(plan.acc_unit, nl * H),
             ea=_one_hot(g, W, R), edst=a("edst").int(),
             emask=a("emask").float(), nmask=a("node_mask").float(),
             nsrc=a("nsrc").int(), g=0.1 * n(4 * kn, nl * H),
             tg=0.1 * n(T, nl * H), tdst=a("tdst").int(),
             tmask=a("tmask").float())
    return (True, H, nl), _to_dev(d, dt, dev), weights


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
    row_in = nb(d["xin"]) + nb(d["vals"]) + nb(d["ea"]) + idx
    out1 = kn2 * nl * H * es + ke2 * nl * 4 + kn2 * 4 * nl * H * es
    f_bytes = row_in + wsum(fwd_w) + out1
    gemm = 0
    attn = 0
    for l in range(nl):
        din = emb if l == 0 else H
        gemm += 2 * kn2 * 3 * H * (din + H)                  # gates
        attn += kn2 * din * 2 + ne * H * (2 * R + 2 + 2 + 2)   # q/k scores, agg
    f_ops = gemm + attn
    res = ke2 * nl * 4 + kn2 * 4 * nl * H * es
    b_in = row_in + wsum(bwd_w) + nb(d["g"]) + nb(d["tg"]) + nb(d["tdst"]) \
        + nb(d["tmask"]) + res
    dw = sum(weights[k].numel() * 4 for k in weights
             if k.split("_", 1)[1] in ("wq", "wk", "b", "we", "be", "w_ih",
                                       "w_hh", "b_ih", "b_hh"))
    b_out = nb(d["xin"]) + nb(d["vals"]) + nb(d["ea"]) + dw
    b_bytes = b_in + b_out
    b_ops = nt * nl * H
    for l in range(nl):
        din = emb if l == 0 else H
        b_ops += 2 * kn2 * 3 * H * (2 * din + 2 * H) + 2 * kn2 * H * H
        b_ops += ne * H * (4 * R + 12) + kn2 * din * 4
    return f_bytes, f_ops, b_bytes, b_ops


def bound_ms(nbytes, ops, dt):
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_OPS[dt] * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def phase_kernels(spec):
    """Phases 3 / 3b: a forward kernel and its backward against their plain
    versions on one call's inputs (spec["inputs"](dt)), in bf16 and f32.
    Forward outputs on their own max|plain|; backward outputs and weight
    grads on their own max|plain| with the elements that are zero in exact
    arithmetic (the float32 plain run on the same inputs tells them apart)
    held to the noise bound. Times: the median of three windows of 50
    launches, the plain version's mean of 5."""
    from dagnn_tpu_torch import checks
    kf_name, kb_name = spec["names"]
    results = {}
    for dt in (torch.bfloat16, torch.float32):
        st, d, w = spec["inputs"](dt)
        fwd = lambda fn, d, w, emit: fn(*spec["fargs"](st, d, w), emit_res=emit,
                                        **spec["kw"])
        bwd = lambda fn, d, w, res: fn(*spec["bargs"](st, d, w, res), **spec["kw"])
        kf = fwd(spec["fwd"], d, w, True)
        pf = fwd(spec["fwd_plain"], d, w, True)
        torch.cuda.synchronize()
        errs, noise = {}, {}
        for name, a, b in zip(("out", "alpha32", "nres"), kf, pf):
            errs[f"{kf_name}.{name}"] = checks.rel_err(a, b)
        # the backward on identical inputs: the plain forward's residuals
        res = (pf[1], pf[2])
        kb = bwd(spec["bwd"], d, w, res)
        pb = bwd(spec["bwd_plain"], d, w, res)
        torch.cuda.synchronize()
        fd, fw = checks.to_f32(d), checks.to_f32(w)
        truth = bwd(spec["bwd_plain"], fd, fw,
                    fwd(spec["fwd_plain"], fd, fw, True)[1:])
        leaves = [(n, a, b, t, checks.tree_max({n: t})) for n, a, b, t in
                  zip(("dx", "dvals", "dea"), kb[:3], pb[:3], truth[:3])]
        tmax = checks.tree_max(truth[3])
        leaves += [(f"dw[{k}]", kb[3][k], pb[3][k], truth[3][k], tmax) for k in pb[3]]
        for n, a, b, t, m in leaves:
            rel, ab, scale, nz = checks.grad_err(a, b, t, m)
            errs[f"{kb_name}.{n}"] = (rel, ab, scale)
            noise[f"{kb_name}.{n}"] = nz
        tol = TOL[dt]
        worst = {}
        for k, (rel, ab, scale) in errs.items():
            kern = k.split(".")[0]
            worst[kern] = max(worst.get(kern, (0, 0, 0, "")), (rel, ab, scale, k))
        for kern, (rel, ab, scale, k) in sorted(worst.items()):
            print(f"  {kern} {short(dt)}: worst {k} max_abs_err {ab:.3e} of "
                  f"max|plain| {scale:.3e}, rel {rel:.3e} (tolerance {tol:g})")
        nk = max(noise, key=noise.get)
        print(f"  {kb_name} {short(dt)}: exact-zero elements, worst {nk} "
              f"{noise[nk]:.3g} x the plain version's noise (tolerance {NOISE_TOL:g})")
        bad = [k for k, (rel, ab, scale) in errs.items() if not rel <= tol]
        bad += [k for k, v in noise.items() if not v <= NOISE_TOL]
        check(not bad, f"{dt}: kernel disagrees with plain on {bad}")
        f_win = [time_ms(lambda: fwd(spec["fwd"], d, w, True), 50) for _ in range(3)]
        pf_ms = time_ms(lambda: fwd(spec["fwd_plain"], d, w, True), 5)
        b_win = [time_ms(lambda: bwd(spec["bwd"], d, w, res), 50) for _ in range(3)]
        pb_ms = time_ms(lambda: bwd(spec["bwd_plain"], d, w, res), 5)
        print(f"  {short(dt)} windows (ms): {kf_name} "
              f"{' '.join(f'{v:.4f}' for v in f_win)}; {kb_name} "
              f"{' '.join(f'{v:.4f}' for v in b_win)}")
        b1, o1, b2, o2 = kernel_costs(st, d, w, dt)
        results[dt] = {
            kf_name: dict(ms=sorted(f_win)[1], plain_ms=pf_ms, err=worst[kf_name][1],
                          bound=bound_ms(b1, o1, dt), bytes=b1, ops=o1),
            kb_name: dict(ms=sorted(b_win)[1], plain_ms=pb_ms, err=worst[kb_name][1],
                          bound=bound_ms(b2, o2, dt), bytes=b2, ops=o2)}
        for kern in (kf_name, kb_name):
            r = results[dt][kern]
            print(f"  {kern} {short(dt)}: kernel {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.5f} ms by "
                  f"{r['bound'][1]} ({r['bytes'] / 1e6:.2f} MB, "
                  f"{r['ops'] / 1e9:.3f} GFLOP)")
    return results


def row_spec(dev):
    from dagnn_tpu_torch.ops import row_step as rs
    return dict(
        names=("K1", "K2"), fwd=rs.row_forward, fwd_plain=rs.row_forward_plain,
        bwd=rs.row_backward, bwd_plain=rs.row_backward_plain, kw={"ndirs": 2},
        inputs=lambda dt: row_inputs(dt, dev, **FLAGSHIP),
        fargs=lambda st, d, w: (st, d["xin"], d["vals"], d["ea"], d["edst"],
                                d["emask"], d["nmask"], w),
        bargs=lambda st, d, w, res: (st, d["xin"], d["vals"], d["ea"], d["edst"],
                                     d["emask"], d["nmask"], w, d["g"], d["tg"],
                                     d["tdst"], d["tmask"], res))


def pair_spec(dev, plan, kn, p):
    from dagnn_tpu_torch.ops import pair_step as ps
    blocks = plan.blocks
    return dict(
        names=("K3", "K4"), fwd=ps.pair_forward, fwd_plain=ps.pair_forward_plain,
        bwd=ps.pair_backward, bwd_plain=ps.pair_backward_plain, kw={},
        inputs=lambda dt: pair_inputs(dt, dev, plan, kn, p, **WIDTH),
        fargs=lambda st, d, w: (st, d["xin"], d["vals"], d["ea"], d["edst"],
                                d["emask"], d["nmask"], d["nsrc"], w, blocks),
        bargs=lambda st, d, w, res: (st, d["xin"], d["vals"], d["ea"], d["edst"],
                                     d["emask"], d["nmask"], d["nsrc"], w, d["g"],
                                     d["tg"], d["tdst"], d["tmask"], res, blocks))


# -------------------------------------------------------- the main path

def loss_and_grads(params, cfg, batch, impl):
    """(loss, {name: grad}, global grad norm) of one forward and backward."""
    from dagnn_tpu_torch.nn.dagnn import dagnn_forward
    from dagnn_tpu_torch.train.losses import tok_loss
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = tok_loss(dagnn_forward(p, cfg, batch, impl=impl), batch.y["y_arr"],
                    batch.graph_mask)
    gs = torch.autograd.grad(loss, list(p.values()))
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in gs))
    return float(loss.detach()), dict(zip(p, gs)), float(norm)


def phase_step(label, params, cfg, batch, kernels, plain):
    """Phases 5 / 5b: the kernel step's parameter grads against the plain
    step's, leaf by leaf on each leaf's own scale. The plain step in
    float32 with the same bf16-rounded weights marks the elements that
    are zero in exact arithmetic."""
    from dagnn_tpu_torch import checks
    kl, kg, kn = loss_and_grads(params, cfg, batch, kernels)
    pl, pg, pn = loss_and_grads(params, cfg, batch, plain)
    _, truth, _ = loss_and_grads(
        {k: v.to(torch.bfloat16).float() for k, v in params.items()},
        dataclasses.replace(cfg, compute_dtype="float32"), batch, plain)
    tmax = checks.tree_max(truth)
    e_loss, e_norm = abs(kl - pl) / abs(pl), abs(kn - pn) / pn
    print(f"{label} one step, kernels vs plain: loss {kl:.6f} vs {pl:.6f} (rel "
          f"{e_loss:.2e}), grad norm {kn:.6f} vs {pn:.6f} (rel {e_norm:.2e}); "
          f"tolerance {STEP_TOL['loss']:g}")
    rows = []
    for k in pg:
        rel, ab, scale, nz = checks.grad_err(kg[k], pg[k], truth[k], tmax)
        rows.append((rel, ab, scale, nz, k))
    rows.sort(reverse=True)
    print(f"    {len(rows)} grad leaves; the worst, as max_abs_err of max|plain| "
          f"(tolerance {STEP_TOL['leaf']:g}; exact-zero elements' noise, tolerance "
          f"{NOISE_TOL:g} x the plain step's):")
    for rel, ab, scale, nz, k in rows[:6]:
        print(f"      {k:28s} {ab:.3e} of {scale:.3e} = {rel:.3e}   noise {nz:.3g}")
    print(f"    worst noise {max(r[3] for r in rows):.3g} "
          f"({max(rows, key=lambda r: r[3])[4]})")
    bad = [r[4] for r in rows
           if not (r[0] <= STEP_TOL["leaf"] and r[3] <= NOISE_TOL)]
    check(e_loss <= STEP_TOL["loss"] and e_norm <= STEP_TOL["loss"] and not bad,
          f"kernel step disagrees with plain step on {bad or 'the loss or norm'}")


def phase_pair1_vs_merged(params, cfg, batch1):
    """Phase 5c: in f32, the pair path at pair=1 against the merged path on
    the same packing (the same batch without its pair plan), kernels on
    both sides: pairing only changes the execution layout."""
    from dagnn_tpu_torch.nn.dagnn import KERNELS, PAIR_KERNELS
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    lp, gp, np_ = loss_and_grads(params, cfg32, batch1, PAIR_KERNELS)
    lm, gm, nm = loss_and_grads(params, cfg32, batch1._replace(pair=None), KERNELS)
    e_loss, e_norm = abs(lp - lm) / abs(lm), abs(np_ - nm) / nm
    t = PAIR1_TOL
    # the worst leaf's |pair - merged| over (atol + rtol |merged|): <= 1 passes
    ratio = {k: float(((gp[k] - gm[k]).abs()
                       / (t["atol"] + t["rtol"] * gm[k].abs())).max()) for k in gm}
    worst = max(ratio, key=ratio.get)
    print(f"[5c] f32 pair=1 vs merged, kernels: loss {lp:.7f} vs {lm:.7f} (rel "
          f"{e_loss:.2e}), grad norm rel {e_norm:.2e} (tolerance {t['loss']:g}); "
          f"worst leaf {worst} at {ratio[worst]:.3g} of rtol {t['rtol']:g} / "
          f"atol {t['atol']:g}")
    check(e_loss <= t["loss"] and e_norm <= t["loss"] and ratio[worst] <= 1.0,
          "f32 pair=1 step disagrees with the merged step")


def timed_steps(label, make_step_fns, make_optimizer, cfg, params, batch, card,
                n_steps=5):
    """Phases 6 / 6b: one warm-up step, then n_steps timed train steps from
    the same weights on the same batch. Returns (edges/s, step ms, losses,
    params, opt state, train_step, predict)."""
    opt = make_optimizer(lr=1e-3, clip=0.25)
    train_step, predict = make_step_fns(cfg, opt, "tok")
    state = opt.init(params)
    params, state, loss0, _ = train_step(params, state, batch)   # warm-up
    losses = [float(loss0)]
    torch.cuda.synchronize()
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    host0 = time.perf_counter()
    ev0.record()
    step_losses = []
    for _ in range(n_steps):
        params, state, loss, _ = train_step(params, state, batch)
        step_losses.append(loss)
    ev1.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - host0
    dev_ms = ev0.elapsed_time(ev1) / n_steps
    losses += [float(v) for v in step_losses]
    eps = int(batch.n_edge) / (dev_ms / 1e3)
    print(f"{label} losses {' '.join(f'{v:.6f}' for v in losses)}")
    print(f"    step {dev_ms:.2f} ms (CUDA events), host {host_s / n_steps * 1e3:.2f}"
          f" ms/step; {eps:.1f} edges/s fwd+bwd per GPU on {card}; peak cuda "
          f"memory {torch.cuda.max_memory_allocated() / 1e6:.1f} MB")
    check(all(v == v and abs(v) != float("inf") for v in losses), "non-finite loss")
    check(losses[-1] < losses[0], "loss did not decrease")
    return eps, dev_ms, losses, params, state, train_step, predict


def check_predict(label, predict, params, cfg, batch):
    pred = predict(params, batch)
    torch.cuda.synchronize()
    print(f"{label} predict: ids {tuple(pred.shape)} in [{int(pred.min())}, "
          f"{int(pred.max())}]")
    check(tuple(pred.shape) == (int(batch.graph_mask.shape[0]), cfg.max_seq_len)
          and int(pred.min()) >= 0 and int(pred.max()) < cfg.num_vocab,
          "predict output out of range")


def trace_dir(argv):
    """Where --profile writes its traces: --trace-dir DIR, else traces/."""
    return argv[argv.index("--trace-dir") + 1] if "--trace-dir" in argv else "traces"


def profile_step(tag, train_step, params, state, batch, card, out_dir):
    """Optional (--profile): one train step under torch.profiler. Writes
    the trace to <out_dir>/step_trace_<tag>.json and prints, from its
    kernel and memory-op events, the device's busy share of the step's span
    and the device time by kernel."""
    import collections
    import os
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        train_step(params, state, batch)
        torch.cuda.synchronize()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"step_trace_{tag}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    dev = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not dev:
        print(f"[profile {tag}] the trace holds no device events: not measured")
        return
    t0 = min(e["ts"] for e in dev)
    t1 = max(e["ts"] + e["dur"] for e in dev)
    busy = sum(e["dur"] for e in dev)
    print(f"[profile {tag}] device span {(t1 - t0) / 1e3:.2f} ms, busy "
          f"{busy / 1e3:.2f} ms ({100 * busy / (t1 - t0):.1f}%), "
          f"{len(dev)} device events, on {card}")
    by = collections.Counter()
    for e in dev:
        name = e["name"].replace("void ", "").replace("(anonymous namespace)::", "")
        by[name.split("<")[0].split("(")[0]] += e["dur"]
    for name, us in by.most_common(12):
        print(f"    {us / 1e3:9.3f} ms {100 * us / busy:5.1f}%  {name}")


def reset_counts():
    from dagnn_tpu_torch.ops import pair_step, row_step
    row_step.reset_launch_counts()
    pair_step.reset_launch_counts()


def read_counts():
    from dagnn_tpu_torch.ops import pair_step, row_step
    return {**row_step.launch_counts, **pair_step.launch_counts}


def drive_path(tag, labels, cfg, params, batch, per_pass, kernels, plain, card,
               argv):
    """One path through its entry points, launch counts set to 0 before and
    read after: the step check, the timed steps, a predict (and with
    --profile one profiled step). per_pass: (forward wrapper, backward
    wrapper, calls per pass). Fails unless the counts are exactly calls per
    pass times the passes, and every other wrapper launched nothing."""
    from dagnn_tpu_torch.cli.ogb_driver import make_step_fns
    from dagnn_tpu_torch.train.optim import make_optimizer
    fwd_name, bwd_name, per = per_pass
    train_passes = fwd_passes = 0
    reset_counts()
    phase_step(labels[0], params, cfg, batch, kernels, plain)
    train_passes += 1
    eps, ms, losses, p, state, train_step, predict = timed_steps(
        labels[1], make_step_fns, make_optimizer, cfg, params, batch, card)
    train_passes += 6
    check_predict(labels[2], predict, p, cfg, batch)
    fwd_passes += 1
    if "--profile" in argv:
        profile_step(tag, train_step, p, state, batch, card, trace_dir(argv))
        train_passes += 1
    lc = read_counts()
    want = {k: 0 for k in lc}
    want[fwd_name] = per * (train_passes + fwd_passes)
    want[bwd_name] = per * train_passes
    print(f"{labels[3]} {tag} path launch counts {lc}, expected {want}")
    check(lc == want, f"{tag} path launch counts differ from the passes")
    return dict(edges_per_s=eps, step_ms=ms, losses=losses, launches=lc)


def main(argv):
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from dagnn_tpu_torch import convert, flagship
    from dagnn_tpu_torch.dag.batch import collate
    from dagnn_tpu_torch.data.synthetic import synthetic_ast_batch
    from dagnn_tpu_torch.nn.dagnn import (KERNELS, PAIR_KERNELS, PAIR_PLAIN,
                                          PLAIN, dagnn_init)
    from dagnn_tpu_torch.ops import build, row_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = gpu_line()
    print(f"[1] gpu: {card}")
    print(f"    torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    build.build("wavefront")
    row_step._lib()
    secs, log = build.build_log.get("wavefront", (0.0, "(cached)"))
    print(f"[2] built wavefront.cu (K1-K4) in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {secs:.1f} s)")
    for line in ptxas_summary(log):
        print("    " + line)

    # host collation of both workloads (set-up, outside every step)
    graphs = synthetic_ast_batch(0, 160, mean_nodes=125)
    t0 = time.perf_counter()
    host0 = collate(graphs, flagship.pad_for(graphs))
    t_merged = time.perf_counter() - t0
    t0 = time.perf_counter()
    host2 = collate(graphs, flagship.pad_for(graphs, pair=2))
    t_pair = time.perf_counter() - t0
    host1 = collate(graphs, flagship.pad_for(graphs, pair=1))

    print("[3] K1/K2 against their plain versions, one row at the flagship "
          "shapes " + json.dumps(FLAGSHIP))
    rows = phase_kernels(row_spec(dev))
    kn = host2.fwd.node_ids.shape[1]
    p = pair_step_index(host2.pair, kn)
    print(f"[3b] K3/K4 against their plain versions, pair step {p} of the "
          f"flagship pair=2 batch, blocks {host2.pair.blocks}, width "
          + json.dumps(WIDTH))
    pairs = phase_kernels(pair_spec(dev, host2.pair, kn, p))

    batch = convert.batch_to_torch(host0, dev)
    L = batch.fwd.node_ids.shape[0]
    n_edges = int(batch.n_edge)
    print(f"[4] merged workload: {int(batch.n_node)} nodes, {n_edges} edges, "
          f"{int(batch.n_graph)} graphs, L={L} rows, Kn={kn} Ke="
          f"{batch.fwd.edge_src.shape[1]} Kt={batch.fwd.tgrad_eslot.shape[1]} "
          f"per direction; collation {t_merged:.2f} s; cuda memory "
          f"{torch.cuda.memory_allocated() / 1e6:.1f} MB")
    pbatch = convert.batch_to_torch(host2, dev)
    plan = host2.pair
    P = plan.edst.shape[0]
    n_intra = int((plan.nsrc < kn).sum())
    print(f"[4b] pair workload (pair=2): P={P} pair steps (L="
          f"{host2.fwd.node_ids.shape[0]} rows), widths {plan.widths}, U="
          f"{plan.acc_unit}, W={plan.edst.shape[1]}, T={plan.tdst.shape[1]}; "
          f"{n_intra} of {int(plan.emask.sum())} directed edges intra-pair; "
          f"collation {t_pair:.2f} s; cuda memory "
          f"{torch.cuda.memory_allocated() / 1e6:.1f} MB")

    cfg = flagship.flagship_cfg()
    params = dagnn_init(0, cfg, device=dev)
    print(f"    {sum(v.numel() for v in params.values())} parameters")

    torch.cuda.reset_peak_memory_stats()
    merged = drive_path("merged", ("[5]", "[6]", "[7]", "[8]"), cfg, params,
                        batch, ("row_forward", "row_backward", L), KERNELS,
                        PLAIN, card, argv)
    phase_pair1_vs_merged(params, cfg, convert.batch_to_torch(host1, dev))
    torch.cuda.reset_peak_memory_stats()
    paired = drive_path("pair", ("[5b]", "[6b]", "[7b]", "[8b]"), cfg, params,
                        pbatch, ("pair_forward", "pair_backward", P),
                        PAIR_KERNELS, PAIR_PLAIN, card, argv)
    print(f"    edges/s fwd+bwd per GPU on {card}: merged "
          f"{merged['edges_per_s']:.1f}, pair {paired['edges_per_s']:.1f} "
          f"({paired['edges_per_s'] / merged['edges_per_s']:.3f}x)")

    kernels = []
    for kern, name, line, res, run in (
            ("K1", "row_forward", "dagnn_tpu/ops/pallas/row_step.py:616", rows, merged),
            ("K2", "row_backward", "dagnn_tpu/ops/pallas/row_step.py:701", rows, merged),
            ("K3", "pair_forward", "dagnn_tpu/ops/pallas/pair_step.py:254", pairs, paired),
            ("K4", "pair_backward", "dagnn_tpu/ops/pallas/pair_step.py:291", pairs, paired)):
        r = res[torch.bfloat16][kern]
        kernels.append({"name": f"{name} ({kern})", "route": "cuda",
                        "source": "dagnn_tpu_torch/csrc/wavefront.cu",
                        "replaces": line, "launches": run["launches"][name],
                        "max_abs_err": r["err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                        "bound_by": r["bound"][1], "library_ms": None})
    print(json.dumps({"merged": merged, "pair": paired, "gpu": card,
                      "f32_kernels": {**rows[torch.float32], **pairs[torch.float32]}}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)

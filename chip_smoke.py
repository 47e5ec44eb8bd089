"""Smoke run of the PyTorch/CUDA port on one GPU: the flagship TOK train step,
the TOK and LP training drivers, every aggregator kind, the NA/BN VAE
driver with every --model, latent scoring with Bayesian optimisation, and
the ogbg-code2 baselines.

Drives dagnn_tpu_torch (never the JAX package) through the entry points a
user calls, at the flagship's full width (emb/hidden 300, 160 synthetic
ASTs, bf16), on every wavefront the port runs, with the hand-written
kernels of dagnn_tpu_torch/csrc/: wavefront.cu (the row kernels K1
forward / K2 backward, their near/far modes K7 and K2 without residual
streams K2r, the pair kernels K3 / K4, the transpose-grad accumulate K5)
and segment_attn.cu (the edge-softmax aggregate K6, forward and backward).
The paths: the direction-merged wavefront (K1/K2), the pair-scheduled
wavefront (K3/K4; pair=2, the JAX bench's default), the per-direction
wavefront's generic branch (segment_impl="pallas": K6, K5) and its fused
branch (bidirectional=False: K1/K2 at one direction, and K5 + K2 in the
split form), the merged and unidirectional wavefronts on near/far batches
(PadConfig.nearfar: K7) and the merged one without residual streams
(DAGNN_NO_RES_STREAM: K1, K2r):

  1.  the card's name and power limit (nvidia-smi)
  2.  build the kernels from the checkout's sources (nvcc, sm_90a, one
      process per source, all started together)
  3.  K1 and K2 against their plain PyTorch versions on one merged row at
      the flagship shapes, bf16 and f32, with bounds and two timings: on
      the device (50 calls replayed from one CUDA graph) and per eager call
  3b. K3 and K4 the same way on one pair step of the flagship pair batch
  3c. K6 forward and backward the same way on two levels of the flagship
      batch (Ke 512, 257 slots, H 300): the busiest and the median by valid
      edges, each with its valid edges and most edges a slot
  3d. K5 the same way (Kn 256, Kt 512, L*H 600), with index_add_ on the
      same data as the one-PyTorch-call time; and one row at one direction,
      K2 (merge_tg=True) against K5 + K2 (merge_tg=False)
  3e. K7 (K1/K2 with nf) the same way on the merged row with the most near
      edges of the flagship near/far ("regions", "tgonly") batch
  3f. K2r on one merged row at the flagship shapes: bitwise K2 fed by K1,
      and against its plain version; timed beside K2 and K1
  3g. K2's launches one by one on one merged row (bf16), each timed from a
      CUDA graph, with torch.matmul on each GEMM's shapes as a yardstick
  3h. K1's launches (attn_fwd, gru_fwd) the same way, with gru_fwd's
      TFLOP/s and its products in torch.matmul as the yardstick
  4.  the merged workload (synthetic batch, flagship.pad_for, no pair plan)
  4b. the pair workload (the same graphs, flagship.pad_for(pair=2))
  4c. the near/far workloads (the same graphs, pad_for with nearfar
      ("regions", "tgonly") and "regions")
  the merged path (launch counts set to 0 before, read after):
  5.  one train step's loss, gradient norm and every parameter's gradient,
      kernels against the plain versions, from the same weights
  6.  a warm-up step, then 5 timed train steps on the same batch: finite,
      decreasing losses; edges/s fwd+bwd
  7.  one predict
  8.  launch counts: K1/K2 L per pass, every other kernel none
  5c. f32, the pair path at pair=1 against the merged path on the same
      packing, kernels on both sides
  the pair path (counts set to 0 before, read after): 5b, 6b, 7b as 5-7,
  8b. launch counts: K3/K4 P per pass, every other kernel none
  the per-direction pallas path (the merged workload's batch;
  segment_impl="pallas"): 9a-9c as 5-7,
  9d. launch counts: per train pass, K6 forward 2 x (layers x L x 2
      directions) (the forward and its replay in the backward), K6
      backward and K5 once that; every other kernel none
  the unidirectional fused path (the same batch, bidirectional=False):
  10a-10c as 5-7, 10d. launch counts: K1/K2 L per pass
  10e. the split form (K5 + K2 merge_tg=False): f32 against the merged-tg
      kernels, bf16 kernels against plain (counts read after)
  11. f32, the bidirectional fused model per direction (two
      _direction_pass calls, K1 and K5 + K2 at one direction) against the
      merged path on the same batch
  the near/far paths, each as 5-8 with K7 L per pass: 12a-12d merged on
  ("regions", "tgonly"), 13a-13d merged on "regions", 14a-14d
  unidirectional on "regions"; 16a-16d the merged path without residual
  streams (K1 L per pass, K2r L per train pass)
  15. f32: each near/far batch against the plain layout of the same
      graphs (merged, and unidirectional), and the merged step without
      residual streams (K2r) against the one with them
  17. step times in turns (a, b, b, a), 5 steps each: merged against each
      near/far merged path and against K2r, unidirectional against its
      near/far path
  the TOK training driver (launch counts set to 0 before run A, read
  after run C):
  18. main_tok.main in process at the driver's defaults (the flagship's
      widths, batch 160, chunk 256, bf16, fused) on 800 synthetic ASTs:
      run A trains 2 epochs with checkpoints, run B asks for 3 in A's
      directories and resumes at epoch 3 (one checkpoint left), run C
      trains 3 afresh; finite losses falling from epoch 1 to 2, F1 in
      [0, 1], B's epoch 3 equal to C's, parameters on the card, K1/K2
      launched and no other kernel; epoch seconds, graphs/s and edges/s,
      evaluation seconds, and collation, copy and train step timed alone
  18b. outside the counted runs, at the loader's shapes (its bucket, not
      pad_for's): one bf16 step on its train batch 0, kernels against
      plain at phase 5's tolerances
  18c. the forward's logits on its first valid batch, kernels against
      plain (bf16 tolerance), predicted ids equal where the margin decides
  the LP training driver (counts set to 0 before run A, read after run C):
  19. main_lp.main in process at its defaults (gated_sum, unidirectional,
      275 classes; the generic branch) on 18's corpus: runs A, B, C as in
      18, B's epoch 3 bitwise C's, finite losses falling, accuracy in
      [0, 1], K5 launched and no other kernel; epoch seconds and rates
  19a. outside the counted runs, main_lp's config at the LP loader's
      shapes, generic branch kernels against plain: a bf16 train step
      (class_loss) on its train batch 0 at phase 5's gates, the logits of
      its first valid batch at the bf16 tolerance
  19b. every aggregator kind (add and max bidirectional with the quirk,
      gated_sum, self_attn_h, mattn_h, attn_x, attn_h on "dense",
      recurr=False) at the flagship's widths on phase 4's batch: one bf16
      train pass each, kernels against plain at phase 5's gates, its K6
      and K5 launches counted, its forward and backward timed
  19c. out_pool_all on the flagship's attn_h, fused: the per-direction
      wavefront (K1/K2 at one direction) with the node-space readout.
      Max pool: an f32 train pass, kernels against plain at 5c's
      tolerances; a bf16 pass at phase 5's loss and norm gates, its
      leaves printed beside the pool's share of tied features; the bf16
      logits against plain as 18c. Mean pool (no ties; K5 sums every
      node): a bf16 pass at all of phase 5's gates. Launches counted,
      both bf16 passes timed. Then the max pool's bf16 leaves gated
      tie-aware: the pool's gradient kept at the (graph, feature) pairs
      whose plain maximum is one node's and leads by more than twice the
      largest node-state error, detached elsewhere on both sides; loss
      and norm at phase 5's gates, each leaf within 0.3 of its own max
  the VAE driver (counts set to 0 before run A, read after run C):
  20. train_vae.main in process at scripts/na_train.sh's settings (DAGNN,
      attn_h, hs 501, nz 56, 2 layers, batch 32; the generic branch) on
      1,000 graphs of the repo's ENAS corpus: runs A (2 epochs), B
      (resumed to 3 in A's directory), C (3 afresh), latents every epoch;
      B's epoch 3 and parameters bitwise C's, losses finite and falling,
      a finite test NLL, latents [900, 56] / [100, 56], K6 and K5 launched
      at the counts of the passes and no other kernel; epoch seconds,
      graphs/s, latent and test-NLL seconds
  20a. outside the counted runs, at the NA loader's shapes (Kn 256, Ke
      1,024, 32 live nodes a level): one f32 train step, kernels against
      plain (loss and norm 1e-5, leaves rtol 5e-4 / atol 5e-5), mu of a
      128-graph batch within 2e-5; the train step timed; K6 forward and
      backward and K5 at the busiest level timed as 3c / 3d at width 501
      (the one-column path)
  20b. scripts/bn_train.sh's settings (DAGNN_BN, bidirectional, batch
      128) on 512 synthetic BN graphs, one epoch, launches counted; one
      step gated as 20a
  20c. DVAE and DVAE_BN, two short epochs each: no kernel of the port
      launched, finite falling losses
  latent scoring and BO (no kernel of the port on this path), on phase
  20's latents and checkpoints:
  21a. run_bo.main GP only (2 seeds, M 500, 100 iterations) on run C's
      latents [900, 56] / [100, 56]: two finite Test_RMSE_ll.txt lines;
      the seed-0 fit on the card against the same fit on the CPU (mean
      within 1e-3 of max|mean|, RMSE within 1%); fit and predict seconds
  21b. run_bo --bo: ENAS on run C's checkpoint (2 rounds of 50
      candidates, 100 decode attempts each, a 10,000-point grid, 50
      refinement steps, the surrogate scorer trained on the whole
      corpus), BN on 20b's DAGNN_BN checkpoint (1 round, BIC):
      best_arc_scores.txt written, each round's valid count, best score
      and seconds (GP fit, greedy EI, decode, scoring); summarize.main on
      each result directory
  21c. run C's encoder over the whole ENAS corpus (17,118 / 1,902
      graphs), then the GP at M 500 on those latents: finite; the load,
      the encode, the fit and the predict timed
  21d. train_vae.main for SVAE, SVAE_oneshot, SVAE_GraphRNN,
      SVAE_GraphRNN_BFS, DVAE_GCN, DVAE_fast and DVAE_DeepGMG at
      na_train.sh's widths on 256 ENAS graphs, 2 epochs: finite falling
      losses, latents [230, 56] / [26, 56], no kernel of the port
      launched; per model one f32 step on the card against the CPU's
      (loss and norm 1e-5, leaves rtol 5e-4 / atol 5e-5; a leaf past that
      held to the same in float64, card against CPU); run_bo GP only on
      SVAE's latents
  the baselines (float32, the drivers' defaults: emb 300, GIN/GCN 5
  layers, GNN2 3, HPoolConfig's with dense_nodes 256, batch 160; phase
  18's corpus; K5 their only kernel, for their sums onto graphs):
  22a. main_tok.main --gnn gin-virtual, runs A, B, C as in 18 (counts set
      to 0 before A, read after C): B's epoch 3 bitwise C's, K5 launched 5
      times a forward pass (4 virtual-node pools and the readout) and no
      other kernel, epoch seconds and graphs/s; then the node-level sum
      of the loader's batch 0 (edges sorted by node once a batch,
      ops/segment.SortedSegments) against index_add_ (equal within f32,
      ten repeats bitwise, timed, the sort timed apart), K5 at its
      graph-level sum against its plain version, and its train step
      timed with its launches counted
  22b. main_tok.main for gin, gcn, gcn-virtual, ggnns, ggnn-etype, gat,
      dgcnn, diffpool, unet, sagpool and asap, one epoch each: finite
      loss, F1 in [0, 1], K5 at the count of the forward passes; one f32
      step on the loader's batch 0 card against CPU at 21d's rule; the
      train step timed and its launches counted
  22c. main_lp.main --gnn sagpool, one epoch: finite, accuracy in [0, 1]
  22d. main_basic.main --model all (its own synthetic corpus of 800):
      the perfect model's F1 1.0 on valid and test, the CSV rows written
  22e. (--profile) one gin-virtual train step summarised by
      dagnn_tpu_torch.utils.profiling.summarize_trace

The second-to-last line is the kernel table as JSON, the last line
{"ok": true, "device": {...}}. Any failed check exits non-zero.

    python3 chip_smoke.py              # needs one CUDA device
    python3 chip_smoke.py --profile    # adds a profiled train step per path,
                                       # one NA VAE step and one gin-virtual
                                       # step (traces in traces/, or
                                       # --trace-dir DIR)
"""

import argparse
import contextlib
import dataclasses
import json
import math
import os
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
# phase 19c's tie-aware gate, the bf16 max pool's leaves with the pool's
# gradient kept only at the decided (graph, feature) pairs: each leaf 0.3
# of its own max|plain|. Set from the first reading (H100, 700 W): the
# worst 0.177 on layer 0's edge encoder weight in direction 0, a nearly
# cancelling leaf (max 3.6e-7, the tree's largest near 1e-3), the next
# 0.064 (the mean pool's gated pass reads 0.055 on the same attention
# weight); a routing fault moves a feature's whole gradient to another
# node, an error of order 1
TIE_AWARE_LEAF_TOL = 0.3
# phases 5c, 10e and 11, f32 steps of two routes or forms that compute the
# same function (the JAX package's own layout test, tests/test_pair.py:
# 105-112): loss and norm 1e-5 relative; every grad leaf within rtol / atol
CROSS_TOL = {"loss": 1e-5, "rtol": 5e-4, "atol": 5e-5}
PEAK_BYTES = 3.35e12                     # H100 SXM HBM3, bytes/s
PEAK_OPS = {torch.bfloat16: 989e12,      # dense tensor-core bf16
            torch.float32: 67e12}        # float32 outside the tensor cores
# K5 and K6 do their arithmetic in float32 on the CUDA cores whatever the
# operands' type, so their operations are bounded at the float32 rate
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


def timings(fn, reps=50):
    """A call's time two ways, each the median of three windows of `reps`
    calls: `ms` on the device alone (the calls captured in one CUDA graph,
    the graph replayed, so the host's issue time between launches drops
    out) and `call_ms` per eager call (host issue included: what a caller
    that launches one call after another waits). The windows beside."""
    call = [time_ms(fn, reps) for _ in range(3)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                  # warm-up on a side stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    dev = [time_ms(graph.replay, 1) / reps for _ in range(3)]
    return dict(ms=sorted(dev)[1], windows=dev, call_ms=sorted(call)[1],
                call_windows=call)


def fmt_windows(w):
    return " / ".join(f"{v:.4f}" for v in w)


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
    """Kernel weights at torch's default init scale: stacked [nd, ...], or
    one direction's unstacked for nd = 1."""
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
    w = row_step.stack_row_weights(dirs) if nd > 1 else dirs[0]
    return {k: v.to(dev) for k, v in w.items()}


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
    # K7: the previous row's outputs (read by the near edges)
    row_in = nb(d["xin"]) + nb(d["vals"]) + nb(d["ea"]) + idx \
        + (nb(d["prev_out"]) if "prev_out" in d else 0)
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
    # K7: the next row's near grads in, this row's out (near_g_out)
    near = 2 * nb(d["near_g"]) if "near_g" in d else 0
    b_in = row_in + wsum(bwd_w) + nb(d["g"]) + nb(d["tg"]) + nb(d["tdst"]) \
        + nb(d["tmask"]) + res
    dw = sum(weights[k].numel() * 4 for k in weights
             if k.split("_", 1)[1] in ("wq", "wk", "b", "we", "be", "w_ih",
                                       "w_hh", "b_ih", "b_hh"))
    b_out = nb(d["xin"]) + nb(d["vals"]) + nb(d["ea"]) + dw
    b_bytes = b_in + b_out + near
    b_ops = nt * nl * H
    if "near_g" in d:       # K7's near-grad sums (a merged row: Kn = kn2 / 2)
        b_ops += int((d["nsrc"] < kn2 // 2).sum()) * nl * H
    for l in range(nl):
        din = emb if l == 0 else H
        b_ops += 2 * kn2 * 3 * H * (2 * din + 2 * H) + 2 * kn2 * H * H
        b_ops += ne * H * (4 * R + 12) + kn2 * din * 4
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


def bound_ms(nbytes, ops, dt):
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_OPS[dt] * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def phase_kernels(spec):
    """Phases 3 / 3b: a forward kernel and its backward against their plain
    versions on one call's inputs (spec["inputs"](dt)), in bf16 and f32.
    Forward outputs on their own max|plain|; backward outputs and weight
    grads on their own max|plain| with the elements that are zero in exact
    arithmetic (the float32 plain run on the same inputs tells them apart)
    held to the noise bound. Times (`timings`): on the device and per eager
    call, each the median of three windows of 50 launches; the plain
    version's mean of 5 eager calls."""
    from dagnn_tpu_torch import checks
    kf_name, kb_name = spec["names"]
    # keyword arguments of the forward and the backward, from the inputs
    fkw = spec.get("fkw", lambda d: spec["kw"])
    bkw = spec.get("bkw", lambda d: spec["kw"])
    results = {}
    for dt in (torch.bfloat16, torch.float32):
        st, d, w = spec["inputs"](dt)
        fwd = lambda fn, d, w, emit: fn(*spec["fargs"](st, d, w), emit_res=emit,
                                        **fkw(d))
        bwd = lambda fn, d, w, res: fn(*spec["bargs"](st, d, w, res), **bkw(d))
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
        # outputs: dx, dvals, dea and (K7) near_g_out; kb[3] the weight grads
        outs = [(n, i) for n, i in (("dx", 0), ("dvals", 1), ("dea", 2),
                                    ("near_g_out", 4)) if i < len(pb)]
        leaves = [(n, kb[i], pb[i], truth[i], checks.tree_max({n: truth[i]}))
                  for n, i in outs]
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
        ft = timings(lambda: fwd(spec["fwd"], d, w, True))
        pf_ms = time_ms(lambda: fwd(spec["fwd_plain"], d, w, True), 5)
        bt = timings(lambda: bwd(spec["bwd"], d, w, res))
        pb_ms = time_ms(lambda: bwd(spec["bwd_plain"], d, w, res), 5)
        print(f"  {short(dt)} device windows (ms): {kf_name} {fmt_windows(ft['windows'])}; "
              f"{kb_name} {fmt_windows(bt['windows'])}; per eager call: {kf_name} "
              f"{fmt_windows(ft['call_windows'])}; {kb_name} "
              f"{fmt_windows(bt['call_windows'])}")
        b1, o1, b2, o2 = kernel_costs(st, d, w, dt)
        results[dt] = {
            kf_name: dict(ft, plain_ms=pf_ms, err=worst[kf_name][1],
                          bound=bound_ms(b1, o1, dt), bytes=b1, ops=o1),
            kb_name: dict(bt, plain_ms=pb_ms, err=worst[kb_name][1],
                          bound=bound_ms(b2, o2, dt), bytes=b2, ops=o2)}
        for kern in (kf_name, kb_name):
            r = results[dt][kern]
            print(f"  {kern} {short(dt)}: kernel {r['ms']:.4f} ms on the device, "
                  f"{r['call_ms']:.4f} ms per eager call, plain "
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


def nf_layout(host):
    """nf of a near/far batch's merged rows: per direction (mode, Ke, Kf),
    as nn/dagnn.py derives it."""
    from dagnn_tpu_torch.nn.dagnn import _nf_layout
    return tuple(_nf_layout(s, s.node_ids.shape[1], "cpu")[0]
                 for s in (host.fwd, host.rev))


def nearfar_row(host, kn):
    """The merged row of a near/far batch with the most near edges."""
    import numpy as np
    nsrc = np.concatenate([host.fwd.edge_nsrc, host.rev.edge_nsrc], axis=1)
    return int((nsrc < kn).sum(1).argmax())


def nf_inputs(dt, dev, host, row, seed=4, H=300, emb=300, nl=2, R=2):
    """One merged row of a near/far host batch at the flagship width: its
    own slots, masks, nsrc and transpose lists (each direction's padded to
    the wider Kt, as nn/dagnn.py does), random xin / vals (the gathered
    rows) / prev_out / near_g / g / tg and one-hot edge types."""
    import numpy as np
    g = torch.Generator().manual_seed(seed)
    u = lambda *s: (torch.rand(s, generator=g) * 2 - 1)
    n = lambda *s: torch.randn(s, generator=g)
    weights = rand_weights(g, dt, dev, H, emb, nl, R, 2)
    f, r = host.fwd, host.rev
    kn = f.node_ids.shape[1]
    kt = max(f.tgrad_dst.shape[1], r.tgrad_dst.shape[1])
    cat = lambda k, fill=None: torch.as_tensor(np.concatenate([
        np.pad(getattr(s, k)[row], (0, kt - getattr(s, k).shape[1]),
               constant_values=fill) if fill is not None else getattr(s, k)[row]
        for s in (f, r)]))
    U = sum(kf if m == "r" else ke for m, ke, kf in nf_layout(host))
    W = f.edge_src_slot.shape[1] + r.edge_src_slot.shape[1]
    d = dict(xin=n(2 * kn, emb), vals=u(U, nl * H), ea=_one_hot(g, W, R),
             edst=cat("edge_dst").int(), emask=cat("edge_mask").float(),
             nmask=cat("node_mask").float(), nsrc=cat("edge_nsrc").int(),
             prev_out=u(2 * kn, nl * H), near_g=0.1 * n(2 * kn, nl * H),
             g=0.1 * n(2 * kn, nl * H), tg=0.1 * n(2 * kt, nl * H),
             tdst=cat("tgrad_dst", kn).int(), tmask=cat("tgrad_mask", False).float())
    return (True, H, nl), _to_dev(d, dt, dev), weights


def nf_spec(dev, host, row):
    """K7: K1/K2 with nf on one merged row of a near/far batch."""
    from dagnn_tpu_torch.ops import row_step as rs
    nf = nf_layout(host)
    fkw = lambda d: dict(ndirs=2, nf=nf, nsrc=d["nsrc"], prev_out=d["prev_out"])
    return dict(
        names=("K7f", "K7b"), fwd=rs.row_forward, fwd_plain=rs.row_forward_plain,
        bwd=rs.row_backward, bwd_plain=rs.row_backward_plain, fkw=fkw,
        bkw=lambda d: dict(fkw(d), near_g=d["near_g"]),
        inputs=lambda dt: nf_inputs(dt, dev, host, row, **WIDTH),
        fargs=row_spec(dev)["fargs"], bargs=row_spec(dev)["bargs"])


def phase_recompute(dev):
    """Phase 3f: K2r (row_backward with res=None: K1's kernels recompute
    the residual streams, then K2's launches) on one merged row at the
    flagship shapes, bf16 and f32: bitwise K2 fed by K1 on the same inputs
    (max_abs_err 0 over dx, dvals, dea and every weight grad), and against
    its plain version (row_backward_plain(res=None)) as phase 3 holds K2.
    Timed as phase 3, beside K2 in the same call."""
    from dagnn_tpu_torch import checks
    from dagnn_tpu_torch.ops import row_step as rs
    results = {}
    for dt in (torch.bfloat16, torch.float32):
        st, d, w = row_inputs(dt, dev, **FLAGSHIP)
        fa = (st, d["xin"], d["vals"], d["ea"], d["edst"], d["emask"], d["nmask"], w)
        ba = fa + (d["g"], d["tg"], d["tdst"], d["tmask"])
        res = rs.row_forward(*fa, emit_res=True, ndirs=2)[1:]
        k2 = rs.row_backward(*ba, res, ndirs=2)
        k2r = rs.row_backward(*ba, None, ndirs=2)
        p2r = rs.row_backward_plain(*ba, None, ndirs=2)
        torch.cuda.synchronize()
        bit = max([float((a.float() - b.float()).abs().max()) for a, b in
                   zip(k2r[:3], k2[:3])]
                  + [float((k2r[3][k] - k2[3][k]).abs().max()) for k in k2[3]])
        truth = rs.row_backward_plain(*checks.to_f32(ba), None, ndirs=2)
        tmax = checks.tree_max(truth[3])
        errs = [checks.rel_err(a, b) + (0.0, n) for n, a, b in
                zip(("dx", "dvals", "dea"), k2r[:3], p2r[:3])]
        for k in p2r[3]:
            rel, ab, scale, nz = checks.grad_err(k2r[3][k], p2r[3][k], truth[3][k], tmax)
            errs.append((rel, ab, scale, nz, f"dw[{k}]"))
        worst = max(errs)
        noise = max(errs, key=lambda e: e[3])
        t2r = timings(lambda: rs.row_backward(*ba, None, ndirs=2))
        t2 = timings(lambda: rs.row_backward(*ba, res, ndirs=2))
        t1 = timings(lambda: rs.row_forward(*fa, emit_res=True, ndirs=2))
        p_ms = time_ms(lambda: rs.row_backward_plain(*ba, None, ndirs=2), 5)
        nb, ops = recompute_costs(st, d, w, dt)
        r = dict(t2r, plain_ms=p_ms, err=worst[1], scale=worst[2], rel=worst[0],
                 bytes=nb, ops=ops, bound=bound_ms(nb, ops, dt), library_ms=None,
                 bitwise_err=bit, k2_ms=t2["ms"], k1_ms=t1["ms"])
        print(f"  K2r {short(dt)}: against K2 fed by K1, max_abs_err {bit:.3e} "
              f"(must be 0); against plain: worst {worst[4]} {worst[1]:.3e} of "
              f"{worst[2]:.3e}, rel {worst[0]:.3e} (tolerance {TOL[dt]:g}), "
              f"exact-zero elements' noise worst {noise[4]} {noise[3]:.3g}")
        print(f"    device ms: K2r {t2r['ms']:.4f} (windows {fmt_windows(t2r['windows'])}), "
              f"K2 {t2['ms']:.4f}, K1 {t1['ms']:.4f}: K2r - K2 {t2r['ms'] - t2['ms']:.4f}; "
              f"per eager call K2r {t2r['call_ms']:.4f}, K2 {t2['call_ms']:.4f}; plain "
              f"K2r {p_ms:.4f}; bound {r['bound'][0]:.5f} ms by {r['bound'][1]} "
              f"({nb / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP)")
        check(bit == 0.0, f"K2r {dt}: not bitwise K2 ({bit:.3e})")
        check(worst[0] <= TOL[dt] and noise[3] <= NOISE_TOL,
              f"K2r {dt}: kernel disagrees with plain on {worst[4]} / {noise[4]}")
        results[dt] = {"K2r": r}
    return results


def busiest_level(host, key):
    """(direction schedule, row) of the flagship batch whose `key` mask
    has the most entries set, over both directions."""
    return max(((s, int(getattr(s, key).sum(1).argmax())) for s in (host.fwd, host.rev)),
               key=lambda sr: int(getattr(sr[0], key)[sr[1]].sum()))


def report(name, dt, r):
    print(f"  {name} {short(dt)}: kernel {r['ms']:.4f} ms on the device (windows "
          f"{fmt_windows(r['windows'])}), {r['call_ms']:.4f} ms per eager call "
          f"(windows {fmt_windows(r['call_windows'])}), plain {r['plain_ms']:.4f} ms"
          + (f", one PyTorch call {r['library_ms']:.4f} ms on the device, "
             f"{r['library_call_ms']:.4f} ms per eager call"
             if r.get("library_ms") is not None else "")
          + f", bound {r['bound'][0]:.5f} ms by {r['bound'][1]} "
          f"({r['bytes'] / 1e6:.3f} MB, {r['ops'] / 1e6:.3f} MFLOP); max_abs_err "
          f"{r['err']:.3e} of max|plain| {r['scale']:.3e} (tolerance {TOL[dt]:g})")


def median_level(host, key):
    """(direction schedule, row) of the flagship batch whose `key` mask has
    the median count of entries set over both directions' levels: what
    most of a step's launches of a per-level kernel see."""
    rows = sorted((int(getattr(s, key)[r].sum()), i, r)
                  for i, s in enumerate((host.fwd, host.rev))
                  for r in range(getattr(s, key).shape[0]))
    _, i, r = rows[len(rows) // 2]
    return (host.fwd, host.rev)[i], r


def phase_segment_attn(dev, host, level, H=300):
    """Phase 3c: K6 forward and backward against their plain versions on
    one level of the flagship batch (its slots and masks; random scores,
    values and cotangent from a seed), bf16 and f32; timed as phase 3.
    `level` picks the level: "busiest" or "median" by valid edges."""
    from dagnn_tpu_torch import checks
    from dagnn_tpu_torch.ops import segment_attn as sa
    pick = busiest_level if level == "busiest" else median_level
    sched, row = pick(host, "edge_mask")
    kn = sched.node_ids.shape[1]
    S = kn + 1
    dst = torch.as_tensor(sched.edge_dst[row]).int().to(dev)
    mask = torch.as_tensor(sched.edge_mask[row]).float().to(dev)
    ke = dst.shape[0]
    ne = int((mask > 0).sum())
    deg = torch.bincount(dst[mask > 0].long(), minlength=S)
    print(f"  {level} level: level {row} of the "
          f"{'fwd' if sched is host.fwd else 'rev'} schedule: {ne} of {ke} edges "
          f"valid, {int((deg > 0).sum())} of {S} slots non-empty, at most "
          f"{int(deg.max())} edges a slot")
    results = {"level": dict(schedule="fwd" if sched is host.fwd else "rev", row=row,
                             valid_edges=ne, max_edges_a_slot=int(deg.max()))}
    for dt in (torch.bfloat16, torch.float32):
        g = torch.Generator().manual_seed(2)
        sc = torch.randn(ke, generator=g).to(dt).to(dev)
        v = torch.randn(ke, H, generator=g).to(dt).to(dev)
        gout = (0.1 * torch.randn(S, H, generator=g)).to(dt).to(dev)
        es = sc.element_size()
        kf = sa.segment_attn_forward(sc, v, dst, mask, S)
        pf = sa.segment_attn_forward_plain(sc, v, dst, mask, S)
        kb = sa.segment_attn_backward(sc, v, dst, mask, gout, S)
        pb = sa.segment_attn_backward_plain(sc, v, dst, mask, gout, S)
        torch.cuda.synchronize()
        errs = {"K6f": [checks.rel_err(kf, pf)],
                "K6b": [checks.rel_err(kb[0], pb[0]), checks.rel_err(kb[1], pb[1])]}
        fb, fo, bb, bo = segment_costs(ke, ne, int((deg > 0).sum()), S, H, es)
        cost = {"K6f": (fb, fo), "K6b": (bb, bo)}
        runs = {"K6f": (lambda: sa.segment_attn_forward(sc, v, dst, mask, S),
                        lambda: sa.segment_attn_forward_plain(sc, v, dst, mask, S)),
                "K6b": (lambda: sa.segment_attn_backward(sc, v, dst, mask, gout, S),
                        lambda: sa.segment_attn_backward_plain(sc, v, dst, mask, gout, S))}
        results[dt] = {}
        for kern in ("K6f", "K6b"):
            rel, ab, scale = max(errs[kern])
            nb, ops = cost[kern]
            r = dict(timings(runs[kern][0]), plain_ms=time_ms(runs[kern][1], 5),
                     err=ab, scale=scale, rel=rel, bytes=nb, ops=ops, library_ms=None,
                     bound=bound_ms(nb, ops, torch.float32))
            report(kern, dt, r)
            check(rel <= TOL[dt], f"{kern} {dt}: kernel disagrees with plain ({rel:.3e})")
            results[dt][kern] = r
    return results


def phase_tg_accumulate(dev, host, LH=600):
    """Phase 3d: K5 against its plain version on the transpose schedule of
    one level of the flagship batch (random g and tg from a seed), bf16
    and f32, timed as phase 3, with index_add_ of the masked rows into g
    padded with a scratch row (the same function in one PyTorch call)."""
    from dagnn_tpu_torch import checks
    from dagnn_tpu_torch.ops import row_step as rs
    sched, row = busiest_level(host, "tgrad_mask")
    kn = sched.node_ids.shape[1]
    tdst = torch.as_tensor(sched.tgrad_dst[row]).int().to(dev)
    tmask = torch.as_tensor(sched.tgrad_mask[row]).float().to(dev)
    kt = tdst.shape[0]
    nt = int((tmask > 0).sum())
    print(f"  level {row}: {nt} of {kt} transpose edges valid, Kn {kn}, L*H {LH}")
    results = {}
    for dt in (torch.bfloat16, torch.float32):
        g = torch.Generator().manual_seed(3)
        gg = (0.1 * torch.randn(kn, LH, generator=g)).to(dt).to(dev)
        tg = (0.1 * torch.randn(kt, LH, generator=g)).to(dt).to(dev)
        k = rs.tg_accumulate(gg, tg, tdst, tmask)
        p = rs.tg_accumulate_plain(gg, tg, tdst, tmask)
        gpad = torch.cat([gg, torch.zeros(1, LH, dtype=dt, device=dev)])
        idx = tdst.long()
        tgm = torch.where(tmask[:, None] > 0, tg, torch.zeros((), dtype=dt, device=dev))
        lib = gpad.index_add(0, idx, tgm)[:kn]
        torch.cuda.synchronize()
        rel, ab, scale = checks.rel_err(k, p)
        lib_rel = checks.rel_err(lib, p)[0]
        nb, ops = tg_costs(kn, kt, nt, LH, gg.element_size())
        lib_t = timings(lambda: gpad.index_add(0, idx, tgm))
        r = dict(timings(lambda: rs.tg_accumulate(gg, tg, tdst, tmask)), err=ab,
                 scale=scale, rel=rel, bytes=nb, ops=ops,
                 plain_ms=time_ms(lambda: rs.tg_accumulate_plain(gg, tg, tdst, tmask), 5),
                 library_ms=lib_t["ms"], library_call_ms=lib_t["call_ms"],
                 bound=bound_ms(nb, ops, torch.float32))
        report("K5", dt, r)
        print(f"    index_add_ against plain: {lib_rel:.3e} of max|plain|")
        check(rel <= TOL[dt], f"K5 {dt}: kernel disagrees with plain ({rel:.3e})")
        results[dt] = {"K5": r}
    return results


def phase_split_row(dev):
    """Phase 3d, second half: one row at one direction (Kn 256, Ke 512,
    Kt 512, flagship width): K2 merging the transpose grads itself against
    K5 + K2 with merge_tg=False, on the same inputs, each output and
    weight grad on its own max|merged|. f32: the same arithmetic (K5's f32
    sum is the one K2 takes inside): held to TOL. bf16: K5 rounds the
    merged cotangent to bf16 once more, a difference of the algorithm (the
    JAX package's two forms differ so too), not of a kernel; the readings
    are printed (weight-grad elements that are zero in exact arithmetic,
    told apart by the f32 plain backward, as noise). The split kernels are
    held against their plain versions in phases 3d (K5) and 10e (the
    step)."""
    from dagnn_tpu_torch import checks
    from dagnn_tpu_torch.ops import row_step as rs
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        st, d, w = row_inputs(dt, dev, nd=1, **{k: v for k, v in FLAGSHIP.items()
                                                if k != "nd"})
        fa = (st, d["xin"], d["vals"], d["ea"], d["edst"], d["emask"], d["nmask"], w)
        _, a32, nres = rs.row_forward(*fa, emit_res=True)
        ba = fa + (d["g"], d["tg"], d["tdst"], d["tmask"], (a32, nres))
        m = rs.row_backward(*ba)
        sp = rs.row_backward(*ba, merge_tg=False)
        torch.cuda.synchronize()
        f = checks.to_f32(ba)
        truth = rs.row_backward_plain(*f[:-1], rs.row_forward_plain(
            *f[:8], emit_res=True)[1:])[3]
        tmax = checks.tree_max(truth)
        errs = [(checks.rel_err(a, b)[0], n, 0.0)
                for n, a, b in zip(("dx", "dvals", "dea"), sp[:3], m[:3])]
        for k in m[3]:
            rel, _, _, noise = checks.grad_err(sp[3][k], m[3][k], truth[k], tmax)
            errs.append((rel, f"dw[{k}]", noise))
        worst = max(errs)
        noise = max(errs, key=lambda e: e[2])
        mt = timings(lambda: rs.row_backward(*ba))
        spt = timings(lambda: rs.row_backward(*ba, merge_tg=False))
        k1t = timings(lambda: rs.row_forward(*fa, emit_res=True))
        p1_ms = time_ms(lambda: rs.row_forward_plain(*fa, emit_res=True), 5)
        p2_ms = time_ms(lambda: rs.row_backward_plain(*ba), 5)
        b1, o1, b2, o2 = kernel_costs(st, d, w, dt)
        bd1, bd2 = bound_ms(b1, o1, dt), bound_ms(b2, o2, dt)
        print(f"  ndirs=1 {short(dt)}, ms on the device (per eager call): K1 "
              f"{k1t['ms']:.4f} ({k1t['call_ms']:.4f}; plain {p1_ms:.4f}, bound "
              f"{bd1[0]:.5f} by {bd1[1]}); K2 {mt['ms']:.4f} ({mt['call_ms']:.4f}; "
              f"device windows {fmt_windows(mt['windows'])}; plain {p2_ms:.4f}, bound "
              f"{bd2[0]:.5f} by {bd2[1]}); K5 + K2 split {spt['ms']:.4f} "
              f"({spt['call_ms']:.4f}; device windows {fmt_windows(spt['windows'])}); "
              f"split vs merged: worst {worst[1]} {worst[0]:.3e} of its max"
              + (f" (tolerance {TOL[dt]:g})" if dt == torch.float32 else "") + ", "
              f"exact-zero elements' noise worst {noise[1]} {noise[2]:.3g} x merged's")
        if dt == torch.float32:
            check(worst[0] <= TOL[dt], "f32: split K2 disagrees with merged K2")
        out[dt] = dict(k1_ms=k1t["ms"], k2_ms=mt["ms"], split_ms=spt["ms"],
                       k1_call_ms=k1t["call_ms"], k2_call_ms=mt["call_ms"],
                       split_call_ms=spt["call_ms"], k1_plain_ms=p1_ms,
                       k2_plain_ms=p2_ms, k1_bound=bd1, k2_bound=bd2,
                       worst=worst[:2], noise=noise[1:])
    return out


class _Recorder:
    """Stands in for the wavefront library: forwards every C entry and
    records (name, function, arguments) of each launch."""

    def __init__(self, lib):
        self.lib, self.calls = lib, []

    def __getattr__(self, name):
        fn = getattr(self.lib, name)

        def call(*args):
            self.calls.append((name, fn, args))
            return fn(*args)
        return call


def gemm_flops(name, kn, H, emb, nd):
    """Operations of one bf16 GEMM launch of K2 (or K1's gru_fwd) at layer
    0 (Din = emb; the flagship's layer 1 has Din = H = emb)."""
    return {"wf_gemm_nn": 2 * nd * kn * 3 * H * (H + emb),
            "wf_wgrad": 2 * nd * kn * 3 * H * (emb + H),
            "wf_rebuild": 2 * nd * kn * H * H,
            "wf_gru_fwd": 2 * nd * kn * 3 * H * (emb + H)}.get(name)


def time_launches(run):
    """Each CUDA launch of one call of run() (a wrapper of ops/row_step.py)
    timed alone. The call is captured into a CUDA graph with the library's
    entries recorded (its buffers stay in the graph's memory pool) and
    replayed once, so they hold a real pass's values; then each launch is
    timed as phase 3 times whole kernels (50 launches from one CUDA graph,
    median of three windows)."""
    from dagnn_tpu_torch.ops import row_step as rs
    run()                                         # warm: the library is built
    torch.cuda.synchronize()
    rec, lib_fn = _Recorder(rs._lib()), rs._lib
    rs._lib = lambda: rec
    try:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            run()
    finally:
        rs._lib = lib_fn
    graph.replay()
    torch.cuda.synchronize()

    def launch(fn, args, name):
        rs._check(fn(*args[:-1], torch.cuda.current_stream().cuda_stream), name)

    out, seen = [], {}
    for name, fn, args in rec.calls:
        seen[name] = seen.get(name, 0) + 1
        t = timings(lambda: launch(fn, args, name))
        out.append(dict(launch=f"{name}#{seen[name]}", ms=t["ms"], windows=t["windows"],
                        call_ms=t["call_ms"]))
    del graph
    return out


def report_launches(out, lib_ms, what, kn, H, emb, nd):
    """Print each launch's device time (TFLOP/s for the GEMMs) and each
    kernel's share with its torch.matmul yardstick; returns the summary."""
    per = {}
    for o in out:
        per.setdefault(o["launch"].split("#")[0], []).append(o["ms"])
    total = sum(o["ms"] for o in out)
    print(f"  {len(out)} launches {what}, {total:.4f} ms summed on the device")
    for o in out:
        fl = gemm_flops(o["launch"].split("#")[0], kn, H, emb, nd)
        line = (f"    {o['launch']:22s} {o['ms'] * 1e3:8.2f} us on the device (windows "
                f"{fmt_windows(o['windows'])} ms), {o['call_ms'] * 1e3:.2f} us per eager call")
        if fl:
            line += f"; {fl / (o['ms'] * 1e-3) / 1e12:.1f} TFLOP/s"
        print(line)
    for name, ts in per.items():
        lm = lib_ms.get(name)
        print(f"  {name}: {len(ts)} a row, {sum(ts) * 1e3:.2f} us ({sum(ts) / total:.1%})"
              + (f"; torch.matmul bf16 {lm['shape']} {lm['ms'] * 1e3:.2f} us on the "
                 f"device (yardstick, one launch's products)" if lm else ""))
    return dict(launches=out, total_ms=total,
                per_kernel={k: dict(count=len(v), ms=sum(v), library_ms=(
                    lib_ms[k]["ms"] if k in lib_ms else None)) for k, v in per.items()},
                matmul={k: dict(ms=v["ms"], call_ms=v["call_ms"], shape=v["shape"])
                        for k, v in lib_ms.items()})


def matmul_yardsticks(mm):
    """timings of torch.matmul over each entry's operand pairs (bf16), a
    yardstick only: the port never calls it."""
    out = {}
    for name, pairs in mm.items():
        out[name] = dict(timings(lambda: [torch.matmul(a, b) for a, b in pairs]),
                         shape=" + ".join(f"{list(a.shape)} x {list(b.shape)}"
                                          for a, b in pairs))
    return out


def phase_k2_launches(dev):
    """Phase 3g: K2's CUDA launches one by one, on one merged row at the
    flagship shapes in bf16 (time_launches). Beside each GEMM, torch.matmul
    on the same shapes in bf16 (batched over directions and the launch's
    products), a yardstick only: the port never calls it."""
    from dagnn_tpu_torch.ops import row_step as rs
    dt = torch.bfloat16
    st, d, w = row_inputs(dt, dev, **FLAGSHIP)
    kn, H, emb, nd = (FLAGSHIP[k] for k in ("kn", "H", "emb", "nd"))
    fa = (st, d["xin"], d["vals"], d["ea"], d["edst"], d["emask"], d["nmask"], w)
    res = rs.row_forward(*fa, emit_res=True, ndirs=2)[1:]
    ba = fa + (d["g"], d["tg"], d["tdst"], d["tmask"], res)
    out = time_launches(lambda: rs.row_backward(*ba, ndirs=2))
    g = torch.Generator().manual_seed(5)
    r = lambda *s: torch.randn(s, generator=g).to(dt).to(dev)
    lib_ms = matmul_yardsticks({
        "wf_gemm_nn": [(r(2 * nd, kn, 3 * H), r(2 * nd, 3 * H, H))],
        "wf_wgrad": [(r(2 * nd, kn, 3 * H).transpose(1, 2), r(2 * nd, kn, H))],
        "wf_rebuild": [(r(nd, kn, H), r(nd, H, H).transpose(1, 2))]})
    return report_launches(out, lib_ms, "a merged row", kn, H, emb, nd)


def phase_k1_launches(dev):
    """Phase 3h: K1's CUDA launches one by one (attn_fwd and gru_fwd per
    layer), on one merged row at the flagship shapes in bf16, emit_res as
    the training forward runs it (time_launches). Beside gru_fwd, its
    products in torch.matmul in bf16, batched over directions: [nd, Kn,
    Din] x [nd, Din, 3H] and [nd, Kn, H] x [nd, H, 3H], a yardstick only:
    the port never calls it."""
    from dagnn_tpu_torch.ops import row_step as rs
    dt = torch.bfloat16
    st, d, w = row_inputs(dt, dev, **FLAGSHIP)
    kn, H, emb, nd = (FLAGSHIP[k] for k in ("kn", "H", "emb", "nd"))
    fa = (st, d["xin"], d["vals"], d["ea"], d["edst"], d["emask"], d["nmask"], w)
    out = time_launches(lambda: rs.row_forward(*fa, emit_res=True, ndirs=2))
    g = torch.Generator().manual_seed(6)
    r = lambda *s: torch.randn(s, generator=g).to(dt).to(dev)
    lib_ms = matmul_yardsticks({"wf_gru_fwd": [(r(nd, kn, emb), r(nd, emb, 3 * H)),
                                               (r(nd, kn, H), r(nd, H, 3 * H))]})
    return report_launches(out, lib_ms, "a merged row", kn, H, emb, nd)


# -------------------------------------------------------- the main path

def loss_and_grads(params, cfg, batch, impl):
    """(loss, {name: grad}, global grad norm) of one forward and backward:
    the TOK loss, or with cfg.num_class the LP loss (class_loss on the
    longest path's class)."""
    from dagnn_tpu_torch.nn.dagnn import dagnn_forward
    from dagnn_tpu_torch.train.losses import class_loss, tok_loss
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    out = dagnn_forward(p, cfg, batch, impl=impl)
    if cfg.num_class:
        y = torch.as_tensor(batch.y["len_longest_path"], device=out.device)
        loss = class_loss(out, y, batch.graph_mask)
    else:
        loss = tok_loss(out, batch.y["y_arr"], batch.graph_mask)
    gs = torch.autograd.grad(loss, list(p.values()))
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in gs))
    return float(loss.detach()), dict(zip(p, gs)), float(norm)


def phase_step(label, params, cfg, batch, kernels, plain, group=None,
               leaves=True, leaf_tol=STEP_TOL["leaf"]):
    """Phases 5 / 5b / 9a / 10a / 10e: the kernel step's parameter grads
    against the plain step's, leaf by leaf on each leaf's own scale (after
    `group`, if given). The plain step in float32 with the same
    bf16-rounded weights marks the elements that are zero in exact
    arithmetic. With leaves=False only the loss and the grad norm are
    held to their gate; the leaves are printed. leaf_tol: the leaves'
    limit. Returns the worst leaf's (relative error, name)."""
    from dagnn_tpu_torch import checks
    kl, kg, kn = loss_and_grads(params, cfg, batch, kernels)
    pl, pg, pn = loss_and_grads(params, cfg, batch, plain)
    _, truth, _ = loss_and_grads(
        {k: v.to(torch.bfloat16).float() for k, v in params.items()},
        dataclasses.replace(cfg, compute_dtype="float32"), batch, plain)
    if group is not None:
        kg, pg, truth = group(kg), group(pg), group(truth)
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
          f"(tolerance {leaf_tol:g}; exact-zero elements' noise, tolerance "
          f"{NOISE_TOL:g} x the plain step's):")
    for rel, ab, scale, nz, k in rows[:6]:
        print(f"      {k:28s} {ab:.3e} of {scale:.3e} = {rel:.3e}   noise {nz:.3g}")
    print(f"    worst noise {max(r[3] for r in rows):.3g} "
          f"({max(rows, key=lambda r: r[3])[4]})")
    bad = [r[4] for r in rows
           if leaves and not (r[0] <= leaf_tol and r[3] <= NOISE_TOL)]
    check(e_loss <= STEP_TOL["loss"] and e_norm <= STEP_TOL["loss"] and not bad,
          f"kernel step disagrees with plain step on {bad or 'the loss or norm'}")
    return rows[0][0], rows[0][4]


@contextlib.contextmanager
def no_res_stream(on):
    """The merged wavefront with (on) or without residual streams: the
    port's _NO_RES_STREAM flag, which DAGNN_NO_RES_STREAM sets at import."""
    from dagnn_tpu_torch.nn import dagnn
    old, dagnn._NO_RES_STREAM = dagnn._NO_RES_STREAM, on
    try:
        yield
    finally:
        dagnn._NO_RES_STREAM = old


def phase_cross(label, what, params, cfg, run_a, run_b):
    """Phases 5c, 10e, 11 and 15: in f32, one train step's loss and grads
    by two routes or forms that compute the same function (run_a, run_b:
    (batch, impl) or (batch, impl, True) for the merged path without
    residual streams), kernels on both sides."""
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")

    def run(r):
        with no_res_stream(len(r) > 2 and r[2]):
            return loss_and_grads(params, cfg32, r[0], r[1])

    la, ga, na = run(run_a)
    lb, gb, nb = run(run_b)
    e_loss, e_norm = abs(la - lb) / abs(lb), abs(na - nb) / nb
    t = CROSS_TOL
    # the worst leaf's |a - b| over (atol + rtol |b|): <= 1 passes
    ratio = {k: float(((ga[k] - gb[k]).abs()
                       / (t["atol"] + t["rtol"] * gb[k].abs())).max()) for k in gb}
    worst = max(ratio, key=ratio.get)
    print(f"{label} f32 {what}, kernels: loss {la:.7f} vs {lb:.7f} (rel "
          f"{e_loss:.2e}), grad norm rel {e_norm:.2e} (tolerance {t['loss']:g}); "
          f"worst leaf {worst} at {ratio[worst]:.3g} of rtol {t['rtol']:g} / "
          f"atol {t['atol']:g}")
    check(e_loss <= t["loss"] and e_norm <= t["loss"] and ratio[worst] <= 1.0,
          f"f32 {what}: the two steps disagree")
    return dict(loss_rel=e_loss, norm_rel=e_norm, worst=(worst, ratio[worst]))


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


def forward_vs_plain(label, params, cfg, batch, impls=None):
    """The kernels' logits against the plain versions' on one batch (the
    real graphs'), at the bf16 output tolerance; the kernels' predicted
    ids must equal the plain ones wherever the plain top-two margin
    exceeds twice the largest logit difference. impls: (kernels, plain),
    KERNELS and PLAIN when None."""
    from dagnn_tpu_torch import checks
    from dagnn_tpu_torch.nn.dagnn import KERNELS, PLAIN, dagnn_forward
    kernels, plain = impls or (KERNELS, PLAIN)
    g = int(batch.n_graph)
    with torch.no_grad():
        k = dagnn_forward(params, cfg, batch, impl=kernels)[:g].float()
        p = dagnn_forward(params, cfg, batch, impl=plain)[:g].float()
    rel, err, scale = checks.rel_err(k, p)
    top = p.topk(2, dim=-1).values
    decided = (top[..., 0] - top[..., 1]) > 2 * err
    same = k.argmax(-1) == p.argmax(-1)
    print(f"{label} forward, kernels vs plain: logits {tuple(k.shape)} "
          f"max_abs_err {err:.3e} of {scale:.3e} = {rel:.3e} (tolerance "
          f"{TOL[torch.bfloat16]:g}); predicted ids equal at "
          f"{int(same.sum())} of {same.numel()}, at {int(same[decided].sum())} "
          f"of the {int(decided.sum())} decided by more than 2x that error")
    check(rel <= TOL[torch.bfloat16] and bool(same[decided].all()),
          "the kernels' forward disagrees with the plain forward")


def trace_dir(argv):
    """Where --profile writes its traces: --trace-dir DIR, else traces/."""
    return argv[argv.index("--trace-dir") + 1] if "--trace-dir" in argv else "traces"


def profile_step(tag, train_step, params, state, batch, card, out_dir):
    """Optional (--profile): one train step under torch.profiler, through
    dagnn_tpu_torch.utils.profiling. Writes the trace to
    <out_dir>/step_trace_<tag>.json and prints, from its kernel and
    memory-op events, the device's busy share of the step's span and the
    device time by kernel (profiling.summarize_trace), and K6's summed
    device time where the step launched it. Returns those readings (None
    without device events)."""
    from dagnn_tpu_torch.utils import profiling
    path = profiling.profile_step(lambda: train_step(params, state, batch), iters=1,
                                  logdir=out_dir, name=f"step_trace_{tag}.json")
    dev = profiling.device_events(path)
    if not dev:
        print(f"[profile {tag}] the trace holds no device events: not measured")
        return None
    t0 = min(e["ts"] for e in dev)
    t1 = max(e["ts"] + e["dur"] for e in dev)
    busy = sum(e["dur"] for e in dev)
    print(f"[profile {tag}] device span {(t1 - t0) / 1e3:.2f} ms, busy "
          f"{busy / 1e3:.2f} ms ({100 * busy / (t1 - t0):.1f}%), "
          f"{len(dev)} device events, on {card}")
    rows = profiling.summarize_trace(path, top=12)
    for r in rows:
        print(f"    {r['total_us'] / 1e3:9.3f} ms {100 * r['total_us'] / busy:5.1f}%  "
              f"{r['name']}")
    k6 = {k: [e["dur"] for e in dev if e["name"].replace("void ", "").startswith(k)]
          for k in ("sa_fwd_kernel", "sa_bwd_kernel")}
    if any(k6.values()):
        tot = sum(sum(d) for d in k6.values())
        print(f"[profile {tag}] K6: " + ", ".join(
            f"{k} {sum(d) / 1e3:.3f} ms in {len(d)} launches" for k, d in k6.items())
            + f"; together {tot / 1e3:.3f} ms of the step's busy {busy / 1e3:.2f} ms "
            f"({100 * tot / busy:.1f}%)")
    return dict(span_ms=(t1 - t0) / 1e3, busy_ms=busy / 1e3, busy_share=busy / (t1 - t0),
                events=len(dev), top_ms={r["name"]: r["total_us"] / 1e3 for r in rows},
                k6={k: dict(ms=sum(d) / 1e3, launches=len(d)) for k, d in k6.items()})


def _counted_modules():
    from dagnn_tpu_torch.ops import pair_step, row_step, segment_attn
    return (row_step, pair_step, segment_attn)


def reset_counts():
    for m in _counted_modules():
        m.reset_launch_counts()


def read_counts():
    return {k: v for m in _counted_modules() for k, v in m.launch_counts.items()}


def check_counts(label, tag, expect):
    """The launch counts read now against `expect` (every wrapper not named
    there launched nothing)."""
    lc = read_counts()
    want = {k: 0 for k in lc}
    want.update(expect)
    print(f"{label} {tag} launch counts {lc}, expected {want}")
    check(lc == want, f"{tag}: launch counts differ from the passes")
    return lc


def phase_ab(label, a, b, steppers, n_steps=5):
    """Phase 17: the train steps of paths a and b in turns (a, b, b, a),
    n_steps each from the same warm weights and optimizer state, timed with
    CUDA events: the two compared in one call on one card, so that the
    host's speed, which drifts during a call, weighs on both alike."""
    times = {a: [], b: []}
    for tag in (a, b, b, a):
        train_step, p, state, batch, no_res = steppers[tag]
        with no_res_stream(no_res):
            torch.cuda.synchronize()
            ev0, ev1 = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
            ev0.record()
            for _ in range(n_steps):
                train_step(p, state, batch)
            ev1.record()
            torch.cuda.synchronize()
        times[tag].append(ev0.elapsed_time(ev1) / n_steps)
    ma, mb = (sum(times[t]) / 2 for t in (a, b))
    print(f"{label} {a} {' / '.join(f'{v:.2f}' for v in times[a])} ms, {b} "
          f"{' / '.join(f'{v:.2f}' for v in times[b])} ms a step (order a b b a): "
          f"{b}/{a} edges/s {ma / mb:.3f}x")
    return {a: times[a], b: times[b], "ratio": ma / mb}


def drive_path(tag, labels, cfg, params, batch, expect, kernels, plain, card,
               argv, group=None, steppers=None):
    """One path through its entry points, launch counts set to 0 before and
    read after: the step check, the timed steps, a predict (and with
    --profile one profiled step). expect(train passes, forward passes) gives
    the launches each wrapper of the path must have made; every other
    wrapper must have launched nothing. `steppers` (a dict) keeps the
    path's warm train step, weights, state and batch for phase 17."""
    from dagnn_tpu_torch.cli.ogb_driver import make_step_fns
    from dagnn_tpu_torch.train.optim import make_optimizer
    train_passes = fwd_passes = 0
    reset_counts()
    phase_step(labels[0], params, cfg, batch, kernels, plain, group)
    train_passes += 1
    eps, ms, losses, p, state, train_step, predict = timed_steps(
        labels[1], make_step_fns, make_optimizer, cfg, params, batch, card)
    train_passes += 6
    check_predict(labels[2], predict, p, cfg, batch)
    fwd_passes += 1
    if "--profile" in argv:
        profile_step(tag, train_step, p, state, batch, card, trace_dir(argv))
        train_passes += 1
    lc = check_counts(labels[3], f"{tag} path", expect(train_passes, fwd_passes))
    if steppers is not None:
        from dagnn_tpu_torch.nn import dagnn
        steppers[tag] = (train_step, p, state, batch, dagnn._NO_RES_STREAM)
    return dict(edges_per_s=eps, step_ms=ms, losses=losses, launches=lc)


# ------------------------------------------------------- the TOK driver

DRIVER_FLAGS = ["--synthetic", "800", "--synthetic_mean_nodes", "125",
                "--synthetic_targets", "structural", "--folds", "1",
                "--patience", "10"]


def _csv_rows(path):
    import csv
    with open(path) as f:
        return [[float(v) for v in r] for r in list(csv.reader(f))[1:]]


@contextlib.contextmanager
def driver_probes():
    """Record, without changing them, what the driver's run hands around:
    the dataset load_dataset returns, the device of each fold's initial
    parameters, the wall time of each evaluate call, the route
    dagnn_forward takes for each batch, and the forward passes of each
    model (ogb_driver.MODELS), train and inference apart. Restored on
    exit."""
    from collections import Counter
    from dagnn_tpu_torch.cli import ogb_driver
    from dagnn_tpu_torch.nn import dagnn
    seen = dict(data=None, devices=set(), eval_s=[], routes=Counter(),
                passes=Counter())
    orig = (ogb_driver.load_dataset, ogb_driver.init_params,
            ogb_driver.evaluate, dagnn._route)
    models = dict(ogb_driver.MODELS)

    def counted(fwd):
        def run(params, cfg, batch, *a, **k):
            seen["passes"]["train" if k.get("train") or torch.is_grad_enabled()
                           else "infer"] += 1
            return fwd(params, cfg, batch, *a, **k)
        return run

    for c, (init, fwd) in models.items():
        ogb_driver.MODELS[c] = (init, counted(fwd))

    def load_dataset(*a):
        seen["data"] = orig[0](*a)
        return seen["data"]

    def init_params(*a):
        params = orig[1](*a)
        seen["devices"] |= {v.device.type for v in params.values()}
        return params

    def evaluate(*a):
        t0 = time.perf_counter()
        out = orig[2](*a)
        seen["eval_s"].append(time.perf_counter() - t0)
        return out

    def route(*a):
        r = orig[3](*a)
        seen["routes"][r[0]] += 1
        return r

    (ogb_driver.load_dataset, ogb_driver.init_params, ogb_driver.evaluate,
     dagnn._route) = (load_dataset, init_params, evaluate, route)
    try:
        yield seen
    finally:
        (ogb_driver.load_dataset, ogb_driver.init_params, ogb_driver.evaluate,
         dagnn._route) = orig
        ogb_driver.MODELS.update(models)


def driver_runs(label, main, task, card, kernels, gnn="dagnn"):
    """Runs A, B, C of a training driver's entry point `main` (main_tok or
    main_lp) for model `gnn` (--gnn; the run's name {gnn}_{task}) in
    process on DRIVER_FLAGS, with the launch counts set to 0
    before A and read after C: run A trains 2 epochs with checkpoints; run
    B asks for 3 in A's directories and must resume from A's last
    checkpoint at epoch 3, leaving one checkpoint; run C trains 3 epochs
    afresh without checkpoints. Checks: B's epoch 3 equal to C's, finite
    losses falling from epoch 1 to 2, the metric (F1 or accuracy) in
    [0, 1], parameters on the card, each wrapper of `kernels` launched and
    no other. Returns (seen, counts, rows A+B, rows C, seconds A+B,
    seconds C, wall seconds, the resumed epoch's relative loss gap) and
    removes its directories."""
    import shutil
    import tempfile
    root = tempfile.mkdtemp(prefix=f"chip_smoke_{task}_")
    name = f"{gnn}_{task}"
    flags = DRIVER_FLAGS + ["--gnn", gnn]
    dirs = lambda tag: ["--dir_results", f"{root}/{tag}/results",
                        "--dir_save", f"{root}/{tag}/saved"]
    try:
        reset_counts()
        t0 = time.perf_counter()
        with driver_probes() as seen:
            main(flags + ["--epochs", "2"] + dirs("A"))
            saved_a = sorted(os.listdir(f"{root}/A/saved"))
            main(flags + ["--epochs", "3"] + dirs("A"))
            main(flags + ["--epochs", "3", "--checkpointing", "0"] + dirs("C"))
        wall = time.perf_counter() - t0
        lc = read_counts()
        print(f"{label} {card}: launch counts over runs A, B, C: {lc}; routes "
              f"(forward passes by path) {dict(seen['routes'])}; forward passes "
              f"{dict(seen['passes'])}")
        check(all(lc[k] > 0 for k in kernels),
              f"{task} driver: a kernel of {kernels} never launched")
        check(all(v == 0 for k, v in lc.items() if k not in kernels),
              f"{task} driver: a kernel other than {kernels} launched")
        check(seen["devices"] == {"cuda"},
              f"{task} driver: parameters on {seen['devices']}, not cuda")
        rows_a = _csv_rows(f"{root}/A/results/{name}_train.csv")
        rows_c = _csv_rows(f"{root}/C/results/{name}_train.csv")
        secs_a = _csv_rows(f"{root}/A/results/{name}_times.csv")
        secs_c = _csv_rows(f"{root}/C/results/{name}_times.csv")
        metric = "F1" if task == "tok" else "accuracy"
        for tag, rows in (("A+B", rows_a), ("C", rows_c)):
            for r in rows:
                print(f"{label} run {tag} fold {int(r[0])} epoch {int(r[1])}: loss "
                      f"{r[2]!r} {metric} train {r[3]!r} valid {r[4]!r} test {r[5]!r}")
        check(saved_a == [f"{name}_1_2.ckpt"],
              f"{task} driver: run A left checkpoints {saved_a}")
        check(os.listdir(f"{root}/A/saved") == [f"{name}_1_3.ckpt"],
              f"{task} driver: run B left {os.listdir(f'{root}/A/saved')}")
        check(not os.path.exists(f"{root}/C/saved")
              or not os.listdir(f"{root}/C/saved"), f"{task} driver: run C checkpointed")
        check([r[:2] for r in rows_a] == [[1, 1], [1, 2], [1, 3]],
              f"{task} driver: run B did not resume at fold 1, epoch 3")
        check([r[:2] for r in rows_c] == [[1, 1], [1, 2], [1, 3]],
              f"{task} driver: run C did not train epochs 1-3")
        for r in rows_a + rows_c:
            check(math.isfinite(r[2]), f"{task} driver: non-finite epoch loss")
            check(all(0.0 <= v <= 1.0 for v in r[3:]),
                  f"{task} driver: {metric} out of [0, 1]")
        check(rows_a[1][2] < rows_a[0][2] and rows_c[1][2] < rows_c[0][2],
              f"{task} driver: the loss of epoch 2 is not below epoch 1's")
        b3, c3 = rows_a[2], rows_c[2]
        rel = abs(b3[2] - c3[2]) / abs(c3[2])
        print(f"{label} resumed epoch 3 (B) against uninterrupted (C): loss "
              f"{b3[2]!r} / {c3[2]!r}, relative difference {rel!r}; {metric} "
              f"{b3[3:]} / {c3[3:]}")
        check(rel == 0.0 and b3[3:] == c3[3:],
              f"{task} driver: the resumed epoch 3 differs from the uninterrupted one")
        return seen, lc, rows_a, rows_c, secs_a, secs_c, wall, rel
    finally:
        shutil.rmtree(root, ignore_errors=True)


def epoch_rates(label, seen, secs_a, secs_c, wall, card):
    """The epochs' train seconds, graphs/s and edges/s (host clock) and
    the evaluation seconds an epoch, printed; returns them."""
    train = seen["data"][0]
    n_graphs = len(train)
    n_edges = sum(g.num_edges for g in train)
    steps = -(-n_graphs // 160)
    ep_s = [r[2] for r in secs_c]
    print(f"{label} {card}: epoch train seconds of {steps}-step epochs (host "
          f"clock: collation in the prefetch thread, copies to the card, the "
          f"launch loop, a loss read a step) run C {' / '.join(f'{v:.3f}' for v in ep_s)}, run "
          f"A+B {' / '.join(f'{r[2]:.3f}' for r in secs_a)}; {steps} train "
          f"steps an epoch, {n_graphs} graphs, {n_edges} edges")
    for i, s in enumerate(ep_s):
        print(f"    run C epoch {i + 1}: {n_graphs / s:.1f} graphs/s, "
              f"{n_edges / s:.1f} edges/s, {s / steps * 1e3:.1f} ms a step")
    ev = seen["eval_s"]
    print(f"{label} {card}: evaluation (train subset {len(seen['data'][1]) * 4}, valid "
          f"{len(seen['data'][1])}, test {len(seen['data'][2])} graphs) seconds "
          f"an epoch: " + " / ".join(f"{sum(ev[i:i + 3]):.3f}"
                                      for i in range(0, len(ev), 3))
          + f"; three runs' wall {wall:.1f} s")
    return dict(epoch_s=ep_s, epoch_s_ab=[r[2] for r in secs_a], steps=steps,
                graphs=n_graphs, edges=n_edges,
                graphs_per_s=[n_graphs / s for s in ep_s],
                edges_per_s=[n_edges / s for s in ep_s], eval_s=ev, wall_s=wall)


def loader_shapes(x):
    return (f"L={x.fwd.node_ids.shape[0]}, Kn={x.fwd.node_ids.shape[1]}, "
            f"Ke={x.fwd.edge_src.shape[1]}, Kt={x.fwd.tgrad_eslot.shape[1]}")


def loader_checks(tags, cfg, params, b, valid, impls, kernels):
    """Phases 18b/18c and 19a: outside the counted runs, the kernels at
    the driver's loader's shapes (its bucket, not pad_for's) held to their
    plain versions (impls: kernels, plain): a bf16 train step on the
    train loader's batch 0 `b` at phase 5's gates (tags[0]), and the
    logits of the first batch of the valid graphs `valid` (the driver's
    evaluation bucket) at the bf16 output tolerance (tags[1]). The
    wrappers named in `kernels` must have launched there, and no other."""
    from dagnn_tpu_torch import convert
    from dagnn_tpu_torch.data.dataloader import DAGLoader
    from dagnn_tpu_torch.nn import dagnn
    reset_counts()
    print(f"{tags[0]} {dagnn._route(cfg, b, None)[0]} route on the loader's "
          f"train batch 0 ({loader_shapes(b)})")
    phase_step(tags[0], params, cfg, b, *impls)
    loader = DAGLoader(valid, 160, shuffle=False, chunk_size=256, prefetch=0)
    vb = convert.batch_to_torch(next(iter(loader)), "cuda")
    print(f"{tags[1]} {dagnn._route(cfg, vb, None)[0]} route on the loader's "
          f"first valid batch ({loader_shapes(vb)})")
    forward_vs_plain(tags[1], params, cfg, vb, impls)
    lc = read_counts()
    print(f"{tags[1]} launch counts over the step and the forward: {lc}")
    check(all(lc[k] > 0 for k in kernels)
          and all(v == 0 for k, v in lc.items() if k not in kernels),
          f"{tags[1]}: launches other than those of {kernels}")


def phase_driver(card):
    """Phase 18: the TOK driver through its entry point main_tok.main, at
    the flagship's widths (the driver's defaults: emb 300, 2 layers,
    attn_h, bidirectional, batch 160, chunk 256, head 5002, bf16, fused)
    on 800 synthetic ASTs (640 train, 4 steps an epoch): runs A, B and C
    (driver_runs), K1 and K2 launched, no other kernel. Then, outside the
    counted runs, the kernels at the loader's shapes against their plain
    versions (a train step on its batch 0, 18b; a forward on its first
    valid batch, 18c), and the epoch's parts alone: the bucket measured
    before the epoch's first batch, collation a batch, the batch's copy to
    the card, and the train step on one batch."""
    from dagnn_tpu_torch import convert
    from dagnn_tpu_torch.cli import main_tok, ogb_driver
    from dagnn_tpu_torch.dag.batch import collate
    from dagnn_tpu_torch.data.dataloader import DAGLoader
    from dagnn_tpu_torch.nn.dagnn import KERNELS, PLAIN
    from dagnn_tpu_torch.train.optim import make_optimizer

    seen, lc, rows_a, rows_c, secs_a, secs_c, wall, rel = driver_runs(
        "[18]", main_tok.main, "tok", card, ("row_forward", "row_backward"))
    rates = epoch_rates("[18]", seen, secs_a, secs_c, wall, card)
    train, ep_s, steps = seen["data"][0], rates["epoch_s"], rates["steps"]

    # the epoch's parts alone, outside the counted runs
    loader = DAGLoader(train, 160, shuffle=True, seed=1, chunk_size=256,
                       prefetch=0)
    groups = loader._epoch_batches()
    t0 = time.perf_counter()
    pad = loader._ensure_pad(groups)       # the epoch's bucket, measured
    pad_s = time.perf_counter() - t0       # before its first batch
    t0 = time.perf_counter()
    host = [collate(g, pad) for g in groups]
    coll_s = (time.perf_counter() - t0) / len(host)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batches = [convert.batch_to_torch(b, "cuda") for b in host]
    torch.cuda.synchronize()
    h2d_s = (time.perf_counter() - t0) / len(host)
    b = batches[0]
    args = ogb_driver.add_common_args(argparse.ArgumentParser()).parse_args(
        DRIVER_FLAGS)
    args.num_vocab = len(seen["data"][3]) - 2
    cfg = ogb_driver.build_model_cfg(args, "tok")
    opt = make_optimizer(args.lr, args.clip)
    train_step, _ = ogb_driver.make_step_fns(cfg, opt, "tok")
    params = ogb_driver.init_params(cfg, 0, "cuda")
    loader_checks(("[18b]", "[18c]"), cfg, params, b, seen["data"][1],
                  (KERNELS, PLAIN), ("row_forward", "row_backward"))
    state = opt.init(params)
    params, state, loss, _ = train_step(params, state, b)
    float(loss)
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev0.record()
    for _ in range(5):
        params, state, loss, _ = train_step(params, state, b)
        float(loss)                     # the driver's read a step
    ev1.record()
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / 5
    step_dev = ev0.elapsed_time(ev1) / 5 / 1e3
    print(f"[18] {card}: the epoch's bucket (PadConfig.for_graphs over its "
          f"{len(groups)} batches, before the first) {pad_s:.4f} s, "
          f"{pad_s / len(groups):.4f} s a batch; collation {coll_s:.4f} s a "
          f"batch (alone), copy to the card {h2d_s:.4f} s a batch, train step "
          f"{step_s:.4f} s (host clock, a loss read a step; {step_dev:.4f} s "
          f"by CUDA events) on the loader's batch 0 ({loader_shapes(b)}); steps x "
          f"step time "
          f"{steps * step_s:.3f} s against the epochs' "
          + " / ".join(f"{v:.3f}" for v in ep_s[1:]) + " s: gap "
          + " / ".join(f"{v - steps * step_s:.3f}" for v in ep_s[1:]) + " s")
    return dict(launches=lc, routes=dict(seen["routes"]), **rates,
                bucket_s=pad_s, bucket_s_per_batch=pad_s / len(groups),
                collate_s=coll_s, h2d_s=h2d_s, step_s=step_s,
                step_dev_s=step_dev, resume_loss_rel=rel,
                rows_ab=rows_a, rows_c=rows_c)


def phase_lp_driver(card):
    """Phase 19: the LP driver through its entry point main_lp.main at its
    defaults (gated_sum, unidirectional; emb 300, 2 layers, 275 classes,
    batch 160, chunk 256, bf16, auto: the generic branch) on phase 18's
    corpus: runs A, B and C (driver_runs), K5 launched (the sum kind's
    segment sums and the transpose merges) and no other kernel. Then 19a,
    outside the counted runs: K5 at the LP loader's shapes against its
    plain version (loader_checks, with main_lp's config)."""
    from dagnn_tpu_torch import convert
    from dagnn_tpu_torch.cli import main_lp, ogb_driver
    from dagnn_tpu_torch.data.dataloader import DAGLoader
    from dagnn_tpu_torch.nn.dagnn import SEG_KERNELS, SEG_PLAIN
    seen, lc, rows_a, rows_c, secs_a, secs_c, wall, rel = driver_runs(
        "[19]", main_lp.main, "lp", card, ("tg_accumulate",))
    check(set(seen["routes"]) == {"generic"},
          f"lp driver: routes {dict(seen['routes'])}, not the generic branch")
    rates = epoch_rates("[19]", seen, secs_a, secs_c, wall, card)
    args = main_lp.parser().parse_args(DRIVER_FLAGS)
    args.num_vocab = len(seen["data"][3]) - 2
    cfg = ogb_driver.build_model_cfg(args, "lp")
    params = ogb_driver.init_params(cfg, 0, "cuda")
    loader = DAGLoader(seen["data"][0], 160, shuffle=True, seed=1,
                       chunk_size=256, prefetch=0)
    b = convert.batch_to_torch(next(iter(loader)), "cuda")
    print(f"[19a] main_lp's config: agg {cfg.agg}, bidirectional "
          f"{cfg.bidirectional}, {cfg.num_class} classes, {cfg.compute_dtype}, "
          f"segment_impl {cfg.segment_impl}")
    loader_checks(("[19a]", "[19a]"), cfg, params, b, seen["data"][1],
                  (SEG_KERNELS, SEG_PLAIN), ("tg_accumulate",))
    return dict(launches=lc, routes=dict(seen["routes"]), **rates,
                resume_loss_rel=rel, rows_ab=rows_a, rows_c=rows_c)


# phase 19b: the aggregator kinds at the flagship's widths (dataclasses
# fields replaced on flagship_cfg(); each runs the generic branch)
KINDS = {"add": dict(agg="add"), "max": dict(agg="max"),
         "gated_sum": dict(agg="gated_sum"), "self_attn_h": dict(agg="self_attn_h"),
         "mattn_h": dict(agg="mattn_h"), "attn_x": dict(agg="attn_x"),
         "attn_h dense": dict(segment_impl="dense"),
         "recurr=False": dict(recurr=False)}


def time_pass(fn, reps=3):
    """Mean ms of fn() (a forward and backward) by CUDA events."""
    torch.cuda.synchronize()
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    for _ in range(reps):
        fn()
    ev1.record()
    torch.cuda.synchronize()
    return ev0.elapsed_time(ev1) / reps


def phase_kinds(dev, batch, card):
    """Phase 19b: each aggregator kind of KINDS (add and max bidirectional
    with ref_shared_agg_quirk, as the defaults have it) in the flagship
    model on phase 4's batch: one bf16 train pass, kernels against plain
    at phase 5's gates, with its K6 and K5 launches counted (per level,
    layer and direction: K5 merges the transpose grads once, and sums the
    add / gated_sum messages in the forward and its replay; K6 runs
    forward, replayed and backward on the attention kinds); then the
    kernel pass timed by CUDA events (3 passes, forward and backward)."""
    from dagnn_tpu_torch import checks, flagship
    from dagnn_tpu_torch.nn import dagnn
    from dagnn_tpu_torch.nn.dagnn import SEG_KERNELS, SEG_PLAIN, dagnn_init
    L = batch.fwd.node_ids.shape[0]
    out = {}
    for tag, kw in KINDS.items():
        cfg = dataclasses.replace(flagship.flagship_cfg(), **kw)
        check(dagnn._route(cfg, batch, None)[0] == "generic",
              f"{tag}: not on the generic branch")
        params = dagnn_init(0, cfg, device=dev)
        n = cfg.num_layers * L * len(cfg.dirs)
        expect = {"tg_accumulate": n}
        if cfg.agg_attn:
            expect.update(segment_attn_forward=2 * n, segment_attn_backward=n)
        elif cfg.agg in ("add", "gated_sum"):
            expect["tg_accumulate"] = 3 * n
        reset_counts()
        phase_step(f"[19b] {tag}:", params, cfg, batch, SEG_KERNELS, SEG_PLAIN,
                   group=checks.score_linears)
        lc = check_counts("[19b]", f"{tag} one train pass", expect)
        ms = time_pass(lambda: loss_and_grads(params, cfg, batch, SEG_KERNELS))
        print(f"[19b] {tag}: forward and backward {ms:.2f} ms (CUDA events, "
              f"3 passes) on {card}")
        out[tag] = dict(launches=lc, pass_ms=ms)
    return out


def pool_ties(params, cfg, batch):
    """Of the max pool over every node of a graph (the node-space
    readout) in the layers' state features (the kernels' bf16 states; x,
    the encoder's output, is the same in the plain version), the share of
    (graph, feature) pairs whose largest value two or more nodes hold
    (ties), and whose two largest values are at most one bf16 step apart
    (near ties). At such a pair a state rounded one step apart moves the
    feature's whole gradient to another node."""
    from dagnn_tpu_torch.nn.dagnn import dagnn_node_states
    from dagnn_tpu_torch.ops import segment
    with torch.no_grad():
        _, h_dirs = dagnn_node_states(params, cfg, batch)
        h = torch.cat([hd[l] for hd in h_dirs for l in range(cfg.num_layers)],
                      dim=-1).float()
        g = int(batch.n_graph)
        gid = torch.as_tensor(batch.graph_id, device=h.device).long()
        live = torch.as_tensor(batch.node_mask, device=h.device).bool() & (gid < g)
        m1 = segment.segment_max(h, gid, g + 1, live)[:g]
        at_max = live[:, None] & (h == m1[gid.clamp(max=g - 1)])
        n_max = torch.zeros((g + 1, h.shape[1]), device=h.device)
        n_max.index_add_(0, torch.where(live, gid, g), at_max.float())
        m2 = segment.segment_max(torch.where(at_max, -torch.inf, h), gid, g + 1,
                                 live)[:g]
        # one bf16 step at m1: 2^(e - 8) for m1 = f 2^e, f in [0.5, 1)
        step = torch.ldexp(torch.ones_like(m1), torch.frexp(m1)[1] - 8)
        tie = n_max[:g] >= 2
        near = tie | ((m1 - m2) <= step)
    return float(tie.float().mean()), float(near.float().mean()), tuple(h.shape)


def decided_pairs(params, cfg, batch):
    """The max pool's (graph, feature) pairs whose winning node the bf16
    kernels and the plain version must agree on: a single node holds the
    plain states' largest value and it beats the second largest by more
    than twice the largest |kernel - plain| difference of any live node
    state (the margin rule of 18c's ids). Returns (mask [graph slots, F],
    that error); pad slots count as decided."""
    from dagnn_tpu_torch.nn.dagnn import KERNELS, PLAIN, dagnn_node_states
    from dagnn_tpu_torch.ops import segment
    states = []
    with torch.no_grad():
        for impl in (KERNELS, PLAIN):
            x, h_dirs = dagnn_node_states(params, cfg, batch, impl)
            layers = [hd[l] for hd in h_dirs for l in range(cfg.num_layers)]
            states.append(torch.cat(([x] if cfg.out_wx else []) + layers,
                                    dim=-1).float())
        hk, h = states
        g = int(batch.n_graph)
        gid = torch.as_tensor(batch.graph_id, device=h.device).long()
        live = torch.as_tensor(batch.node_mask, device=h.device).bool() & (gid < g)
        err = float((hk - h)[live].abs().max())
        m1 = segment.segment_max(h, gid, g + 1, live)[:g]
        at_max = live[:, None] & (h == m1[gid.clamp(max=g - 1)])
        n_max = torch.zeros((g + 1, h.shape[1]), device=h.device)
        n_max.index_add_(0, torch.where(live, gid, g), at_max.float())
        m2 = segment.segment_max(torch.where(at_max, -torch.inf, h), gid, g + 1,
                                 live)[:g]
        decided = torch.ones((batch.num_graph_slots, h.shape[1]), dtype=torch.bool,
                             device=h.device)
        decided[:g] = (n_max[:g] == 1) & ((m1 - m2) > 2 * err)
    return decided, err


@contextlib.contextmanager
def undecided_detached(decided):
    """The readout's max pool with its output detached at the undecided
    (graph, feature) pairs: their gradient goes to no node, on the kernel
    and the plain side alike, so every leaf is comparable. The pooled
    values, and so the loss, are unchanged."""
    from dagnn_tpu_torch.nn import dagnn
    orig = dagnn.pool_nodes

    def pool(h, graph_id, num_graphs, kind, mask, *rest):
        out = orig(h, graph_id, num_graphs, kind, mask, *rest)
        return torch.where(decided, out, out.detach()) if kind == "max" else out

    dagnn.pool_nodes = pool
    try:
        yield
    finally:
        dagnn.pool_nodes = orig


def phase_node_space(dev, batch, card):
    """Phase 19c: out_pool_all (the node-space readout) on the flagship's
    attn_h with segment_impl "fused": the per-direction wavefront, K1/K2
    at one direction, read out through _perm_gather and a pool over every
    node of a graph. With the flagship's max pool: one f32 train pass,
    kernels against plain at CROSS_TOL; one bf16 train pass at phase 5's
    loss and norm gates, its leaves printed beside the max pool's ties
    and near ties (pool_ties), since a tied feature's gradient lands on
    one node or another; the bf16 logits against plain
    (forward_vs_plain). With a mean pool, which has no ties: one bf16
    train pass at all of phase 5's gates, leaves included; its readout
    sums run K5 over every node of the batch. Launches counted over the
    train passes. Then, uncounted, the tie-aware gate of the max pool's
    bf16 leaves: the pass again with the pool's gradient kept only at the
    decided (graph, feature) pairs (decided_pairs): loss and norm at
    phase 5's gates, every leaf within TIE_AWARE_LEAF_TOL."""
    from dagnn_tpu_torch import flagship
    from dagnn_tpu_torch.nn import dagnn
    from dagnn_tpu_torch.nn.dagnn import KERNELS, PLAIN, dagnn_init
    L = batch.fwd.node_ids.shape[0]
    cfg = dataclasses.replace(flagship.flagship_cfg(), out_pool_all=True)
    cfg_mean = dataclasses.replace(cfg, out_pool="mean")
    check(dagnn._route(cfg, batch, None)[0] == "direction",
          "out_pool_all: not on the per-direction fused route")
    params = dagnn_init(0, cfg, device=dev)
    reset_counts()
    cross = phase_cross("[19c]", "out_pool_all, fused, kernels vs plain", params,
                        cfg, (batch, KERNELS), (batch, PLAIN))
    worst = phase_step("[19c] max pool, bf16:", params, cfg, batch, KERNELS,
                       PLAIN, leaves=False)
    worst_mean = phase_step("[19c] mean pool, bf16:", params, cfg_mean, batch,
                            KERNELS, PLAIN)
    lc = check_counts("[19c]", "node-space train passes (f32 max, bf16 max, "
                      "bf16 mean)", {"row_forward": 6 * L, "row_backward": 6 * L,
                                     "tg_accumulate": 1})
    tie, near, shape = pool_ties(params, cfg, batch)
    print(f"[19c] the max pool over the layers' node states {shape} of "
          f"{int(batch.n_graph)} graphs, bf16 kernels: {100 * tie:.2f}% of "
          f"(graph, feature) pairs tied, {100 * near:.2f}% within one bf16 "
          f"step; the max pool's worst leaf {worst[1]} at {worst[0]:.3e} "
          f"(gated below at the decided pairs), the mean pool's {worst_mean[1]} at "
          f"{worst_mean[0]:.3e} (gate {STEP_TOL['leaf']:g})")
    forward_vs_plain("[19c] bf16", params, cfg, batch)
    decided, err = decided_pairs(params, cfg, batch)
    share = float(decided[:int(batch.n_graph)].float().mean())
    print(f"[19c] tie-aware gate: {100 * share:.2f}% of (graph, feature) pairs "
          f"decided (one node holds the plain maximum, ahead of the next by "
          f"more than 2 x {err:.3e}, the largest |kernel - plain| node state); "
          f"the others' pool gradient detached on both sides")
    with undecided_detached(decided):
        worst_decided = phase_step("[19c] max pool, bf16, decided pairs:", params,
                                   cfg, batch, KERNELS, PLAIN,
                                   leaf_tol=TIE_AWARE_LEAF_TOL)
    ms = time_pass(lambda: loss_and_grads(params, cfg, batch, KERNELS))
    ms_mean = time_pass(lambda: loss_and_grads(params, cfg_mean, batch, KERNELS))
    print(f"[19c] out_pool_all, fused: bf16 forward and backward {ms:.2f} ms "
          f"(max pool), {ms_mean:.2f} ms (mean pool) (CUDA events, 3 passes "
          f"each) on {card}")
    return dict(launches=lc, pass_ms=ms, pass_ms_mean=ms_mean, cross=cross,
                bf16_worst_leaf=worst, bf16_worst_leaf_mean=worst_mean,
                bf16_worst_leaf_decided=worst_decided, decided_share=share,
                state_err=err, ties=tie, near_ties=near)


# ------------------------------------------------------- the VAE driver

# scripts/na_train.sh and scripts/bn_train.sh at their widths; only depth
# (epochs, --max-count) is cut
NA_FLAGS = ["--data-name", "final_structures6", "--data-type", "ENAS",
            "--model", "DAGNN", "--nvt", "6", "--hs", "501", "--nz", "56",
            "--batch-size", "32", "--lr", "1e-4", "--save-interval", "1",
            "--load-latest-model", "--max-count", "1000"]
BN_FLAGS = ["--data-name", "asia_200k", "--data-type", "BN", "--model",
            "DAGNN_BN", "--nvt", "8", "--hs", "501", "--nz", "56",
            "--batch-size", "128", "--lr", "1e-4", "--bidirectional",
            "--save-interval", "1", "--load-latest-model", "--max-count", "512"]


@contextlib.contextmanager
def vae_probes():
    """Record, without changing them, what the VAE driver's runs do: the
    devices of the initial parameters, the train and inference passes of
    the model (VAEModel.loss with and without training, encode_mu), and
    the host seconds of each epoch's train loop (ended by a synchronize;
    the driver reads the sums right after), of each latent extraction and
    of each test NLL. Restored on exit."""
    from dagnn_tpu_torch.cli import train_vae as tv
    seen = dict(devices=set(), train=0, infer=0, epochs=[], latent_s=[],
                nll_s=[])
    M = tv.VAEModel
    orig = (M.init, M.loss, M.encode_mu, tv.train_epoch,
            tv.save_latent_representations, tv.test_nll)

    def init(self, seed):
        params = orig[0](self, seed)
        seen["devices"] |= {v.device.type for v in params.values()}
        return params

    def loss(self, params, prepared, gen, training=True, impl=None):
        seen["train" if training else "infer"] += 1
        return orig[1](self, params, prepared, gen, training, impl)

    def encode_mu(self, *a, **k):
        seen["infer"] += 1
        return orig[2](self, *a, **k)

    def timed(i, key):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = orig[i](*a, **k)
            torch.cuda.synchronize()
            seen[key].append(time.perf_counter() - t0)
            return out
        return run

    M.init, M.loss, M.encode_mu = init, loss, encode_mu
    tv.train_epoch = timed(3, "epochs")
    tv.save_latent_representations = timed(4, "latent_s")
    tv.test_nll = timed(5, "nll_s")
    try:
        yield seen
    finally:
        (M.init, M.loss, M.encode_mu, tv.train_epoch,
         tv.save_latent_representations, tv.test_nll) = orig


def vae_passes(args, runs, n_train, n_test):
    """(train passes, inference passes) of the driver's runs, from the
    flags and the corpus alone: `runs` the epochs each run trains. An
    epoch is ceil(n_train / --batch-size) train passes; each epoch saves
    (--save-interval 1) the latents of the train and test graphs in
    batches of --infer-batch-size; each run ends with one test NLL over
    the test graphs unless --no-test."""
    check(args.save_interval == 1, "vae_passes counts a save every epoch")
    up = lambda n, b: -(-n // b)
    ib = args.infer_batch_size
    nll = 0 if args.no_test else up(n_test, ib)
    return (sum(runs) * up(n_train, args.batch_size),
            sum(runs) * (up(n_train, ib) + up(n_test, ib)) + len(runs) * nll)


def vae_expect(model, train, infer):
    """The launches `train` train passes and `infer` inference passes of a
    DAGNN VAE make: per level, layer and direction n = L x layers x
    directions, K6 forward twice a train pass (the forward and its replay
    in the backward) and once an inference pass, K6 backward and K5 (the
    transpose merges) once a train pass."""
    cfg = model.cfg
    n = cfg.max_n * cfg.num_layers * len(cfg.encoder_cfg.dirs)
    return {"segment_attn_forward": n * (2 * train + infer),
            "segment_attn_backward": n * train, "tg_accumulate": n * train}


def check_passes(label, seen, want):
    """The probes' pass counts against vae_passes' derivation."""
    print(f"{label} train / inference passes: {seen['train']} / {seen['infer']}, "
          f"from the flags and the corpus {want[0]} / {want[1]}")
    check((seen["train"], seen["infer"]) == want,
          f"{label}: the driver's passes differ from the flags' count")


def _vae_rows(res_dir):
    return _csv_rows(os.path.join(res_dir, "train_loss.txt"))


def vae_step(model, params, prepared, impl, seed=0):
    """(loss, {name: grad}, global grad norm) of one f32 train pass of the
    VAE with the encoder's segment functions `impl`; the noise drawn from
    a generator seeded `seed`, so two calls draw the same."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    total = model.loss(p, prepared, gen, impl=impl)[0]
    gs = torch.autograd.grad(total, list(p.values()), allow_unused=True)
    gs = {k: torch.zeros_like(v) if g is None else g for (k, v), g in zip(p.items(), gs)}
    norm = torch.sqrt(sum((g * g).sum() for g in gs.values()))
    return float(total.detach()), gs, float(norm)


def vae_gates(label, model, params, prepared, infer):
    """Phases 20a / 20b: one f32 train step's loss, norm and every leaf with
    the kernels against their plain versions (CROSS_TOL), and mu of an
    inference batch within 2e-5 of max|plain|. Returns the readings."""
    from dagnn_tpu_torch import checks
    from dagnn_tpu_torch.nn.aggregators import SEG_KERNELS, SEG_PLAIN
    kl, kg, kn = vae_step(model, params, prepared, SEG_KERNELS)
    pl, pg, pn = vae_step(model, params, prepared, SEG_PLAIN)
    t = CROSS_TOL
    e_loss, e_norm = abs(kl - pl) / abs(pl), abs(kn - pn) / pn
    ratio = {k: float(((kg[k] - pg[k]).abs()
                       / (t["atol"] + t["rtol"] * pg[k].abs())).max()) for k in pg}
    worst = max(ratio, key=ratio.get)
    with torch.no_grad():
        mk = model.encode_mu(params, infer, SEG_KERNELS)
        mp = model.encode_mu(params, infer, SEG_PLAIN)
    mu_rel, mu_err, mu_scale = checks.rel_err(mk, mp)
    print(f"{label} f32 train step, kernels vs plain: loss {kl:.7f} vs {pl:.7f} "
          f"(rel {e_loss:.2e}), grad norm rel {e_norm:.2e} (tolerance "
          f"{t['loss']:g}); {len(pg)} leaves, worst {worst} at {ratio[worst]:.3g} "
          f"of rtol {t['rtol']:g} / atol {t['atol']:g}; mu of {tuple(mk.shape)} "
          f"{mu_err:.3e} of {mu_scale:.3e} = {mu_rel:.3e} (tolerance 2e-5)")
    check(e_loss <= t["loss"] and e_norm <= t["loss"] and ratio[worst] <= 1.0,
          f"{label}: the kernel step disagrees with the plain step")
    check(mu_rel <= 2e-5, f"{label}: mu disagrees with plain")
    return dict(loss_rel=e_loss, norm_rel=e_norm, worst=(worst, ratio[worst]),
                mu_rel=mu_rel)


def vae_shapes(host):
    return (loader_shapes(host) + ", live nodes a level "
            f"{int(host.fwd.node_mask.sum(1).max())}")


def phase_vae(dev, card, argv, root):
    """Phase 20: the VAE driver through its entry point train_vae.main.
    20: NA (scripts/na_train.sh: DAGNN, attn_h, hs 501, nz 56, batch 32)
    on 1,000 graphs of the repo's ENAS corpus (900 train: 28 steps of 32
    and one of 4), runs A (2 epochs), B (resumed to 3 in A's directory), C
    (3 afresh), every epoch's latents; B's epoch 3 bitwise C's, only K6
    and K5 launched, at vae_expect's counts. 20a: at the NA loader's
    shapes, one f32 train step and an inference batch's mu, kernels
    against plain (vae_gates), and K6 / K5 at the busiest level timed as
    phase 3c / 3d. 20b: BN (scripts/bn_train.sh: DAGNN_BN,
    bidirectional, batch 128) on 512 synthetic BN graphs, one epoch,
    counted, then gated as 20a. 20c: DVAE and DVAE_BN, two short epochs
    each: no kernel of the port, finite falling losses. Its runs' files
    stay in `root` for phase 21."""
    import pickle
    import numpy as np
    from dagnn_tpu_torch.cli import train_vae as tv
    from dagnn_tpu_torch.vae.dagnn_vae import na_collate
    out = {}
    d = lambda tag: ["--res_dir", f"{root}/{tag}"]
    reset_counts()
    t0 = time.perf_counter()
    with vae_probes() as seen:
        tv.main(NA_FLAGS + ["--epochs", "2"] + d("A"))
        saved_a = sorted(f for f in os.listdir(f"{root}/A") if f.endswith(".ckpt"))
        tv.main(NA_FLAGS + ["--epochs", "3"] + d("A"))
        tv.main(NA_FLAGS + ["--epochs", "3"] + d("C"))
    wall = time.perf_counter() - t0
    lc = read_counts()
    args = tv.parse_args(NA_FLAGS)
    train, test, ga = tv.load_data(tv.parse_args(NA_FLAGS + d("C")))
    model = tv.VAEModel(args, ga, dev)
    passes = vae_passes(args, [2, 1, 3], len(train), len(test))
    check_passes("[20] runs A, B, C", seen, passes)
    want = {k: 0 for k in lc}
    want.update(vae_expect(model, *passes))
    print(f"[20] {card}: launch counts over runs A, B, C {lc}; expected {want}")
    check(lc == want, "NA VAE driver: launch counts differ from the passes")
    check(seen["devices"] == {"cuda"}, f"NA VAE: parameters on {seen['devices']}")
    rows_a, rows_c = _vae_rows(f"{root}/A"), _vae_rows(f"{root}/C")
    for tag, rows in (("A+B", rows_a), ("C", rows_c)):
        for r in rows:
            print(f"[20] run {tag} epoch {int(r[0])}: loss {r[1]!r} recon "
                  f"{r[2]!r} kld {r[3]!r}")
    check(saved_a == ["DAGNN_0_1.ckpt", "DAGNN_0_2.ckpt"],
          f"NA VAE: run A left {saved_a}")
    check([r[0] for r in rows_a] == [1, 2, 3] and [r[0] for r in rows_c] == [1, 2, 3],
          "NA VAE: run B did not resume at epoch 3, or run C did not train 1-3")
    check(all(math.isfinite(v) for r in rows_a + rows_c for v in r),
          "NA VAE: a non-finite epoch loss")
    check(rows_a[1][1] < rows_a[0][1] and rows_c[1][1] < rows_c[0][1],
          "NA VAE: the loss of epoch 2 is not below epoch 1's")
    check(rows_a[2] == rows_c[2], f"NA VAE: the resumed epoch 3 {rows_a[2]} "
          f"differs from the uninterrupted {rows_c[2]}")
    ca, cc = (torch.load(f"{root}/{t}/DAGNN_0_3.ckpt", weights_only=True)
              for t in ("A", "C"))
    check(all(torch.equal(ca["params"][k], cc["params"][k]) for k in cc["params"]),
          "NA VAE: the resumed run's parameters differ from the uninterrupted")
    with open(f"{root}/C/test_results.txt") as f:
        nll = [float(line.rsplit(":", 1)[1]) for line in f]
    with open(f"{root}/C/final_structures6_latent_epoch3.pkl", "rb") as f:
        z_tr, y_tr, z_te, y_te = pickle.load(f)
    print(f"[20] test NLL {nll}; latents Z_train {z_tr.shape}, Z_test "
          f"{z_te.shape}, finite {bool(np.isfinite(z_tr).all() and np.isfinite(z_te).all())}")
    check(all(math.isfinite(v) for v in nll), "NA VAE: non-finite test NLL")
    check(z_tr.shape == (900, 56) and z_te.shape == (100, 56)
          and os.path.exists(f"{root}/C/final_structures6_latent_epoch3.mat"),
          "NA VAE: latents missing or of the wrong shape")
    ep = seen["epochs"]
    print(f"[20] {card}: epoch train seconds (host clock: collation, copy, "
          f"launches, no loss read a step) " + " / ".join(f"{e:.3f}" for e in ep)
          + f"; {len(train)} graphs, {-(-len(train) // args.batch_size)} steps an "
          "epoch; graphs/s " + " / ".join(f"{len(train) / e:.1f}" for e in ep)
          + "; latent extraction "
          + " / ".join(f"{v:.3f}" for v in seen["latent_s"]) + " s, test NLL "
          + " / ".join(f"{v:.3f}" for v in seen["nll_s"]) + f" s; three runs' wall "
          f"{wall:.1f} s")

    # 20a, outside the counted runs: the NA loader's batch 0 and an
    # inference batch, from one set of weights
    rnd = np.random.default_rng(args.seed)
    order = rnd.permutation(len(train))
    graphs = [train[j] for j in order[:32]]
    params = model.init(0)
    prepared = model.prepare(graphs)
    host = na_collate(graphs, model.cfg)[0]
    print(f"[20a] NA loader's batch 0: {vae_shapes(host)}")
    infer = model.prepare(train[:128])
    reset_counts()
    gates = vae_gates("[20a]", model, params, prepared, infer)
    opt = tv.make_optimizer(args.lr, args.clip)
    step = tv.make_train_step(model, opt)
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = opt.init(params)
    p, s, _ = step(params, state, prepared, gen, args.lr)      # warm-up
    torch.cuda.synchronize()
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    h0 = time.perf_counter()
    ev0.record()
    for _ in range(5):
        p, s, stats = step(p, s, prepared, gen, args.lr)
    ev1.record()
    torch.cuda.synchronize()
    step_host = (time.perf_counter() - h0) / 5 * 1e3
    step_dev = ev0.elapsed_time(ev1) / 5
    print(f"[20a] {card}: NA train step {step_host:.2f} ms (host clock, 5 steps "
          f"after a warm-up, no loss read), {step_dev:.2f} ms by CUDA events; "
          f"last loss {float(stats[0]):.4f}")
    prof = None
    if "--profile" in argv:
        prof = profile_step("vae_na", lambda a, b, c: step(a, b, c, gen, args.lr),
                            p, s, prepared, card, trace_dir(argv))
    print("[20a] K6 forward / backward at the busiest level of the NA batch, H 501")
    segs = phase_segment_attn(dev, host, "busiest", H=501)
    print("[20a] K5 at the busiest transpose level of the NA batch, C 501")
    tgs = phase_tg_accumulate(dev, host, LH=501)
    keep = ("ms", "windows", "call_ms", "plain_ms", "library_ms", "err", "rel",
            "bound", "bytes", "ops")
    shapes = {short(dt): {k: {x: r.get(x) for x in keep}
                          for k, r in {**segs[dt], **tgs[dt]}.items()}
              for dt in (torch.bfloat16, torch.float32)}
    out["na"] = dict(launches=lc, train_passes=seen["train"],
                     infer_passes=seen["infer"], rows_ab=rows_a, rows_c=rows_c,
                     test_nll=nll, epoch_s=ep,
                     graphs_per_s=[len(train) / e for e in ep],
                     latent_s=seen["latent_s"], nll_s=seen["nll_s"], wall_s=wall,
                     step_ms=step_host, step_dev_ms=step_dev, profile=prof,
                     gates=gates, level=segs["level"], kernels=shapes)

    # 20b: BN, one epoch, counted; then gated as 20a
    reset_counts()
    with vae_probes() as seen_bn:
        tv.main(BN_FLAGS + ["--epochs", "1"] + d("BN"))
    lc_bn = read_counts()
    args_bn = tv.parse_args(BN_FLAGS + d("BN"))
    train_bn, test_bn, ga_bn = tv.load_data(args_bn)
    model_bn = tv.VAEModel(args_bn, ga_bn, dev)
    passes = vae_passes(args_bn, [1], len(train_bn), len(test_bn))
    check_passes("[20b] BN run", seen_bn, passes)
    want = {k: 0 for k in lc_bn}
    want.update(vae_expect(model_bn, *passes))
    rows_bn = _vae_rows(f"{root}/BN")
    print(f"[20b] {card}: BN run, {len(train_bn)} train graphs, epoch "
          f"{rows_bn[0]}; {seen_bn['epochs'][0]:.3f} s train; launch counts "
          f"{lc_bn}, expected {want}")
    check(lc_bn == want, "BN VAE driver: launch counts differ from the passes")
    check(all(math.isfinite(v) for v in rows_bn[0]), "BN VAE: non-finite loss")
    bgraphs = train_bn[:128]
    bhost = na_collate(bgraphs, model_bn.cfg)[0]
    print(f"[20b] BN loader's batch 0: {vae_shapes(bhost)}")
    gates_bn = vae_gates("[20b]", model_bn, model_bn.init(0),
                         model_bn.prepare(bgraphs), model_bn.prepare(bgraphs))
    out["bn"] = dict(launches=lc_bn, train_passes=seen_bn["train"],
                     infer_passes=seen_bn["infer"], rows=rows_bn,
                     epoch_s=seen_bn["epochs"], gates=gates_bn)

    # 20c: the base D-VAEs run no kernel of the port
    for model_name, flags in (("DVAE", NA_FLAGS), ("DVAE_BN", BN_FLAGS)):
        tag = model_name.lower()
        argv_c = (flags + ["--model", model_name, "--max-count", "320",
                           "--epochs", "2", "--no-test"] + d(tag))
        reset_counts()
        with vae_probes() as seen_c:
            tv.main(argv_c)
        lc_c = read_counts()
        args_c = tv.parse_args(argv_c)
        tr_c, te_c, _ = tv.load_data(args_c)
        check_passes(f"[20c] {model_name}", seen_c,
                     vae_passes(args_c, [2], len(tr_c), len(te_c)))
        rows = _vae_rows(f"{root}/{tag}")
        print(f"[20c] {model_name}: epochs {rows}; train seconds "
              + " / ".join(f"{e:.3f}" for e in seen_c["epochs"])
              + f"; launch counts {lc_c}")
        check(all(v == 0 for v in lc_c.values()),
              f"{model_name}: a kernel of the port launched")
        check(all(math.isfinite(v) for r in rows for v in r) and rows[1][1] < rows[0][1],
              f"{model_name}: losses not finite and falling")
        out[tag] = dict(launches=lc_c, rows=rows, epoch_s=seen_c["epochs"])
    return out


# ------------------------------------------------ latent scoring and BO

# run_bo at its defaults (the reference's GP: M 500, 100 Adam iterations at
# lr 5e-4; BO batch 50, 100 decode attempts, a 10,000-point grid, 50
# refinement steps)
GP_FLAGS = ["--M", "500", "--gp-iters", "100", "--gp-lr", "5e-4"]
OTHER_VAES = ("SVAE", "SVAE_oneshot", "SVAE_GraphRNN", "SVAE_GraphRNN_BFS",
              "DVAE_GCN", "DVAE_fast", "DVAE_DeepGMG")


def _widths(flags):
    """The --hs / --nz pair of a train_vae flag list, for run_bo."""
    return [x for f in ("--hs", "--nz") for x in (f, flags[flags.index(f) + 1])]


def _rmse_rows(res_dir):
    with open(os.path.join(res_dir, "Test_RMSE_ll.txt")) as f:
        return [[float(x.split(":")[1]) for x in line.split(",")] for line in f]


def _timed(fn):
    """(fn(), host seconds ended by a synchronize)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_gp(dev, card, root, mat, label="[21a]"):
    """21a: run_bo.main, GP only, on phase 20's latents (2 seeds, M 500,
    100 iterations): two finite Test_RMSE_ll.txt lines. Then the seed-0 fit
    on the card against the same fit on the CPU from the same data: the
    predictive mean within 1e-3 of the CPU's max|mean|, the test RMSE
    within 1% of the CPU's; fit and predict seconds."""
    import numpy as np
    from dagnn_tpu_torch.cli import run_bo
    from dagnn_tpu_torch.vae.sparse_gp import fit_sparse_gp, predict
    res = f"{root}/bo_gp"
    out = run_bo.main(["--latent", mat, "--seeds", "2", *GP_FLAGS, "--res_dir", res])
    rows = _rmse_rows(res)
    print(f"{label} run_bo GP only: Test_RMSE_ll.txt {rows}; float64 refits "
          f"{[g[3] for g in out['gp']]}")
    check(len(rows) == 2 and np.isfinite(rows).all(),
          "run_bo: Test_RMSE_ll.txt lacks two finite lines")
    X_tr, y_tr, X_te, y_te, _, _ = run_bo.load_latents(mat)
    fit = lambda d: fit_sparse_gp(X_tr, y_tr, M=500, iters=100, lr=5e-4, seed=0,
                                  device=d)
    gp, fit_s = _timed(lambda: fit(dev))
    (mean, _), pred_s = _timed(lambda: predict(gp, X_te))
    t0 = time.perf_counter()
    gp_cpu = fit("cpu")
    cpu_s = time.perf_counter() - t0
    mean_cpu = predict(gp_cpu, X_te)[0]
    mean = mean.cpu()
    rel = float((mean - mean_cpu).abs().max() / mean_cpu.abs().max())
    rmse, rmse_cpu = (run_bo.score_gp(g, X_te, y_te)[0] for g in (gp, gp_cpu))
    print(f"{label} {card}: seed-0 fit of {X_tr.shape} (M 500, 100 iterations) "
          f"{fit_s:.3f} s, predict {X_te.shape} {pred_s:.4f} s on the card "
          f"(host clock, synchronized), {cpu_s:.3f} s on the CPU; refit_f64 card "
          f"{gp.refit_f64} CPU {gp_cpu.refit_f64}; mean vs CPU {rel:.3e} of "
          f"max|mean| (limit 1e-3), RMSE {rmse:.6f} vs {rmse_cpu:.6f} (limit 1%)")
    check(rel <= 1e-3 and abs(rmse - rmse_cpu) <= 0.01 * rmse_cpu,
          "the card's GP disagrees with the CPU's")
    return dict(rows=rows, fit_s=fit_s, predict_s=pred_s, cpu_fit_s=cpu_s,
                mean_rel=rel, rmse=rmse, rmse_cpu=rmse_cpu, refit_f64=gp.refit_f64)


def phase_bo_rounds(card, root):
    """21b: run_bo --bo on the card. ENAS: run C's DAGNN checkpoint and
    latents, 1 seed, 2 rounds of 50 candidates, 100 decode attempts each
    (5,000 latents decoded a round in one batch), the surrogate scorer
    trained on the whole corpus. BN: phase 20b's DAGNN_BN checkpoint, 1
    round, the BIC scorer. Gates: best_arc_scores.txt written, each
    round's valid count and best score; then summarize.main on each
    result directory (no --plot)."""
    from dagnn_tpu_torch.cli import run_bo, summarize
    out = {}
    for tag, flags in (
            ("enas", ["--latent", f"{root}/C/final_structures6_latent_epoch3.mat",
                      "--checkpoint", f"{root}/C/DAGNN_0_3.ckpt", "--BO_rounds", "2"]
             + _widths(NA_FLAGS)),
            ("bn", ["--latent", f"{root}/BN/asia_200k_latent_epoch1.mat",
                    "--checkpoint", f"{root}/BN/DAGNN_BN_0_1.ckpt", "--data-type",
                    "BN", "--model", "DAGNN", "--bidirectional", "--BO_rounds", "1"]
             + _widths(BN_FLAGS))):
        res = f"{root}/bo_{tag}"
        t0 = time.perf_counter()
        r = run_bo.main(flags + ["--bo", "--seeds", "1", *GP_FLAGS, "--res_dir", res])
        wall = time.perf_counter() - t0
        for rd in r["rounds"]:
            print(f"[21b] {tag} round {rd['round']} on {card}: {rd['valid']}/"
                  f"{rd['n']} valid, best {rd['best']}; seconds: GP fit "
                  f"{rd['fit_s']:.3f}, greedy EI {rd['ei_s']:.3f}, decode and vote "
                  f"{rd['decode_s']:.3f}, scoring {rd['score_s']:.3f}")
        check(os.path.exists(f"{res}/best_arc_scores.txt"),
              f"run_bo {tag}: no best_arc_scores.txt (no valid arc decoded)")
        check(all(rd["best"] is not None for rd in r["rounds"]),
              f"run_bo {tag}: a round without a best score")
        print(f"[21b] summarize {tag}:")
        summarize.main(["--res_dir", res])
        out[tag] = dict(rounds=r["rounds"], gp=r["gp"], wall_s=wall,
                        scorer_quality=r["scorer_quality"])
    return out


def phase_gp_corpus(dev, card, root):
    """21c: run C's encoder over the whole ENAS corpus (load_enas with the
    driver's burn-in: 17,100 train / 1,900 test graphs), then the GP at
    M 500, 100 iterations, on those latents: finite RMSE; the encode, the
    fit and the predict timed."""
    import numpy as np
    import scipy.io
    from dagnn_tpu_torch.cli import run_bo
    from dagnn_tpu_torch.cli import train_vae as tv
    from dagnn_tpu_torch.train import checkpoint as ckpt
    from dagnn_tpu_torch.vae.sparse_gp import fit_sparse_gp, predict
    i = NA_FLAGS.index("--max-count")
    args = tv.parse_args(NA_FLAGS[:i] + NA_FLAGS[i + 2:] + ["--res_dir", f"{root}/corpus"])
    (train, test, ga), load_s = _timed(lambda: tv.load_data(args))
    model = tv.VAEModel(args, ga, dev)
    params = model.init(0)
    opt = tv.make_optimizer(args.lr, args.clip)
    _, _, params, _ = ckpt.load_checkpoint(f"{root}/C/DAGNN_0_3.ckpt", params,
                                           opt.init(params))
    ((Z_tr, Y_tr), (Z_te, Y_te)), enc_s = _timed(lambda: (
        tv.extract_latent(args, model, params, train),
        tv.extract_latent(args, model, params, test)))
    mat = f"{root}/corpus/latent.mat"
    scipy.io.savemat(mat, {"Z_train": Z_tr, "Z_test": Z_te, "Y_train": Y_tr,
                           "Y_test": Y_te})
    X_tr, y_tr, X_te, y_te, _, _ = run_bo.load_latents(mat)
    gp, fit_s = _timed(lambda: fit_sparse_gp(X_tr, y_tr, M=500, iters=100, lr=5e-4,
                                             seed=0, device=dev))
    (mean, _), pred_s = _timed(lambda: predict(gp, X_te))
    rmse, ll, r = run_bo.score_gp(gp, X_te, y_te)
    print(f"[21c] {card}: the corpus ({len(train)} train / {len(test)} test) "
          f"loaded in {load_s:.2f} s, encoded in {enc_s:.2f} s "
          f"({(len(train) + len(test)) / enc_s:.1f} graphs/s); GP fit of "
          f"{X_tr.shape} {fit_s:.3f} s, predict {pred_s:.4f} s (host clock, "
          f"synchronized); test RMSE {rmse:.4f}, ll {ll:.4f}, Pearson r {r:.4f}, "
          f"refit_f64 {gp.refit_f64}")
    check(np.isfinite([rmse, ll, r]).all() and bool(torch.isfinite(mean).all()),
          "the corpus-scale GP is not finite")
    return dict(n_train=len(train), n_test=len(test), load_s=load_s, encode_s=enc_s,
                fit_s=fit_s, predict_s=pred_s, rmse=rmse, ll=ll, pearson=r,
                refit_f64=gp.refit_f64)


def model_step(model, params, prepared):
    """(loss, {name: grad}, grad norm) of one f32 train pass without noise."""
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    total = model.loss(p, prepared, None, training=False)[0]
    gs = torch.autograd.grad(total, list(p.values()), allow_unused=True)
    gs = {k: torch.zeros_like(v) if g is None else g for (k, v), g in zip(p.items(), gs)}
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in gs.values()))
    return float(total.detach()), gs, float(norm)


def phase_other_vaes(dev, card, root):
    """21d: train_vae.main for each of the seven other models at
    scripts/na_train.sh's widths on 256 ENAS graphs (230 train), 2 epochs:
    finite losses, epoch 2 below epoch 1, latents [230, 56] / [26, 56], no
    kernel of the port launched. Per model one f32 train step (noise off)
    on the card against the CPU's from the same weights and batch (32
    graphs): loss and norm 1e-5 relative, every leaf rtol 5e-4 / atol
    5e-5 (CROSS_TOL); a leaf past that (float32 rounding: a cancelling
    sum in another order, a ReLU input within rounding of 0) is held in
    float64, card against CPU, to the same rtol / atol. Then run_bo GP
    only on SVAE's latents."""
    import pickle
    import numpy as np
    from dagnn_tpu_torch.cli import run_bo
    from dagnn_tpu_torch.cli import train_vae as tv
    out = {}
    t = CROSS_TOL
    for m in OTHER_VAES:
        tag = m.lower()
        argv = NA_FLAGS + ["--model", m, "--max-count", "256", "--epochs", "2",
                           "--res_dir", f"{root}/{tag}"]
        reset_counts()
        with vae_probes() as seen:
            tv.main(argv)
        lc = read_counts()
        args = tv.parse_args(argv)
        train, test, ga = tv.load_data(args)
        check_passes(f"[21d] {m}", seen, vae_passes(args, [2], len(train), len(test)))
        rows = _vae_rows(f"{root}/{tag}")
        with open(f"{root}/{tag}/final_structures6_latent_epoch2.pkl", "rb") as f:
            z_tr, _, z_te, _ = pickle.load(f)
        print(f"[21d] {m} on {card}: epochs {rows}; train seconds "
              + " / ".join(f"{e:.3f}" for e in seen["epochs"])
              + f"; latents {z_tr.shape} / {z_te.shape}; launch counts {lc}")
        check(all(v == 0 for v in lc.values()), f"{m}: a kernel of the port launched")
        check(all(math.isfinite(v) for r in rows for v in r) and rows[1][1] < rows[0][1],
              f"{m}: losses not finite and falling")
        check(z_tr.shape == (len(train), args.nz) and z_te.shape == (len(test), args.nz)
              and np.isfinite(z_tr).all(), f"{m}: latents of the wrong shape")
        # one f32 step, card against CPU, from one set of weights and batch
        card_m = tv.VAEModel(args, ga, dev)
        cpu_m = tv.VAEModel(args, ga, torch.device("cpu"))
        params = card_m.init(0)
        graphs = train[:args.batch_size]
        for mod in (card_m, cpu_m):
            mod.seed_host(args.seed, 1)
        prep_cpu = cpu_m.prepare(graphs)
        kl, kg, kn = model_step(card_m, params, card_m.prepare(graphs))
        pl, pg, pn = model_step(cpu_m, {k: v.cpu() for k, v in params.items()},
                                prep_cpu)
        e_loss, e_norm = abs(kl - pl) / abs(pl), abs(kn - pn) / pn
        ratio = {k: float(((kg[k].cpu() - pg[k]).abs()
                           / (t["atol"] + t["rtol"] * pg[k].abs())).max()) for k in pg}
        worst = max(ratio, key=ratio.get)
        print(f"[21d] {m} f32 step, card vs CPU: loss {kl:.6f} vs {pl:.6f} (rel "
              f"{e_loss:.2e}), grad norm rel {e_norm:.2e} (tolerance {t['loss']:g}); "
              f"{len(pg)} leaves, worst {worst} at {ratio[worst]:.3g} of rtol "
              f"{t['rtol']:g} / atol {t['atol']:g}")
        # a leaf past rtol / atol is float32 rounding (a cancelling sum in
        # another order; a ReLU input within rounding of 0, whose sign, and
        # so a whole gradient element, differs between the devices) when
        # the same step in float64 agrees there, card against CPU
        over = [k for k in pg if ratio[k] > 1.0]
        f64 = {}
        if over:
            d64 = lambda x: None if x is None else (
                x.double() if torch.is_floating_point(x) else x)
            steps64 = [model_step(mod, {k: v.detach().to(d).double()
                                        for k, v in params.items()},
                                  tuple(d64(None if x is None else x.to(d))
                                        for x in prep_cpu))[1]
                       for mod, d in ((card_m, dev), (cpu_m, "cpu"))]
            for k in over:
                a64, b64 = steps64[0][k].cpu(), steps64[1][k]
                f64[k] = float(((a64 - b64).abs() / (t["atol"] + t["rtol"] * b64.abs())).max())
                print(f"[21d] {m} {k}: float32 card vs CPU {ratio[k]:.3g} of rtol / "
                      f"atol; in float64 {f64[k]:.3g} (limit 1)")
        check(e_loss <= t["loss"] and e_norm <= t["loss"]
              and all(r <= 1.0 for r in f64.values()),
              f"{m}: the card's step disagrees with the CPU's")
        out[tag] = dict(launches=lc, rows=rows, epoch_s=seen["epochs"],
                        loss_rel=e_loss, norm_rel=e_norm, worst=(worst, ratio[worst]),
                        float64_leaves=f64)
    res = f"{root}/bo_svae"
    run_bo.main(["--latent", f"{root}/svae/final_structures6_latent_epoch2.mat",
                 "--seeds", "1", *GP_FLAGS, "--res_dir", res])
    rows = _rmse_rows(res)
    print(f"[21d] run_bo GP only on SVAE's latents: {rows}")
    check(len(rows) == 1 and np.isfinite(rows).all(), "GP on SVAE's latents not finite")
    out["svae_gp"] = rows
    return out


def phase_latent_scoring(dev, card, root):
    """Phase 21, on phase 20's files in `root`: 21a-21d. K1-K7 launch in
    none of it but 21c's encoder (the DAGNN's K6 inference passes)."""
    gp = phase_gp(dev, card, root, f"{root}/C/final_structures6_latent_epoch3.mat")
    bo = phase_bo_rounds(card, root)
    corpus = phase_gp_corpus(dev, card, root)
    others = phase_other_vaes(dev, card, root)
    return dict(gp=gp, bo=bo, corpus=corpus, other_vaes=others)


# ------------------------------------------------------------ the baselines

# phase 22: every --gnn the JAX driver accepts but dagnn, at the driver's
# defaults (emb 300; GIN/GCN 5 layers, GNN2 3, HPoolConfig's defaults with
# dense_nodes 256; batch 160; float32) on phase 18's corpus
BASELINES = ("gin", "gcn", "gcn-virtual", "ggnns", "ggnn-etype", "gat", "dgcnn",
             "diffpool", "unet", "sagpool", "asap")


def k5_per_pass(cfg):
    """K5 launches of one forward pass of a baseline: its sums onto graphs
    (merged_segment_sum); their backward is a gather, no launch."""
    from dagnn_tpu_torch.nn.baselines import MPNNConfig
    from dagnn_tpu_torch.nn.gnn2_models import GNN2Config
    if isinstance(cfg, MPNNConfig):
        # the readout (mean, add or attention: one sum; max: none) and one
        # virtual-node pool per layer but the last
        return ((cfg.graph_pooling != "max")
                + (cfg.num_layers - 1 if cfg.virtual_node else 0))
    if isinstance(cfg, GNN2Config):
        return 1                                 # the graph sum of the readout
    return cfg.num_layers if cfg.kind == "sagpool" else 0   # _gmp_gap a layer


def baseline_setup(gnn, task, data):
    """(config, the train loader's batch 0 on the host) of `gnn` at the
    driver's defaults on phase 18's corpus `data` (load_dataset's)."""
    from dagnn_tpu_torch.cli import main_lp, main_tok, ogb_driver
    from dagnn_tpu_torch.data.dataloader import DAGLoader
    p = main_lp.parser() if task == "lp" else ogb_driver.add_common_args(
        argparse.ArgumentParser())
    args = p.parse_args(DRIVER_FLAGS + ["--gnn", gnn])
    args.num_vocab = len(data[3]) - 2
    cfg = ogb_driver.build_model_cfg(args, task)
    loader = DAGLoader(data[0], 160, shuffle=True, seed=1, chunk_size=256,
                       prefetch=0, schedules=False)
    return cfg, next(iter(loader))


def f64_merge(g, tg, tdst, tmask):
    """K5's contract in the operands' dtype (index_add_): the graph-level
    sums of a float64 pass, which K5 (float32 or bfloat16) does not take."""
    from dagnn_tpu_torch.ops import segment
    return g + segment.segment_sum(tg, tdst, g.shape[0], tmask)


def baseline_step(cfg, params, batch, task="tok", merge=None):
    """(loss, {name: grad}, grad norm) of one train pass of a baseline
    (dropout off), on the parameters' device; `merge` replaces K5 (the
    forward's default) for the graph-level sums."""
    from dagnn_tpu_torch.cli import ogb_driver
    from dagnn_tpu_torch.train.losses import class_loss, tok_loss
    fwd = ogb_driver.MODELS[type(cfg)][1]
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    logits = fwd(p, cfg, batch, **({} if merge is None else {"merge": merge}))
    dev = logits.device
    mask = torch.as_tensor(batch.graph_mask, device=dev)
    loss = (tok_loss(logits, torch.as_tensor(batch.y["y_arr"], device=dev), mask)
            if task == "tok" else
            class_loss(logits, torch.as_tensor(batch.y["len_longest_path"], device=dev),
                       mask))
    gs = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
    gs = {k: torch.zeros_like(v) if g is None else g for (k, v), g in zip(p.items(), gs)}
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in gs.values()))
    return float(loss.detach()), gs, float(norm)


def card_vs_cpu(label, cfg, params, host):
    """One f32 train pass on the card against the CPU's from the same
    weights and host batch, at phase 21d's rule: loss and norm 1e-5
    relative, every leaf within rtol 5e-4 / atol 5e-5 (CROSS_TOL), a leaf
    past that held in float64, card against CPU, to the same rtol / atol.
    Returns the readings."""
    from dagnn_tpu_torch import convert
    t = CROSS_TOL
    bc, bh = convert.batch_to_torch(host, "cuda"), convert.batch_to_torch(host, "cpu")
    kl, kg, kn = baseline_step(cfg, params, bc)
    t0 = time.perf_counter()
    pl, pg, pn = baseline_step(cfg, {k: v.cpu() for k, v in params.items()}, bh)
    cpu_s = time.perf_counter() - t0
    e_loss, e_norm = abs(kl - pl) / abs(pl), abs(kn - pn) / pn
    ratio = {k: float(((kg[k].cpu() - pg[k]).abs()
                       / (t["atol"] + t["rtol"] * pg[k].abs())).max()) for k in pg}
    worst = max(ratio, key=ratio.get)
    print(f"{label} f32 step, card vs CPU: loss {kl:.6f} vs {pl:.6f} (rel {e_loss:.2e}), "
          f"grad norm rel {e_norm:.2e} (tolerance {t['loss']:g}); {len(pg)} leaves, "
          f"worst {worst} at {ratio[worst]:.3g} of rtol {t['rtol']:g} / atol "
          f"{t['atol']:g}; the CPU's pass {cpu_s:.2f} s")
    over = [k for k in pg if ratio[k] > 1.0]
    f64 = {}
    if over:
        g64 = [baseline_step(cfg, {k: v.to(d).double() for k, v in params.items()},
                             b, merge=f64_merge)[1] for d, b in (("cuda", bc), ("cpu", bh))]
        for k in over:
            a64, b64 = g64[0][k].cpu(), g64[1][k]
            f64[k] = float(((a64 - b64).abs() / (t["atol"] + t["rtol"] * b64.abs())).max())
            print(f"{label} {k}: float32 card vs CPU {ratio[k]:.3g} of rtol / atol; "
                  f"in float64 {f64[k]:.3g} (limit 1)")
    check(math.isfinite(kl) and e_loss <= t["loss"] and e_norm <= t["loss"]
          and all(r <= 1.0 for r in f64.values()),
          f"{label}: the card's step disagrees with the CPU's")
    return dict(loss_rel=e_loss, norm_rel=e_norm, worst=(worst, ratio[worst]),
                float64_leaves=f64, cpu_pass_s=cpu_s)


def timed_baseline_steps(label, cfg, params, host, card, n=3, task="tok"):
    """The driver's train step (make_step_fns) on one batch: a warm-up, then
    n steps timed by CUDA events and the host clock (a loss read a step),
    launch counts set to 0 before them and read after: K5 at k5_per_pass a
    step, no other kernel."""
    from dagnn_tpu_torch import convert
    from dagnn_tpu_torch.cli import ogb_driver
    from dagnn_tpu_torch.train.optim import make_optimizer
    opt = make_optimizer(1e-3, 0.25)
    train_step, _ = ogb_driver.make_step_fns(cfg, opt, task)
    b = convert.batch_to_torch(host, "cuda")
    state = opt.init(params)
    p, state, loss, _ = train_step(params, state, b)
    float(loss)
    reset_counts()
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev0.record()
    losses = []
    for _ in range(n):
        p, state, loss, _ = train_step(p, state, b)
        losses.append(float(loss))
    ev1.record()
    torch.cuda.synchronize()
    host_s = (time.perf_counter() - t0) / n
    dev_ms = ev0.elapsed_time(ev1) / n
    lc = check_counts(label, "train steps", {"tg_accumulate": n * k5_per_pass(cfg)})
    print(f"{label} {card}: train step {dev_ms:.2f} ms (CUDA events), {host_s * 1e3:.2f} ms "
          f"(host clock, a loss read a step) on the loader's batch 0 "
          f"({int(host.n_node)} nodes, {int(host.n_edge)} edges, "
          f"{int(host.n_graph)} graphs); losses {losses}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(all(math.isfinite(v) for v in losses), f"{label}: a non-finite loss")
    return dict(step_ms=dev_ms, step_host_s=host_s, step_losses=losses,
                step_launches=lc)


def ordered_sum_vs_index_add(label, host, card, H=300):
    """The baselines' node-level sum (ops/segment.SortedSegments: sorted by
    destination once a batch, segment_reduce in that order) against
    index_add_ on the loader's batch 0 edges ([E, 300] f32 onto the N+1
    nodes): equal within f32 rounding, bitwise repeatable (index_add_'s
    repeat printed beside), each timed (CUDA events), the sort timed apart;
    K5 (merged_segment_sum) at the graph-level sum of the same batch
    against its plain version, timed beside index_add_."""
    from dagnn_tpu_torch import convert
    from dagnn_tpu_torch.ops import row_step, segment
    b = convert.batch_to_torch(host, "cuda")
    n1, dst, em = b.x.shape[0], b.edge_dst_flat.long(), b.edge_mask_flat.bool()
    g = torch.Generator(device="cuda").manual_seed(0)
    v = torch.randn((dst.shape[0], H), generator=g, device="cuda")
    seg = segment.SortedSegments(dst, n1, em)
    differ = lambda fn, ref: sum(not torch.equal(fn(), ref) for _ in range(10))
    a1, i1 = seg.sum(v), segment.segment_sum(v, dst, n1, em)
    a_diff = differ(lambda: seg.sum(v), a1)
    i_diff = differ(lambda: segment.segment_sum(v, dst, n1, em), i1)
    rel = float((a1 - i1).abs().max() / i1.abs().max())
    ms = dict(ordered=time_ms(lambda: seg.sum(v), 20),
              index_add=time_ms(lambda: segment.segment_sum(v, dst, n1, em), 20),
              sort=time_ms(lambda: segment.SortedSegments(dst, n1, em), 20))
    print(f"{label} node-level sum [{dst.shape[0]}, {H}] f32 onto {n1} nodes on {card}: "
          f"ordered {ms['ordered']:.4f} ms, index_add_ {ms['index_add']:.4f} ms, the "
          f"sort and CSR bounds {ms['sort']:.4f} ms a batch; ordered vs index_add_ "
          f"{rel:.3g} of max; of 10 repeats, {a_diff} of the ordered sum and {i_diff} "
          f"of index_add_ differ from their first result")
    check(a_diff == 0 and rel <= TOL[torch.float32],
          "the ordered segment sum is not repeatable or disagrees with index_add_")
    G = host.num_graph_slots
    gid, nmask = b.graph_id, b.node_mask
    h = torch.randn((n1, H), generator=g, device="cuda")
    reset_counts()
    kern = segment.merged_segment_sum(h, gid, G + 1, nmask, row_step.tg_accumulate)
    plain = segment.merged_segment_sum(h, gid, G + 1, nmask, row_step.tg_accumulate_plain)
    k5 = read_counts()["tg_accumulate"]
    krel = float((kern - plain).abs().max() / plain.abs().max())
    k_diff = differ(lambda: segment.merged_segment_sum(
        h, gid, G + 1, nmask, row_step.tg_accumulate), kern)
    g_ref = segment.segment_sum(h, gid, G + 1, nmask)
    g_diff = differ(lambda: segment.segment_sum(h, gid, G + 1, nmask), g_ref)
    kms = dict(k5=time_ms(lambda: row_step.tg_accumulate(
                   torch.zeros((G + 1, H), device="cuda"), h, gid, nmask), 20),
               index_add=time_ms(lambda: segment.segment_sum(h, gid, G + 1, nmask), 20))
    print(f"{label} K5 at the graph-level sum [{n1}, {H}] f32 onto {G + 1} graphs: kernel "
          f"vs plain {krel:.3g} of max (tolerance {TOL[torch.float32]:g}), {k5} launch; "
          f"{kms['k5']:.4f} ms, index_add_ {kms['index_add']:.4f} ms; of 10 repeats, "
          f"{k_diff} of K5 and {g_diff} of index_add_ differ from their first result")
    check(k5 == 1 and krel <= TOL[torch.float32] and k_diff == 0,
          "K5 disagrees at the baselines' sum or does not repeat")
    return dict(ms=ms, rel=rel, repeats_differing=dict(ordered=a_diff, index_add=i_diff,
                                                       k5=k_diff, graph_index_add=g_diff),
                k5_rel=krel, k5_ms=kms)


def phase_baselines(dev, card, argv):
    """Phase 22: the ogbg-code2 baselines through the driver's entry points
    on phase 18's corpus, float32. 22a: main_tok --gnn gin-virtual, runs
    A, B, C (driver_runs): B's epoch 3 bitwise C's, K5 launched exactly
    k5_per_pass x the forward passes and no other kernel; epoch rates; the
    ordered node sum and K5 at the batch's shapes; its train step timed.
    22b: every other --gnn of BASELINES, one main_tok epoch each (finite
    loss, F1 in [0, 1], K5 counted as in 22a), one f32 step on the
    loader's batch 0 card against CPU, the train step timed and its
    launches counted. 22c: main_lp --gnn sagpool, one epoch. 22d:
    main_basic --model all: perfect F1 1.0 on valid and test, the CSV rows
    written. 22e (--profile): one gin-virtual step summarised by
    utils.profiling.summarize_trace."""
    import shutil
    import tempfile
    from dagnn_tpu_torch.cli import main_basic, main_lp, main_tok, ogb_driver
    out = {}
    print("[22a] main_tok --gnn gin-virtual, runs A (2 epochs), B (resumed to 3), "
          "C (3 afresh): " + " ".join(DRIVER_FLAGS))
    seen, lc, rows_a, rows_c, secs_a, secs_c, wall, rel = driver_runs(
        "[22a]", main_tok.main, "tok", card, ("tg_accumulate",), gnn="gin-virtual")
    data = seen["data"]
    cfg, host = baseline_setup("gin-virtual", "tok", data)
    passes = sum(seen["passes"].values())
    check(lc == {**{k: 0 for k in lc}, "tg_accumulate": k5_per_pass(cfg) * passes},
          f"gin-virtual driver: launches {lc}, not K5 {k5_per_pass(cfg)} x {passes} passes")
    rates = epoch_rates("[22a]", seen, secs_a, secs_c, wall, card)
    sums = ordered_sum_vs_index_add("[22a]", host, card)
    params = ogb_driver.init_params(cfg, 0, "cuda")
    step = timed_baseline_steps("[22a] gin-virtual", cfg, params, host, card)
    out["gin-virtual"] = dict(launches=lc, passes=dict(seen["passes"]), **rates,
                              resume_loss_rel=rel, rows_ab=rows_a, rows_c=rows_c,
                              sums=sums, **step)
    if "--profile" in argv:
        from dagnn_tpu_torch import convert
        from dagnn_tpu_torch.train.optim import make_optimizer
        from dagnn_tpu_torch.utils import profiling
        opt = make_optimizer(1e-3, 0.25)
        train_step, _ = ogb_driver.make_step_fns(cfg, opt, "tok")
        b, state = convert.batch_to_torch(host, "cuda"), opt.init(params)
        train_step(params, state, b)
        prof = profile_step("baseline_gin_virtual", train_step, params, state, b, card,
                            trace_dir(argv))
        path = os.path.join(trace_dir(argv), "step_trace_baseline_gin_virtual.json")
        rows = profiling.summarize_trace(path, top=8)
        print("[22e] utils.profiling.summarize_trace of the gin-virtual step: "
              + "; ".join(f"{r['name']} {r['total_us']:.1f} us x{r['count']}" for r in rows))
        out["gin-virtual"]["profile"] = prof
    root = tempfile.mkdtemp(prefix="chip_smoke_baselines_")
    try:
        for gnn in BASELINES:
            t0 = time.perf_counter()
            d = ["--dir_results", f"{root}/{gnn}", "--dir_save", f"{root}/{gnn}_s",
                 "--checkpointing", "0"]
            reset_counts()
            with driver_probes() as seen_b:
                main_tok.main(DRIVER_FLAGS + ["--gnn", gnn, "--epochs", "1"] + d)
            lc_b = read_counts()
            cfg_b, host_b = baseline_setup(gnn, "tok", seen_b["data"])
            passes_b = sum(seen_b["passes"].values())
            rows = _csv_rows(f"{root}/{gnn}/{gnn}_tok_train.csv")
            secs = _csv_rows(f"{root}/{gnn}/{gnn}_tok_times.csv")
            print(f"[22b] {gnn} on {card}: epoch 1 loss {rows[0][2]!r}, F1 train / valid / "
                  f"test {rows[0][3:]}; train seconds {secs[0][2]:.3f}; forward passes "
                  f"{dict(seen_b['passes'])}; launch counts {lc_b}")
            check(len(rows) == 1 and math.isfinite(rows[0][2])
                  and all(0.0 <= v <= 1.0 for v in rows[0][3:]),
                  f"{gnn}: the epoch's loss or F1 is out of range")
            check(lc_b == {**{k: 0 for k in lc_b},
                           "tg_accumulate": k5_per_pass(cfg_b) * passes_b},
                  f"{gnn}: launches other than K5 x {k5_per_pass(cfg_b)} a pass")
            params_b = ogb_driver.init_params(cfg_b, 0, "cuda")
            torch.cuda.reset_peak_memory_stats()
            gate = card_vs_cpu(f"[22b] {gnn}", cfg_b, params_b, host_b)
            step_b = timed_baseline_steps(f"[22b] {gnn}", cfg_b, params_b, host_b, card)
            out[gnn] = dict(launches=lc_b, passes=dict(seen_b["passes"]), epoch_s=secs[0][2],
                            rows=rows, **gate, **step_b,
                            wall_s=time.perf_counter() - t0)
        reset_counts()
        with driver_probes() as seen_lp:
            main_lp.main(DRIVER_FLAGS + ["--gnn", "sagpool", "--epochs", "1",
                                         "--dir_results", f"{root}/lp", "--dir_save",
                                         f"{root}/lp_s", "--checkpointing", "0"])
        lc_lp = read_counts()
        rows = _csv_rows(f"{root}/lp/sagpool_lp_train.csv")
        secs = _csv_rows(f"{root}/lp/sagpool_lp_times.csv")
        print(f"[22c] main_lp --gnn sagpool on {card}: epoch 1 loss {rows[0][2]!r}, accuracy "
              f"train / valid / test {rows[0][3:]}; train seconds {secs[0][2]:.3f}; "
              f"launch counts {lc_lp}")
        check(math.isfinite(rows[0][2]) and all(0.0 <= v <= 1.0 for v in rows[0][3:]),
              "main_lp sagpool: the loss or accuracy is out of range")
        check(lc_lp == {**{k: 0 for k in lc_lp},
                        "tg_accumulate": 3 * sum(seen_lp["passes"].values())},
              "main_lp sagpool: launches other than K5 x 3 a pass")
        out["lp_sagpool"] = dict(rows=rows, epoch_s=secs[0][2], launches=lc_lp)
        t0 = time.perf_counter()
        res = main_basic.main(DRIVER_FLAGS[:2] + ["--dir_results", f"{root}/basic"])
        basic_s = time.perf_counter() - t0
        with open(f"{root}/basic/baselines_basic.csv") as f:
            lines = f.read().splitlines()
        print(f"[22d] main_basic --model all: {lines}; {basic_s:.2f} s")
        check(lines[0] == "model,split,precision,recall,F1" and len(lines) == 7
              and all(res[("perfect", s)]["F1"] == 1.0 for s in ("valid", "test")),
              "main_basic: the perfect model's F1 is not 1.0 or the rows are missing")
        out["basic"] = dict(rows=lines, seconds=basic_s)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def main(argv):
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from dagnn_tpu_torch import checks, convert, flagship
    from dagnn_tpu_torch.dag.batch import collate
    from dagnn_tpu_torch.data.synthetic import synthetic_ast_batch
    from dagnn_tpu_torch.nn.dagnn import (KERNELS, PAIR_KERNELS, PAIR_PLAIN,
                                          PLAIN, SEG_KERNELS, SEG_PLAIN,
                                          SPLIT_KERNELS, SPLIT_PLAIN, dagnn_init)
    from dagnn_tpu_torch.ops import build, row_step, segment_attn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = gpu_line()
    print(f"[1] gpu: {card}")
    print(f"    torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    sources = {"wavefront": "K1-K5, K7, K2r", "segment_attn": "K6"}
    build.build_all(list(sources))
    row_step._lib()
    segment_attn._lib()
    print(f"[2] built {len(sources)} sources in parallel in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, kerns in sources.items():
        secs, log = build.build_log.get(name, (0.0, "(cached)"))
        print(f"    {name}.cu ({kerns}): nvcc {secs:.1f} s")
        for line in ptxas_summary(log):
            print("      " + line)

    # host collation of both workloads (set-up, outside every step)
    graphs = synthetic_ast_batch(0, 160, mean_nodes=125)
    t0 = time.perf_counter()
    host0 = collate(graphs, flagship.pad_for(graphs))
    t_merged = time.perf_counter() - t0
    t0 = time.perf_counter()
    host2 = collate(graphs, flagship.pad_for(graphs, pair=2))
    t_pair = time.perf_counter() - t0
    host1 = collate(graphs, flagship.pad_for(graphs, pair=1))
    nf_hosts = {}           # the near/far layouts (K7) of the same graphs
    for tag, mode in (("rt", ("regions", "tgonly")), ("r", "regions")):
        t0 = time.perf_counter()
        nf_hosts[tag] = collate(graphs, dataclasses.replace(
            flagship.pad_for(graphs), nearfar=mode))
        print(f"    near/far {mode}: collation {time.perf_counter() - t0:.2f} s")

    print("[3] K1/K2 against their plain versions, one row at the flagship "
          "shapes " + json.dumps(FLAGSHIP))
    rows = phase_kernels(row_spec(dev))
    kn = host2.fwd.node_ids.shape[1]
    p = pair_step_index(host2.pair, kn)
    print(f"[3b] K3/K4 against their plain versions, pair step {p} of the "
          f"flagship pair=2 batch, blocks {host2.pair.blocks}, width "
          + json.dumps(WIDTH))
    pairs = phase_kernels(pair_spec(dev, host2.pair, kn, p))
    print("[3c] K6 forward (K6f) and backward (K6b) against their plain "
          "versions, the busiest and the median level of the flagship batch, H 300")
    segs = phase_segment_attn(dev, host0, "busiest")
    segs_median = phase_segment_attn(dev, host0, "median")
    print("[3d] K5 against its plain version, one level's transpose schedule "
          "of the flagship batch")
    tgs = phase_tg_accumulate(dev, host0)
    split_row = phase_split_row(dev)
    nf_row = nearfar_row(nf_hosts["rt"], kn)
    print(f"[3e] K7 (K1/K2 with nf) against their plain versions, row {nf_row} "
          f"of the flagship near/far (regions, tgonly) batch, nf "
          f"{nf_layout(nf_hosts['rt'])}, width " + json.dumps(WIDTH))
    nfk = phase_kernels(nf_spec(dev, nf_hosts["rt"], nf_row))
    print("[3f] K2r (K2 without residual streams) against K2 and its plain "
          "version, one merged row at the flagship shapes " + json.dumps(FLAGSHIP))
    k2r_row = phase_recompute(dev)
    print("[3g] K2 launch by launch, one merged row at the flagship shapes, bf16, "
          "with torch.matmul yardsticks beside the GEMMs")
    k2_launches = phase_k2_launches(dev)
    print("[3h] K1 launch by launch, one merged row at the flagship shapes, bf16, "
          "with a torch.matmul yardstick beside gru_fwd")
    k1_launches = phase_k1_launches(dev)

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
    rows_per = lambda n: (lambda t, f: {"row_forward": n * (t + f),
                                        "row_backward": n * t})

    torch.cuda.reset_peak_memory_stats()
    steppers = {}
    merged = drive_path("merged", ("[5]", "[6]", "[7]", "[8]"), cfg, params,
                        batch, rows_per(L), KERNELS, PLAIN, card, argv,
                        steppers=steppers)
    phase_cross("[5c]", "pair=1 vs merged", params, cfg,
                (convert.batch_to_torch(host1, dev), PAIR_KERNELS),
                (convert.batch_to_torch(host1, dev)._replace(pair=None), KERNELS))
    torch.cuda.reset_peak_memory_stats()
    paired = drive_path("pair", ("[5b]", "[6b]", "[7b]", "[8b]"), cfg, params,
                        pbatch, lambda t, f: {"pair_forward": P * (t + f),
                                              "pair_backward": P * t},
                        PAIR_KERNELS, PAIR_PLAIN, card, argv)

    # the per-direction wavefront, generic branch: K6 per level, layer and
    # direction, replayed in the backward; K5 merges the transpose grads
    cfg_p = flagship.flagship_cfg(segment_impl="pallas")
    n6 = cfg_p.num_layers * L * len(cfg_p.dirs)
    torch.cuda.reset_peak_memory_stats()
    pallas = drive_path(
        "pallas", ("[9a]", "[9b]", "[9c]", "[9d]"), cfg_p, params, batch,
        lambda t, f: {"segment_attn_forward": n6 * (2 * t + f),
                      "segment_attn_backward": n6 * t, "tg_accumulate": n6 * t},
        SEG_KERNELS, SEG_PLAIN, card, argv, group=checks.score_linears)

    # the per-direction wavefront, fused branch at one direction
    cfg_u = flagship.flagship_cfg(bidirectional=False)
    params_u = dagnn_init(0, cfg_u, device=dev)
    torch.cuda.reset_peak_memory_stats()
    uni = drive_path("unidirectional", ("[10a]", "[10b]", "[10c]", "[10d]"), cfg_u,
                     params_u, batch, rows_per(L), KERNELS, PLAIN, card, argv,
                     steppers=steppers)
    reset_counts()
    phase_cross("[10e]", "split (K5 + K2) vs merged-tg K2, unidirectional",
                params_u, cfg_u, (batch, SPLIT_KERNELS), (batch, KERNELS))
    phase_step("[10e]", params_u, cfg_u, batch, SPLIT_KERNELS, SPLIT_PLAIN)
    split = check_counts("[10e]", "split checks", {
        "row_forward": 3 * L, "row_backward": 3 * L, "tg_accumulate": 2 * L})
    reset_counts()
    cross = phase_cross("[11]", "bidirectional fused per direction vs merged",
                        params, cfg, (batch, SPLIT_KERNELS), (batch, KERNELS))
    # per direction 2L calls each (K1, K5, K2), merged L (K1, K2)
    check_counts("[11]", "cross-route check", {
        "row_forward": 3 * L, "row_backward": 3 * L, "tg_accumulate": 2 * L})

    # the near/far layouts (K7): the merged path on both layouts, the
    # unidirectional one on "regions"; each row one K7 forward and backward
    nfb = {t: convert.batch_to_torch(h, dev) for t, h in nf_hosts.items()}
    for t, b in nfb.items():
        print(f"[4c] near/far workload {t}: nf {nf_layout(nf_hosts[t])} (mode, Ke, "
              f"Kf per direction), Kt {b.fwd.tgrad_eslot.shape[1]} / "
              f"{b.rev.tgrad_eslot.shape[1]}, L={b.fwd.node_ids.shape[0]} rows; "
              f"near edges {int((b.fwd.edge_nsrc < kn).sum())} fwd, "
              f"{int((b.rev.edge_nsrc < kn).sum())} rev")
        check(b.fwd.node_ids.shape[0] == L, "the near/far batch has other rows")
    nf_rows = lambda t, f: {"row_forward_nf": L * (t + f), "row_backward_nf": L * t}
    torch.cuda.reset_peak_memory_stats()
    nf_rt = drive_path("nearfar_rt", ("[12a]", "[12b]", "[12c]", "[12d]"), cfg,
                       params, nfb["rt"], nf_rows, KERNELS, PLAIN, card, argv,
                       steppers=steppers)
    torch.cuda.reset_peak_memory_stats()
    nf_r = drive_path("nearfar_r", ("[13a]", "[13b]", "[13c]", "[13d]"), cfg,
                      params, nfb["r"], nf_rows, KERNELS, PLAIN, card, argv,
                      steppers=steppers)
    torch.cuda.reset_peak_memory_stats()
    nf_u = drive_path("nearfar_unidirectional", ("[14a]", "[14b]", "[14c]", "[14d]"),
                      cfg_u, params_u, nfb["r"], nf_rows, KERNELS, PLAIN, card, argv,
                      steppers=steppers)
    # the merged path without residual streams (DAGNN_NO_RES_STREAM): K2r
    torch.cuda.reset_peak_memory_stats()
    with no_res_stream(True):
        k2r = drive_path("merged_k2r", ("[16a]", "[16b]", "[16c]", "[16d]"), cfg,
                         params, batch, lambda t, f: {
                             "row_forward": L * (t + f),
                             "row_backward_recompute": L * t},
                         KERNELS, PLAIN, card, argv, steppers=steppers)
    reset_counts()
    nf_cross = {
        "merged_rt": phase_cross("[15a]", "near/far (regions, tgonly) vs plain "
                                 "layout, merged", params, cfg,
                                 (nfb["rt"], KERNELS), (batch, KERNELS)),
        "merged_r": phase_cross("[15b]", "near/far (regions) vs plain layout, "
                                "merged", params, cfg, (nfb["r"], KERNELS),
                                (batch, KERNELS)),
        "unidirectional_r": phase_cross(
            "[15c]", "near/far (regions) vs plain layout, unidirectional",
            params_u, cfg_u, (nfb["r"], KERNELS), (batch, KERNELS)),
        "k2r": phase_cross("[15d]", "K2r vs residual streams, merged", params, cfg,
                           (batch, KERNELS, True), (batch, KERNELS))}
    # a train pass each: K7 on the three near/far sides; K1 and K2 on the
    # four others; K1 and K2r on the side without residual streams
    check_counts("[15]", "near/far and K2r cross-route checks", {
        "row_forward_nf": 3 * L, "row_backward_nf": 3 * L, "row_forward": 5 * L,
        "row_backward": 4 * L, "row_backward_recompute": L})
    ab = {f"{a}/{b}": phase_ab("[17]", a, b, steppers) for a, b in (
        ("merged", "nearfar_rt"), ("merged", "nearfar_r"),
        ("unidirectional", "nearfar_unidirectional"), ("merged", "merged_k2r"))}
    print("[18] the TOK driver (main_tok.main), runs A (2 epochs), B (resumed "
          "to 3), C (3 afresh): " + " ".join(DRIVER_FLAGS))
    driver = phase_driver(card)
    print("[19] the LP driver (main_lp.main) at its defaults (gated_sum, "
          "unidirectional), runs A, B, C as in 18: " + " ".join(DRIVER_FLAGS))
    lp = phase_lp_driver(card)
    print("[19b] every aggregator kind at the flagship's widths on phase 4's "
          "batch, one bf16 train pass each, kernels against plain")
    kinds = phase_kinds(dev, batch, card)
    node_space = phase_node_space(dev, batch, card)
    print("[20] the VAE driver (train_vae.main): NA runs A (2 epochs), B (resumed "
          "to 3), C (3 afresh): " + " ".join(NA_FLAGS))
    import shutil
    import tempfile
    root = tempfile.mkdtemp(prefix="chip_smoke_vae_")
    try:
        vae = phase_vae(dev, card, argv, root)
        t0 = time.perf_counter()
        print("[21] latent scoring and BO (run_bo, summarize) on phase 20's "
              "latents and checkpoints; the other VAEs (train_vae.main)")
        scoring = phase_latent_scoring(dev, card, root)
        scoring["wall_s"] = time.perf_counter() - t0
        print(f"[21] {card}: phase 21 took {scoring['wall_s']:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    print("[22] the ogbg-code2 baselines (main_tok / main_lp --gnn ..., main_basic) "
          "at the driver's defaults, float32, on phase 18's corpus")
    baselines = phase_baselines(dev, card, argv)
    baselines["wall_s"] = time.perf_counter() - t0
    print(f"[22] {card}: phase 22 took {baselines['wall_s']:.1f} s")
    runs = {"merged": merged, "pair": paired, "pallas": pallas,
            "unidirectional": uni, "nearfar_rt": nf_rt, "nearfar_r": nf_r,
            "nearfar_unidirectional": nf_u, "merged_k2r": k2r}
    eps = {k: v["edges_per_s"] for k, v in runs.items()}
    print(f"    edges/s fwd+bwd per GPU on {card}: "
          + ", ".join(f"{k} {v:.1f}" for k, v in eps.items())
          + f"; pair/merged {eps['pair'] / eps['merged']:.3f}x, near/far "
          f"(regions, tgonly)/merged {eps['nearfar_rt'] / eps['merged']:.3f}x, "
          f"(regions)/merged {eps['nearfar_r'] / eps['merged']:.3f}x, "
          f"K2r/merged {eps['merged_k2r'] / eps['merged']:.3f}x")

    kernels = []
    wf = "dagnn_tpu_torch/csrc/wavefront.cu"
    for kern, name, src, line, res, main_path in (
            ("K1", "row_forward", wf, "dagnn_tpu/ops/pallas/row_step.py:616", rows, "merged"),
            ("K2", "row_backward", wf, "dagnn_tpu/ops/pallas/row_step.py:701", rows, "merged"),
            ("K3", "pair_forward", wf, "dagnn_tpu/ops/pallas/pair_step.py:254", pairs, "pair"),
            ("K4", "pair_backward", wf, "dagnn_tpu/ops/pallas/pair_step.py:291", pairs, "pair"),
            ("K5", "tg_accumulate", wf, "dagnn_tpu/ops/pallas/row_step.py:674", tgs, "pallas"),
            ("K6f", "segment_attn_forward", "dagnn_tpu_torch/csrc/segment_attn.cu",
             "dagnn_tpu/ops/pallas/segment_attn.py:61", segs, "pallas"),
            ("K6b", "segment_attn_backward", "dagnn_tpu_torch/csrc/segment_attn.cu",
             "dagnn_tpu/ops/pallas/segment_attn.py:94", segs, "pallas"),
            ("K7f", "row_forward_nf", wf, "dagnn_tpu/ops/pallas/row_step.py:356", nfk,
             "nearfar_rt"),
            ("K7b", "row_backward_nf", wf, "dagnn_tpu/ops/pallas/row_step.py:555", nfk,
             "nearfar_rt"),
            ("K2r", "row_backward_recompute", wf, "dagnn_tpu/ops/pallas/row_step.py:536",
             k2r_row, "merged_k2r")):
        r = res[torch.bfloat16][kern]
        kernels.append({"name": f"{name} ({kern})", "route": "cuda", "source": src,
                        "replaces": line, "launches": runs[main_path]["launches"][name],
                        "max_abs_err": r["err"], "ms": r["ms"], "call_ms": r["call_ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                        "bound_by": r["bound"][1], "library_ms": r.get("library_ms"),
                        "launches_by_path": {k: v["launches"][name] for k, v in
                                             {**runs, "tok_driver": driver,
                                              "lp_driver": lp, "node_space": node_space,
                                              **{f"kind {t}": v for t, v in kinds.items()},
                                              **{f"vae_{t}": v for t, v in vae.items()},
                                              **{f"baseline {t}": v
                                                 for t, v in baselines.items()
                                                 if isinstance(v, dict) and "launches" in v}
                                              }.items()
                                             if v["launches"][name]}})
        if kern in vae["na"]["kernels"]["float32"]:
            r = vae["na"]["kernels"]["float32"][kern]
            kernels[-1]["vae_na_f32"] = {
                "ms": r["ms"], "plain_ms": r["plain_ms"], "max_abs_err": r["err"],
                "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                "library_ms": r["library_ms"]}
    print(json.dumps({**runs, "tok_driver": driver, "lp_driver": lp, "kinds": kinds,
                      "node_space": node_space, "vae": vae, "latent_scoring": scoring,
                      "baselines": baselines,
                      "split_checks": split, "cross_route": cross,
                      "nearfar_cross_route": nf_cross, "ab_steps": ab,
                      "split_row": {short(k): v for k, v in split_row.items()},
                      "k2_launches": k2_launches, "k1_launches": k1_launches,
                      "k6": {lv: {"level": res["level"], **{
                          short(dt): {k: {x: r[x] for x in ("ms", "windows", "call_ms",
                                                            "plain_ms", "rel")}
                                      for k, r in res[dt].items()}
                          for dt in (torch.bfloat16, torch.float32)}}
                             for lv, res in (("busiest", segs), ("median", segs_median))},
                      "gpu": card,
                      "f32_kernels": {**rows[torch.float32], **pairs[torch.float32],
                                      **segs[torch.float32], **tgs[torch.float32],
                                      **nfk[torch.float32], **k2r_row[torch.float32]}}))
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

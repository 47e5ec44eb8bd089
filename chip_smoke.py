"""Smoke run of the PyTorch/CUDA port on one GPU: the flagship TOK train step,
the TOK and LP training drivers, every aggregator kind, the NA/BN VAE
driver with every --model, latent scoring with Bayesian optimisation, the
ogbg-code2 baselines, the parallel layer (data-parallel and
edge-partitioned ranks sharing the card), and the bench with the tools.

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
  latent scoring and BO (no kernel of the port on this path; on the card
  each program the JAX package compiles replays a CUDA graph: the GP
  fit's Adam steps, each greedy-EI candidate, the decode, the ENAS
  surrogate's step and MLP), on phase 20's latents and checkpoints:
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
      each result directory; each run's captures and replays by program,
      at most one capture a key (its graphs freed before it); in the ENAS
      run scripts.bo_diagnose's stages: each round's candidates (their
      distance to the training latents, the box's bounds) and GP, and 50
      training latents decoded by the run's model; each ENAS round and
      the training latents' votes at least 45 of 50 valid
  21e. each captured program against its eager form (capture=False) at
      run_bo's defaults on run C's files, bit for bit from the same inputs
      and generator seed: the fit's 100 Adam steps (parameters and last
      loss; float32 and float64; one step a graph), 8 greedy-EI
      candidates of a float64 round (4 timed in turns), the decode of 50
      latents x 100 attempts (types, adj, nv), the surrogate's 400 steps
      and its validation predictions (against its eager build's);
      captures and replays counted; eager
      against captured in turns a b b a (CUDA events); a captured float64
      fit and EI round profiled (busy share, the top device ops)
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
  the parallel layer (dagnn_tpu_torch/parallel; D ranks started on this
  one card with the spawn start method, gloo with every collective staged
  on the host, since NCCL takes one rank a card; its numbers measure the
  code path, not scaling):
  the two spawns (2 and 4 ranks) run at once, started after phase 20
  (start_parallel) so that their processes run beside phases 21 and 22,
  their results read here; they carry 23a's and 23d's ranks too: the CLIs' own mains run in threads, given the phase's spawn
  (SharedWorlds), which adds their jobs to the world of their size:
  23a. dryrun.main(["--ranks", N, "--timeout", "900"]) at 2 and 4 ranks
      (its plan, build_all, spawn and check): the JAX dry run's checks (a
      finite DP
      loss; the replicated-state EP forward within 1e-3 of the single-rank
      states; at 4 ranks the (dp 2, ep 2) step's loss within 1e-3 of the
      mean of the two batches' single-rank losses)
  23b. data parallel, 2 ranks, bf16, the merged path (K1/K2) on phase 4's
      batch split by node count (flagship.pad_for(n_shards=2)): the
      averaged loss, norm and leaves against one process's mean of the two
      shards' (the same kernels; phase 5's gates), parameters bitwise
      equal across the ranks after 3 steps, each rank's K1/K2 launches the
      rows of its shard's pass and no other kernel, the score linears'
      bias measured with its weight (checks.score_linears) as in phases 9
      and 19b; the same step at world size 1 over NCCL (captured, its
      default there) bitwise equal to the single-process step
  23c. edge partitioned, 2 and 4 ranks, segment_impl="pallas" (K6, K5),
      scan rows 64 x D wide: one f32 step against the single-rank f32
      generic step (loss and norm 1e-5, leaves rtol 5e-4 / atol 5e-5,
      exact zeros to the noise bound), one bf16 step at phase 5's gates,
      every rank's K6 forward / backward and K5 launches as the plan
      derives them (per row of each direction: K6f 2 x layers, K6b
      layers, K5 3); the bf16 leaves with the score linears' bias grouped
      with its weight (checks.score_linears); the plan's seconds (and its greedy stage-row loop's),
      the wire accounting; the bf16 step in the overlapped order (the default: the deferred exchange waited
      on after the row's outputs, before the gather only in the rows that
      read it at its delivery) against the synchronous order: forward
      buffers, loss and gradient digests bitwise equal on every rank, the
      same collectives issued (at 2 ranks from the trace section's turns
      and forward passes); scripts.ep_overlap_report's plan section on
      both batches (its flagged rows those the ranks used) and, on the
      2-rank spawn, its trace section: both orders' bf16 steps in turns a
      b b a (CUDA events), one profiled forward pass each, every deferred
      exchange's wait where its order puts it
  23d. bench_scaling.main(["--devices", "2", "--iters", "1"]) (its
      defaults' workload, 1 timed step), its lines and JSON line: its
      2-rank bench_job in the 2-rank spawn, its 1-rank job served in this
      process's world-size-1 group after 23e; the ranks of 23b-23d that
      share the card run gloo, so their steps are eager, which their
      lines say
  23e. on the in-process world-size-1 NCCL group, at the flagship's widths
      on bench_scaling's workload: the DP step (merged) and the EP step
      (D = 1, scan rows 64, the generic branch) captured, their default
      over NCCL, against their eager forms: 3 steps of each bit for bit
      (loss, every leaf, the collectives, the launches a replay counts);
      the graph's own nodes (graphs.graph_nodes): K1's attn_fwd / gru_fwd
      and K2's kernels at the shard's rows, sa_fwd / sa_bwd / seg_merge at
      the plan's rows, NCCL's kernels (none at one rank); eager against
      captured in turns a b b a (CUDA events), a replay's busy share
  the bench and the tools (dagnn_tpu_torch/bench.py, dagnn_tpu_torch/
  scripts/), in process; launch counts set to 0 before each bench run and
  read after it:
  24a. bench.main --roofline on the pair default and with --nopair: one
      metric line and one roofline line, a finite positive edges/s,
      model_tflops equal to roofline.model_flops of the same batch, mfu in
      (0, 1.05], the device's busy share in (0, 1], K3/K4 P (K1/K2 L) per
      train step and no other kernel; the edges/s beside phase 6 / 6b's
      (information); then DAGNN_BENCH_STEPS=17: one group of 17 steps
      timed
  24b. scripts.microbench_row_kernel: each width's (H 300, 384, 256) K1/K2
      call against the plain versions at phase 3's bf16 gates, then its
      main (82 calls from one CUDA graph, and eager)
  24c. scripts.microbench_pair_kernel: its pair step's K3/K4 and merged
      row's K1/K2 against the plain versions, then its main
  24d. scripts.ep_decompose: the plan statistics against a direct call of
      the planner; DP x1 and EP x1 in a world-size-1 NCCL group, EP x1's
      K6 / K5 launches as its plan's rows derive them, DP x1's K1/K2 only,
      each profile's categories within 2% of its device time
  24e. scripts.rehearse_preprocess --graphs 20000 (host work, its own
      process, started after phase 20 beside phases 21 and 22, ended
      before phase 23): every stage reported
  24f. scripts.bn_ceiling --seeds 1 on the synthetic BN rows: finite RMSE,
      ll and Pearson r

  the captured steps (dagnn_tpu_torch/train/graphs.py: one CUDA graph
  replay a step, as the JAX package's jitted steps; phases 4-24 above run
  through them wherever the driver's make_step_fns, train_vae or the bench
  capture, each replay counted as the launches of its capture):
  25a. the flagship TOK step at full width (emb/hidden 300, 2 layers, bf16)
      on three batches of 160 synthetic ASTs in one bucket, merged (K1/K2)
      and pair (K3/K4): 5 steps over batches 0, 1, 2, 0, 1 captured and
      twice eager from the same weights; bit for bit where the eager runs
      repeat bit for bit, else phase 5's gates; launch counts equal; one
      capture per distinct key (the merged bucket one; pair blocks are
      widths of each batch's plan, part of the key); the step on batch 0
      eager against captured in turns (CUDA events and host clock); what
      a replay launches, read from the graph itself (its kernel, copy and
      set nodes by name: graphs.graph_nodes, CUDAGraph.debug_dump), against
      the profiler's device events of one eager step on the graph's input
      buffers (census_pair: kernels name by name equal, copies the eager
      step's plus the write-back; up to three eager traces, failing when
      none equals the graph's nodes)
  25b. the same for the flagship on the generic branch
      (segment_impl="pallas": K6, K5) on 25a's merged batches, and for LP
      at main_lp's defaults (gated_sum, the generic branch, K5), with one
      eager run held bit for bit; the graph's K5 and K6 nodes against the
      eager step's wrapper counts (wrapper_nodes; no profiler census: it
      drops events of traces this long)
  25c. train_vae.main at phase 20's NA flags, 2 epochs, the plateau drop
      forced after epoch 1, captured against all eager: the loss file and
      the parameters bit for bit, one capture a batch size (the tail's
      its own); epoch 1 equal to phase 20's run C's, epoch 2 not (the
      staged plateau scale, dropped to 0, reached the replays);
      at 20b's BN flags one epoch the same; each VAE's train step eager
      against captured in turns, its graph's K5 and K6 nodes against the
      eager step's wrapper counts
  25d. the bench (pair) with the graph and with --eager in turns
      (graph, eager, eager, graph)
  every other model of the drivers captured (phases 21d and 22 above
  replay their steps too, each replay counted as its capture's launches):
  26a. each baseline (gin, gin-virtual, gcn, gcn-virtual, ggnns,
      ggnn-etype, gat, dgcnn, diffpool, unet, sagpool, asap) at the
      driver's defaults (float32, batch 160) on three batches of one
      bucket of its loader on phase 22's corpus: 3 train steps captured
      and eager from the same weights, bit for bit after each (the loss,
      finite, every parameter and Adam leaf), predict after them bit for
      bit, the launches equal (K5 at k5_per_pass a step), the graph's
      seg_merge nodes equal to k5_per_pass, one capture; the step on
      batch 0 eager against captured in turns; K5 at the baselines' graph
      sum against its plain version, from a CUDA graph, with its bound and
      index_add_; ASAP's master query (both fixed-shape forms) timed at the
      driver's shapes with the memory it takes
  26b. SVAE, SVAE_oneshot, SVAE_GraphRNN, SVAE_GraphRNN_BFS, DVAE_GCN,
      DVAE_fast and DVAE_DeepGMG: train_vae.main at 21d's flags, 21d's
      captured first epoch against one epoch all eager
      (train_vae.CAPTURED emptied): the loss sums and the parameters bit
      for bit, one capture a batch size; epoch seconds each way; the step
      on batch 0
      eager against captured in turns, no kernel of the port in the graph
  26c. on gin-virtual, ggnn-etype, asap, SVAE_GraphRNN and DVAE_DeepGMG:
      the graph's kernels against the profiler's trace of the step run
      eagerly on the graph's buffers, name for name (census_pair, padded
      with spin kernels), and a replay's busy share
  the launchers of dagnn_tpu_torch/scripts/ as a user starts them:
  27. each protocol script run with bash in a process of its own on the
      card, at full width and small depth, four chains at once, started
      after phase 20 beside phases 21 and 22 and ended before phase 23
      (their lines printed here):
      na_train.sh (EPOCHS=1, --max-count 1000) then na_eval.sh on its
      latents (CKPT, SEEDS=1, ROUNDS=1, then summarize); ogb_tok.sh and
      ogb_lp.sh (EPOCHS=1 FOLDS=1, --synthetic 400); bn_train.sh (one
      epoch on 512 synthetic rows) then bn_eval.sh (one seed, one round).
      Gates: exit code 0, the files each protocol writes, finite numbers,
      each CLI's line saying it ran on cuda; the VAE epochs' steps all
      replays (captures 2: the full batches' key and the tail's), K6 and
      K5 launched as the replays' passes predict

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
import functools
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from dagnn_tpu_torch.ops import read_launch_counts as read_counts
from dagnn_tpu_torch.ops import reset_launch_counts as reset_counts
# each launch's bytes and operations, and its bound at the H100's peaks
from dagnn_tpu_torch.roofline import (bound_ms, kernel_costs, recompute_costs,
                                      segment_costs, tg_costs)
from dagnn_tpu_torch.utils.timing import time_ms, timings

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


def sync():
    """Wait for the card (a CPU rehearsal has none to wait for)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


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


def hold_kernels(spec, dt):
    """A forward kernel and its backward against their plain versions on
    one call's inputs (spec["inputs"](dt)): forward outputs on their own
    max|plain|; backward outputs and weight grads on their own max|plain|
    with the elements that are zero in exact arithmetic (the float32 plain
    run on the same inputs tells them apart) held to the noise bound.
    Returns (static, inputs, weights, the plain forward's residuals, the
    forward and backward as fn(impl, ...), the worst error by kernel)."""
    from dagnn_tpu_torch import checks
    kf_name, kb_name = spec["names"]
    # keyword arguments of the forward and the backward, from the inputs
    fkw = spec.get("fkw", lambda d: spec["kw"])
    bkw = spec.get("bkw", lambda d: spec["kw"])
    st, d, w = spec["inputs"](dt)
    fwd = lambda fn, d, w, emit: fn(*spec["fargs"](st, d, w), emit_res=emit,
                                    **fkw(d))
    bwd = lambda fn, d, w, res: fn(*spec["bargs"](st, d, w, res), **bkw(d))
    kf = fwd(spec["fwd"], d, w, True)
    pf = fwd(spec["fwd_plain"], d, w, True)
    sync()
    errs, noise = {}, {}
    for name, a, b in zip(("out", "alpha32", "nres"), kf, pf):
        errs[f"{kf_name}.{name}"] = checks.rel_err(a, b)
    # the backward on identical inputs: the plain forward's residuals
    res = (pf[1], pf[2])
    kb = bwd(spec["bwd"], d, w, res)
    pb = bwd(spec["bwd_plain"], d, w, res)
    sync()
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
    return st, d, w, res, fwd, bwd, worst


def phase_kernels(spec):
    """Phases 3 / 3b: hold_kernels in bf16 and f32, then times (`timings`):
    on the device and per eager call, each the median of three windows of
    50 launches; the plain version's mean of 5 eager calls."""
    kf_name, kb_name = spec["names"]
    results = {}
    for dt in (torch.bfloat16, torch.float32):
        st, d, w, res, fwd, bwd, worst = hold_kernels(spec, dt)
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
    occ = profiling.device_busy(dev)
    if occ is None:
        print(f"[profile {tag}] the trace holds no device events: not measured")
        return None
    span, busy = occ["span_us"], occ["busy_us"]
    print(f"[profile {tag}] device span {span / 1e3:.2f} ms, busy "
          f"{busy / 1e3:.2f} ms ({100 * occ['share']:.1f}%), "
          f"{occ['events']} device events, on {card}")
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
    return dict(span_ms=span / 1e3, busy_ms=busy / 1e3, busy_share=occ["share"],
                events=occ["events"], top_ms={r["name"]: r["total_us"] / 1e3 for r in rows},
                k6={k: dict(ms=sum(d) / 1e3, launches=len(d)) for k, d in k6.items()})


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
    read after: the step check, the timed steps (one captured train step,
    train/graphs.py), a predict (and with --profile one profiled step).
    expect(train passes, forward passes) gives the launches each wrapper of
    the path must have made; every other wrapper must have launched
    nothing. `steppers` (a dict) keeps the
    path's warm train step, weights, state and batch for phase 17."""
    from dagnn_tpu_torch.cli.ogb_driver import make_step_fns
    from dagnn_tpu_torch.nn import dagnn
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
def replay_passes(count):
    """Within the block, count the passes that captured steps
    (dagnn_tpu_torch/train/graphs.py) stand for: count("train") once a
    replay of a step that writes its state, count("infer") once a replay
    of one that does not. Yields a function that is true while a capture's
    set-up runs (its warm-up calls and the capture itself), whose Python
    passes are no passes of the run. Restored on exit."""
    from dagnn_tpu_torch.train import graphs
    C = graphs.CapturedStep
    orig = (C.__call__, C._capture)
    setup = [0]

    def capture(self, *a, **k):
        setup[0] += 1
        try:
            return orig[1](self, *a, **k)
        finally:
            setup[0] -= 1

    def call(self, *a, **k):
        out = orig[0](self, *a, **k)
        if self.last_graph() is not None:
            count("train" if self.writes_state else "infer")
        return out

    C.__call__, C._capture = call, capture
    try:
        yield lambda: setup[0] > 0
    finally:
        C.__call__, C._capture = orig


@contextlib.contextmanager
def driver_probes():
    """Record, without changing them, what the driver's run hands around:
    the dataset load_dataset returns, the device of each fold's initial
    parameters, the wall time of each evaluate call, the route
    dagnn_forward takes for each batch (the captured steps' keys read it
    too), and the forward passes of each model (ogb_driver.MODELS), train
    and inference apart, a captured step's replay counted as the pass it
    stands for (replay_passes). Restored on exit."""
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
            if not in_setup():
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
        with replay_passes(lambda kind: seen["passes"].update([kind])) as in_setup:
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
    the model (VAEModel.loss with and without training, encode_mu; a
    captured step's replay counted as its train pass, replay_passes), and
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
        if not in_setup():
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

    def bump(kind):
        seen[kind] += 1

    try:
        with replay_passes(bump) as in_setup:
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
    p, s, _ = step(params, state, prepared, gen, 1.0)      # warm-up
    torch.cuda.synchronize()
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    h0 = time.perf_counter()
    ev0.record()
    for _ in range(5):
        p, s, stats = step(p, s, prepared, gen, 1.0)
    ev1.record()
    torch.cuda.synchronize()
    step_host = (time.perf_counter() - h0) / 5 * 1e3
    step_dev = ev0.elapsed_time(ev1) / 5
    print(f"[20a] {card}: NA train step {step_host:.2f} ms (host clock, 5 steps "
          f"after a warm-up, no loss read), {step_dev:.2f} ms by CUDA events; "
          f"last loss {float(stats[0]):.4f}")
    prof = None
    if "--profile" in argv:
        prof = profile_step("vae_na", lambda a, b, c: step(a, b, c, gen, 1.0),
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


# 21b's gate on the ENAS rounds and on the training latents' votes: at
# least 45 of 50 valid (the JAX package's record decoded 50 of 50 a round)
BO_VALID_SHARE = 0.9


def phase_bo_rounds(card, root):
    """21b: run_bo --bo on the card. ENAS: run C's DAGNN checkpoint and
    latents, 1 seed, 2 rounds of 50 candidates, 100 decode attempts each
    (5,000 latents decoded a round in one batch), the surrogate scorer
    trained on the whole corpus, with scripts.bo_diagnose's stages read
    in the run (its observe hook): b. each round's candidates (valid
    share, distance to the nearest training latent in median
    nearest-neighbour distances, share on the box's bounds, non-finite)
    and c. its GP; then a. 50 training latents decoded 100 times each by
    the run's model (the vote's valid share and reconstruction share).
    BN: phase 20b's DAGNN_BN checkpoint, 1 round, the BIC scorer. Gates:
    best_arc_scores.txt written, each round's best score; each ENAS round
    and a.'s votes at least BO_VALID_SHARE valid, no candidate
    non-finite; then summarize.main on each result directory (no
    --plot). a.'s reconstruction share is printed: at run C's depth (3
    epochs on 900 graphs) the model reconstructs none of its graphs (0 of
    50 on the CPU), so a bound on it would hold nothing here; the NA
    protocol's run reads it (PERF.md)."""
    import numpy as np
    import scipy.io
    from dagnn_tpu_torch.cli import run_bo, summarize
    from dagnn_tpu_torch.scripts import bo_diagnose as bd
    out = {}
    mat_c, ckpt_c = f"{root}/C/final_structures6_latent_epoch3.mat", f"{root}/C/DAGNN_0_3.ckpt"
    Z_c = scipy.io.loadmat(mat_c)
    X_c = torch.as_tensor(np.asarray(Z_c["Z_train"], np.float64), device="cuda")
    scale = bd.nn_scale(X_c)
    stages, model = [], []
    record = bd.recorder(stages, X_c, scale)

    def observe(r):
        model[:] = [r["model"]]
        record(r)
    for tag, flags in (
            ("enas", ["--latent", mat_c, "--checkpoint", ckpt_c, "--BO_rounds", "2"]
             + _widths(NA_FLAGS)),
            ("bn", ["--latent", f"{root}/BN/asia_200k_latent_epoch1.mat",
                    "--checkpoint", f"{root}/BN/DAGNN_BN_0_1.ckpt", "--data-type",
                    "BN", "--model", "DAGNN", "--bidirectional", "--BO_rounds", "1"]
             + _widths(BN_FLAGS))):
        res = f"{root}/bo_{tag}"
        run_bo.release_graphs()          # this run captures every program it runs
        t0 = time.perf_counter()
        r = run_bo.main(flags + ["--bo", "--seeds", "1", *GP_FLAGS, "--res_dir", res],
                        observe=observe if tag == "enas" else None)
        wall = time.perf_counter() - t0
        for rd in r["rounds"]:
            print(f"[21b] {tag} round {rd['round']} on {card}: {rd['valid']}/"
                  f"{rd['n']} valid, best {rd['best']}; seconds: GP fit "
                  f"{rd['fit_s']:.3f}, greedy EI {rd['ei_s']:.3f}, decode and vote "
                  f"{rd['decode_s']:.3f}, scoring {rd['score_s']:.3f}")
        if tag == "enas":
            out["stages"] = bo_stages(card, r, stages, model[0], mat_c, ckpt_c, Z_c, scale)
        check(os.path.exists(f"{res}/best_arc_scores.txt"),
              f"run_bo {tag}: no best_arc_scores.txt (no valid arc decoded)")
        check(all(rd["best"] is not None for rd in r["rounds"]),
              f"run_bo {tag}: a round without a best score")
        print(f"[21b] summarize {tag}:")
        summarize.main(["--res_dir", res])
        g = r["graphs"]
        # keys: the fit unpadded and padded, each in float32 and float64;
        # the EI's posterior in float32 or float64; one decode batch; the
        # surrogate's step and its MLP at the validation rows and one row
        most = {"GP fit": 4, "greedy EI": 2, "decode": 1, "surrogate fit": 1,
                "surrogate predict": 2}
        print(f"[21b] {tag}: captures / replays by program {g}, at most {most} "
              f"captures")
        check(all(g[k][0] <= n for k, n in most.items())
              and g["decode"][1] == len(r["rounds"])
              and g["greedy EI"][1] == 50 * len(r["rounds"]) and g["GP fit"][1] > 0,
              f"run_bo {tag}: a program captured more than once a key, or not replayed")
        out[tag] = dict(rounds=r["rounds"], gp=r["gp"], wall_s=wall, graphs=g,
                        scorer_quality=r["scorer_quality"])
    return out


def bo_stages(card, r, stages, model, mat, ckpt, Z, scale):
    """21b's stages of the ENAS run `r` (scripts.bo_diagnose): b. and c. of
    each round from `stages` (its observe hook's records), then a. on 50
    training latents (numpy seed 0) decoded 100 times each by the run's
    `model`. Gates each round and a.'s votes at BO_VALID_SHARE valid and
    every candidate finite."""
    import numpy as np
    from dagnn_tpu_torch.scripts import bo_diagnose as bd
    for st, rd in zip(stages, r["rounds"]):
        print(f"[21b] enas round {st['round']}: b. candidates {bd.describe_b(st)} (median "
              f"NN {scale:.4g}); c. {bd.describe_c(st['gp'])}")
        check(rd["valid"] >= BO_VALID_SHARE * rd["n"] and st["nonfinite"] == 0,
              f"21b: ENAS round {rd['round']} decoded {rd['valid']} of {rd['n']} "
              f"(at least {BO_VALID_SHARE:.0%} valid), {st['nonfinite']} non-finite "
              f"candidates")
    args = bd.parse_args(["--latent", mat, "--checkpoint", ckpt, "--max-count", "1000"])
    graphs = bd.train_graphs(args, Z["Y_train"].reshape(-1))
    rows = np.random.default_rng(0).choice(len(graphs), 50, replace=False)
    gen = torch.Generator(device="cuda").manual_seed(0)
    a, a_s = _timed(lambda: bd.latent_stats(model, Z["Z_train"][rows],
                                            [graphs[i] for i in rows], 100, gen))
    print(f"[21b] enas a. on {card}: {bd.describe_a(a)} (100 attempts each; {a_s:.2f} s)")
    check(a["valid"] >= BO_VALID_SHARE,
          f"21b: {a['valid']:.2f} of the training latents' votes valid (at least "
          f"{BO_VALID_SHARE:.0%})")
    return dict(train=a, rounds=stages, scale=scale)


# 21e: run_bo's defaults (M 500, 100 Adam steps at lr 5e-4, a 10,000-point
# grid refined 50 steps, 100 decode attempts of 50 latents) on run C's
# files; EI_Q of the round's 50 candidates held, EI_TURN_Q timed in turns
GP_ITERS, GP_LR, EI_Q, EI_TURN_Q = 100, 5e-4, 8, 4


def _bits(t):
    """A float tensor's bits as integers: NaN equal to itself."""
    return t.contiguous().view({torch.float32: torch.int32,
                                torch.float64: torch.int64}.get(t.dtype, t.dtype))


def _same_bits(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_bits(a[k], b[k]) for k in a)
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _form_turns(label, dev, run, n=1):
    """run(capture) -> a call of the program; the eager and captured calls
    timed in turns (a b b a) on the card, nothing on the CPU."""
    if dev.type != "cuda":
        return None
    return timed_turns(label, {"eager": run(False), "captured": run(True)}, n)


def _profile_top(label, fn, top=5):
    """One call of fn profiled on the card: its device busy share and the
    `top` device operations by summed time (utils/profiling); None on the
    CPU."""
    import tempfile
    from dagnn_tpu_torch.utils import profiling
    if not torch.cuda.is_available():
        return None
    with tempfile.TemporaryDirectory(prefix="chip_smoke_21e_") as tmp:
        path = profiling.profile_step(fn, iters=1, logdir=tmp, name="replay.json")
        busy = profiling.device_busy(profiling.device_events(path))
        rows = profiling.summarize_trace(path, top=top)
    check(busy is not None, f"{label}: the profiler saw no device events")
    print(f"{label} one captured call profiled: {busy['events']} device events, busy "
          f"{100 * busy['share']:.1f}% of {busy['span_us'] / 1e3:.2f} ms; the top device "
          f"ops: " + "; ".join(f"{r['name'][:60]} {r['total_us'] / 1e3:.2f} ms x{r['count']}"
                              for r in rows))
    return {"busy_share": busy["share"], "span_ms": busy["span_us"] / 1e3,
            "events": busy["events"], "top": [(r["name"][:80], r["total_us"], r["count"])
                                              for r in rows]}


def phase_bo_graphs(dev, card, mat, model_flags, corpus=None, pad_rounds=2):
    """21e: each program run_bo captures (train/graphs.CapturedStep)
    against its eager form (capture=False) at run_bo's defaults, from the
    same inputs and generator seed, bit for bit; then eager against
    captured in turns a b b a (CUDA events), with the captures and
    replays each made. On the latents of `mat` (their rows padded by
    pad_rounds rounds of 50, as 21b's fits), the checkpoint of
    `model_flags` (run_bo's flags) and the ENAS corpus (run_bo's default
    when None):
      the GP fit's 100 Adam steps (sparse_gp._adam_fit, FIT) in float32 and
      float64, the parameters and last loss, one step a graph replayed 100
      times;
      EI_Q greedy-EI candidates from the float64 fit (EI), EI_TURN_Q in
      the turns;
      the decode of 50 latents x 100 attempts (DECODE, the generator
      registered), types, adj and nv;
      the surrogate's 400 train steps (enas_eval FIT) and its predictions
      on the validation rows (PREDICT), against its eager build's.
    On the CPU (a rehearsal) the captured forms call the step functions
    directly and nothing is timed."""
    from dagnn_tpu_torch.cli import run_bo
    from dagnn_tpu_torch.vae import dvae, enas_eval, sparse_gp as T
    from dagnn_tpu_torch.vae.dagnn_vae import dagnn_vae_decode
    t_all = time.perf_counter()
    X_tr, y_tr, *_ = run_bo.load_latents(mat)
    Xh = np.asarray(X_tr, np.float64)
    yh = np.asarray(y_tr, np.float64).reshape(-1)
    pad = len(Xh) + pad_rounds * 50
    out = {}

    def counted(prog, fn):
        c0, r0 = prog.captures, prog.replays
        t0 = time.perf_counter()
        res = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        s = time.perf_counter() - t0
        return res, s, (prog.captures - c0, prog.replays - r0)

    fits = {}
    for dt in (torch.float32, torch.float64):
        label = f"[21e fit {short(dt)}]"
        fit = lambda capture: T._adam_fit(
            *T._fit_problem(Xh, yh, 500, 0, pad, dt, dev), GP_ITERS, GP_LR, capture)
        (pe, le), eager_s, _ = counted(T.FIT, lambda: fit(False))
        res = {"eager_s": eager_s, "loss": float(le)}
        (pc, lc), first_s, (c1, r1) = counted(T.FIT, lambda: fit(True))
        _, again_s, (c2, r2) = counted(T.FIT, lambda: fit(True))
        same = _same_bits(pc, pe) and _same_bits(lc, le)
        print(f"{label} one Adam step a graph: the parameters and last loss "
              f"({float(lc):.6g}) bit for bit eager's: {same}; first fit {first_s:.3f} s "
              f"({c1} capture, {r1} replays), next {again_s:.3f} s ({c2} captures, "
              f"{r2} replays); eager {eager_s:.3f} s")
        check(same and c2 == 0 and r2 == GP_ITERS,
              f"{label}: the captured fit differs from eager's or recaptured")
        res["step"] = {"first_s": first_s, "next_s": again_s, "captures": c1 + c2,
                       "replays": r1 + r2}
        res["turns"] = _form_turns(label, dev, lambda c: lambda: fit(c))
        fits[short(dt)] = res
    # every fit at M 500 ends in float64 (the float32 one went NaN in each
    # card run): its captured fit profiled, and the EI from its parameters
    fits["float64"]["profile"] = _profile_top(label, lambda: fit(True))
    gp64 = T.SparseGP(pc, torch.as_tensor(Xh, device=dev), torch.as_tensor(yh, device=dev))
    out["fit"] = fits

    label = "[21e EI]"
    ei = lambda capture, q=EI_Q: T.batched_greedy_ei(
        gp64, q, Xh.min(0), Xh.max(0), Xh.mean(0), Xh.std(0), seed=0, capture=capture)
    ce, eager_s, _ = counted(T.EI, lambda: ei(False))
    cc, first_s, (c1, r1) = counted(T.EI, lambda: ei(True))
    same = _same_bits(cc, ce)
    print(f"{label} {EI_Q} candidates of a float64 round (grid 10,000, 50 refinement "
          f"steps) bit for bit eager's: {same}; eager {eager_s:.3f} s, captured "
          f"{first_s:.3f} s with its capture ({c1} capture, {r1} replays)")
    check(same and r1 == EI_Q, f"{label}: the captured candidates differ from eager's")
    out["ei"] = {"eager_s": eager_s, "first_s": first_s, "captures": c1, "replays": r1,
                 "turns": _form_turns(label, dev, lambda c: lambda: ei(c, EI_TURN_Q)),
                 "profile": _profile_top(label, lambda: ei(True))}

    label = "[21e decode]"
    cfg, params = run_bo.load_model(run_bo.parse_args(["--latent", mat, *model_flags]), dev)
    z = torch.as_tensor(X_tr[:50], dtype=torch.float32, device=dev).repeat(100, 1)
    gen = torch.Generator(device=dev)

    def decode(capture):
        def call():
            gen.manual_seed(0)
            return dagnn_vae_decode(params, cfg, z, gen, capture=capture)
        return call

    de, eager_s, _ = counted(dvae.DECODE, decode(False))
    dc, first_s, (c1, r1) = counted(dvae.DECODE, decode(True))
    same = all(np.array_equal(a, b) for a, b in zip(dc, de))
    print(f"{label} {z.shape[0]} latents (50 x 100 attempts): types, adj and nv equal "
          f"to eager's from one generator seed: {same} ({int(dc[2].sum())} vertices); "
          f"eager {eager_s:.3f} s, captured {first_s:.3f} s with its capture ({c1} "
          f"capture, {r1} replay)")
    check(same and (c1, r1) == (1, 1), f"{label}: the captured decode differs from eager's")
    out["decode"] = {"eager_s": eager_s, "first_s": first_s,
                     "turns": _form_turns(label, dev, decode)}

    label = "[21e surrogate]"
    t0 = time.perf_counter()
    # built eagerly: its 400 epochs from init_params(seed 0) are the eager
    # reference
    ev = enas_eval.EvalENAS(corpus or run_bo.parse_args(["--latent", mat]).enas_corpus,
                            device=dev, capture=False)
    pe, ye = ev._params, ev.predict(ev.split[2])
    build_s = time.perf_counter() - t0
    d = ev.split[0].shape[1]

    def surrogate(capture):
        def call():
            ev.capture = capture
            ev._fit(*ev.split, ev.init_params(d, 256, 0), 400)
            return ev._params, ev.predict(ev.split[2])
        return call

    (pc, yc), first_s, (c1, r1) = counted(enas_eval.FIT, surrogate(True))
    same = _same_bits(pc, pe) and np.array_equal(yc, ye)
    print(f"{label} 400 epochs on {ev.split[0].shape[0]} rows: the parameters and the "
          f"{len(ye)} validation predictions bit for bit the eager build's ({build_s:.3f} "
          f"s with the corpus): {same}; captured {first_s:.3f} s with its capture ({c1} "
          f"capture, {r1} replays)")
    check(same and r1 == 400, f"{label}: the captured surrogate differs from eager's")
    out["surrogate"] = {"first_s": first_s, "build_s": build_s,
                        "turns": _form_turns(label, dev, surrogate)}
    out["wall_s"] = time.perf_counter() - t_all
    print(f"[21e] {card}: 21e took {out['wall_s']:.1f} s")
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
        made, make = [], tv.make_captured_step
        tv.make_captured_step = lambda step: made.append(make(step)) or made[-1]
        try:
            with vae_probes() as seen:
                tv.main(argv)
        finally:
            tv.make_captured_step = make
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
        # the captured run's first epoch, which 26b holds an all-eager epoch to
        first = dict(rows=rows[:1], epoch_s=seen["epochs"][:1],
                     params=torch.load(f"{root}/{tag}/{m}_0_1.ckpt",
                                       weights_only=True)["params"],
                     captures=made[0].captures if made else 0,
                     replays=made[0].replays if made else 0)
        out[tag] = dict(launches=lc, rows=rows, epoch_s=seen["epochs"],
                        loss_rel=e_loss, norm_rel=e_norm, worst=(worst, ratio[worst]),
                        float64_leaves=f64, first_epoch=first)
    res = f"{root}/bo_svae"
    run_bo.main(["--latent", f"{root}/svae/final_structures6_latent_epoch2.mat",
                 "--seeds", "1", *GP_FLAGS, "--res_dir", res])
    rows = _rmse_rows(res)
    print(f"[21d] run_bo GP only on SVAE's latents: {rows}")
    check(len(rows) == 1 and np.isfinite(rows).all(), "GP on SVAE's latents not finite")
    out["svae_gp"] = rows
    return out


def phase_latent_scoring(dev, card, root):
    """Phase 21, on phase 20's files in `root`: 21a, 21b, 21e, 21c, 21d.
    K1-K7 launch in none of it but 21c's encoder (the DAGNN's K6 inference
    passes). run_bo's graphs are freed after it."""
    from dagnn_tpu_torch.cli import run_bo
    mat = f"{root}/C/final_structures6_latent_epoch3.mat"
    gp = phase_gp(dev, card, root, mat)
    bo = phase_bo_rounds(card, root)
    print("[21e] run_bo's captured programs against their eager forms at its "
          "defaults on run C's files")
    bo_graphs = phase_bo_graphs(dev, card, mat, ["--checkpoint", f"{root}/C/DAGNN_0_3.ckpt",
                                                 *_widths(NA_FLAGS)])
    corpus = phase_gp_corpus(dev, card, root)
    others = phase_other_vaes(dev, card, root)
    run_bo.release_graphs()
    return dict(gp=gp, bo=bo, bo_graphs=bo_graphs, corpus=corpus, other_vaes=others)


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


def baseline_cfg(gnn, task, data):
    """The config of `gnn` at the driver's defaults on phase 18's corpus
    `data` (load_dataset's)."""
    from dagnn_tpu_torch.cli import main_lp, ogb_driver
    p = main_lp.parser() if task == "lp" else ogb_driver.add_common_args(
        argparse.ArgumentParser())
    args = p.parse_args(DRIVER_FLAGS + ["--gnn", gnn])
    args.num_vocab = len(data[3]) - 2
    return ogb_driver.build_model_cfg(args, task)


def baseline_hosts(data, n=1):
    """The first n host batches of the driver's train loader for the
    baselines (DAGLoader(schedules=False), batch 160, one bucket for the
    epoch) on `data`."""
    from dagnn_tpu_torch.data.dataloader import DAGLoader
    loader = DAGLoader(data[0], 160, shuffle=True, seed=1, chunk_size=256,
                       prefetch=0, schedules=False)
    return [b for b, _ in zip(loader, range(n))]


def baseline_setup(gnn, task, data):
    """(config, the train loader's batch 0 on the host) of `gnn` at the
    driver's defaults on phase 18's corpus `data` (load_dataset's)."""
    return baseline_cfg(gnn, task, data), baseline_hosts(data)[0]


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


# --------------------------------------------- the parallel layer (phase 23)

SHARED = "ranks share one card"


def _leaf_gate(label, got, want, truth, tol, what, group=None):
    """got / want gradient dicts of numpy arrays: each leaf within `tol`
    (STEP_TOL's relative leaf gate, or CROSS_TOL's rtol / atol), the
    elements that are zero in exact arithmetic (|truth| <= checks.ZERO x
    the tree's max) within NOISE_TOL of want's noise; after `group`, if
    given, as phase_step applies it (checks.score_linears: each attention
    score's bias measured with its weight). Returns the worst."""
    from dagnn_tpu_torch import checks
    if group is not None:
        got, want, truth = group(got), group(want), group(truth)
    tmax = checks.tree_max(truth)
    rows = []
    for k in want:
        a, b, t = (np.asarray(x[k], np.float32) for x in (got, want, truth))
        rel, ab, scale, noise = checks.grad_err(a, b, t, tmax)
        if "rtol" in tol:
            live = np.abs(t) > checks.ZERO * tmax
            ratio = float((np.abs(a - b)[live] / (tol["atol"] + tol["rtol"] * np.abs(b)[live])
                           ).max(initial=0.0))
            ok = ratio <= 1.0 and noise <= NOISE_TOL
            rows.append((ratio, noise, ok, k))
        else:
            rows.append((rel, noise, rel <= tol["leaf"] and noise <= NOISE_TOL, k))
    rows.sort(reverse=True)
    worst = rows[0]
    gate = (f"rtol {tol['rtol']:g} / atol {tol['atol']:g}" if "rtol" in tol
            else f"{tol['leaf']:g} of max|ref|")
    print(f"{label} {what}: {len(rows)} leaves, worst {worst[3]} {worst[0]:.3g} "
          f"(gate {gate}), worst noise {max(r[1] for r in rows):.3g} "
          f"(gate {NOISE_TOL:g})")
    bad = [r[3] for r in rows if not r[2]]
    check(not bad, f"{what}: leaves past the gate: {bad}")
    return {"worst": worst[3], "value": worst[0], "noise": max(r[1] for r in rows)}


def _scalar_gate(label, what, got, want, tol=STEP_TOL["loss"]):
    rel = abs(got - want) / abs(want)
    print(f"{label} {what}: {got:.7f} vs {want:.7f} (rel {rel:.2e}, gate {tol:g})")
    check(rel <= tol, f"{what}: {got} vs {want}")
    return rel


def _norm(grads):
    return float(np.sqrt(sum(float((np.asarray(g, np.float64) ** 2).sum())
                             for g in grads.values())))


def _np_grads(g):
    return {k: v.detach().float().cpu().numpy() for k, v in g.items()}


def nccl_world_one(label, dev, card, cfg, params, graphs, serve_one):
    """The DP step at world size 1 over NCCL (gloo for a CPU rehearsal) in
    this process: one step (make_dp_train_step's default form: captured
    over NCCL) bitwise equal to the single-process step (loss_and_grads,
    the optimizer's update, params + updates); then, on the same group,
    23e (parallel_graphs) and `serve_one` (SharedWorlds.serve_one:
    bench_scaling's 1-rank run, served on this group)."""
    import tempfile
    import torch.distributed as dist
    from dagnn_tpu_torch import flagship
    from dagnn_tpu_torch.parallel import comm
    from dagnn_tpu_torch.parallel.dp import collate_sharded, make_dp_train_step
    from dagnn_tpu_torch.parallel.jobs import loss_of
    from dagnn_tpu_torch.parallel.mesh import make_mesh, release_graphs
    from dagnn_tpu_torch.nn.dagnn import KERNELS, dagnn_forward
    from dagnn_tpu_torch.train.optim import make_optimizer
    store = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"file://{store}/store", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(None, ("dp",))
        head = loss_of("tok")

        def loss_fn(p, b, rng):
            return head(dagnn_forward(p, cfg, b),
                        {k: torch.as_tensor(v, device=dev) for k, v in b.y.items()},
                        torch.as_tensor(b.graph_mask, device=dev))

        opt = make_optimizer()
        step = make_dp_train_step(loss_fn, opt, mesh.groups["dp"])
        batch = step.shard(collate_sharded(graphs, 1, flagship.pad_for(graphs)), dev)
        route = comm.route(mesh.groups["dp"])
        comm.reset_issued()
        p1, _, loss1 = step(params, opt.init(params), batch)
        issued = dict(comm.issued)
        print(f"{label} {backend}, world size 1: the step ({step.form}): its collectives "
              f"by route {issued} (its one all-reduce of the flat gradient buffer)")
        check(issued == {**{k: 0 for k in issued}, route: 1},
              f"the world-size-1 step issued {issued}, not one {route} collective")
        l0, g0, _ = loss_and_grads(params, cfg, batch, KERNELS)
        _, g1 = step.grads(params, batch)
        diff = [k for k in g0 if not torch.equal(g0[k], g1[k])]
        print(f"{label} the world-size-1 DP gradients bitwise the single "
              f"process's: {not diff} {diff[:4]}")
        with torch.no_grad():
            u, _ = opt.update(g0, opt.init(params))
            p0 = {k: params[k] + u[k] for k in params}
        same = all(torch.equal(p1[k], p0[k]) for k in params)
        print(f"{label} {backend}, world size 1 ({route} route): one DP step, loss "
              f"{float(loss1):.7f} vs {l0:.7f}; parameters bitwise equal to the "
              f"single-process step: {same}")
        check(same and float(loss1) == l0, "the NCCL world-size-1 step differs "
              "from the single-process step")
        del step, p1
        out = {"route": route, "bitwise": same, "issued": issued}
        print(f"[23e] the DP and EP steps at world size 1 over {backend}, captured "
              f"against eager")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_23e_") as tmp:
            out["graphs"] = parallel_graphs(dev, card, cfg, params, tmp)
        t0 = time.perf_counter()
        serve_one(dev)
        out["bench_s"] = time.perf_counter() - t0
    finally:
        release_graphs()
        dist.destroy_process_group()
    return out


# 23e: steps each form runs from the same weights (held bit for bit), and
# steps a turn of its timed steps (in turns a b b a) by kind
FORM_STEPS, PAR_TURN_STEPS = 3, {"dp": 3, "ep": 1}
# K2's kernels other than seg_merge: each launched once a layer a row
K2_PER_LAYER = ("rebuild_kernel", "gru_bwd_elem_kernel", "gemm_nn_kernel",
                "attn_bwd_kernel", "wgrad_kernel", "small_reduce_kernel")


def parallel_graphs(dev, card, cfg, params, out_dir):
    """23e, on the caller's world-size-1 group (NCCL on the card): the DP
    step (merged, K1/K2) and the EP step (D = 1, scan rows 64, the generic
    branch: K6, K5) at cfg's widths from `params` on cli.bench_scaling's
    workload (64 synthetic ASTs of mean 80 nodes; its dp_setup /
    ep_setup), each in
    make_*_train_step's default form (captured over NCCL: one CUDA graph,
    recorded in debug mode) against its eager form (capture=False):
    FORM_STEPS steps each from the same weights bit for bit (the loss,
    every parameter and optimizer leaf, comm.issued, the wrappers' launch
    counts with a replay counted as its capture), one capture and a replay
    a step; what a replay launches read from the graph itself
    (graphs.graph_nodes): DP K1's attn_fwd / gru_fwd a layer a row of the
    shard, K2's seg_merge a row and its other kernels a layer a row; EP
    sa_fwd / sa_bwd / seg_merge at _ep_counts of the plan's rows; the
    graph's NCCL kernels (none at one rank, where NCCL reduces in place
    without a kernel: the collectives are held by comm.issued); then
    eager against captured in turns a b b a (CUDA events) and a replay's
    busy share. On the CPU (a rehearsal) the captured form stages and
    nothing is captured or timed."""
    from dagnn_tpu_torch.cli import bench_scaling
    from dagnn_tpu_torch.data.synthetic import synthetic_ast_batch
    from dagnn_tpu_torch.parallel import jobs
    from dagnn_tpu_torch.train import graphs as tg
    from dagnn_tpu_torch.train.optim import make_optimizer
    t_all = time.perf_counter()
    graphs = synthetic_ast_batch(0, 64, mean_nodes=80)
    n_edges = sum(g.num_edges for g in graphs)
    nl = cfg.num_layers
    opt = make_optimizer()
    out = {}
    for kind, setup in (("dp", bench_scaling.dp_setup), ("ep", bench_scaling.ep_setup)):
        t0 = time.perf_counter()
        label = f"[23e {kind.upper()} x1]"
        make, inputs, _ = setup(dev, cfg, graphs, opt)
        steps = {"captured": make(), "eager": make(False)}
        cap = steps["captured"]
        if dev.type == "cuda":
            check(cap.form == "captured", f"{label} the default step over NCCL is {cap.form}")
        cap.captured.debug = True
        runs, counts, parts = {}, {}, {"set-up": time.perf_counter() - t0}
        for f, st in steps.items():
            t1 = time.perf_counter()
            reset_counts()
            runs.update(jobs.run_forms({f: st}, params, opt, inputs, FORM_STEPS))
            counts[f] = {k: v for k, v in read_counts().items() if v}
            parts[f] = time.perf_counter() - t1
        same = all(runs["captured"][k] == runs["eager"][k]
                   for k in ("losses", "params", "state", "issued"))
        print(f"{label} {cap.form}, {FORM_STEPS} steps against {FORM_STEPS} eager from "
              f"the same weights, losses {runs['captured']['losses']} / "
              f"{runs['eager']['losses']}; the loss, every parameter and Adam leaf and "
              f"the collectives ({runs['captured']['issued']}) bit for bit: {same}; "
              f"captures {cap.captured.captures}, replays {cap.captured.replays}")
        check(same, f"{label}: the captured step differs from the eager one")
        print(f"{label} launches over the {FORM_STEPS} steps, eager {counts['eager']}, "
              f"replays {counts['captured']}")
        check(counts["captured"] == counts["eager"]
              and (cap.captured.captures, cap.captured.replays) == (1, FORM_STEPS),
              f"{label}: the replays' counted launches or captures differ")
        if kind == "dp":
            L = int(inputs.fwd.node_ids.shape[0])
            launches = {"row_forward": L, "row_backward": L}
            want = {"attn_fwd_kernel": nl * L, "gru_fwd_kernel": nl * L,
                    "seg_merge_kernel": L, **{k: nl * L for k in K2_PER_LAYER}}
        else:
            launches = _ep_counts([st.rows for st in inputs.statics], nl)
            want = {ONE_KERNEL[k]: v for k, v in launches.items()}
        one = {k: v // FORM_STEPS for k, v in counts["eager"].items()}
        if dev.type == "cuda":        # a CPU rehearsal launches no kernel
            check(one == launches, f"{label}: an eager step launched {one}, not "
                  f"the rows' {launches}")
        res = {"bitwise": same, "losses": runs["captured"]["losses"],
               "issued": runs["captured"]["issued"], "launches": counts["captured"],
               "form": cap.form}
        if dev.type == "cuda":
            t1 = time.perf_counter()
            nodes = node_kinds(tg.graph_nodes(cap.captured.last_graph()))
            parts["nodes"] = time.perf_counter() - t1
            got = {k: nodes.get(k, 0) for k in want}
            nccl = {k: v for k, v in nodes.items() if "nccl" in k.lower()}
            print(f"{label} the graph's nodes: {sum(v for k, v in nodes.items() if not _is_copy(k))} "
                  f"kernels, {sum(v for k, v in nodes.items() if _is_copy(k))} copies and sets; "
                  f"the port's kernels among them {got}, from the plan's rows {want}; NCCL's "
                  f"kernels {nccl or 'none (one rank: an in-place sum runs no kernel)'}")
            check(got == want, f"{label}: the graph's kernel nodes differ from the rows'")
            chained = {f: bench_scaling._chained(st, params, opt, inputs)
                       for f, st in steps.items()}
            t1 = time.perf_counter()
            # the replay's state copied in outside the turns (the eager
            # step ran its FORM_STEPS steps already)
            chained["captured"]()
            turns = timed_turns(label, chained, PAR_TURN_STEPS[kind])
            parts["turns"] = time.perf_counter() - t1
            t1 = time.perf_counter()
            busy = replay_busy(label, chained["captured"], out_dir)
            parts["busy"] = time.perf_counter() - t1
            res.update(nodes=dict(nodes), nccl_nodes=nccl, turns=turns,
                       busy_share=busy["share"], replay_events=busy["events"],
                       edges_per_s={f: n_edges / (sum(t["ms"] for t in turns[f]) / 2e3)
                                    for f in steps})
        res["wall_s"] = time.perf_counter() - t0
        print(f"{label} took {res['wall_s']:.1f} s ("
              + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()) + ")")
        out[kind] = res
    out["wall_s"] = time.perf_counter() - t_all
    print(f"[23e] {card}: 23e took {out['wall_s']:.1f} s")
    return out


def _ep_counts(rows, nl):
    """One EP train pass's launches on a rank: per row of each direction, K6
    forward once a layer and once more in the replay, K6 backward once a
    layer, K5 three times (own columns, halo blocks, returned blocks)."""
    r = sum(rows)
    return {"segment_attn_forward": 2 * nl * r, "segment_attn_backward": nl * r,
            "tg_accumulate": 3 * r}


def _ep_probe(D, res, counted):
    """23c's kernels against their plain versions at the EP rank's own
    shapes: every K6 forward / backward and K5 call of each rank's probe
    pass (jobs.ep_job's checks.KernelProbe, run after the launches were
    read) beside the plain version on the same card tensors, at phase 3's
    tolerance TOL, each call on its own max|plain| floored at checks.ZERO
    x the pass's largest (KernelProbe). The probe holds as many calls as
    the counted pass launched, and computes the same gradients bit for
    bit."""
    from dagnn_tpu_torch import checks
    names = ("segment_attn_forward", "segment_attn_backward", "tg_accumulate")
    worst = {}
    for j, dt in ((-2, torch.float32), (-1, torch.bfloat16)):
        for r in res:
            pr = r[j]["probe"]
            check(pr["grads_digest"] == r[j]["grads_digest"],
                  f"D={D} rank {r[j]['rank']}: the probe pass computed other gradients")
            for name in names:
                if counted:
                    check(pr[name]["calls"] == r[j]["counts"][name],
                          f"D={D} {name}: the probe held {pr[name]['calls']} calls, "
                          f"the pass launched {r[j]['counts'][name]}")
        for name in names:
            worst[(short(dt), name)] = checks.worst_call([r[j]["probe"][name] for r in res])
        for name in names:
            p = worst[(short(dt), name)]
            print(f"[23c] D={D} {short(dt)} {name} on the EP ranks vs plain, every "
                  f"call ({p['calls']} a rank, {p['shapes']} shapes): max_abs_err "
                  f"{p['max_abs_err']:.3e}; the worst call on its max|plain| (floor "
                  f"{checks.ZERO:g} x the pass's largest, {p['floor']:.3e}): shape "
                  f"{p['shape']} output {p['output']}, {p['err']:.3e} of "
                  f"{p['scale']:.3e} = {p['rel']:.3e} (tolerance {TOL[dt]:g})")
            check(p["rel"] <= TOL[dt], f"D={D} {short(dt)} {name}: the kernel "
                  f"disagrees with plain at the EP shapes ({p['rel']:.3e})")
    return {f"{dt} {name}": {k: p[k] for k in ("rel", "err", "scale", "floor", "shape",
                                                "output", "max_abs_err")}
            for (dt, name), p in worst.items()}


def parallel_refs(dev, cfg, params, stacked, ep_batches):
    """Phase 23's single-rank references, in this process: {"dp": 23b's
    (the mean of the two shards' loss and grads through the kernels, the
    same through the plain step, the f32 truth of the bf16 weights' grads,
    a shard's merged rows), "ep": {D: 23c's (the single-rank generic step
    through the plain K6 / K5: f32 loss and grads, bf16 loss and grads, the
    f32 truth of the bf16 weights' grads)}}, the grads as numpy."""
    from dagnn_tpu_torch.convert import batch_to_torch
    from dagnn_tpu_torch.nn.dagnn import KERNELS, PLAIN, SEG_PLAIN
    from dagnn_tpu_torch.parallel.dp import shard_of
    shards = [batch_to_torch(shard_of(stacked, i), dev) for i in range(2)]
    ref = [loss_and_grads(params, cfg, b, KERNELS) for b in shards]
    ref_l = (ref[0][0] + ref[1][0]) / 2
    ref_g = {k: (ref[0][1][k].float() + ref[1][1][k].float()) / 2 for k in ref[0][1]}
    plain = [loss_and_grads(params, cfg, b, PLAIN) for b in shards]
    plain_l = (plain[0][0] + plain[1][0]) / 2
    plain_g = {k: (plain[0][1][k].float() + plain[1][1][k].float()) / 2 for k in ref_g}
    as_bf16 = {k: v.to(torch.bfloat16).float() for k, v in params.items()}
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    truth = [loss_and_grads(as_bf16, cfg32, b, PLAIN) for b in shards]
    truth_g = _np_grads({k: (truth[0][1][k] + truth[1][1][k]) / 2 for k in ref_g})
    out = {"dp": (ref_l, ref_g, plain_l, plain_g, truth_g, shards[0].fwd), "ep": {}}
    cfg_p = dataclasses.replace(cfg, segment_impl="pallas")
    cfg_p32 = dataclasses.replace(cfg_p, compute_dtype="float32")
    for D, batch in ep_batches.items():
        b = batch_to_torch(batch, dev)
        # the single-rank step through the plain versions of K6 and K5
        l32, g32, _ = loss_and_grads(params, cfg_p32, b, SEG_PLAIN)
        l16, g16, _ = loss_and_grads(params, cfg_p, b, SEG_PLAIN)
        _, t16, _ = loss_and_grads(as_bf16, cfg_p32, b, SEG_PLAIN)
        out["ep"][D] = (l32, _np_grads(g32), l16, _np_grads(g16), _np_grads(t16))
    return out


class SharedWorlds:
    """A spawn with parallel.mesh.spawn's signature, for the CLIs' own
    mains (cli.dryrun, cli.bench_scaling) inside phase 23: each call's
    jobs join the phase's jobs of its world size, and a world of gloo
    ranks starts once every call it waits for (`joiners`, by world size)
    has joined, with the least timeout they ask for: one process start a
    rank in all. A one-rank call is served on the caller's own
    world-size-1 group instead (serve_one), where no process starts. A
    call's multi-rank results reach it only after release(): the worlds
    may run beside other phases, and the calls' own checks (the dry run's
    references) launch kernels in this process, which those phases
    count."""

    def __init__(self, todo, joiners, device):
        import queue
        import threading
        self.todo = {n: list(j) for n, j in todo.items()}
        self.left, self.device = dict(joiners), device
        self.timeout = {n: 900.0 for n in todo}
        self.lock = threading.Lock()
        self.started = {n: threading.Event() for n in todo}
        self.done = {n: threading.Event() for n in todo}
        self.released = threading.Event()
        self.results, self.errors, self.seconds = {}, {}, {}
        self.one, self.closed = queue.Queue(), False

    def __call__(self, fn, world, backend=None, device="cuda", store_dir=None,
                 timeout=300.0, args=()):
        import inspect
        from concurrent.futures import Future
        from dagnn_tpu_torch.parallel import jobs
        names = list(inspect.signature(fn).parameters)[1:]
        mine = (list(args[0]) if fn is jobs.run_jobs
                else [(fn, dict(zip(names, args)))])
        if world == 1:
            fut = Future()
            with self.lock:
                check(not self.closed, "a one-rank run asked for after phase 23")
                self.one.put((mine[0], fut))
            return [fut.result(timeout=timeout)]
        check(backend in (None, "gloo"), f"a {world}-rank world on {backend}")
        with self.lock:
            start = len(self.todo[world])
            self.todo[world] += mine
            self.timeout[world] = min(self.timeout[world], timeout)
            self.left[world] -= 1
            go = self.left[world] == 0
        if go:
            self._start(world)
        res = self.wait(world)
        self.released.wait()
        check(not self.closed, f"the {world}-rank world's results asked for after "
              f"phase 23")
        part = [r[start:start + len(mine)] for r in res]
        return part if fn is jobs.run_jobs else [p[0] for p in part]

    def _start(self, world):
        from dagnn_tpu_torch.parallel import jobs
        from dagnn_tpu_torch.parallel.mesh import spawn
        t0 = time.perf_counter()
        self.started[world].set()
        try:
            self.results[world] = spawn(jobs.run_jobs, world, "gloo", self.device,
                                        timeout=self.timeout[world],
                                        args=(self.todo[world],))
        except Exception as e:
            self.errors[world] = e
        finally:
            self.seconds[world] = time.perf_counter() - t0
            self.done[world].set()

    def wait(self, world, callers=()):
        """The world's results, every rank's job results in order; raises
        what a call of `callers` (futures) raised before its world began."""
        while not self.done[world].wait(1.0):
            for f in callers:
                if f.done() and f.exception() is not None:
                    raise f.exception()
        if world in self.errors:
            raise self.errors[world]
        return self.results[world]

    def serve_one(self, dev, timeout=600.0):
        """Run the one-rank call waiting (its job, on this process's
        world-size-1 group); its result."""
        (fn, kw), fut = self.one.get(timeout=timeout)
        try:
            fut.set_result(fn(dev, **kw))
        except BaseException as e:
            fut.set_exception(e)
            raise
        return fut.result()

    def release(self):
        """Hand the worlds' results to the calls waiting for them."""
        self.released.set()

    def close(self):
        """Fail a one-rank call still waiting (the phase ended first), and
        a call still waiting for its world's results."""
        with self.lock:
            self.closed = True
            while not self.one.empty():
                self.one.get()[1].set_exception(SmokeFailure("phase 23 ended"))
        self.released.set()


def start_parallel(dev, graphs, params, cfg, bench_argv=()):
    """Phase 23's two gloo spawns (2 and 4 ranks), started: its own jobs
    and those of 23a's dry runs and 23d's bench_scaling (their CLIs' mains
    in threads, given a SharedWorlds). Returns once both worlds have
    started, so that no thread of this process is left doing device work;
    the worlds then run in their own processes, and their results wait
    for phase_parallel (SharedWorlds.release). On a CPU device the ranks
    run on the CPU (`bench_argv`: bench_scaling's size flags for it)."""
    from concurrent.futures import ThreadPoolExecutor
    from dagnn_tpu_torch import flagship
    from dagnn_tpu_torch.cli import bench_scaling, dryrun
    from dagnn_tpu_torch.dag.batch import collate
    from dagnn_tpu_torch.parallel import jobs
    from dagnn_tpu_torch.parallel.dp import collate_sharded
    from dagnn_tpu_torch.scripts import ep_overlap_report as overlap
    device = dev.type
    cpu = ["--cpu"] if device == "cpu" else []
    if device == "cuda":
        torch.cuda.empty_cache()
    t_all = time.perf_counter()
    cfg_p = dataclasses.replace(cfg, segment_impl="pallas")
    cfg_p32 = dataclasses.replace(cfg_p, compute_dtype="float32")
    pnp = {k: v.detach().cpu().numpy() for k, v in params.items()}
    stacked = collate_sharded(graphs, 2, flagship.pad_for(graphs, n_shards=2))
    ep_batches = {}
    for D in (2, 4):
        chunk = 64 * D
        ep_batches[D] = collate(graphs, dataclasses.replace(
            flagship.pad_for(graphs, chunk=chunk), nodes_per_level=chunk))
    ep_jobs = lambda D: [
        (jobs.ep_job, dict(cfg=cfg_p32, params_np=pnp, batches=[ep_batches[D]],
                           mesh_shape=(1, D), probe=True)),
        (jobs.ep_job, dict(cfg=cfg_p, params_np=pnp, batches=[ep_batches[D]],
                           mesh_shape=(1, D), probe=True, orders=D == 4))]
    todo = {2: [(jobs.dp_job, dict(cfg=cfg, params_np=pnp, stacked=stacked, steps=3))]
            + ep_jobs(2) + [(overlap.trace_job, dict(
                cfg=cfg_p, params_np=pnp, batch=ep_batches[2], mesh_shape=(1, 2),
                warmup=False, backward=False))],
            4: ep_jobs(4)}
    own = {n: len(todo[n]) for n in todo}
    # 23a's dry runs and 23d's bench_scaling are their CLIs' mains: their
    # multi-rank jobs join these two worlds (the 2-rank world waits for
    # cli.dryrun --ranks 2 and bench_scaling's 2-rank run, the 4-rank one
    # for cli.dryrun --ranks 4), bench_scaling's 1-rank run waits for the
    # world-size-1 group of 23e
    worlds = SharedWorlds(todo, {2: 2, 4: 1}, device)
    pool = ThreadPoolExecutor(3)
    dry = {n: pool.submit(dryrun.main, ["--ranks", str(n), "--timeout", "900",
                                        *cpu], worlds) for n in (2, 4)}
    bench = pool.submit(bench_scaling.main, ["--devices", "2", "--iters", "1",
                                             *cpu, *bench_argv], worlds)
    callers = [*dry.values(), bench]
    try:
        while not all(e.is_set() for e in worlds.started.values()):
            for f in callers:
                if f.done() and f.exception() is not None:
                    raise f.exception()
            time.sleep(0.05)
    except BaseException:
        worlds.close()
        pool.shutdown(wait=False, cancel_futures=True)
        raise
    return dict(worlds=worlds, pool=pool, dry=dry, bench=bench, own=own,
                stacked=stacked, ep_batches=ep_batches, t0=t_all)


def phase_parallel(dev, card, graphs, params, cfg, bench_argv=(), started=None):
    """Phase 23: the parallel layer at cfg's widths (the flagship's) on
    `graphs` (phase 4's batch), D ranks on this one card (gloo: the host
    route). `started`: start_parallel's worlds, started beside earlier
    phases; else they start here. On a CPU device it rehearses the same
    calls with gloo ranks on the CPU (`bench_argv`: bench_scaling's size
    flags for it)."""
    from dagnn_tpu_torch.parallel.mesh import default_backend
    out, device = {}, dev.type
    t_all = time.perf_counter()
    st = started or start_parallel(dev, graphs, params, cfg, bench_argv)
    worlds, pool, dry, bench, own = (st[k] for k in ("worlds", "pool", "dry", "bench",
                                                    "own"))
    stacked, ep_batches = st["stacked"], st["ep_batches"]
    try:
        # the dry runs' checks run in their threads once released, beside
        # this process's single-rank references
        worlds.release()
        t0 = time.perf_counter()
        refs = parallel_refs(dev, cfg, params, stacked, ep_batches)
        t_refs = time.perf_counter() - t0
        t0 = time.perf_counter()
        res2, res4 = ([r[:own[n]] for r in worlds.wait(n, [*dry.values(), bench])]
                      for n in (2, 4))
        t_wait = time.perf_counter() - t0
        t_spawn2, t_spawn4 = worlds.seconds[2], worlds.seconds[4]
        for n in (2, 4):
            backend = default_backend(n, device)
            print(f"[23a] the dry run at {n} ranks ({backend}: {SHARED}), "
                  f"dryrun.main with its jobs in the {n}-rank spawn:")
            try:
                got = dry[n].result()
            except AssertionError as e:
                check(False, f"the dry run at {n} ranks: {e}")
            passes = 2 + ("dp_ep_loss" in got)
            check(passes == (3 if n >= 4 else 2),
                  f"the dry run at {n} ranks: {passes} checks")
            print(f"[23a] {passes} of the JAX dry run's checks passed at {n} ranks")
            out[f"dryrun_{n}"] = passes
        parallel_checks(out, res2, res4, refs, ep_batches, cfg, device, card)
        print(f"[23] spawns, at once: 2 ranks {t_spawn2:.1f} s, 4 ranks "
              f"{t_spawn4:.1f} s, started {t_all - st['t0']:.1f} s before this "
              f"phase; the single-rank references {t_refs:.1f} s, then "
              f"{t_wait:.1f} s waiting for the spawns")
        out["spawn_s"] = {2: t_spawn2, 4: t_spawn4}
        out["dp"]["nccl"] = nccl_world_one("[23b]", dev, card, cfg, params, graphs,
                                           worlds.serve_one)
        out["graphs"] = out["dp"]["nccl"].pop("graphs")
        print(f"[23d] cli.bench_scaling.main --devices 2 --iters 1 ({SHARED}): its "
              f"2-rank run in the 2-rank spawn, its 1-rank run in this process's "
              f"world-size-1 group ({out['dp']['nccl']['bench_s']:.1f} s)")
        out["bench_scaling"] = bench.result(timeout=600)
    finally:
        worlds.close()
        pool.shutdown(wait=False, cancel_futures=True)
    out["wall_s"] = time.perf_counter() - t_all
    print(f"[23] {card}: phase 23 took {out['wall_s']:.1f} s")
    return out


def parallel_checks(out, res2, res4, refs, ep_batches, cfg, device, card):
    """23b and 23c: the phase's own jobs of the two worlds against the
    single-rank references."""
    from dagnn_tpu_torch import checks
    from dagnn_tpu_torch.parallel import jobs
    from dagnn_tpu_torch.scripts import ep_overlap_report as overlap
    nl = cfg.num_layers
    # 23b: data parallel, 2 ranks, bf16, the merged path
    dp = [r[0] for r in res2]
    print(f"[23b] DP, 2 ranks ({dp[0]['route']} route, {SHARED}; the step "
          f"{dp[0]['form']}), bf16 merged path, "
          f"split_by_nodes of phase 4's batch: rows {dp[0]['rows']} a shard; step "
          f"s {' / '.join(f'{s:.4f}' for s in dp[0]['step_s'])} (rank 0), losses "
          f"{dp[0]['losses']}")
    ref_l, ref_g, plain_l, plain_g, truth_g, sh = refs["dp"]
    _scalar_gate("[23b]", "averaged loss vs one process's mean of the two shards",
                 dp[0]["loss"], ref_l)
    _scalar_gate("[23b]", "averaged grad norm vs the mean's", _norm(dp[0]["grads"]),
                 _norm(_np_grads(ref_g)))
    _leaf_gate("[23b]", dp[0]["grads"], _np_grads(ref_g), truth_g, STEP_TOL,
               "averaged grads vs one process's mean", group=checks.score_linears)
    # the kernels at the shards' shapes against their plain versions: the
    # same mean computed with the plain step (phase 5's gates)
    print(f"[23b] a shard's merged rows: Kn {sh.node_ids.shape[1]}, Ke "
          f"{sh.edge_dst.shape[1]}, Kt {sh.tgrad_dst.shape[1]}")
    _scalar_gate("[23b]", "averaged loss vs the plain step's mean of the two shards",
                 dp[0]["loss"], plain_l)
    _scalar_gate("[23b]", "averaged grad norm vs the plain mean's",
                 _norm(dp[0]["grads"]), _norm(_np_grads(plain_g)))
    dp_leaf = _leaf_gate("[23b]", dp[0]["grads"], _np_grads(plain_g), truth_g, STEP_TOL,
                         "averaged grads (K1/K2) vs the plain step's mean",
                         group=checks.score_linears)
    same = dp[0]["params_digest"] == dp[1]["params_digest"]
    print(f"[23b] parameters after 3 steps bitwise equal across the ranks: {same}")
    check(same and dp[0]["losses"] == dp[1]["losses"], "the DP ranks diverged")
    L = dp[0]["rows"]
    counted = device == "cuda"        # a CPU rehearsal launches no kernel
    for r in dp:
        want = {**{k: 0 for k in r["counts"]},
                **({"row_forward": L, "row_backward": L} if counted else {})}
        print(f"[23b] rank {r['rank']} launch counts (the grads pass) {r['counts']}, "
              f"expected {want}")
        check(r["counts"] == want, "DP rank launches differ from its shard's rows")
    out["dp"] = dict(loss=dp[0]["loss"], step_s=dp[0]["step_s"], leaf=dp_leaf,
                     rows=L, launches=dp[0]["counts"])

    # 23c: edge partitioned, 2 and 4 ranks, the generic branch (K6, K5)
    out["ep"] = {}
    # the overlap report's trace section on the 2-rank spawn (bf16, D = 2):
    # both orders' steps in turns and a profiled forward pass of each
    traces = [r[-1] for r in res2]
    for D, res in ((2, [r[:-1] for r in res2]), (4, res4)):
        f32, bf = res[0][-2], res[0][-1]
        l32, g32, l16, g16, t16 = refs["ep"][D]
        st = f32["statics"][0]
        print(f"[23c] EP, {D} ranks ({f32['route']} route, {SHARED}; the step "
              f"{f32['form']}), chunk {64 * D}: "
              f"rows {f32['rows']}, w {st['own_w']}, halo {st['halo']}, urgent "
              f"{st['has_urgent']}, deferred {st['has_deferred']} ({f32['deferred']} "
              f"deferred entries, direction 0); plan {bf['plan_s']:.3f} s, of it the "
              f"greedy stage-row loop {bf['greedy_s']:.3f} s; wire {bf['wire']}")
        _scalar_gate("[23c]", f"D={D} f32 loss vs the single-rank plain step",
                     f32["loss"], l32)
        _scalar_gate("[23c]", f"D={D} f32 grad norm", _norm(f32["grads"]), _norm(g32))
        leaf32 = _leaf_gate("[23c]", f32["grads"], g32, g32, CROSS_TOL,
                            f"D={D} f32 grads vs the single-rank plain step")
        _scalar_gate("[23c]", f"D={D} bf16 loss vs the single-rank plain step",
                     bf["loss"], l16)
        _scalar_gate("[23c]", f"D={D} bf16 grad norm", _norm(bf["grads"]), _norm(g16))
        leaf16 = _leaf_gate("[23c]", bf["grads"], g16, t16, STEP_TOL,
                            f"D={D} bf16 grads vs the single-rank plain step",
                            group=checks.score_linears)
        probe = _ep_probe(D, res, counted)
        for r in res:
            for j in (-2, -1):
                want = {**{k: 0 for k in r[j]["counts"]},
                        **(_ep_counts(r[j]["rows"], nl) if counted else {})}
                check(r[j]["counts"] == want,
                      f"EP rank {r[j]['rank']} launches {r[j]['counts']}, want {want}")
        check(all(r[j]["grads_digest"] == res[0][j]["grads_digest"]
                  for r in res for j in (-2, -1)), "EP ranks hold other gradients")
        print(f"[23c] every rank's launch counts of each grads pass as the plan "
              f"derives them: {res[0][-1]['counts']}; every rank holds the same "
              f"summed gradients (bitwise)")
        plan = overlap.plan_section(jobs.ep_plans(ep_batches[D], D)[0], cfg.hidden_dim)
        print("\n".join(f"    {ln}" for ln in overlap.plan_lines(plan)[2:] if ln))
        wait_rows = [len(plan[d]["wait_rows"]) for d in ("fwd", "rev")]
        check(all(r[-1]["read_rows"] == wait_rows for r in res),
              f"D={D}: the ranks' rows that wait before their gather "
              f"{[r[-1]['read_rows'] for r in res]}, the report's {wait_rows}")
        orders = ([{o: t[o] for o in ("overlap", "sync")} for t in traces] if D == 2
                  else [r[-1]["orders"] for r in res])
        same = all(o["overlap"][k] == o["sync"][k] for o in orders
                   for k in ("buffers_digest", "loss", "grads_digest", "issued"))
        print(f"[23c] D={D} bf16, overlapped order against the synchronous one "
              f"({wait_rows} rows of (fwd, rev) wait before their gather, the rest "
              f"after their outputs): forward buffers, loss and gradients bitwise "
              f"equal and the same collectives issued ({orders[0]['sync']['issued']}) "
              f"on every rank: {same}")
        check(same, f"D={D}: the overlapped EP step differs from the synchronous order")
        out["ep"][D] = dict(loss32=f32["loss"], loss16=bf["loss"], leaf32=leaf32,
                            leaf16=leaf16, rows=f32["rows"], plan_s=bf["plan_s"],
                            greedy_s=bf["greedy_s"], deferred=f32["deferred"],
                            wire=bf["wire"],
                            launches=res[0][-1]["counts"], probe=probe,
                            wait_rows=wait_rows, orders_bitwise=same,
                            plan=plan)
    where = card if device == "cuda" else "the CPU (no device time)"
    print("\n".join(f"    {ln}" for ln in overlap.trace_lines(traces, where) if ln))
    bad = overlap.check_trace(traces)
    summ = [overlap.trace_summary(t) for t in traces]
    n_ex = sum(out["ep"][2]["plan"][d]["exchanges"] for d in ("fwd", "rev"))
    check(not bad and all(s[o]["exchanges"] == n_ex for s in summ
                          for o in ("overlap", "sync")),
          f"the trace's deferred exchanges: misplaced waits {bad[:6]}, counts "
          f"{[(s['overlap']['exchanges'], s['sync']['exchanges']) for s in summ]} "
          f"against {n_ex}")
    o, sy = summ[0]["overlap"], summ[0]["sync"]
    print(f"[23c] D=2 trace of a forward pass (rank 0): {n_ex} deferred exchanges in "
          f"each order, every wait where its order puts it ({o['before']} before the "
          f"gather, "
          f"{o['after']} after the outputs overlapped; {sy['before']} before, "
          f"synchronous); bf16 step s in turns: overlapped "
          f"{' / '.join(f'{x:.4f}' for x in o['step_s'])}, synchronous "
          f"{' / '.join(f'{x:.4f}' for x in sy['step_s'])} ({SHARED})")
    out["ep"]["trace"] = summ


# ----------------------------------------- the bench and the tools (phase 24)

def _bench_run(label, argv, env=None):
    """dagnn_tpu_torch.bench.main(argv) in process (env set around it), its
    standard output echoed; returns (its result, the JSON lines it printed,
    the launch counts of the run)."""
    import io
    from dagnn_tpu_torch import bench
    reset_counts()
    old = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            res = bench.main(argv)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    lc = read_counts()
    text = buf.getvalue()
    print("\n".join(f"{label} {ln}" for ln in text.strip().splitlines()))
    return res, [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")], lc


def phase_bench(dev, card, eps_events):
    """24a: python -m dagnn_tpu_torch.bench --roofline on the pair default
    and with --nopair. eps_events: phase 6 / 6b's edges/s (CUDA events) by
    path, or None."""
    from dagnn_tpu_torch import bench, flagship, roofline
    from dagnn_tpu_torch.dag.batch import collate
    from dagnn_tpu_torch.data.synthetic import synthetic_ast_batch
    cpu = ["--cpu"] if dev.type == "cpu" else []
    counted = dev.type == "cuda"
    cfg = flagship.flagship_cfg(emb=bench.WIDTH, hidden=bench.WIDTH)
    graphs = synthetic_ast_batch(0, bench.GRAPHS, mean_nodes=bench.MEAN_NODES)
    out = {}
    for tag, argv, pair, names in (
            ("pair", [], 2, ("pair_forward", "pair_backward")),
            ("merged", ["--nopair"], 0, ("row_forward", "row_backward"))):
        host = collate(graphs, flagship.pad_for(graphs, pair=pair))
        steps = host.pair.edst.shape[0] if pair else host.fwd.node_ids.shape[0]
        t0 = time.perf_counter()
        res, lines, lc = _bench_run(f"[24a] {tag}:", ["--roofline", *argv, *cpu])
        secs = time.perf_counter() - t0
        check([ln.get("metric") for ln in lines] == ["edges_per_s_per_chip_fwdbwd",
                                                     "roofline"],
              f"bench {tag}: printed {len(lines)} JSON lines, not the metric and "
              f"the roofline line")
        m, r = lines
        check(math.isfinite(m["value"]) and m["value"] > 0, f"bench {tag}: {m['value']}")
        model = roofline.model_flops(cfg, host) / 1e12
        check(r["model_tflops"] == model, f"bench {tag}: model_tflops "
              f"{r['model_tflops']} is not roofline.model_flops's {model}")
        passes = res["passes"]
        want = {**{k: 0 for k in lc},
                **({names[0]: steps * passes, names[1]: steps * passes} if counted else {})}
        print(f"[24a] {tag}: launch counts {lc}, expected {want} ({passes} train "
              f"steps of {steps} scan steps)")
        check(lc == want, f"bench {tag}: launch counts differ from its steps")
        if counted:
            check(0 < r["mfu"] <= 1.05 and 0 < r["device_busy_share"] <= 1,
                  f"bench {tag}: mfu {r['mfu']}, busy share {r['device_busy_share']}")
            ref = (eps_events or {}).get(tag)
            print(f"[24a] {tag}: {m['value']:.1f} edges/s on the host clock, "
                  f"{r['us_per_step']:.1f} us a scan step, mfu {r['mfu']:.5f}, "
                  f"executed {r['executed_tflops']:.4f} TFLOP a step, busy share "
                  f"{r['device_busy_share']:.3f}"
                  + (f"; against phase 6{'b' if pair else ''}'s {ref:.1f} (CUDA events): "
                     f"{m['value'] / ref:.3f}x (information, not a gate)" if ref else "")
                  + f"; on {card}; the run took {secs:.1f} s")
        out[tag] = dict(metric=m, roofline=r, launches=lc, passes=passes, seconds=secs)
    return out


def phase_bench_17(dev):
    """24a's last run: DAGNN_BENCH_STEPS=17 on the pair default times one
    group of 17 steps (the JAX bench's 16 // 17 times none)."""
    from dagnn_tpu_torch import bench, flagship
    from dagnn_tpu_torch.dag.batch import collate
    from dagnn_tpu_torch.data.synthetic import synthetic_ast_batch
    counted = dev.type == "cuda"
    graphs = synthetic_ast_batch(0, bench.GRAPHS, mean_nodes=bench.MEAN_NODES)
    res, lines, lc = _bench_run("[24a] 17 steps:", [] if counted else ["--cpu"],
                                env={"DAGNN_BENCH_STEPS": "17"})
    steps = collate(graphs, flagship.pad_for(graphs, pair=2)).pair.edst.shape[0]
    print(f"[24a] DAGNN_BENCH_STEPS=17: {res['iters']} group of {res['n_chain']} steps "
          f"timed (the JAX bench times 16 // 17 = 0), {lines[0]['value']:.1f} edges/s")
    check(len(lines) == 1 and (res["iters"], res["n_chain"]) == (1, 17)
          and lines[0]["value"] > 0, "DAGNN_BENCH_STEPS=17 timed no group")
    check(lc == {**{k: 0 for k in lc}, **({"pair_forward": 34 * steps,
                                           "pair_backward": 34 * steps} if counted else {})},
          f"bench at 17 steps: launch counts {lc}")
    return dict(metric=lines[0], launches=lc, iters=res["iters"])


def _row_spec_at(dev, st_d_w):
    """row_spec's calls on the given (static, inputs, weights) builder."""
    return {**row_spec(dev), "inputs": st_d_w}


def _pair_spec_at(blocks, st_d_w):
    """pair_spec's calls on the given block table and inputs builder."""
    import types
    return {**pair_spec(None, types.SimpleNamespace(blocks=blocks), 0, 0),
            "inputs": st_d_w}


def phase_microbenches(dev):
    """24b / 24c: each width's K1/K2 call of the row microbench, and the
    pair microbench's K3/K4 pair step and merged K1/K2 row, held against
    their plain versions at phase 3's gates (bf16) before anything is
    timed; then both microbenches' main (device times from CUDA graphs,
    eager per call)."""
    from dagnn_tpu_torch.scripts import microbench_pair_kernel as mp
    from dagnn_tpu_torch.scripts import microbench_row_kernel as mr
    cpu = ["--cpu"] if dev.type == "cpu" else []
    out = {}
    for label, h in mr.WIDTHS:
        print(f"[24b] {label}: K1/K2 against their plain versions at the row "
              f"microbench's shapes")
        hold_kernels(_row_spec_at(dev, lambda dt, h=h: mr.make_inputs(
            h, h, dtype=dt, device=dev)), torch.bfloat16)
    out["row"] = mr.main(cpu)
    inp = mp.make_inputs(int(os.environ.get("PAIR", "2")), dev)
    st, d, w, blocks, P, i = inp["pair"]
    print(f"[24c] pair step {i} of {P}: K3/K4 against their plain versions")
    hold_kernels(_pair_spec_at(blocks, lambda dt: (st, d, w)), torch.bfloat16)
    stm, dm, wm, L, r = inp["merged"]
    print(f"[24c] merged row {r} of {L}: K1/K2 against their plain versions")
    hold_kernels(_row_spec_at(dev, lambda dt: (stm, dm, wm)), torch.bfloat16)
    out["pair"] = mp.main(cpu)
    return out


def phase_ep_decompose(dev, card):
    """24d: scripts.ep_decompose (DP x1 and EP x1 in a world-size-1
    group): its plan statistics against a direct call of the port's
    planner, EP x1's K6 / K5 launches against the plan's rows, DP x1's
    only K1/K2, and each profile's categories against its total."""
    from dagnn_tpu_torch import flagship
    from dagnn_tpu_torch.dag.batch import collate
    from dagnn_tpu_torch.data.synthetic import synthetic_ast_batch
    from dagnn_tpu_torch.parallel.edge_partition import partition_schedule_sharded
    from dagnn_tpu_torch.scripts import ep_decompose as ed
    # the tool's depth cut to 2 timed steps and 1 profiled (its defaults 5
    # and 3) to pay for 21b's stages; every check below stands
    depth = ed.STEPS, ed.PROFILE_STEPS
    ed.STEPS, ed.PROFILE_STEPS = 2, 1
    try:
        out = ed.main(["--cpu"] if dev.type == "cpu" else [])
    finally:
        ed.STEPS, ed.PROFILE_STEPS = depth
    graphs = synthetic_ast_batch(0, ed.GRAPHS, mean_nodes=ed.MEAN_NODES)
    for d in ed.DEVICES:
        chunk = max(64, 64 * d)
        b = collate(graphs, dataclasses.replace(flagship.pad_for(graphs, chunk=chunk),
                                                nodes_per_level=chunk))
        eps, st = partition_schedule_sharded(b.fwd, d)
        want = (st.rows, st.own_w, st.halo, eps.e_dst.shape[-1], eps.t_mask.shape[-1],
                eps.x_send_col.shape[-1], eps.d_send_col.shape[-1], eps.u_send_col.shape[-1])
        check(tuple(out["plan_by_D"][d].values()) == want,
              f"ep_decompose's plan at D={d} differs from the planner's {want}")
    print(f"[24d] plan statistics at D = {list(ed.DEVICES)} equal the planner's")
    if dev.type != "cuda":
        return out
    nl = flagship.flagship_cfg().num_layers
    want = {k: v * out["steps"] for k, v in _ep_counts(out["ep1_rows"], nl).items()}
    print(f"[24d] EP x1 launches over {out['steps']} steps {out['ep1_launches']}, from the "
          f"plan's rows {out['ep1_rows']}: {want}")
    check(out["ep1_launches"] == want, "EP x1's K6 / K5 launches differ from the plan")
    dl = out["dp1_launches"]
    check(set(dl) == {"row_forward", "row_backward"} and dl["row_forward"] == dl[
        "row_backward"] and dl["row_forward"] % out["steps"] == 0,
          f"DP x1 launched {dl}, not K1/K2 once a row")
    for tag in ("dp1", "ep1"):
        p = out[f"{tag}_profile"]
        tot = sum(p["categories_us"].values())
        print(f"[24d] {tag}: {out[tag + '_ms']:.2f} ms a step, "
              f"{out[tag + '_edges_per_s']:.1f} edges/s, busy share {p['busy_share']:.3f}, "
              f"{p['events_per_step']:.0f} device events a step; device us a step by "
              f"category " + ", ".join(f"{k} {v:.1f}" for k, v in p["categories_us"].items())
              + f" (sum {tot:.1f} of {p['total_us']:.1f}); the largest kernels: "
              + "; ".join(f"{c}: " + ", ".join(f"{k} {v:.1f}" for k, v in top.items())
                          for c, top in p["top_us"].items())
              + f"; on {card}")
        check(abs(tot - p["total_us"]) <= 0.02 * p["total_us"],
              f"{tag}: categories sum to {tot}, the profile's total {p['total_us']}")
    return out


def start_rehearsal(graphs=20000):
    """24e's scripts.rehearse_preprocess --graphs `graphs` (host work),
    started in a process of its own, its output to a file. Returns
    (process, its directory, REPORT.md's path, the log's path, the
    start's clock)."""
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tools_")
    report, log = os.path.join(tmp, "REPORT.md"), os.path.join(tmp, "rehearsal.log")
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "dagnn_tpu_torch.scripts.rehearse_preprocess",
             "--graphs", str(graphs), "--root", tmp, "--out", report],
            stdout=f, stderr=subprocess.STDOUT, text=True, start_new_session=True,
            cwd=os.path.dirname(os.path.abspath(__file__)))
    return proc, tmp, report, log, time.perf_counter()


def wait_rehearsal(reh, timeout=900):
    """Wait for start_rehearsal's process; returns the seconds waited.
    Killed if it outlives `timeout`."""
    t0 = time.perf_counter()
    try:
        reh[0].wait(timeout=timeout)
    finally:
        if reh[0].poll() is None:
            reh[0].kill()
            reh[0].wait()
    return time.perf_counter() - t0


def phase_tools(dev, card, eps_events=None, rehearsal=None, rehearsal_graphs=20000):
    """Phase 24: the bench (24a), the two microbenches (24b, 24c),
    ep_decompose (24d), the preprocessing rehearsal at rehearsal_graphs
    (24e; host work in a process of its own: `rehearsal`, start_rehearsal's
    process started beside earlier phases, else started here; ended
    before 24a, whose host-bound steps it would slow) and bn_ceiling (24f).
    On a CPU device it rehearses the same calls with --cpu (the tools'
    module sizes set small by the caller)."""
    from dagnn_tpu_torch.scripts import bn_ceiling
    t_all = time.perf_counter()
    reh = rehearsal or start_rehearsal(rehearsal_graphs)
    proc, tmp, report, log, t_reh = reh
    waited = wait_rehearsal(reh)
    print(f"[24e] waited {waited:.1f} s for the rehearsal (started "
          f"{t_all - t_reh:.1f} s before this phase)")
    out = {"bench": phase_bench(dev, card, eps_events)}
    out["bench"]["steps17"] = phase_bench_17(dev)
    for tag, run in (("microbench", phase_microbenches),
                     ("ep_decompose", lambda dev: phase_ep_decompose(dev, card))):
        t0 = time.perf_counter()
        out[tag] = run(dev)
        out[tag]["seconds"] = time.perf_counter() - t0
        print(f"[24] {tag} took {out[tag]['seconds']:.1f} s")
    with open(log) as f:
        print("\n".join("[24e] " + ln for ln in f.read().strip().splitlines()))
    check(proc.returncode == 0 and os.path.exists(report),
          f"rehearse_preprocess --graphs {rehearsal_graphs} exited {proc.returncode}")
    with open(report) as f:
        out["rehearsal"] = [ln for ln in f.read().splitlines() if ln.startswith("| ")]
    check(len(out["rehearsal"]) == 8, "the rehearsal's report lacks a stage")
    t0 = time.perf_counter()
    scores = bn_ceiling.main(["--seeds", "1", "--out", os.path.join(tmp, "ceiling.txt"),
                              *(["--cpu"] if dev.type == "cpu" else [])])
    print(f"[24f] bn_ceiling on the synthetic BN rows: {scores[0]} "
          f"({time.perf_counter() - t0:.1f} s)")
    check(all(math.isfinite(scores[0][k]) for k in ("rmse", "ll", "pearson_r")),
          "bn_ceiling: a non-finite score")
    out["bn_ceiling"] = scores[0]
    import shutil
    shutil.rmtree(tmp, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_all
    print(f"[24] {card}: phase 24 took {out['wall_s']:.1f} s")
    return out


# ------------------------------------------------- the captured steps

def bucket_hosts(graphs, n, pair, task="tok"):
    """n host batches of 160 of `graphs` in one bucket, as the drivers make
    them: the PadConfig the fieldwise max of each group's flagship.pad_for,
    as the loader's bucket is the max over an epoch's batches, with the
    output slots a graph left to each batch (the loader leaves them too),
    then each batch's output-slot lists widened to the widest
    (convert.widen_out_slots, as ogb_driver.run does with the loader's
    out_per_graph); for LP each graph's longest-path class set as
    load_dataset sets it."""
    from dagnn_tpu_torch import convert, flagship
    from dagnn_tpu_torch.cli.ogb_driver import LP_NUM_CLASSES
    from dagnn_tpu_torch.dag.batch import PadConfig, collate
    groups = [graphs[i * 160:(i + 1) * 160] for i in range(n)]
    if task == "lp":
        for g in graphs[:n * 160]:
            g.y["len_longest_path"] = np.asarray(
                min(g.len_longest_path, LP_NUM_CLASSES - 1), np.int32)
    pads = [flagship.pad_for(g, pair=pair) for g in groups]
    pad = PadConfig(*[max(v) for v in zip(*map(dataclasses.astuple, pads))])
    pad = dataclasses.replace(pad, out_per_graph=0)
    widest = max(p.out_per_graph for p in pads)
    return [convert.widen_out_slots(collate(g, pad), widest) for g in groups]


def _same(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _kind(name, cat="kernel"):
    """A device event's or graph node's kind for the census: "memcpy" /
    "memset" for a copy or a set (the trace's gpu_memcpy and gpu_memset
    events, a graph's copy and set nodes), "direct_copy" for a copy kernel,
    else the kernel's function name (graphs.kernel_name: the profiler's
    demangled signature and a graph node's mangled symbol read alike)."""
    from dagnn_tpu_torch.train.graphs import kernel_name
    if cat == "gpu_memset" or name == "memset":
        return "memset"
    if cat == "gpu_memcpy" or name == "memcpy":
        return "memcpy"
    if "direct_copy_kernel" in name:
        return "direct_copy"
    return kernel_name(name)


def _is_copy(kind):
    return kind in ("memcpy", "memset", "direct_copy")


# spin kernels (torch.cuda._sleep, about 57 us each) on each side of a
# censused call: the profiler loses device events at a trace's edge now
# and then (7 of an eager step's in one run, the same 7 in three traces;
# 4-5 of these 128 in the next), so the losses fall on these
PAD, PAD_CYCLES = 64, 100_000


def kernel_census(tag, fn, out_dir):
    """The device events (_kind: launches) of one call of fn, from a
    torch.profiler trace (utils/profiling.py), PAD spin kernels and a
    synchronise before it and PAD after it (left out of the census,
    their count returned), and the call's device busy share. None when
    the trace holds no device events."""
    from collections import Counter
    from dagnn_tpu_torch.utils import profiling

    def padded():
        for _ in range(PAD):
            torch.cuda._sleep(PAD_CYCLES)
        torch.cuda.synchronize()
        fn()
        for _ in range(PAD):
            torch.cuda._sleep(PAD_CYCLES)

    path = profiling.profile_step(padded, iters=1, logdir=out_dir,
                                  name=f"census_{tag}.json")
    dev = profiling.device_events(path)
    kinds = [_kind(e["name"], e.get("cat")) for e in dev]
    own = [e for e, k in zip(dev, kinds) if k != "spin_kernel"]
    if not own:
        return None, None, 0
    return (Counter(k for k in kinds if k != "spin_kernel"),
            profiling.device_busy(own), len(dev) - len(own))


# The kernel each launch of these wrappers runs, once a call (K5, K6)
ONE_KERNEL = {"tg_accumulate": "seg_merge_kernel",
              "segment_attn_forward": "sa_fwd_kernel",
              "segment_attn_backward": "sa_bwd_kernel"}


def node_kinds(nodes):
    """A graph's nodes (graphs.graph_nodes) by _kind."""
    from collections import Counter
    out = Counter()
    for name, v in nodes.items():
        out[_kind(name)] += v
    return out


def wrapper_nodes(label, k_e, nodes):
    """What a replay launches, read from the graph (its nodes, `nodes` by
    _kind), against the wrappers' launches of one eager step (`k_e`): on
    a path where no row or pair wrapper ran (the generic branch, the
    VAEs), the graph's seg_merge_kernel, sa_fwd_kernel and sa_bwd_kernel
    nodes number the eager step's K5, K6 forward and K6 backward launches
    (one kernel a call). Where a row or pair wrapper ran (its K2 launches
    seg_merge_kernel too), the census (census_pair) holds every kernel by
    name instead. Returns the graph's counts by wrapper, or None there."""
    ours = ("attn_fwd_kernel", "gru_fwd_kernel", "seg_merge_kernel",
            "rebuild_kernel", "gru_bwd_elem_kernel", "gemm_nn_kernel",
            "attn_bwd_kernel", "wgrad_kernel", "small_reduce_kernel",
            "sa_fwd_kernel", "sa_bwd_kernel")
    print(f"{label} the graph's nodes: {sum(v for k, v in nodes.items() if not _is_copy(k))} "
          f"kernels, {sum(v for k, v in nodes.items() if _is_copy(k))} copies and "
          f"sets; the port's kernels among them: "
          + ", ".join(f"{k} {nodes[k]}" for k in ours if nodes.get(k)))
    if any(k.startswith(("row_", "pair_")) and v for k, v in k_e.items()):
        return None
    got = {w: nodes.get(n, 0) for w, n in ONE_KERNEL.items()}
    want = {w: k_e.get(w, 0) for w in ONE_KERNEL}
    print(f"{label} a replay's K5/K6 launches from the graph's nodes {got}, the "
          f"eager step's wrapper counts {want}")
    check(got == want and any(want.values()),
          f"{label}: the graph's K5/K6 nodes differ from the eager step's launches")
    return got


def census_pair(label, eager, nodes, n_state, out_dir, tries=3):
    """The device events of an eager step (`eager`, run on the graph's own
    input buffers, so that both read the same tensors and pick the same
    kernel variants), from the profiler, against the nodes of the graph
    (`nodes` by _kind, read from the graph itself: what a replay
    launches): the kernels equal name by name, the copies and sets the
    eager step's plus one a state leaf (`n_state`: the replay's in-place
    write-back). The profiler drops an event now and then, so the eager
    step is traced between spin kernels (kernel_census) up to `tries`
    times: the census holds when one trace equals the graph's nodes, and
    fails when none does."""
    compute_g = {n: v for n, v in nodes.items() if not _is_copy(n)}
    copies_g = sum(v for n, v in nodes.items() if _is_copy(n))
    seen = []
    for t in range(tries):
        census, busy, spins = kernel_census(f"{label[1:-1]}_eager{t}", eager,
                                            out_dir)
        check(census is not None, f"{label}: the profiler saw no device events")
        compute = {n: v for n, v in census.items() if not _is_copy(n)}
        copies = sum(v for n, v in census.items() if _is_copy(n))
        seen.append(sum(census.values()))
        equal = compute == compute_g and copies_g == copies + n_state
        print(f"{label} census, eager trace {t + 1}: {seen[-1]} device events "
              f"(busy {round(100 * busy['share'], 1)}% of its span; {spins} of "
              f"{2 * PAD} padding spin kernels seen), "
              f"{sum(compute.values())} kernels in {len(compute)} names, "
              f"{copies} copies and sets; the graph's nodes: "
              f"{sum(compute_g.values())} kernels in {len(compute_g)} names, "
              f"{copies_g} copies and sets ({n_state} state leaves written "
              f"back): {'equal' if equal else 'not equal'}")
        if equal:
            break
        diff = {k: (compute.get(k, 0), compute_g.get(k, 0))
                for k in set(compute) | set(compute_g)
                if compute.get(k, 0) != compute_g.get(k, 0)}
        print(f"{label} kernels that differ (eager, graph): "
              + "; ".join(f"{k[:160]}: {v}" for k, v in diff.items()))
    check(equal, f"{label}: no eager trace of {tries} equals the graph's nodes")
    return dict(eager_events=seen, traces=len(seen), equal=equal,
                graph_kernels=sum(compute_g.values()), graph_copies=copies_g,
                state_leaves=n_state, busy_share_eager=busy["share"])


def timed_turns(label, fns, n=5):
    """Each of the two step functions `fns` (tag: fn) n times in turns (a,
    b, b, a), timed by CUDA events and the host clock around each run of
    n (ms a step): the two compared in one process, as phase 17 does."""
    (a, fa), (b, fb) = fns.items()
    times = {a: [], b: []}
    for tag in (a, b, b, a):
        torch.cuda.synchronize()
        ev0, ev1 = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
        h0 = time.perf_counter()
        ev0.record()
        for _ in range(n):
            fns[tag]()
        ev1.record()
        torch.cuda.synchronize()
        times[tag].append((ev0.elapsed_time(ev1) / n,
                           (time.perf_counter() - h0) / n * 1e3))
    mean = {t: sum(v[0] for v in times[t]) / 2 for t in times}
    print(f"{label} {a} " + " / ".join(f"{e:.2f} ({h:.2f} host)" for e, h in times[a])
          + f" ms, {b} " + " / ".join(f"{e:.2f} ({h:.2f} host)" for e, h in times[b])
          + f" ms a step (CUDA events, order a b b a): {a}/{b} {mean[a] / mean[b]:.3f}x")
    return {t: [{"ms": e, "host_ms": h} for e, h in v] for t, v in times.items()} | {
        "ratio": mean[a] / mean[b]}


def graph_vs_eager(label, cfg, params, hosts, task, kernels, card, out_dir,
                   dev, order=(0, 1, 2, 0, 1), n_turns=5, eager_runs=2):
    """25a / 25b: 5 train steps over three batches of one bucket (`hosts`,
    host arrays, in `order`) from the same parameters, through the
    driver's captured train step and `eager_runs` times through its eager
    one (make_step_fns(capture=False)). Where two eager runs agree bit for
    bit, the captured run must equal them bit for bit (losses, every
    parameter and optimizer leaf, the predicted ids); elsewhere the losses
    are held to phase 5's loss gate and each leaf's change to its leaf
    gate. With one eager run (the generic branch, whose eager steps take
    0.4-1.6 s) the captured run must equal it bit for bit. The wrappers'
    launch counts of the runs must be equal (each replay counted as its
    capture's), and a capture made each time the key changes from one step
    to the next (one graph is kept: one capture for the merged bucket; a
    pair plan's block widths are the batch's own, so each pair batch is a
    key of its own). Then the step on batch 0 (on the card) timed, eager
    against captured in turns (n_turns steps a turn), and what a replay
    launches read from the graph itself (its nodes, graphs.graph_nodes):
    against the wrappers' launches of an eager step on every path
    (wrapper_nodes), and on the fused paths against the profiler's
    device events of an eager step on the graph's input buffers, kernel
    by kernel (census_pair)."""
    from dagnn_tpu_torch import checks, convert
    from dagnn_tpu_torch.cli.ogb_driver import make_step_fns, step_key
    from dagnn_tpu_torch.train import graphs
    from dagnn_tpu_torch.train.optim import make_optimizer
    t_start = time.perf_counter()
    opt = make_optimizer(1e-3, 0.25)
    runs = {}
    torch.cuda.reset_peak_memory_stats()
    tags = (("graph", True), ("eager", False), ("eager2", False))
    for tag, capture in tags[:1 + eager_runs]:
        train_step, predict = make_step_fns(cfg, opt, task, capture=capture)
        if capture:
            train_step.captured.debug = True       # keep the graphs' nodes
        p, s = params, opt.init(params)
        losses = []
        reset_counts()
        t0 = time.perf_counter()
        for i in order:
            p, s, loss, _ = train_step(p, s, hosts[i])
            losses.append(float(loss))
        secs = time.perf_counter() - t0
        lc = read_counts()
        runs[tag] = dict(losses=losses, counts=lc, secs=secs,
                         p={k: v.clone() for k, v in p.items()},
                         s=convert.flatten_tree(convert.tree_map(torch.clone, s)),
                         ids=predict(p, hosts[0]), step=train_step, predict=predict)
    g, e = runs["graph"], runs["eager"]
    e2 = runs.get("eager2")
    repeat = e2 is not None and (e["losses"] == e2["losses"] and _same(e["p"], e2["p"])
                                 and _same(e["s"], e2["s"]))
    same = (g["losses"] == e["losses"] and _same(g["p"], e["p"])
            and _same(g["s"], e["s"]) and torch.equal(g["ids"], e["ids"]))
    seq = [step_key("train", cfg, hosts[i]) for i in order]
    keys = set(seq)
    # one graph kept (the driver's one bucket an epoch): a step whose key
    # is not the previous step's captures anew
    switches = sum(1 for i, k in enumerate(seq) if i == 0 or k != seq[i - 1])
    cap = g["step"].captured
    print(f"{label} {len(order)} steps over batches {list(order)} of one bucket "
          f"({len(keys)} distinct key(s)): captured losses "
          f"{' '.join(f'{v:.6f}' for v in g['losses'])}, eager "
          f"{' '.join(f'{v:.6f}' for v in e['losses'])}; eager repeats bit for "
          f"bit: {repeat if e2 is not None else 'not run (one eager run)'}; "
          f"captured equals eager bit for bit: {same}; "
          f"{cap.captures} capture(s), {cap.replays} replays; wall {g['secs']:.2f} s "
          f"captured (captures included), {e['secs']:.2f} s eager")
    worst = None
    if repeat or e2 is None:
        check(same, f"{label}: the captured steps differ from the eager steps"
              + (", which repeat bit for bit" if repeat else ""))
    else:
        e_loss = max(abs(a - b) / abs(b) for a, b in zip(g["losses"], e["losses"]))
        rel = {k: checks.rel_err(g["p"][k] - params[k], e["p"][k] - params[k])[0]
               for k in e["p"]}
        worst = max(rel, key=rel.get)
        print(f"{label} the eager steps do not repeat bit for bit: losses within "
              f"{e_loss:.2e} (gate {STEP_TOL['loss']:g}), worst parameter change "
              f"{worst} at {rel[worst]:.3e} of its max (gate {STEP_TOL['leaf']:g})")
        check(e_loss <= STEP_TOL["loss"] and rel[worst] <= STEP_TOL["leaf"],
              f"{label}: the captured steps leave the gates of the eager steps")
    print(f"{label} launch counts over the {len(order)} steps: captured "
          f"{g['counts']}, eager {e['counts']}")
    check(g["counts"] == e["counts"] and all(g["counts"][k] > 0 for k in kernels),
          f"{label}: the replays' launch counts differ from the eager steps'")
    check(cap.captures == switches and cap.replays == len(order),
          f"{label}: {cap.captures} captures for {switches} changes of key")
    peak = torch.cuda.max_memory_allocated() / 1e6
    # the step on batch 0, eager against captured in turns, on the card
    b0 = convert.batch_to_torch(hosts[0], dev)
    eg, gr = e["step"], g["step"]
    pe, se = dict(e["p"]), opt.init(params)
    pg, sg, _, _ = gr(dict(g["p"]), opt.init(params), b0)
    eg(pe, se, b0)
    turns = timed_turns(f"{label} step on batch 0, eager against captured:", {
        "eager": lambda: eg(pe, se, b0), "graph": lambda: gr(pg, sg, b0)},
        n=n_turns)
    # what a replay of batch 0's graph launches, from the graph itself
    staged = cap.graphs[next(reversed(cap.graphs))]
    nodes = node_kinds(graphs.graph_nodes(staged.graph))
    reset_counts()
    eg(pe, se, b0)
    k_e = {k: v for k, v in read_counts().items() if v}
    print(f"{label} the wrappers' launches of an eager step {k_e}; peak cuda "
          f"memory of the steps {peak:.1f} MB on {card}")
    from_graph = wrapper_nodes(label, k_e, nodes)
    census = None if seq[0][1] == "generic" else census_pair(
        label, lambda: eg(pe, se, staged.inputs[0]), nodes,
        len(convert.flatten_tree(pg)) + len(convert.flatten_tree(sg)), out_dir)
    print(f"{label} took {time.perf_counter() - t_start:.1f} s")
    return dict(repeat=repeat if e2 is not None else None, bitwise=same,
                worst=worst, keys=len(keys), key_changes=switches,
                captures=cap.captures, replays=cap.replays, losses=g["losses"],
                launches=g["counts"], eager_step_launches=k_e,
                graph_nodes=dict(nodes), k5_k6_from_graph=from_graph,
                turns=turns, census=census, peak_mb=peak)


class _DropAfterEpoch1:
    """A plateau scheduler whose scale drops to 0 after epoch 1, whatever
    the loss (25c): the driver's gradients then reach the clip and Adam as
    zeros, so that the drop shows in epoch 2 (Adam all but undoes a drop
    to 0.1, as in the JAX driver)."""

    def __init__(self, factor=0.1, patience=10):
        from dagnn_tpu_torch.train.optim import PlateauScheduler
        self._s = PlateauScheduler(factor, patience)

    def __getattr__(self, k):
        return getattr(self._s, k)

    def step(self, metric):
        self._s.scale = 0.0
        return self._s.scale


def vae_graph_vs_eager(label, flags, root, epochs, drop=False, graph=None):
    """Two train_vae.main runs of `flags` for `epochs` epochs, the train step
    captured (the default) and all eager (train_vae.CAPTURED emptied), with
    the plateau drop forced after epoch 1 when `drop`: the loss files and
    the last checkpoint's parameters bit for bit equal. `graph`: the
    captured run's rows, epoch seconds, parameters, captures and replays,
    taken from a run made before (no captured run here). Returns the rows,
    each run's epoch seconds and the captured run's captures and
    replays."""
    from dagnn_tpu_torch.cli import train_vae as tv
    out = {} if graph is None else {"graph": graph}
    made = []
    orig = (tv.CAPTURED, tv.PlateauScheduler, tv.make_captured_step)

    def record(step):
        made.append(orig[2](step))
        return made[-1]

    try:
        tv.make_captured_step = record
        if drop:
            tv.PlateauScheduler = _DropAfterEpoch1
        for tag, captured in (("graph", orig[0]), ("eager", ())):
            if tag in out:
                continue
            tv.CAPTURED = captured
            d = f"{root}/{label[1:-1]}_{tag}"
            with vae_probes() as seen:
                tv.main(flags + ["--epochs", str(epochs), "--no-test",
                                 "--save-interval", "100", "--res_dir", d])
            args = tv.parse_args(flags + ["--res_dir", d])
            model = args.model
            # one key a batch size: the full batches' and the tail's
            keys = 1 + bool(len(tv.load_data(args)[0]) % args.batch_size)
            out[tag] = dict(rows=_vae_rows(d), epoch_s=seen["epochs"],
                            params=torch.load(f"{d}/{model}_0_{epochs}.ckpt",
                                              weights_only=True)["params"])
            if captured:
                out[tag].update(captures=made[0].captures if made else 0,
                                replays=made[0].replays if made else 0)
    finally:
        tv.CAPTURED, tv.PlateauScheduler, tv.make_captured_step = orig
    g, e = out["graph"], out["eager"]
    print(f"{label} {' '.join(flags[:6])}: captured epochs {g['rows']}, eager "
          f"{e['rows']}; epoch seconds captured "
          + " / ".join(f"{v:.3f}" for v in g["epoch_s"]) + ", eager "
          + " / ".join(f"{v:.3f}" for v in e["epoch_s"])
          + f"; {g['captures']} capture(s), {g['replays']} replays")
    check(g["rows"] == e["rows"], f"{label}: the captured epochs' losses differ "
          "from the eager epochs'")
    check(_same(g["params"], e["params"]), f"{label}: the captured run's parameters "
          "differ from the eager run's")
    check(g["captures"] == keys, f"{label}: {g['captures']} captures for {keys} "
          f"batch sizes (one capture a key: the full batches' and the tail's)")
    return dict(rows=g["rows"], epoch_s=g["epoch_s"], eager_epoch_s=e["epoch_s"],
                captures=g["captures"], replays=g["replays"])


def vae_step_turns(label, flags, dev):
    """The VAE's train step on its loader's batch 0, eager against one
    replay of the captured step, in turns of 3; and what a replay launches,
    read from the graph, against the eager step's K5/K6 launches
    (wrapper_nodes)."""
    from dagnn_tpu_torch import convert
    from dagnn_tpu_torch.cli import train_vae as tv
    from dagnn_tpu_torch.train import graphs
    import tempfile
    args = tv.parse_args(flags + ["--res_dir", tempfile.mkdtemp(prefix="vae_turns_")])
    train, _, ga = tv.load_data(args)
    model = tv.VAEModel(args, ga, dev)
    params = model.init(0)
    opt = tv.make_optimizer(args.lr, args.clip)
    step = tv.make_train_step(model, opt)
    captured = tv.make_captured_step(step)
    captured.debug = True                       # keep the graph's nodes
    host = model.prepare_host(train[:args.batch_size])
    prepared = convert.batch_to_torch(host, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    scale = np.asarray(1.0, np.float32)          # the plateau scale, staged
    inputs = (host, scale, gen)
    key = ("vae", model.kind, convert.batch_key(inputs))
    state = [(params, opt.init(params), torch.zeros(3, device=dev))]

    def replay():
        state[0] = captured(key, state[0], inputs, (gen,))[0]

    replay()
    reset_counts()
    step(params, opt.init(params), prepared, gen, 1.0)
    k_e = {k: v for k, v in read_counts().items() if v}
    print(f"{label} the wrappers' launches of an eager step {k_e}")
    from_graph = wrapper_nodes(label, k_e, node_kinds(
        graphs.graph_nodes(captured.last_graph())))
    pe, se = params, opt.init(params)
    turns = timed_turns(f"{label} train step, eager against captured:",
                        {"eager": lambda: step(pe, se, prepared, gen, 1.0),
                         "graph": replay}, n=3)
    return dict(turns=turns, eager_step_launches=k_e, k5_k6_from_graph=from_graph)


def phase_graphs(dev, card, argv, na_rows_c, na_epoch_s):
    """Phase 25: the captured steps (dagnn_tpu_torch/train/graphs.py)
    against the eager steps. 25a: the flagship TOK step, merged (K1/K2)
    and pair (K3/K4), at full width on three batches of 160 synthetic
    ASTs in one bucket (graph_vs_eager). 25b: the same for the flagship on
    the generic branch (K6, K5) and for LP there (K5). 25c: train_vae at
    phase 20's NA flags (2 epochs, the plateau drop forced after epoch 1)
    and at 20b's BN flags (1 epoch), captured against eager
    (vae_graph_vs_eager); the NA run's
    epoch 1 equal to phase 20's run C's, its epoch 2 not (the drop reached
    the replays); each VAE's step timed eager against captured. 25d: the
    bench (pair) with the graph and with --eager, in turns."""
    import shutil
    import tempfile
    from dagnn_tpu_torch import flagship
    from dagnn_tpu_torch.cli import main_lp, ogb_driver
    from dagnn_tpu_torch.data.synthetic import synthetic_ast_batch
    from dagnn_tpu_torch.nn.dagnn import dagnn_init
    out = {}
    root = tempfile.mkdtemp(prefix="chip_smoke_graphs_")
    try:
        graphs = synthetic_ast_batch(0, 480, mean_nodes=125)
        cfg = flagship.flagship_cfg()
        params = dagnn_init(0, cfg, device=dev)
        for tag, pair, kern in (("merged", 0, ("row_forward", "row_backward")),
                                ("pair", 2, ("pair_forward", "pair_backward"))):
            t0 = time.perf_counter()
            hosts = bucket_hosts(graphs, 3, pair)
            print(f"[25a] {tag}: three batches of one bucket "
                  f"({loader_shapes(hosts[0])}), collated in "
                  f"{time.perf_counter() - t0:.1f} s")
            out[tag] = graph_vs_eager(f"[25a {tag}]", cfg, params, hosts, "tok",
                                      kern, card, root, dev)
            if not pair:
                merged_hosts = hosts
        # the flagship on the generic branch (K6, K5) on the merged batches
        out["pallas"] = graph_vs_eager(
            "[25b pallas]", flagship.flagship_cfg(segment_impl="pallas"), params,
            merged_hosts, "tok",
            ("segment_attn_forward", "segment_attn_backward", "tg_accumulate"),
            card, root, dev, order=(0, 1, 2), n_turns=2, eager_runs=1)
        args = main_lp.parser().parse_args(DRIVER_FLAGS)
        cfg_lp = ogb_driver.build_model_cfg(args, "lp")
        hosts = bucket_hosts(graphs, 3, 0, task="lp")
        print(f"[25b] LP at main_lp's defaults (agg {cfg_lp.agg}, bidirectional "
              f"{cfg_lp.bidirectional}, {cfg_lp.compute_dtype}; the generic branch)")
        out["lp"] = graph_vs_eager("[25b lp]", cfg_lp,
                                   ogb_driver.init_params(cfg_lp, 0, dev), hosts,
                                   "lp", ("tg_accumulate",), card, root, dev,
                                   order=(0, 1, 2), n_turns=2, eager_runs=1)
        t0 = time.perf_counter()
        na = vae_graph_vs_eager("[25c na]", NA_FLAGS, root, 2, drop=True)
        check(na["rows"][0] == na_rows_c[0] and na["rows"][1] != na_rows_c[1],
              "25c: the forced plateau drop did not reach the replayed steps "
              f"(epochs {na['rows']}, phase 20's run C {na_rows_c[:2]})")
        print(f"[25c na] epoch 1 equals phase 20's run C's {na_rows_c[0]}, epoch 2 "
              f"differs from its {na_rows_c[1]} (the drop reached the replays); "
              f"phase 20's epoch seconds (captured) "
              + " / ".join(f"{v:.3f}" for v in na_epoch_s))
        na["step"] = vae_step_turns("[25c na]", NA_FLAGS, dev)
        bn = vae_graph_vs_eager("[25c bn]", BN_FLAGS, root, 1)
        bn["step"] = vae_step_turns("[25c bn]", BN_FLAGS, dev)
        out["vae_na"], out["vae_bn"] = na, bn
        print(f"[25c] {card}: {time.perf_counter() - t0:.1f} s; peak cuda memory "
              f"{torch.cuda.max_memory_allocated() / 1e6:.1f} MB")
        t0 = time.perf_counter()
        bench = {}
        for tag, extra in (("graph", []), ("eager", ["--eager"]),
                           ("eager", ["--eager"]), ("graph", [])):
            res, lines, _ = _bench_run(f"[25d] {tag}:", extra)
            check(lines[0]["step"] == tag, f"25d: the bench ran {lines[0]['step']}")
            bench.setdefault(tag, []).append(lines[0]["value"])
        print(f"[25d] bench (pair) edges/s, in turns graph, eager, eager, graph: "
              f"graph {bench['graph']}, eager {bench['eager']} on {card}; "
              f"{time.perf_counter() - t0:.1f} s")
        out["bench"] = bench
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# ----------------------- every other model of the drivers captured (phase 26)

# 26a: every --gnn the JAX driver accepts but dagnn; 26b: OTHER_VAES; 26c:
# the graph-node census on one model of each family
CAPTURED_BASELINES = ("gin", "gin-virtual") + BASELINES[1:]
CENSUS_MODELS = ("gin-virtual", "ggnn-etype", "asap", "SVAE_GraphRNN",
                 "DVAE_DeepGMG")
# steps a turn of 26a's (26b's) timed steps, in turns a b b a, cut to fit
# the phase's time
TURN_STEPS, VAE_TURN_STEPS = 3, 1


def _equal_or_nan(a, b):
    return torch.equal(a, b) or bool((a.isnan() & b.isnan()).all())


def replay_busy(label, fn, out_dir):
    """The device's busy share over one call of fn (one replay of a
    captured step: its input copies and the graph), from a profiler trace
    (utils/profiling.device_busy)."""
    from dagnn_tpu_torch.utils import profiling
    fn()
    path = profiling.profile_step(fn, iters=1, logdir=out_dir,
                                  name=f"replay_{label[1:-1]}.json")
    busy = profiling.device_busy(profiling.device_events(path))
    check(busy is not None, f"{label}: the profiler saw no device events")
    print(f"{label} one replay: {busy['events']} device events, busy "
          f"{100 * busy['share']:.1f}% of their span ({busy['span_us'] / 1e3:.2f} ms)")
    return busy


def baseline_graph_vs_eager(label, cfg, hosts, dev, out_dir, census):
    """26a (and 26c with `census`): the driver's train step and predict for
    a baseline config, captured (make_step_fns) and eager
    (capture=False), from the same weights over the three host batches of
    one bucket `hosts`: after every step the loss, `finite`, every
    parameter and every Adam leaf bit for bit; predict on batch 0 after
    the last step bit for bit; the wrappers' launches of the runs equal,
    K5 at k5_per_pass a step; the graph's seg_merge nodes (graph_nodes,
    debug) equal to k5_per_pass, as its capture's counts; one capture,
    three replays. Then TURN_STEPS steps of each on batch 0 in turns; with
    `census`, the graph's kernels against the profiler's trace of the
    step run eagerly on the graph's buffers, name for name (census_pair)."""
    from dagnn_tpu_torch import convert
    from dagnn_tpu_torch.cli import ogb_driver
    from dagnn_tpu_torch.train import graphs
    from dagnn_tpu_torch.train.optim import make_optimizer
    t0 = time.perf_counter()
    opt = make_optimizer(1e-3, 0.25)
    params = ogb_driver.init_params(cfg, 0, dev)
    k5 = k5_per_pass(cfg)
    runs = {}
    for tag, capture in (("graph", True), ("eager", False)):
        train_step, predict = ogb_driver.make_step_fns(cfg, opt, "tok",
                                                       capture=capture)
        if capture:
            train_step.captured.debug = True       # keep the graph's nodes
        p, s = params, opt.init(params)
        gen = torch.Generator(device=dev).manual_seed(0)
        seen = []
        reset_counts()
        for h in hosts:
            p, s, loss, finite = train_step(p, s, h, gen)
            seen.append(dict(loss=loss.clone(), finite=finite.clone(),
                             p={k: v.clone() for k, v in p.items()},
                             s=convert.flatten_tree(convert.tree_map(torch.clone, s))))
        runs[tag] = dict(steps=seen, counts=read_counts(), ids=predict(p, hosts[0]),
                         step=train_step, p=p, s=s, gen=gen)
    g, e = runs["graph"], runs["eager"]
    same = [_equal_or_nan(a["loss"], b["loss"]) and torch.equal(a["finite"], b["finite"])
            and _same(a["p"], b["p"]) and _same(a["s"], b["s"])
            for a, b in zip(g["steps"], e["steps"])]
    ids_same = torch.equal(g["ids"], e["ids"])
    cap = g["step"].captured
    staged = cap.graphs[next(reversed(cap.graphs))]
    nodes = node_kinds(graphs.graph_nodes(staged.graph))
    seg = nodes.get("seg_merge_kernel", 0)
    losses = [float(x["loss"]) for x in g["steps"]]
    print(f"{label} {len(hosts)} steps over the batches of one bucket, captured "
          f"against eager: losses {' '.join(f'{v:.6f}' for v in losses)}; bit for "
          f"bit (loss, finite, {len(g['p'])} parameters, {len(g['steps'][0]['s'])} "
          f"Adam leaves) at each step: {same}; predict bit for bit: {ids_same}; "
          f"{cap.captures} capture(s), {cap.replays} replays; launches captured "
          f"{g['counts']}, eager {e['counts']}; the graph's nodes: "
          f"{sum(v for k, v in nodes.items() if not _is_copy(k))} kernels, "
          f"{sum(v for k, v in nodes.items() if _is_copy(k))} copies and sets, "
          f"seg_merge_kernel {seg} (k5_per_pass {k5}; its capture counted "
          f"{staged.counts})")
    check(all(same) and ids_same, f"{label}: the captured steps differ from the "
          "eager steps")
    check(all(bool(x["finite"]) for x in g["steps"]), f"{label}: a non-finite step")
    check(g["counts"] == e["counts"]
          and g["counts"].get("tg_accumulate", 0) == len(hosts) * k5
          and all(v == 0 for k, v in g["counts"].items() if k != "tg_accumulate"),
          f"{label}: the replays' launches differ from K5 x {k5} a step")
    check(seg == k5 and staged.counts == ({"tg_accumulate": k5} if k5 else {}),
          f"{label}: the graph's seg_merge nodes ({seg}) differ from K5's count {k5}")
    check(cap.captures == 1 and cap.replays == len(hosts),
          f"{label}: {cap.captures} captures for one bucket")
    b0 = convert.batch_to_torch(hosts[0], dev)
    eg, gr, gen = e["step"], g["step"], g["gen"]
    pe, se, pg, sg = params, opt.init(params), g["p"], g["s"]
    turns = timed_turns(f"{label} train step on batch 0, eager against captured:", {
        "eager": lambda: eg(pe, se, b0, gen), "graph": lambda: gr(pg, sg, b0, gen)},
        n=TURN_STEPS)
    check(cap.captures == 1, f"{label}: the timed steps captured anew")
    out = dict(bitwise=all(same) and ids_same, losses=losses, launches=g["counts"],
               graph_seg_merge=seg, k5_per_pass=k5, captures=cap.captures,
               replays=cap.replays, turns=turns,
               graph_kernels=sum(v for k, v in nodes.items() if not _is_copy(k)))
    if census:
        out["census"] = census_pair(label, lambda: cap.fn(staged.state, staged.inputs),
                                    nodes, len(graphs._leaves(staged.state)), out_dir)
        out["replay_busy"] = replay_busy(label, lambda: gr(pg, sg, b0, gen), out_dir)
    out["wall_s"] = time.perf_counter() - t0
    return out


def vae_captured_step(label, model_name, dev, root, census):
    """26b (and 26c with `census`): a VAE's train step at 21d's flags on its
    batch 0, eager (as the driver's tail step runs it) against one replay
    of the captured step, VAE_TURN_STEPS steps a turn; the graph launches no
    kernel of the port (its capture counted none, no seg_merge or sa
    node); with `census`, the graph's kernels against the profiler's
    trace of the captured function run eagerly on the graph's buffers,
    name for name (census_pair)."""
    from dagnn_tpu_torch import convert
    from dagnn_tpu_torch.cli import train_vae as tv
    from dagnn_tpu_torch.train import graphs
    flags = NA_FLAGS + ["--model", model_name, "--max-count", "256"]
    args = tv.parse_args(flags + ["--res_dir", f"{root}/{model_name}_step"])
    train, _, ga = tv.load_data(args)
    model = tv.VAEModel(args, ga, dev)
    params = model.init(0)
    opt = tv.make_optimizer(args.lr, args.clip)
    step = tv.make_train_step(model, opt)
    captured = tv.make_captured_step(step)
    captured.debug = True                       # keep the graph's nodes
    model.seed_host(args.seed, 1)
    host = model.prepare_host(train[:args.batch_size])
    prepared = convert.batch_to_torch(host, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    inputs = (host, np.asarray(1.0, np.float32), gen)
    key = ("vae", model.kind, convert.batch_key(inputs))
    state = [(params, opt.init(params), torch.zeros(3, device=dev))]

    def replay():
        state[0] = captured(key, state[0], inputs, (gen,))[0]

    replay()
    staged = captured.graphs[key, (gen,)]
    nodes = node_kinds(graphs.graph_nodes(staged.graph))
    ours = {k: v for k, v in nodes.items() if k in ONE_KERNEL.values()}
    print(f"{label} the graph's nodes: "
          f"{sum(v for k, v in nodes.items() if not _is_copy(k))} kernels, "
          f"{sum(v for k, v in nodes.items() if _is_copy(k))} copies and sets; "
          f"the port's kernels among them {ours}, its capture counted {staged.counts}")
    check(not ours and not staged.counts, f"{label}: the graph launches a kernel "
          "of the port")
    pe, se = params, opt.init(params)
    turns = timed_turns(f"{label} train step on batch 0, eager against captured:",
                        {"eager": lambda: step(pe, se, prepared, gen, 1.0),
                         "graph": replay}, n=VAE_TURN_STEPS)
    out = dict(turns=turns, graph_kernels=sum(v for k, v in nodes.items()
                                              if not _is_copy(k)))
    if census:
        out["census"] = census_pair(
            label, lambda: captured.fn(staged.state, staged.inputs), nodes,
            len(graphs._leaves(staged.state)), root)
        out["replay_busy"] = replay_busy(label, replay, root)
    return out


def k5_at_baseline_sum(label, host, dev, card, H=300):
    """K5 at the baselines' graph-level sum (the loader's batch 0: [N+1,
    H] f32 node rows onto its G+1 graph slots, the pad nodes masked)
    against its plain version, timed as phase 3d (50 calls from one CUDA
    graph, median of three windows; eager calls beside), with its bound
    (roofline.tg_costs) and index_add_ into a scratch row timed the same
    way."""
    from dagnn_tpu_torch import checks, convert
    from dagnn_tpu_torch.ops import row_step
    b = convert.batch_to_torch(host, dev)
    n1, G = b.x.shape[0], host.num_graph_slots
    gid, nmask = b.graph_id, b.node_mask
    g = torch.Generator(device=dev).manual_seed(0)
    h = torch.randn((n1, H), generator=g, device=dev)
    zero = torch.zeros((G + 1, H), device=dev)
    kern = row_step.tg_accumulate(zero, h, gid, nmask)
    plain = row_step.tg_accumulate_plain(zero, h, gid, nmask)
    idx = torch.where(nmask.bool(), gid.long(), G + 1)
    gpad = torch.zeros((G + 2, H), device=dev)
    lib = gpad.index_add(0, idx, h)[:G + 1]
    rel, ab, _ = checks.rel_err(kern, plain)
    nt = int(nmask.sum())
    nb, ops = tg_costs(G + 1, n1, nt, H, 4)
    lib_t = timings(lambda: gpad.index_add(0, idx, h))
    r = dict(timings(lambda: row_step.tg_accumulate(zero, h, gid, nmask)), err=ab,
             rel=rel, lib_rel=checks.rel_err(lib, plain)[0], bytes=nb, ops=ops,
             plain_ms=time_ms(lambda: row_step.tg_accumulate_plain(zero, h, gid, nmask), 5),
             library_ms=lib_t["ms"], library_call_ms=lib_t["call_ms"],
             bound=bound_ms(nb, ops, torch.float32), shape=[n1, H], graphs=G + 1,
             valid_rows=nt)
    print(f"{label} K5 at the baselines' graph sum [{n1}, {H}] f32 ({nt} valid rows) "
          f"onto {G + 1} graph slots on {card}: {r['ms']:.4f} ms from a CUDA graph "
          f"(windows {fmt_windows(r['windows'])}; eager {r['call_ms']:.4f}), plain "
          f"{r['plain_ms']:.4f} ms, index_add_ {r['library_ms']:.4f} ms (eager "
          f"{r['library_call_ms']:.4f}); bound {r['bound'][0]:.5f} ms ({r['bound'][1]}: "
          f"{nb / 1e6:.3f} MB, {ops / 1e6:.3f} MFLOP); kernel vs plain {rel:.3g} of "
          f"max (tolerance {TOL[torch.float32]:g}), index_add_ vs plain "
          f"{r['lib_rel']:.3g}")
    check(rel <= TOL[torch.float32], f"{label}: K5 disagrees with plain at the "
          "baselines' graph sum")
    return r


class _NonzeroMasterQuery(torch.autograd.Function):
    """ASAP's master query in its former form, the reference
    master_query_cost holds the fixed-shape forms to: a scatter max over
    E's nonzero (g, i, j) (a host sync: it cannot be captured), each tied
    pair's power-of-two share, an ordered sum onto the sources."""

    @staticmethod
    def forward(ctx, h, E):
        G, n, d = h.shape
        g, i, j = E.transpose(1, 2).nonzero(as_tuple=True)
        dest, src = g * n + i, g * n + j
        vals = h.reshape(G * n, d)[src]
        m = torch.full((G * n, d), torch.finfo(h.dtype).min, dtype=h.dtype,
                       device=h.device)
        m = m.scatter_reduce(0, dest[:, None].expand_as(vals), vals, "amax",
                             include_self=True)
        ctx.save_for_backward(h, dest, src, vals, m)
        return m.reshape(G, n, d)

    @staticmethod
    def backward(ctx, gout):
        from dagnn_tpu_torch.nn.pooling_baselines import _pow2_neg
        from dagnn_tpu_torch.ops.segment import SortedSegments
        h, dest, src, vals, m = ctx.saved_tensors
        G, n, d = h.shape
        tie = (vals == m[dest]).to(torch.int32)
        c = torch.cumsum(tie, 0)
        lo = torch.searchsorted(dest, dest)
        hi = torch.searchsorted(dest, dest, right=True)
        cz = torch.cat([torch.zeros((1, d), dtype=c.dtype, device=c.device), c])
        before, after = cz[:-1] - cz[lo], cz[hi] - cz[:-1] - tie
        w = _pow2_neg(after + (before > 0).to(torch.int32)) * tie.float()
        contrib = w * gout.reshape(G * n, d)[dest]
        return SortedSegments(src, G * n).sum(contrib).reshape(G, n, d), None


def master_query_cost(label, cfg, host, dev, card):
    """ASAP's master query (nn/pooling_baselines.master_query) at the
    driver's shapes: A~ of the loader's batch 0 (its dense per-graph
    adjacency plus self loops, [G, n, n] at dense_nodes n) and random ReLU
    states [G, n, asap_hidden], in both fixed-shape forms: over the
    candidate pairs of the batch's edges and self loops (the first pool's,
    the driver's path) and over blocks of sources (a later pool's). Each
    held to the form they replaced (_NonzeroMasterQuery: the forward bit
    for bit, the gradient within CROSS_TOL's rtol / atol, bit for bit
    printed); forward and forward + backward of each timed (CUDA events,
    mean of 3; the former form eager, its nonzero a host sync); the memory
    each fixed form takes beyond its inputs (peak allocated)."""
    from dagnn_tpu_torch import convert
    from dagnn_tpu_torch.nn import pooling_baselines as pb
    from dagnn_tpu_torch.nn.baselines import FlatEdges
    b = convert.batch_to_torch(host, dev)
    G, n, d = host.num_graph_slots, cfg.dense_nodes, cfg.asap_hidden
    nmask, gid = b.node_mask.bool(), b.graph_id.long()
    x = torch.zeros((b.x.shape[0], 1), device=dev)
    _, dmask, pos, ok = pb._dense_from_batch(x, gid, G, nmask, n)
    e = FlatEdges(b, b.x.shape[0])
    adj = pb._dense_adj(e, gid, pos, ok, G, n, torch.float32)
    E = (adj + torch.eye(n, device=dev)[None] * dmask[..., None]) > 0
    pairs = pb._edge_pairs(e, gid, pos, ok, G, n)
    g = torch.Generator(device=dev).manual_seed(0)
    h = torch.relu(torch.randn((G, n, d), generator=g, device=dev)).requires_grad_(True)
    ct = torch.randn((G, n, d), generator=g, device=dev)
    forms = {"pairs": lambda: pb._PairsMasterQuery.apply(h, E, *pairs),
             "blocks": lambda: pb._MasterQuery.apply(h, E),
             "former": lambda: _NonzeroMasterQuery.apply(h, E)}
    grad = lambda fn: torch.autograd.grad((fn() * ct).sum(), h)[0]

    def fwd(fn):
        with torch.no_grad():
            fn()

    want, g_want = forms["former"](), grad(forms["former"])
    r = dict(shape=[G, n, d], sources=int(E.sum()), candidates=int(pairs[0].shape[0]),
             source_blocks=len(pb._source_blocks(G, n, d)))
    for tag, fn in forms.items():
        t = dict(fwd_ms=time_ms(lambda: fwd(fn), 3),
                 fwd_bwd_ms=time_ms(lambda: grad(fn), 3))
        if tag != "former":
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            got, g_got = fn(), grad(fn)
            torch.cuda.synchronize()
            t.update(extra_bytes=torch.cuda.max_memory_allocated() - base,
                     forward_equal=torch.equal(got, want),
                     grad_equal=torch.equal(g_got, g_want),
                     grad_ratio=float(((g_got - g_want).abs() / (
                         CROSS_TOL["atol"] + CROSS_TOL["rtol"] * g_want.abs())).max()))
            del got, g_got
        r[tag] = t
    print(f"{label} ASAP's master query at [{G}, {n}, {d}] ({r['sources']} (source, "
          f"destination) pairs of A~ in {G * n * n}) on {card}: "
          + "; ".join(f"{tag} forward {t['fwd_ms']:.3f} ms, forward + backward "
                      f"{t['fwd_bwd_ms']:.3f} ms" for tag, t in r.items()
                      if isinstance(t, dict))
          + f" (pairs: {r['candidates']} candidates; blocks: {r['source_blocks']} of "
          f"{pb.MASTER_QUERY_BLOCK_BYTES / 2**20:.0f} MiB; former: nonzero, eager); "
          + "; ".join(f"{tag} {r[tag]['extra_bytes'] / 2**30:.3f} GiB beyond its inputs "
                      f"at the peak, against the former form: forward bit for bit "
                      f"{r[tag]['forward_equal']}, gradient bit for bit "
                      f"{r[tag]['grad_equal']}, at {r[tag]['grad_ratio']:.3g} of rtol "
                      f"{CROSS_TOL['rtol']:g} / atol {CROSS_TOL['atol']:g}"
                      for tag in ("pairs", "blocks")))
    check(all(r[t]["forward_equal"] and r[t]["grad_ratio"] <= 1.0
              for t in ("pairs", "blocks")),
          f"{label}: a fixed-shape master query disagrees with the form it replaced")
    return r


def phase_captured_models(dev, card, argv, first_epochs):
    """Phase 26: the captured steps of every model of the drivers but
    DAGNN. 26a: each baseline of CAPTURED_BASELINES at the driver's
    defaults (float32, batch 160) on phase 22's corpus, three batches of
    one bucket (baseline_graph_vs_eager); K5 at the baselines' graph sum
    timed from a CUDA graph (k5_at_baseline_sum); ASAP's master query
    (master_query_cost). 26b: each of OTHER_VAES, train_vae at 21d's
    flags, 21d's captured first epoch (`first_epochs`, by model) against
    one epoch all eager (vae_graph_vs_eager: the loss sums and the
    parameters bit for bit, epoch seconds each way), and its step eager
    against captured (vae_captured_step). 26c: the census on
    CENSUS_MODELS."""
    import shutil
    import tempfile
    from dagnn_tpu_torch.cli import ogb_driver
    out = dict(baselines={}, vaes={})
    args = ogb_driver.add_common_args(argparse.ArgumentParser()).parse_args(
        DRIVER_FLAGS)
    data = ogb_driver.load_dataset(args, "tok")
    hosts = baseline_hosts(data, 3)
    print(f"[26a] three batches of one bucket of the baselines' loader on phase 22's "
          f"corpus: {int(hosts[0].x.shape[0])} node rows, "
          f"{int(hosts[0].edge_src_flat.shape[0])} edge rows, "
          f"{hosts[0].num_graph_slots} graph slots; real nodes "
          f"{[int(h.n_node) for h in hosts]}")
    root = tempfile.mkdtemp(prefix="chip_smoke_captured_models_")
    try:
        out["k5"] = k5_at_baseline_sum("[26a]", hosts[0], dev, card)
        out["master_query"] = master_query_cost(
            "[26a]", baseline_cfg("asap", "tok", data), hosts[0], dev, card)
        for gnn in CAPTURED_BASELINES:
            cfg = baseline_cfg(gnn, "tok", data)
            tag = "[26c" if gnn in CENSUS_MODELS else "[26a"
            out["baselines"][gnn] = r = baseline_graph_vs_eager(
                f"{tag} {gnn}]", cfg, hosts, dev, root, gnn in CENSUS_MODELS)
            print(f"{tag} {gnn}] took {r['wall_s']:.1f} s")
        for m in OTHER_VAES:
            t0 = time.perf_counter()
            flags = NA_FLAGS + ["--model", m, "--max-count", "256"]
            epoch = vae_graph_vs_eager(f"[26b {m}]", flags, root, 1,
                                       graph=first_epochs[m])
            tag = "[26c" if m in CENSUS_MODELS else "[26b"
            epoch["step"] = vae_captured_step(f"{tag} {m}]", m, dev, root,
                                              m in CENSUS_MODELS)
            epoch["wall_s"] = time.perf_counter() - t0
            out["vaes"][m] = epoch
            print(f"{tag} {m}] took {epoch['wall_s']:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# ---------------------- the launchers as a user starts them (phase 27)

LAUNCHERS = os.path.join("dagnn_tpu_torch", "scripts")
# what the launchers read from the environment, cleared before each run
LAUNCHER_VARS = ("DATA_ROOT", "TRAIN_IDX", "BS", "LR", "CLIP", "FOLDS", "PATIENCE",
                 "EMB", "LAYERS", "AGG", "BIDIR", "POOL", "EPOCHS", "HS", "NZ",
                 "SAVE_INTERVAL", "RES", "DATA", "CKPT", "SEEDS", "ROUNDS")


def run_launcher(label, script, env, args, say=print, procs=None):
    """bash dagnn_tpu_torch/scripts/<script> `args` from the checkout's
    root, in a process group of its own (appended to `procs`, so that a
    caller can end it), with `env` as a user sets it; exit code 0 within
    600 s, its output on cuda (the CLI's own line). Returns (seconds,
    output)."""
    root = os.path.dirname(os.path.abspath(__file__))
    base = {k: v for k, v in os.environ.items() if k not in LAUNCHER_VARS}
    t0 = time.perf_counter()
    p = subprocess.Popen(["bash", os.path.join(LAUNCHERS, script), *args], cwd=root,
                         env={**base, **env}, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True, start_new_session=True)
    if procs is not None:
        procs.append(p)
    try:
        stdout, stderr = p.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        end_group(p)
        stdout, stderr = p.communicate()
    secs = time.perf_counter() - t0
    say(f"{label} {' '.join(f'{k}={v}' for k, v in env.items())} bash "
        f"{LAUNCHERS}/{script} {' '.join(args)}: exit {p.returncode} in {secs:.1f} s")
    check(p.returncode == 0, f"{script} exited {p.returncode}:\n{stdout[-2000:]}"
          f"\n{stderr[-3000:]}")
    check(re.search(r", on cuda(:\d+)?$", stdout, re.M) is not None,
          f"{script}: no line of its CLI saying it ran on cuda")
    return secs, stdout


def end_group(p):
    """Kill the process group a Popen started with start_new_session leads
    (bash and the python it runs), if it is still running."""
    import signal
    if p.poll() is None:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(p.pid, signal.SIGKILL)
        p.wait()


def _finite_csv(label, path):
    check(os.path.exists(path), f"{label}: {path} was not written")
    rows = _csv_rows(path)
    check(rows and all(math.isfinite(v) for r in rows for v in r),
          f"{label}: {path} holds no rows or a non-finite number")
    return rows


def _vae_launch_gates(label, out, res, files, layers=2, dirs=1, bs=32, say=print):
    """train_vae's output run by a launcher, one epoch: the loss finite,
    every step a replay of the captured train step (one capture for the
    full batches, one for the tail), K6 forward / backward and K5
    launched as many times as those replays' passes make them (per level,
    layer and direction: 2, 1, 1), and its files."""
    m = re.search(r"^(\d+) train / (\d+) test, nvt=\d+ max_n=(\d+), on cuda", out, re.M)
    cap = re.search(r"captured train step \(captures / replays\) this run: "
                    r"(\d+) / (\d+)", out)
    got = re.search(r"kernel launches this epoch: (.*)$", out, re.M)
    check(m and cap and got, f"{label}: the driver printed no corpus, captures or "
          f"launches line")
    n_train, max_n = int(m[1]), int(m[3])
    steps = -(-n_train // bs)
    launches = {k: int(v) for k, v in (kv.rsplit(" ", 1) for kv in got[1].split(", "))}
    n = max_n * layers * dirs * steps
    want = {"segment_attn_backward": n, "segment_attn_forward": 2 * n,
            "tg_accumulate": n}
    say(f"{label} {n_train} train graphs, {steps} steps of {bs} (the tail "
          f"{n_train - (steps - 1) * bs}): captures / replays {cap[1]} / {cap[2]}; "
          f"launches {launches}, from the replays {want}")
    check((int(cap[1]), int(cap[2])) == (2, steps),
          f"{label}: the epoch's steps were not each one replay, tail included")
    check(launches == want, f"{label}: K6 / K5 launches differ from the replays'")
    rows = _finite_csv(label, os.path.join(res, "train_loss.txt"))
    for name in files:
        check(os.path.exists(os.path.join(res, name)), f"{label}: no {name}")
    return {"n_train": n_train, "steps": steps, "loss": rows[-1][1],
            "launches": launches}


def _bo_launch_gates(label, out, res, say=print):
    """run_bo + summarize run by a launcher: one seed's scores finite, its
    BO round's best architecture written, the summary printed."""
    with open(os.path.join(res, "Test_RMSE_ll.txt")) as f:
        rows = re.findall(r"Test RMSE: (\S+), ll: (\S+), Pearson r: (\S+)", f.read())
    check(len(rows) == 1 and all(math.isfinite(float(v)) for v in rows[0]),
          f"{label}: Test_RMSE_ll.txt holds {rows}")
    arcs = os.path.join(res, "best_arc_scores.txt")
    check(os.path.exists(arcs), f"{label}: no best_arc_scores.txt (no valid arc)")
    with open(arcs) as f:
        best = [float(ln.rsplit(",", 1)[1]) for ln in f if ln.strip()]
    check(len(best) == 1 and math.isfinite(best[0]), f"{label}: best scores {best}")
    check("1 seeds" in out and "best architecture scores:" in out,
          f"{label}: summarize printed no summary")
    rmse, ll, r = (float(v) for v in rows[0])
    say(f"{label} seed 0: RMSE {rmse:.4f}, ll {ll:.4f}, Pearson r {r:.4f}; "
          f"round 0 best {best[0]}")
    return {"rmse": rmse, "ll": ll, "pearson_r": r, "best": best[0]}


def phase_launchers(say=print, procs=None):
    """Phase 27: the six protocol launchers, four chains at once (each
    step a process of its own, as a user starts it). Its lines go to
    `say`; each launcher's process to `procs` (see run_launcher)."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_launchers_")
    d = lambda tag: os.path.join(tmp, tag)

    launch = functools.partial(run_launcher, say=say, procs=procs)

    def na():
        s1, out = launch("[27 na]", "na_train.sh", {
            "EPOCHS": "1", "SAVE_INTERVAL": "1", "RES": d("na")},
            ["DAGNN", "--max-count", "1000"])
        r = {"train_s": s1, **_vae_launch_gates(
            "[27 na]", out, d("na"), ("DAGNN_0_1.ckpt", "test_results.txt",
                                      "final_structures6_latent_epoch1.mat"), say=say)}
        s2, out = launch("[27 na]", "na_eval.sh", {
            "CKPT": os.path.join(d("na"), "DAGNN_0_1.ckpt"), "SEEDS": "1",
            "ROUNDS": "1", "RES": d("bo")},
            [os.path.join(d("na"), "final_structures6_latent_epoch1.mat")])
        return {**r, "eval_s": s2, **_bo_launch_gates("[27 na]", out, d("bo"), say=say)}

    def ogb(script, task):
        secs, _ = launch(f"[27 {task}]", script, {"EPOCHS": "1", "FOLDS": "1"}, [
            "--synthetic", "400", "--dir_results", d(task), "--dir_save",
            d(task + "_saved")])
        rows = _finite_csv(f"[27 {task}]", os.path.join(d(task), f"dagnn_{task}.csv"))
        _finite_csv(f"[27 {task}]", os.path.join(d(task), f"dagnn_{task}_train.csv"))
        return {"seconds": secs, "row": rows[-1]}

    def bn():
        s1, out = launch("[27 bn]", "bn_train.sh", {"EPOCHS": "1", "RES": d("bn")},
                         ["DAGNN_BN", "--max-count", "512"])
        r = {"train_s": s1, **_vae_launch_gates(
            "[27 bn]", out, d("bn"), ("DAGNN_BN_0_1.ckpt", "asia_200k_latent_epoch1.mat"),
            dirs=2, bs=128, say=say)}
        s2, out = launch("[27 bn]", "bn_eval.sh", {
            "CKPT": os.path.join(d("bn"), "DAGNN_BN_0_1.ckpt"), "SEEDS": "1",
            "ROUNDS": "1", "RES": d("bo_bn")},
            [os.path.join(d("bn"), "asia_200k_latent_epoch1.mat")])
        return {**r, "eval_s": s2, **_bo_launch_gates("[27 bn]", out, d("bo_bn"), say=say)}

    try:
        with ThreadPoolExecutor(4) as pool:
            runs = {"na": pool.submit(na), "tok": pool.submit(ogb, "ogb_tok.sh", "tok"),
                    "lp": pool.submit(ogb, "ogb_lp.sh", "lp"), "bn": pool.submit(bn)}
            out = {k: f.result() for k, f in runs.items()}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t0
    return out


class Beside:
    """The work that runs in processes of its own, started together to
    run beside the phases that follow (each in-process phase counts only
    this process's launches): phase 23's two gloo spawns
    (start_parallel), 24e's rehearsal (start_rehearsal) and phase 27's
    launcher chains (phase_launchers in a thread, its lines kept for phase
    27). wait() ends the rehearsal and the launchers; stop() kills
    whatever still runs (a failed check)."""

    def __init__(self, dev, graphs, params, cfg):
        from concurrent.futures import ThreadPoolExecutor
        self.t0 = time.perf_counter()
        self.procs, self.lines = [], []
        self.parallel = self.rehearsal = None
        self.pool = ThreadPoolExecutor(1)
        self.launchers = self.pool.submit(phase_launchers, self.lines.append,
                                          self.procs)
        try:
            self.rehearsal = start_rehearsal()
            self.parallel = start_parallel(dev, graphs, params, cfg)
        except BaseException:
            self.stop()
            raise

    def wait(self):
        """The launchers' results and the seconds waited for them and for
        the rehearsal."""
        t0 = time.perf_counter()
        wait_rehearsal(self.rehearsal)
        out = self.launchers.result(timeout=1200)
        return out, time.perf_counter() - t0

    def stop(self):
        import multiprocessing
        for p in self.procs:
            end_group(p)
        if self.rehearsal and self.rehearsal[0].poll() is None:
            self.rehearsal[0].kill()
            self.rehearsal[0].wait()
        for c in multiprocessing.active_children():
            c.kill()
        if self.parallel:
            self.parallel["worlds"].close()
            self.parallel["pool"].shutdown(wait=False, cancel_futures=True)
        self.pool.shutdown(wait=False, cancel_futures=True)


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

    t_start = time.perf_counter()

    def at(label):
        print(f"{label} {time.perf_counter() - t_start:.1f} s into the script")

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

    at("[3]")
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

    at("[4]")
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
    at("[9a]")
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
    at("[12a]")
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
    at("[17]")
    ab = {f"{a}/{b}": phase_ab("[17]", a, b, steppers) for a, b in (
        ("merged", "nearfar_rt"), ("merged", "nearfar_r"),
        ("unidirectional", "nearfar_unidirectional"), ("merged", "merged_k2r"))}
    at("[18]")
    print("[18] the TOK driver (main_tok.main), runs A (2 epochs), B (resumed "
          "to 3), C (3 afresh): " + " ".join(DRIVER_FLAGS))
    driver = phase_driver(card)
    at("[19]")
    print("[19] the LP driver (main_lp.main) at its defaults (gated_sum, "
          "unidirectional), runs A, B, C as in 18: " + " ".join(DRIVER_FLAGS))
    lp = phase_lp_driver(card)
    at("[19b]")
    print("[19b] every aggregator kind at the flagship's widths on phase 4's "
          "batch, one bf16 train pass each, kernels against plain")
    kinds = phase_kinds(dev, batch, card)
    node_space = phase_node_space(dev, batch, card)
    at("[20]")
    print("[20] the VAE driver (train_vae.main): NA runs A (2 epochs), B (resumed "
          "to 3), C (3 afresh): " + " ".join(NA_FLAGS))
    import shutil
    import tempfile
    root = tempfile.mkdtemp(prefix="chip_smoke_vae_")
    beside = None
    try:
        try:
            vae = phase_vae(dev, card, argv, root)
            # every phase whose kernels the kernel table times has run: the
            # work in processes of its own starts here, beside 21 and 22
            at("[21]")
            beside = Beside(dev, graphs, params, cfg)
            print(f"[21] started in {time.perf_counter() - beside.t0:.1f} s, to run "
                  "beside phases 21 and 22: phase 23's spawns (2 and 4 gloo ranks), "
                  "24e's rehearsal, phase 27's four launcher chains")
            t0 = time.perf_counter()
            print("[21] latent scoring and BO (run_bo, summarize) on phase 20's "
                  "latents and checkpoints; the other VAEs (train_vae.main)")
            scoring = phase_latent_scoring(dev, card, root)
            scoring["wall_s"] = time.perf_counter() - t0
            first_epochs = {m: scoring["other_vaes"][m.lower()].pop("first_epoch")
                            for m in OTHER_VAES}
            print(f"[21] {card}: phase 21 took {scoring['wall_s']:.1f} s")
        finally:
            shutil.rmtree(root, ignore_errors=True)
        at("[22]")
        t0 = time.perf_counter()
        print("[22] the ogbg-code2 baselines (main_tok / main_lp --gnn ..., main_basic) "
              "at the driver's defaults, float32, on phase 18's corpus")
        baselines = phase_baselines(dev, card, argv)
        baselines["wall_s"] = time.perf_counter() - t0
        print(f"[22] {card}: phase 22 took {baselines['wall_s']:.1f} s")
        at("[23]")
        launchers, waited = beside.wait()
        print(f"[23] waited {waited:.1f} s for 24e's rehearsal and phase 27's "
              f"launchers, started {time.perf_counter() - beside.t0:.1f} s ago")
        print("[23] the parallel layer (cli.dryrun, data-parallel and edge-partitioned "
              "steps, cli.bench_scaling) at the flagship's widths on phase 4's batch, "
              "ranks on this one card")
        parallel = phase_parallel(dev, card, graphs, params, cfg, started=beside.parallel)
        at("[24]")
        print("[24] the bench (python -m dagnn_tpu_torch.bench) and the tools of "
              "dagnn_tpu_torch/scripts/ in process: the row and pair microbenches, "
              "ep_decompose, rehearse_preprocess --graphs 20000, bn_ceiling")
        tools = phase_tools(dev, card, {"merged": merged["edges_per_s"],
                                        "pair": paired["edges_per_s"]},
                            rehearsal=beside.rehearsal)
        at("[25]")
        t0 = time.perf_counter()
        print("[25] the captured steps (dagnn_tpu_torch/train/graphs.py) against the "
              "eager steps: the flagship TOK step (merged, pair), LP, the NA and BN "
              "VAEs, the bench")
        captured = phase_graphs(dev, card, argv, vae["na"]["rows_c"],
                                vae["na"]["epoch_s"])
        captured["wall_s"] = time.perf_counter() - t0
        print(f"[25] {card}: phase 25 took {captured['wall_s']:.1f} s")
        at("[26]")
        t0 = time.perf_counter()
        print("[26] the captured steps of every other model of the drivers: each "
              "baseline's train step and predict, each other VAE's train step")
        others = phase_captured_models(dev, card, argv, first_epochs)
        others["wall_s"] = time.perf_counter() - t0
        print(f"[26] {card}: phase 26 took {others['wall_s']:.1f} s")
    finally:
        if beside is not None:
            beside.stop()
    at("[27]")
    print("[27] the launchers of dagnn_tpu_torch/scripts/ as a user starts them, "
          "bash on the card, four chains at once: na_train.sh -> na_eval.sh, "
          "ogb_tok.sh, ogb_lp.sh, bn_train.sh -> bn_eval.sh; run beside phases 21 "
          "and 22")
    print("\n".join(beside.lines))
    print(f"[27] {card}: the four chains took {launchers['wall_s']:.1f} s")
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
                                                 if isinstance(v, dict) and "launches" in v},
                                              "dp_rank": parallel["dp"],
                                              "ep_rank": parallel["ep"][2],
                                              "bench_pair": tools["bench"]["pair"],
                                              "bench_merged": tools["bench"]["merged"],
                                              "bench_17_steps": tools["bench"]["steps17"],
                                              **{f"graph {t}": captured[t] for t in
                                                 ("merged", "pair", "pallas", "lp")},
                                              **{f"graph baseline {t}": v for t, v in
                                                 others["baselines"].items()},
                                              **{f"graph {k}_x1": parallel["graphs"][k]
                                                 for k in ("dp", "ep")},
                                              "ep_decompose_dp1": {"launches": tools[
                                                  "ep_decompose"]["dp1_launches"]},
                                              "ep_decompose_ep1": {"launches": tools[
                                                  "ep_decompose"]["ep1_launches"]},
                                              **{f"launcher {t}_train": launchers[t]
                                                 for t in ("na", "bn")}}.items()
                                             if v["launches"].get(name)}})
        ep_err = [parallel["ep"][D]["probe"].get(f"bfloat16 {name}") for D in (2, 4)]
        if ep_err[0]:
            # every call of the EP ranks' pass at its own shapes (23c)
            kernels[-1]["max_abs_err_by_path"] = {
                "ep_rank": max(e["max_abs_err"] for e in ep_err)}
        if kern == "K5":
            r = others["k5"]
            kernels[-1]["baseline_graph_sum_f32"] = {
                "ms": r["ms"], "plain_ms": r["plain_ms"], "max_abs_err": r["err"],
                "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                "library_ms": r["library_ms"]}
        if kern in vae["na"]["kernels"]["float32"]:
            r = vae["na"]["kernels"]["float32"][kern]
            kernels[-1]["vae_na_f32"] = {
                "ms": r["ms"], "plain_ms": r["plain_ms"], "max_abs_err": r["err"],
                "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                "library_ms": r["library_ms"]}
    print(json.dumps({**runs, "tok_driver": driver, "lp_driver": lp, "kinds": kinds,
                      "node_space": node_space, "vae": vae, "latent_scoring": scoring,
                      "baselines": baselines, "parallel": parallel, "tools": tools,
                      "captured_steps": captured, "captured_models": others,
                      "launchers": launchers,
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
    print(f"chip_smoke took {time.perf_counter() - t_start:.1f} s on {card}")
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

"""Benchmark: edges/s per GPU on the flagship DAGNN fwd+bwd train step.

The JAX package's bench.py on the port. The ogbg-code2-TOK-shaped
workload (160 synthetic ASTs of mean 125 nodes, emb/hidden 300,
bidirectional attn_h, bf16: flagship.flagship_cfg) runs through the
driver's train step (cli/ogb_driver.make_step_fns: the TOK loss, then Adam
with gradient clip 0.25) and prints ONE JSON line: raw graph edges (not
direction-multiplied, bench.py:5-9) over the host-clock seconds of the
train steps, per GPU. vs_baseline is value / 1e6, the JAX bench's nominal
bar.

The path: by default a pair plan of 2 (the pair-scheduled wavefront, K3/K4
in csrc/wavefront.cu; --pairN a plan of N), --nopair the direction-merged
rows (K1/K2). Timing: DAGNN_BENCH_STEPS steps a group (default 2), one
warm-up group, then max(1, 16 // steps) groups between two
torch.cuda.synchronize() calls (the JAX bench's 16 // steps times no
group above 16 steps). A group is one captured step (train/graphs.py):
its steps chained in one CUDA graph, replayed once a group after the
batch is copied into its buffers, as the JAX bench jits them into one
program (bench.py:171-190); the warm-up group captures it. --eager runs
each step launch by launch instead. The metric line's "step" says which
("graph" or "eager").

--roofline adds a second line: roofline.roofline's accounting of one step
(model and executed TFLOP, mfu against the card's bf16 peak, the HBM
estimate, rows and scan steps and the time each takes) and the device's
busy share of one profiled group after the timed window (a replay, or
the eager steps), its launches counted per step. The card's peaks
come from roofline.PEAKS; a card without an entry raises.

    python -m dagnn_tpu_torch.bench [--nopair | --pairN] [--roofline] [--eager]
    python -m dagnn_tpu_torch.bench --cpu     # the plain versions, no card

Without a card and without --cpu it raises. On the CPU no kernel launches
and no device is measured: the peak shares, the executed census and the
busy share read null, and `device` says "cpu".
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import torch

BASELINE_EDGES_PER_S = 1.0e6
# the workload (bench.py:137-153); the CPU tests set them small
GRAPHS = 160
MEAN_NODES = 125
WIDTH = 300        # emb and hidden


def parse_args(argv):
    """(pair plan size, 0 for the merged rows; --roofline; --cpu;
    --eager)."""
    pair, roofline, cpu, eager = 2, False, False, False
    for a in argv:
        if a == "--nopair":
            pair = 0
        elif a.startswith("--pair") and a[6:].isdigit() and int(a[6:]) > 0:
            pair = int(a[6:])
        elif a == "--roofline":
            roofline = True
        elif a == "--cpu":
            cpu = True
        elif a == "--eager":
            eager = True
        else:
            raise SystemExit(f"usage: python -m dagnn_tpu_torch.bench [--nopair | "
                             f"--pairN] [--roofline] [--cpu] [--eager]; got {a!r}")
    return pair, roofline, cpu, eager


def main(argv=None) -> dict:
    """Run the bench; print its line(s). Returns {"metric": line 1,
    "roofline": line 2 or None, "passes": train steps run, "n_chain",
    "iters", "captured": the CapturedStep (None with --eager)}."""
    pair, want_roofline, cpu, eager = parse_args(
        sys.argv[1:] if argv is None else argv)
    from dagnn_tpu_torch import convert, flagship, resolve_device, roofline
    from dagnn_tpu_torch.cli.ogb_driver import make_step_fns
    from dagnn_tpu_torch.dag.batch import collate
    from dagnn_tpu_torch.data.synthetic import synthetic_ast_batch
    from dagnn_tpu_torch.nn.dagnn import dagnn_init
    from dagnn_tpu_torch.ops import read_launch_counts
    from dagnn_tpu_torch.train.graphs import CapturedStep
    from dagnn_tpu_torch.train.optim import make_optimizer
    from dagnn_tpu_torch.utils import profiling

    dev = resolve_device("cpu" if cpu else "cuda")
    card = "cpu" if cpu else torch.cuda.get_device_name(dev)
    card_peaks = None if cpu or not want_roofline else roofline.peaks(card)
    sync = (lambda: None) if cpu else torch.cuda.synchronize
    n_chain = int(os.environ.get("DAGNN_BENCH_STEPS", "2"))
    if n_chain < 1:
        raise ValueError(f"DAGNN_BENCH_STEPS must be at least 1, got {n_chain}")
    iters = max(1, 16 // n_chain)

    cfg = flagship.flagship_cfg(emb=WIDTH, hidden=WIDTH)
    graphs = synthetic_ast_batch(0, GRAPHS, mean_nodes=MEAN_NODES)
    host = collate(graphs, flagship.pad_for(graphs, pair=pair))
    batch = convert.batch_to_torch(host, dev)
    params = dagnn_init(torch.Generator().manual_seed(0), cfg, device=dev)
    opt = make_optimizer(lr=1e-3, clip=0.25)
    train_step, _ = make_step_fns(cfg, opt, "tok", capture=False)
    state = opt.init(params)

    def chain(st, b):
        p, s = st
        for _ in range(n_chain):
            p, s, loss, _ = train_step(p, s, b)
        return (p, s), loss

    captured = None if eager else CapturedStep(chain)

    def group(p, s):
        if captured is None:
            (p, s), loss = chain((p, s), batch)
        else:
            (p, s), loss = captured(("bench", n_chain), (p, s), batch)
        return p, s, loss

    params, state, loss = group(params, state)     # warm-up (and kernel build)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        params, state, loss = group(params, state)
    sync()
    dt = time.perf_counter() - t0
    if not torch.isfinite(loss):
        raise RuntimeError(f"the bench's last train step gave a non-finite loss {loss}")
    n_edges = int(host.n_edge)
    eps = n_edges * n_chain * iters / dt
    line = {"metric": "edges_per_s_per_chip_fwdbwd", "value": eps,
            "unit": "edges/s", "vs_baseline": eps / BASELINE_EDGES_PER_S,
            "device": card, "step": "eager" if eager else "graph"}
    print(json.dumps(line))
    out = {"metric": line, "roofline": None, "passes": n_chain * (iters + 1),
           "n_chain": n_chain, "iters": iters, "captured": captured}
    if want_roofline:
        # one more group under the profiler: its kernel launches a step
        # (the counts before and after, over n_chain) and the device's
        # busy share
        before = read_launch_counts()
        with tempfile.TemporaryDirectory(prefix="dagnn_bench_") as tmp:
            path = profiling.profile_step(lambda: group(params, state),
                                          iters=1, logdir=tmp, name="bench_step.json")
            busy = profiling.device_busy(profiling.device_events(path))
        out["passes"] += n_chain
        after = read_launch_counts()
        launches = {k: (after[k] - before[k]) // n_chain for k in after
                    if after[k] != before[k]}
        n_params = sum(v.numel() for v in params.values())
        r = roofline.roofline(cfg, host, dt / iters / n_chain, n_params, card_peaks,
                              launches or None, busy and busy["share"])
        out["roofline"] = {"metric": "roofline", **r, "n_params": n_params,
                           "launches": launches, "device": card}
        print(json.dumps(out["roofline"]))
    return out


if __name__ == "__main__":
    main()

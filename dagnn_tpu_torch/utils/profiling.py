"""Device profiling: trace capture and op-level aggregation.

Counterpart of dagnn_tpu/utils/profiling.py on torch.profiler: capture a
trace around any callable (CPU and, where a card is present, CUDA
activity), export it as a chrome trace, and rank the device operations
by their summed time, without TensorBoard. The JAX package's other
utility, utils/cache.py (the XLA compilation cache), has no counterpart:
the port compiles its kernels with nvcc into a cache of its own
(ops/build.py).

    from dagnn_tpu_torch.utils.profiling import profile_step, summarize_trace
    path = profile_step(lambda: step(params, state, batch), iters=3)
    for row in summarize_trace(path, top=20, iters=3):
        print(row)

or from the CLI:

    python -m dagnn_tpu_torch.utils.profiling traces/step_trace.json --top 30
    python -m dagnn_tpu_torch.utils.profiling trace.json --cpu-ops   # host ops

A CUDA kernel's trace name is its demangled signature; rows are keyed by
the short name (no "void ", namespaces kept, template arguments and the
parameter list cut), with one full signature kept as the row's example.
"""

from __future__ import annotations

import collections
import gzip
import json
import os
from typing import Callable, Dict, List, Optional

# chrome-trace categories of the work a card does (kernels, copies, sets)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def profile_step(fn: Callable[[], object], iters: int = 3,
                 logdir: str = "traces", name: str = "step_trace.json") -> str:
    """Run `fn` `iters` times under torch.profiler (CPU activity, and CUDA
    activity where a card is present); return the exported chrome trace's
    path, logdir/name (gzipped when name ends in .gz).

    `fn` should run one warm step: warm up outside for clean numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        if cuda:
            torch.cuda.synchronize()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, name)
    prof.export_chrome_trace(path)
    return path


def load_events(path: str) -> List[Dict]:
    """The complete ("X") events of a chrome trace, .json or .json.gz."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        tr = json.load(f)
    ev = tr["traceEvents"] if isinstance(tr, dict) else tr
    return [e for e in ev if e.get("ph") == "X"]


def device_events(path: str, categories=DEVICE_CATEGORIES) -> List[Dict]:
    """The trace's events of the given categories (the card's, by default)."""
    return [e for e in load_events(path) if e.get("cat") in categories]


def short_name(name: str) -> str:
    """A kernel's demangled signature cut to its name."""
    name = name.replace("void ", "").replace("(anonymous namespace)::", "")
    return name.split("<")[0].split("(")[0]


def summarize_trace(path: str, top: int = 25, iters: Optional[int] = None,
                    categories=DEVICE_CATEGORIES) -> List[Dict]:
    """Aggregate the durations of the trace's device operations (or of the
    events of `categories`, e.g. ("cpu_op",) for the host's operators).

    Returns rows sorted by total time: {name, total_us, count, mean_us,
    category, example}, divided by `iters` when given so the numbers read
    per step. A trace without such events gives no rows."""
    dur = collections.Counter()
    cnt = collections.Counter()
    meta: Dict[str, Dict] = {}
    for e in device_events(path, categories):
        name = short_name(e["name"])
        dur[name] += e.get("dur", 0)
        cnt[name] += 1
        if name not in meta:
            meta[name] = {"category": e.get("cat", ""),
                          "example": e["name"][:160]}
    div = iters or 1
    return [{"name": name,
             "total_us": round(d / div, 1),
             "count": cnt[name] // div,
             "mean_us": round(d / max(cnt[name], 1), 2),
             **meta[name]}
            for name, d in dur.most_common(top)]


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("trace", help="path to a chrome trace (.json or .json.gz)")
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--iters", type=int, default=None,
                   help="divide totals by this (per-step numbers)")
    p.add_argument("--cpu-ops", action="store_true",
                   help="rank the host's operators instead of the device's")
    args = p.parse_args(argv)
    cats = ("cpu_op",) if args.cpu_ops else DEVICE_CATEGORIES
    rows = summarize_trace(args.trace, top=args.top, iters=args.iters,
                           categories=cats)
    if not rows:
        print("the trace holds no events of " + ", ".join(cats))
    w = max((len(r["name"]) for r in rows), default=10)
    for r in rows:
        print(f"{r['total_us']:>12.1f} us  x{r['count']:<6} "
              f"{r['name']:<{w}}  {r['category']}")
    return rows


if __name__ == "__main__":
    main()

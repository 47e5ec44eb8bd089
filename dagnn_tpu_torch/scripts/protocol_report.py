"""The NA protocol's records of the port held against the JAX package's.

Reads what `dagnn_tpu_torch/scripts/na_train.sh` and `na_eval.sh` write
(train_loss.txt, test_results.txt; Test_RMSE_ll.txt, best_arc_scores.txt)
and the JAX package's committed records of the same protocol
(results/na/, results/bo_enas_bo/), both result directories read through
the port's own `cli.summarize`, and prints one markdown table, each row
with its limit and whether the port met it:

  * at every tenth epoch both runs reached, the mean loss of the last 10
    epochs within 0.5x-2x of JAX's mean over the same epochs;
  * the test reconstruction loss at the last epoch at most 2x JAX's;
  * the seeds' mean Pearson r at least JAX's less 0.02, the mean RMSE at
    most 1.1x JAX's;
  * every BO round with a valid architecture, the best score beside JAX's.

Where the port's directories also hold the launchers' output with each
line stamped by the host clock (train_log.txt, eval_log.txt: "<unix
seconds> <line>"), the times follow: epoch seconds, a latent extraction,
a seed of scoring, a BO round.

    python -m dagnn_tpu_torch.scripts.protocol_report \\
        --port results/torch_na --port-bo results/torch_bo_enas_bo
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import io
import os
import re

import numpy as np

from dagnn_tpu_torch.cli import summarize


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--port", default="results/torch_na")
    p.add_argument("--port-bo", default="results/torch_bo_enas_bo")
    p.add_argument("--jax", default="results/na")
    p.add_argument("--jax-bo", default="results/bo_enas_bo")
    return p.parse_args(argv)


def losses(res_dir):
    """{epoch: mean loss} of train_loss.txt."""
    with open(os.path.join(res_dir, "train_loss.txt")) as f:
        return {int(r[0]): float(r[1]) for r in list(csv.reader(f))[1:]}


def test_recon(res_dir):
    with open(os.path.join(res_dir, "test_results.txt")) as f:
        return float(re.findall(r"recon loss: (\S+)", f.read())[-1])


def read_bo(res_dir):
    """(rows [seeds, (rmse, ll, r)], best scores in file order), both as
    cli.summarize prints them."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        summarize.main(["--res_dir", res_dir])
    text = out.getvalue().split("best architecture scores:")
    best = [float(ln.rsplit(",", 1)[1]) for ln in text[1].splitlines()
            if ln.strip()] if len(text) > 1 else []
    return summarize.parse_rmse_ll(os.path.join(res_dir, "Test_RMSE_ll.txt")), best


def stamped(path):
    """[(seconds, line)] of a log stamped by the host clock, or []."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [(float(t), ln) for t, _, ln in
                (s.rstrip("\n").partition(" ") for s in f) if t]


def times(port, port_bo):
    """Lines on the times the stamped logs hold."""
    lines = []
    train = stamped(os.path.join(port, "train_log.txt"))
    ep = [float(m[1]) for _, ln in train
          for m in [re.search(r"====> Epoch: \d+ .*\[([\d.]+)s\]", ln)] if m]
    lat = [float(m[1]) for _, ln in train
           for m in [re.search(r"saved latent .*\[([\d.]+)s\]", ln)] if m]
    if ep:
        lines.append(f"- epoch seconds: first {ep[0]:.1f} (the kernels' build and the "
                     f"captures in it), then {min(ep[1:]):.1f}-{max(ep[1:]):.1f}, mean "
                     f"{np.mean(ep[1:]):.2f} over {len(ep) - 1} epochs")
    if lat:
        lines.append(f"- a latent extraction (train and test graphs): "
                     f"{min(lat):.1f}-{max(lat):.1f} s over {len(lat)}")
    ev = stamped(os.path.join(port_bo, "eval_log.txt"))
    marks = [(t, "seed" if ln.startswith("seed ") else "round") for t, ln in ev
             if ln.startswith("seed ") or ln.lstrip().startswith("BO round ")]
    seed_s = [t - t0 for (t0, _), (t, k) in zip(marks, marks[1:]) if k == "seed"]
    round_s = [t - t0 for (t0, _), (t, k) in zip(marks, marks[1:]) if k == "round"]
    if round_s:
        lines.append(f"- a BO round: {min(round_s):.2f}-{max(round_s):.2f} s, mean "
                     f"{np.mean(round_s):.2f} over {len(round_s)}")
    if seed_s:
        lines.append(f"- a seed's GP fit and scoring (from its last round's line): "
                     f"{min(seed_s):.2f}-{max(seed_s):.2f} s over {len(seed_s)}")
    return lines


def report(args) -> tuple:
    """(markdown lines, {limit: met})."""
    pl, jl = losses(args.port), losses(args.jax)
    rows, met = ["| quantity | JAX record | port | limit | met |",
                 "| --- | --- | --- | --- | --- |"], {}
    for e in range(10, min(max(pl), max(jl)) + 1, 10):
        p = np.mean([pl[i] for i in range(e - 9, e + 1)])
        j = np.mean([jl[i] for i in range(e - 9, e + 1)])
        ok = 0.5 * j <= p <= 2 * j
        met[f"loss_{e}"] = ok
        rows.append(f"| mean loss, epochs {e - 9}-{e} | {j:.4f} | {p:.4f} ({p / j:.2f}x) "
                    f"| 0.5x-2x | {'yes' if ok else 'no'} |")
    last = min(max(pl), max(jl))
    pt, jt = test_recon(args.port), test_recon(args.jax)
    met["test_recon"] = pt <= 2 * jt
    rows.append(f"| test recon loss, epoch {last} | {jt:.4f} | {pt:.4f} | at most "
                f"{2 * jt:.4f} | {'yes' if met['test_recon'] else 'no'} |")
    (pr, pb), (jr, jb) = read_bo(args.port_bo), read_bo(args.jax_bo)
    for i, name, lim, ok in ((2, "Pearson r", f"at least {jr[:, 2].mean() - 0.02:.4f}",
                              lambda p, j: p >= j - 0.02),
                             (0, "RMSE", f"at most {1.1 * jr[:, 0].mean():.4f}",
                              lambda p, j: p <= 1.1 * j)):
        p, j = pr[:, i].mean(), jr[:, i].mean()
        met[name] = bool(ok(p, j))
        rows.append(f"| {name}, mean of {len(pr)} seeds (JAX {len(jr)}) | {j:.4f} ± "
                    f"{jr[:, i].std():.4f} | {p:.4f} ± {pr[:, i].std():.4f} | {lim} | "
                    f"{'yes' if met[name] else 'no'} |")
    valid = [int(m[1]) for _, ln in stamped(os.path.join(args.port_bo, "eval_log.txt"))
             for m in [re.search(r"BO round \d+: (\d+)/\d+ valid", ln)] if m]
    if valid:
        met["valid_rounds"] = all(valid)
        rows.append(f"| BO rounds that decoded a valid architecture | not recorded | "
                    f"{sum(v > 0 for v in valid)} of {len(valid)} ({sum(valid)} valid "
                    f"of {50 * len(valid)} candidates) | every round | "
                    f"{'yes' if met['valid_rounds'] else 'no'} |")
    rows.append(f"| best BO score, {len(pb)} rounds (JAX {len(jb)}) | "
                f"{max(jb):.4f} | {max(pb):.4f} | reported | |")
    return rows, met


def main(argv=None):
    args = parse_args(argv)
    rows, met = report(args)
    print("\n".join(rows + times(args.port, args.port_bo)))
    return met


if __name__ == "__main__":
    main()

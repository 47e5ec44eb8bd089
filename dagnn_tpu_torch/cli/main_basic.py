"""Trivial-baseline evaluation driver for ogbg-code2 TOK.

Counterpart of dagnn_tpu/cli/main_basic.py (reference: ogbg-code/
main_pyg_basic.py): evaluate the no-learning baselines — GuessNodeOneToken
(predict the root's first child attr token), GuessTokensByOccurrence
(per-graph most frequent mappable attrs) and PerfectModel (oracle upper
bound) — with the set-F1 evaluator, and append their rows to
{dir_results}/baselines_basic.csv. The flags are the JAX driver's.

The attr-index -> vocab-index translation comes from the dataset's
mapping/attridx2attr.csv.gz joined against the training vocab
(main_pyg_basic.py:234, baselines.py:10-16), read with gzip and csv (the
JAX driver reads it with pandas, whose default missing-value strings —
"null", "nan", "None", "NA", "" and the rest of NA_STRINGS — become NaN
and never match a vocab word; the same strings are skipped here);
synthetic data falls back to an identity mapping (attr i -> vocab token
"tok{i}"). Nothing here runs on a device: the baselines are numpy
functions of the collated host batches (nn/baselines.py).

    python -m dagnn_tpu_torch.cli.main_basic --synthetic 300 --model all
"""

from __future__ import annotations

import argparse
import csv
import gzip
import os

import numpy as np

from dagnn_tpu_torch.dag.batch import PadConfig, collate
from dagnn_tpu_torch.data import code2
from dagnn_tpu_torch.nn.baselines import (guess_node_one_token,
                                          guess_tokens_by_occurrence,
                                          perfect_model)

# pandas.read_csv's default missing-value strings
NA_STRINGS = frozenset([
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"])


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default="all",
                   choices=["all", "guess1", "guessN", "perfect"])
    p.add_argument("--data_root", default=None)
    p.add_argument("--train_idx", default=None)
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--num_vocab", type=int, default=5000)
    p.add_argument("--max_seq_len", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=160)
    p.add_argument("--dir_results", default="results")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--cpu", action="store_true",
                   help="accepted for the drivers' uniformity: nothing here "
                        "runs on a device")
    return p.parse_args(argv)


def read_attr_mapping(path):
    """mapping/attridx2attr.csv.gz (header "attr idx,attr") -> [(idx,
    attr)], the attrs pandas would read as missing left out."""
    with gzip.open(path, "rt", newline="") as f:
        rows = list(csv.DictReader(f))
    return [(int(r["attr idx"]), r["attr"]) for r in rows
            if r["attr"] not in NA_STRINGS]


def build_attr_map(args, vocab2idx):
    """attr idx -> vocab idx via mapping/attridx2attr.csv.gz when available
    (baselines.py:10-16); identity over synthetic token names otherwise."""
    if args.data_root:
        for cand in (os.path.join(args.data_root, "ogbg_code2", "mapping"),
                     os.path.join(args.data_root, "mapping")):
            path = os.path.join(cand, "attridx2attr.csv.gz")
            if os.path.exists(path):
                return {i: vocab2idx[a] for i, a in read_attr_mapping(path)
                        if a in vocab2idx}
    return {int(tok[3:]): v for tok, v in vocab2idx.items()
            if tok.startswith("tok") and tok[3:].isdigit()}


def _batched(graphs, size):
    for i in range(0, len(graphs), size):
        yield graphs[i: i + size]


def eval_baseline(kind, graphs, attr_map, num_vocab, max_seq_len, idx2vocab,
                  batch_size):
    seq_ref, seq_pred = [], []
    for chunk in _batched(graphs, batch_size):
        batch = collate(chunk, PadConfig.for_graphs(chunk))
        if kind == "guess1":
            logits = guess_node_one_token(batch, attr_map, num_vocab,
                                          max_seq_len)
        elif kind == "guessN":
            logits = guess_tokens_by_occurrence(batch, attr_map, num_vocab,
                                                max_seq_len)
        else:
            logits = perfect_model(batch, num_vocab, max_seq_len)
        pred = np.argmax(logits, axis=-1)
        y = np.asarray(batch.y["y_arr"])
        for g in range(int(batch.n_graph)):
            seq_ref.append(code2.decode_arr_to_seq(y[g], idx2vocab))
            seq_pred.append(code2.decode_arr_to_seq(pred[g], idx2vocab))
    return code2.eval_f1(seq_ref, seq_pred)


def main(argv=None):
    """Parse `argv` (sys.argv[1:] when None), evaluate and append the CSV
    rows; returns {(model, split): metrics}."""
    args = parse_args(argv)
    from dagnn_tpu_torch.cli.ogb_driver import load_dataset
    train, valid, test, idx2vocab = load_dataset(args, task="tok")
    vocab2idx = {t: i for i, t in enumerate(idx2vocab)}
    num_vocab = len(idx2vocab)
    attr_map = build_attr_map(args, vocab2idx)
    print(f"dataset: {len(train)}/{len(valid)}/{len(test)}, "
          f"attr map size {len(attr_map)}")

    kinds = (["guess1", "guessN", "perfect"] if args.model == "all"
             else [args.model])
    os.makedirs(args.dir_results, exist_ok=True)
    out_path = os.path.join(args.dir_results, "baselines_basic.csv")
    results = {}
    with open(out_path, "a") as f:
        if f.tell() == 0:
            f.write("model,split,precision,recall,F1\n")
        for kind in kinds:
            for split, graphs in (("valid", valid), ("test", test)):
                m = eval_baseline(kind, graphs, attr_map, num_vocab,
                                  args.max_seq_len, idx2vocab,
                                  args.batch_size)
                results[(kind, split)] = m
                print(f"{kind:8s} {split:5s} F1={m['F1']:.4f} "
                      f"(P={m['precision']:.4f} R={m['recall']:.4f})")
                f.write(f"{kind},{split},{m['precision']:.6f},"
                        f"{m['recall']:.6f},{m['F1']:.6f}\n")
    print(f"wrote {out_path}")
    return results


if __name__ == "__main__":
    main()

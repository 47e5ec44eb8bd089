"""Metrics logging: append-only CSVs + run summaries + epoch timing.

A copy of dagnn_tpu/train/metrics.py: the same three CSVs with the same
headers, byte for byte (tests/test_torch_data.py).

Mirrors the reference's observability surface (SURVEY.md §5.5):
`<name>_train.csv` rows (fold, epoch, loss, train, valid, test), `<name>.csv`
per-fold best + running mean/std via summary_report
(main_pyg.py:198-206,325-332,349-362; utils2.py:82-83), and per-epoch
wall-times `<name>_times.csv` (fold, epoch, seconds; main_pyg.py:317-328,
parsed by dvae/time.py:36-44).
"""

from __future__ import annotations

import csv
import os
import statistics
from typing import Dict, List, Optional, Sequence


def summary_report(vals: Sequence[float]):
    """mean, stdev (reference utils2.py:82-83)."""
    vals = list(vals)
    return (sum(vals) / len(vals),
            statistics.stdev(vals) if len(vals) > 1 else 0)


class CSVLogger:
    def __init__(self, path: str, header: Sequence[str]):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if not os.path.exists(path):
            with open(path, "w", newline="") as f:
                csv.writer(f).writerow(header)

    def append(self, row: Sequence) -> None:
        with open(self.path, "a", newline="") as f:
            csv.writer(f).writerow(row)


class RunLogger:
    """train/summary/time CSVs for one experiment run."""

    def __init__(self, directory: str, name: str, metric: str = "F1"):
        os.makedirs(directory, exist_ok=True)
        self.train = CSVLogger(os.path.join(directory, f"{name}_train.csv"),
                               ["fold", "epoch", "loss", "train", "valid", "test"])
        self.summary = CSVLogger(os.path.join(directory, f"{name}.csv"),
                                 ["fold", "best_epoch", "train", "valid", "test",
                                  "mean_valid", "std_valid", "mean_test", "std_test"])
        self.times = CSVLogger(os.path.join(directory, f"{name}_times.csv"),
                               ["fold", "epoch", "seconds"])
        self.metric = metric
        self._fold_valid: List[float] = []
        self._fold_test: List[float] = []

    def log_epoch(self, fold, epoch, loss, train, valid, test, seconds):
        self.train.append([fold, epoch, loss, train, valid, test])
        self.times.append([fold, epoch, seconds])

    def log_fold(self, fold, best_epoch, train, valid, test):
        self._fold_valid.append(valid)
        self._fold_test.append(test)
        mv, sv = summary_report(self._fold_valid)
        mt, st = summary_report(self._fold_test)
        self.summary.append([fold, best_epoch, train, valid, test, mv, sv, mt, st])


def report_epoch_times(times_csv: str):
    """Mean/std of per-epoch seconds (reference dvae/time.py:36-44)."""
    secs = []
    with open(times_csv) as f:
        for row in csv.DictReader(f):
            secs.append(float(row["seconds"]))
    return summary_report(secs)

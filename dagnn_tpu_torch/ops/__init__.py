"""The port's kernel wrappers (row_step, pair_step, segment_attn) with
their plain PyTorch versions, and the launch counts they keep.

A wrapper's count is a Python increment where it launches its kernels, so
a CUDA graph replay (train/graphs.py) runs no wrapper and counts nothing.
A captured step therefore records the launches its capture issued, and
each replay adds them here (count_replay): read_launch_counts is the
wrappers' own counts plus the replays'."""

from collections import Counter

_replayed: Counter = Counter()


def _counted():
    from dagnn_tpu_torch.ops import pair_step, row_step, segment_attn
    return (row_step, pair_step, segment_attn)


def reset_launch_counts():
    """Set every kernel wrapper's launch count to 0."""
    for m in _counted():
        m.reset_launch_counts()
    _replayed.clear()


def wrapper_counts() -> dict:
    """The wrappers' own counts (launches issued from Python), without
    the replays'."""
    return {k: v for m in _counted() for k, v in m.launch_counts.items()}


def restore_wrapper_counts(counts: dict):
    """Set the wrappers' own counts back to `counts` (wrapper_counts()):
    what a capture's set-up issued is not a launch of the run."""
    for m in _counted():
        for k in m.launch_counts:
            m.launch_counts[k] = counts[k]


def count_replay(counts: dict):
    """Add one replay of a captured step: the launches its capture issued."""
    _replayed.update(counts)


def read_launch_counts() -> dict:
    """Every kernel wrapper's launch count, by wrapper name: its own
    launches plus those of the graph replays since the last reset."""
    return {k: v + _replayed[k] for k, v in wrapper_counts().items()}

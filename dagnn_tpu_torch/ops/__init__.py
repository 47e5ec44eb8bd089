"""The port's kernel wrappers (row_step, pair_step, segment_attn) with
their plain PyTorch versions, and the launch counts they keep.

A wrapper's count is a Python increment where it launches its kernels, so
a CUDA graph replay (train/graphs.py) runs no wrapper and counts nothing.
A captured step therefore records the launches its capture issued, and
each replay adds them here (count_replay): read_launch_counts is the
wrappers' own counts plus the replays'.

Another layer that counts what it issues from Python (parallel/comm.py's
collectives, by route) registers its dict of counts here (count_issued):
wrapper_counts holds it under "name.key", so that a capture records it with
the launches, and a replay adds its share back into that dict itself."""

from collections import Counter

_replayed: Counter = Counter()
_issued: dict = {}      # name -> a dict of counts another layer keeps


def _counted():
    from dagnn_tpu_torch.ops import pair_step, row_step, segment_attn
    return (row_step, pair_step, segment_attn)


def count_issued(name: str, counts: dict) -> dict:
    """Count `counts` (key -> number issued from Python) with the
    wrappers' launches, under "name.key"; returns it."""
    _issued[name] = counts
    return counts


def reset_launch_counts():
    """Set every kernel wrapper's launch count, and every count_issued
    count, to 0."""
    for m in _counted():
        m.reset_launch_counts()
    _replayed.clear()
    for counts in _issued.values():
        for k in counts:
            counts[k] = 0


def _kernel_counts() -> dict:
    return {k: v for m in _counted() for k, v in m.launch_counts.items()}


def wrapper_counts() -> dict:
    """What was issued from Python: the wrappers' own launches (without
    the replays') and the count_issued counts (with them)."""
    out = _kernel_counts()
    for name, counts in _issued.items():
        out.update({f"{name}.{k}": v for k, v in counts.items()})
    return out


def restore_wrapper_counts(counts: dict):
    """Set the counts back to `counts` (wrapper_counts()): what a
    capture's set-up issued is not a launch of the run."""
    for m in _counted():
        for k in m.launch_counts:
            m.launch_counts[k] = counts[k]
    for name, own in _issued.items():
        for k in own:
            own[k] = counts.get(f"{name}.{k}", own[k])


def count_replay(counts: dict):
    """Add one replay of a captured step: what its capture issued (a diff
    of wrapper_counts())."""
    for k, v in counts.items():
        name, _, key = k.partition(".")
        if key:
            _issued[name][key] += v
        else:
            _replayed[k] += v


def read_launch_counts() -> dict:
    """Every kernel wrapper's launch count, by wrapper name: its own
    launches plus those of the graph replays since the last reset."""
    return {k: v + _replayed[k] for k, v in _kernel_counts().items()}

"""The port's kernel wrappers (row_step, pair_step, segment_attn) with
their plain PyTorch versions, and the launch counts they keep."""


def _counted():
    from dagnn_tpu_torch.ops import pair_step, row_step, segment_attn
    return (row_step, pair_step, segment_attn)


def reset_launch_counts():
    """Set every kernel wrapper's launch count to 0."""
    for m in _counted():
        m.reset_launch_counts()


def read_launch_counts() -> dict:
    """Every kernel wrapper's launch count, by wrapper name."""
    return {k: v for m in _counted() for k, v in m.launch_counts.items()}

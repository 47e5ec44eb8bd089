"""Kernel timing on the card: CUDA events around a run of calls, and the
same calls replayed from one CUDA graph, so that the host's issue time
between launches drops out (chip_smoke.py's phases, the microbenches in
dagnn_tpu_torch/scripts/)."""

import torch


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

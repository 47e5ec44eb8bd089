"""Captured steps: one dispatch a step, as the JAX package's jitted steps.

The JAX drivers `jax.jit` their train step and their predict, the VAE
driver fuses --scan-chunk optimizer steps into one dispatch (`lax.scan`),
and the bench chains DAGNN_BENCH_STEPS steps into one program. The port's
counterpart of a compiled program is a CUDA graph: CapturedStep captures a
step once for each key (a bucket of batch shapes) and replays it for each
step of that key, so that the host issues one replay where it issued every
kernel and every glue op of the step. The computation does not change: the
same launches run in the same order on the same inputs.

A step is a function fn(state, inputs) -> (new_state, outputs) of trees
of tensors. CapturedStep holds:
  * static input buffers (convert.static_buffers), into which each call
    first copies its batch (convert.batch_to_torch(..., out=)): the learning
    rate too, as a 0-d tensor, so that a plateau drop reaches the replay;
  * with writes_state (a train step), the state of each key: parameters
    and optimizer state, cloned from the state of the key's first call
    and written in place inside its graph, so that a replay never hands
    back memory of the graph's pool that the next replay overwrites. A
    call with other state tensors copies them in (a checkpoint loaded, a
    new fold). A new key called with the buffers another key handed back
    takes them as its own (the keys then share them: a train step moves
    to another batch shape and trains on). Keys may hold states of
    different shapes or dtypes (a GP fit in float32 and in float64), as
    jax.jit keeps one compiled program a signature. Without writes_state
    (predict) the state is read where it lies, and its tensors are part
    of the key;
  * one graph per key, at most `keep` of them (the least recently used
    is freed, and with it its private memory pool and its state). The
    key is the caller's (route, impl, convert.batch_key of the batch:
    every shape, dtype and host value the step bakes into a launch) and
    the generators the step draws from. A host value the step reads (a
    learning rate, a loop count, a generator) may travel in the inputs:
    their static buffers keep it as it is.

Before a capture the step runs WARMUP times on a side stream, with its
results dropped (the kernel libraries build and load there, the cuBLAS
handles of that stream are made), and the generators' states are put back
after the warm-up: the replay then draws what the eager step draws from
the same seed (CUDAGraph.register_generator_state). A capture that fails
raises; nothing falls back to the eager step.

Launch counts: a replay runs no kernel wrapper, so the counts the wrappers
made while the graph was captured are recorded, the set-up's own counts
(warm-up and capture) taken back, and each replay adds the recorded counts
(ops.count_replay): ops.read_launch_counts reads as if each replay had
been an eager step. The warm-up's launches are set-up, as a capture is,
and are not counted. The collectives of a parallel step (parallel/comm.py
`issued`) are counted in the same registry (ops.count_issued), and so
recorded and added the same way.

Collectives: an NCCL collective is captured like a kernel (its kernel,
and the edges between the NCCL stream and the capture stream, are nodes
of the graph). The warm-up's eager collectives create the communicators
and are synchronised before the capture. Every step is captured with
capture_error_mode="thread_local", so that CUDA calls from other threads
(NCCL's watchdog, where a step holds collectives) during the capture
cannot invalidate it; the capturing thread is held to the same rules as
under "global".

What a replay really launches is read from the graph itself: with
`debug` set before a capture, graph_nodes lists the graph's kernel, copy
and set nodes by name (CUDAGraph.debug_dump). Not for a graph that holds
NCCL kernels: on four H100s such a graph kept in debug mode kept the
process group's destroy from returning.

On CPU tensors nothing is captured: each call stages its inputs into the
static buffers the same way and calls the step on them directly.
"""

from __future__ import annotations

import os
import re
import tempfile
import warnings
from collections import Counter, OrderedDict
from typing import Callable, NamedTuple, Optional

import torch

from dagnn_tpu_torch import convert, ops

# eager calls of a step on a side stream before its capture
WARMUP = 2


def _leaves(tree):
    out = []
    convert.tree_map(lambda t: out.append(t), tree)
    return [t for t in out if isinstance(t, torch.Tensor)]


def _device(tree):
    leaves = _leaves(tree)
    if not leaves:
        raise ValueError("CapturedStep: the state holds no tensor")
    return leaves[0].device


class _Graph(NamedTuple):
    inputs: object            # the static input buffers
    graph: Optional[object]   # torch.cuda.CUDAGraph; None on the CPU
    outputs: object           # the captured step's outputs (graph pool)
    counts: dict              # the launches one replay stands for
    state: object             # the state it reads: with writes_state its
    #                           own buffers, written in place


class CapturedStep:
    """fn(state, inputs) -> (new_state, outputs) replayed from one CUDA
    graph per key. Call it as step(key, state, inputs, generators) ->
    (state, outputs): `state` the step's state (with writes_state the
    key's persistent buffers, returned updated in place), `outputs`
    copies of the step's outputs."""

    def __init__(self, fn: Callable, *, writes_state: bool = True,
                 keep: int = 1, debug: bool = False):
        self.fn = fn
        self.writes_state = writes_state
        self.keep = keep
        self.debug = debug         # keep each graph's nodes (graph_nodes)
        self.graphs: "OrderedDict[tuple, _Graph]" = OrderedDict()
        self.captures = 0          # graphs captured (staged sets on the CPU)
        self.replays = 0           # calls served by a graph (by a direct
        #                            call of the staged step on the CPU)

    def __call__(self, key, state, inputs, generators=()):
        gens = tuple(generators)
        full = (key, gens)
        if not self.writes_state:
            full += (tuple(id(t) for t in _leaves(state)),)
        g = self.graphs.get(full)
        if g is None:
            # another key's buffers stay the state (a train step moving to
            # another batch shape trains on), anything else is cloned
            mine = next((h.state for h in self.graphs.values() if h.state is state),
                        None)
            g = self._capture(full, self._bind(state, mine), inputs, gens)
        else:
            self.graphs.move_to_end(full)
            self._bind(state, g.state)
            convert.batch_to_torch(inputs, out=g.inputs)
        if g.graph is None:
            outputs = self._body(g.state, g.inputs)
        else:
            g.graph.replay()
            ops.count_replay(g.counts)
            outputs = g.outputs
        self.replays += 1
        return g.state, convert.tree_map(torch.clone, outputs)

    def _bind(self, state, mine=None):
        """The state a key's graph reads: with writes_state its persistent
        buffers `mine` (cloned from `state` where the key has none yet),
        into which a state whose tensors are not those buffers is
        copied."""
        if not self.writes_state:
            return state
        if mine is None:
            return convert.tree_map(lambda t: t.detach().clone(), state)
        if state is not mine:
            ours, theirs = _leaves(mine), _leaves(state)
            if len(ours) != len(theirs) or any(m is not t for m, t in
                                               zip(ours, theirs)):
                if convert.batch_key(state) != convert.batch_key(mine):
                    raise ValueError("CapturedStep: the state's structure, "
                                     "shapes or dtypes differ from the "
                                     "captured state's")
                with torch.no_grad():
                    for m, t in zip(ours, theirs):
                        if m is not t:
                            m.copy_(t)
        return mine

    def _body(self, state, inputs):
        new_state, outputs = self.fn(state, inputs)
        if self.writes_state:
            with torch.no_grad():
                convert.tree_map(lambda dst, src: dst.copy_(src), state,
                                 new_state)
        return outputs

    def _capture(self, key, state, inputs, gens):
        while len(self.graphs) >= self.keep:
            self.graphs.popitem(last=False)        # frees its graph and pool
        dev = _device(state)
        static = convert.static_buffers(inputs, dev)
        self.captures += 1
        if dev.type != "cuda":
            g = _Graph(static, None, None, {}, state)
            self.graphs[key] = g
            return g
        own = ops.wrapper_counts()
        rng = [gen.get_state() for gen in gens]
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                self.fn(state, static)
        main.wait_stream(side)
        # the warm-up's collectives done before the capture begins
        torch.cuda.synchronize(dev)
        for gen, s in zip(gens, rng):
            gen.set_state(s)
        # debug: the cudaGraph_t is kept beside its instantiation, for
        # graph_nodes to read
        graph = torch.cuda.CUDAGraph(keep_graph=self.debug)
        if self.debug:
            graph.enable_debug_mode()
        for gen in gens:
            graph.register_generator_state(gen)
        before = ops.wrapper_counts()
        try:
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode="thread_local"):
                outputs = self._body(state, static)
        except RuntimeError as e:
            raise RuntimeError(f"CapturedStep: the capture of {key[0]!r} "
                               f"failed: {e}") from e
        if self.debug:
            graph.instantiate()
        after = ops.wrapper_counts()
        counts = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        ops.restore_wrapper_counts(own)
        for gen, s in zip(gens, rng):
            gen.set_state(s)
        g = _Graph(static, graph, outputs, counts, state)
        self.graphs[key] = g
        return g

    def last_graph(self):
        """The torch.cuda.CUDAGraph of the key called last (None on the
        CPU)."""
        return self.graphs[next(reversed(self.graphs))].graph


def _enclosing(text: str, close: str, open_: str) -> int:
    """The index of the `open_` that matches the `close` ending `text`."""
    depth = 0
    for i in range(len(text) - 1, -1, -1):
        if text[i] == close:
            depth += 1
        elif text[i] == open_:
            depth -= 1
            if depth == 0:
                return i
    return 0


def kernel_name(name: str) -> str:
    """A kernel's unqualified function name, from its mangled symbol (as a
    graph's nodes name it) or its demangled signature (as the profiler
    does): "_ZN2at6native18elementwise_kernelILi128E..." and "void
    at::native::elementwise_kernel<128, ...>(...)" both give
    "elementwise_kernel"; a signature's return type is skipped whatever it
    is ("std::enable_if<...>::type ns::kernel<...>(...)" gives "kernel").
    A name that is neither is returned as it is."""
    if name.startswith("_Z"):
        s, last = name[2:].lstrip("L"), None
        nested = s.startswith("N")
        s = s[1:].lstrip("rVKRO") if nested else s
        while s:
            if s.startswith("St"):
                s = s[2:]
                continue
            m = re.match(r"(\d+)", s)
            if not m:
                break
            n, s = int(m.group(1)), s[m.end():]
            last, s = s[:n], s[n:]
            if not nested:
                break
        return last or name
    name = name.replace("(anonymous namespace)::", "")
    if name.endswith(")"):                  # the parameter list
        name = name[:_enclosing(name, ")", "(")].rstrip()
    if name.endswith(">"):                  # the function's template arguments
        name = name[:_enclosing(name, ">", "<")]
    depth, start = 0, 0                     # past the return type
    for i, c in enumerate(name):
        depth += (c == "<") - (c == ">")
        if c == " " and depth == 0:
            start = i + 1
    return name[start:].split("::")[-1]


_NODE = re.compile(r'"graph_\d+_node_\d+"\s*\[[^\n]*?label="((?:[^"\\]|\\.)*)"')


def graph_nodes(graph) -> Counter:
    """A captured graph's nodes by kind, from CUDAGraph.debug_dump (the
    graph must have been made with keep_graph=True and captured with
    enable_debug_mode, as CapturedStep does with debug set): "memcpy" and
    "memset" for its copy and set nodes, a kernel node by its function's
    symbol as the dump gives it (kernel_name cuts it to the name), any
    other node by its type in lower case."""
    fd, path = tempfile.mkstemp(suffix=".dot")
    os.close(fd)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")       # debug_dump's own notice
            graph.debug_dump(path)
        with open(path) as f:
            text = f.read()
    finally:
        os.remove(path)
    out = Counter()
    for label in _NODE.findall(text):
        kind = re.search(r"[A-Z][A-Z_]{2,}", label)
        kind = kind.group(0) if kind else "?"
        if kind == "KERNEL":
            m = re.search(r"([^\s|{}]+?)\s*(?:\\?<){3}", label)
            out[m.group(1) if m else "?kernel"] += 1
        else:
            out[kind.lower()] += 1
    if not out:
        raise ValueError("graph_nodes: the dump holds no node (was the graph "
                         "kept and captured in debug mode?)")
    return out

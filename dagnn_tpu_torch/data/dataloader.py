"""Batch loader: bucketed collation with background prefetch.

A copy of dagnn_tpu/data/dataloader.py, with the original's defaults as
constants (the last short batch kept, edge budget 1.5x the chunk,
critical-path row packing). schedules=True (DAGNN) levels every batch;
schedules=False (the baselines, whose 4-way augmented graphs may be
cyclic) buckets by node, edge and graph counts alone (max_levels 1, no
edge budget, no stagger) and collates with build_schedules=False, as the
original does. n_shards > 1 (data parallel, parallel/dp.py) splits each
batch by node count (split_by_nodes), buckets every shard into the one
PadConfig and yields the shards stacked on a leading axis
(stack_batches), as the original does. An error in
the prefetch thread is raised in the consumer, where the original ends
the epoch early without one (ROADMAP queue 3). The original replaces the
reference's torch DataLoader + device-balanced Collater
(reference: ogbg-code/tg/dataloader.py:13-57, worker processes at
main_pyg.py:148): batches are collated on the host into one static
PadConfig per epoch (exact max over the epoch's batches, rounded up so
bucket shapes stabilize across epochs -> no per-batch recompiles), with a
thread prefetching the next batch while the accelerator steps.
tests/test_torch_data.py holds the copy to the original: equal PadConfigs
and bitwise equal batches.
"""

from __future__ import annotations

import dataclasses
import threading
import queue
from typing import Iterator, List, Optional, Sequence

import numpy as np

from dagnn_tpu_torch.dag.batch import DAGBatch, DAGGraph, PadConfig, collate
from dagnn_tpu_torch.parallel.dp import split_by_nodes, stack_batches


def _round_cfg(cfg: PadConfig, mult: int = 64) -> PadConfig:
    r = lambda v: ((v + mult - 1) // mult) * mult
    return dataclasses.replace(
        cfg,
        max_nodes=r(cfg.max_nodes),
        max_edges=r(cfg.max_edges),
        max_levels=((cfg.max_levels + 7) // 8) * 8,
        edges_per_level=((cfg.edges_per_level + 31) // 32) * 32,
        tgrad_per_level=((cfg.tgrad_per_level + 31) // 32) * 32,
    )


class DAGLoader:
    """Iterate DAGBatches over a dataset of DAGGraphs."""

    def __init__(
        self,
        graphs: Sequence[DAGGraph],
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        chunk_size: Optional[int] = 256,
        n_shards: int = 1,
        prefetch: int = 2,
        schedules: bool = True,
    ):
        self.graphs = list(graphs)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.chunk_size = chunk_size
        # row split policy (see dag/schedule.py): 1.5x the node chunk is the
        # empirical sweet spot on the TOK workload (362k vs 270k edges/s at
        # chunk 256) — narrower budgets trade too much scan length
        self.edge_budget = (chunk_size * 3 // 2) if (chunk_size and schedules) else 0
        # row layout: 2 = critical-path packing (schedule.pack_rows, the
        # production default — depth-floor row counts at ~0.95 fill)
        self.stagger = 2 if (chunk_size and schedules) else 0
        self.n_shards = n_shards
        self.prefetch = prefetch
        self.schedules = schedules
        self._pad: Optional[PadConfig] = None
        # the widest per-graph output-slot list of the batches bucketed so
        # far (PadConfig.out_per_graph of each, which the bucket leaves to
        # the batch): convert.widen_out_slots gives every batch this width
        self.out_per_graph = 1

    def _epoch_batches(self) -> List[List[DAGGraph]]:
        idx = np.arange(len(self.graphs))
        if self.shuffle:
            self.rng.shuffle(idx)
        out = []
        for i in range(0, len(idx), self.batch_size):
            sel = idx[i: i + self.batch_size]
            out.append([self.graphs[j] for j in sel])
        return out

    def _ensure_pad(self, batches: List[List[DAGGraph]]) -> PadConfig:
        """One bucket for the epoch: exact max over batches (per shard),
        rounded so shapes stabilize across epochs."""
        worst = None
        shards = [s for b in batches for s in
                  (split_by_nodes(b, self.n_shards) if self.n_shards > 1 else [b])
                  if s]
        for s in shards:
            if self.schedules:
                c = PadConfig.for_graphs(s, chunk_size=self.chunk_size,
                                         edge_budget=self.edge_budget,
                                         stagger=self.stagger)
                self.out_per_graph = max(self.out_per_graph, c.out_per_graph)
            else:
                # cyclic baseline graphs: counts only, no leveling
                c = PadConfig(
                    max_nodes=sum(g.num_nodes for g in s),
                    max_edges=max(1, sum(g.num_edges for g in s)),
                    max_graphs=len(s), max_levels=1,
                    nodes_per_level=1, edges_per_level=1,
                )
            if worst is None:
                worst = c
            else:
                worst = PadConfig(
                    max_nodes=max(worst.max_nodes, c.max_nodes),
                    max_edges=max(worst.max_edges, c.max_edges),
                    max_graphs=max(worst.max_graphs, c.max_graphs),
                    max_levels=max(worst.max_levels, c.max_levels),
                    nodes_per_level=max(worst.nodes_per_level, c.nodes_per_level),
                    edges_per_level=max(worst.edges_per_level, c.edges_per_level),
                    tgrad_per_level=max(worst.tgrad_per_level, c.tgrad_per_level),
                    edge_budget=self.edge_budget,
                    stagger=self.stagger,
                )
        worst = _round_cfg(worst)
        if self._pad is not None:
            # keep the old bucket if it still fits (stability across epochs)
            p = self._pad
            if (p.max_nodes >= worst.max_nodes and p.max_edges >= worst.max_edges
                    and p.max_graphs >= worst.max_graphs
                    and p.max_levels >= worst.max_levels
                    and p.nodes_per_level >= worst.nodes_per_level
                    and p.edges_per_level >= worst.edges_per_level
                    and p.tgrad_per_level >= worst.tgrad_per_level
                    and p.edge_budget == worst.edge_budget):
                return p
            worst = PadConfig(*[max(a, b) for a, b in
                                zip(dataclasses.astuple(p), dataclasses.astuple(worst))])
        self._pad = worst
        return worst

    def _collate_one(self, graphs: List[DAGGraph], pad: PadConfig) -> DAGBatch:
        if self.schedules:
            return collate(graphs, pad)
        return collate(graphs, pad, build_schedules=False)

    def _collate(self, graphs: List[DAGGraph], pad: PadConfig) -> DAGBatch:
        if self.n_shards > 1:
            return stack_batches([self._collate_one(s, pad) for s in
                                  split_by_nodes(graphs, self.n_shards)])
        return self._collate_one(graphs, pad)

    def __iter__(self) -> Iterator[DAGBatch]:
        batches = self._epoch_batches()
        pad = self._ensure_pad(batches)
        if self.prefetch <= 0:
            for b in batches:
                yield self._collate(b, pad)
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = object()
        failed = []

        def worker():
            try:
                for b in batches:
                    q.put(self._collate(b, pad))
            except BaseException as e:  # handed to the consumer below
                failed.append(e)
            finally:
                q.put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            yield item
        t.join()
        if failed:
            raise failed[0]

    def __len__(self):
        return -(-len(self.graphs) // self.batch_size)

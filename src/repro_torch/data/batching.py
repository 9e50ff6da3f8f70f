"""Size-bucketed graph packing for the sparse data path (DESIGN.md §4).

The dense batcher (`features.encode_batch`) pads every kernel to a fixed
[N, N] adjacency slot, so batch memory and aggregation FLOPs grow with
B·N² regardless of how small the graphs are. This module provides the
sparse alternative:

* `pack_graphs` — first-fit-decreasing bin packing of kernels into packs
  with a bounded total node count, so many small kernels share one device
  batch and big kernels don't force padding onto small ones.
* `BucketSpec` / `bucket_for` — the capacities of one packed batch
  (node/edge/graph/reduce), rounded up a power-of-two ladder so only a few
  distinct shapes ever reach jit: one compiled executable per bucket.
* `encode_packed` / `iter_packed_batches` — turn kernel lists into
  `features.SparseGraphBatch` pytrees using those capacities.

Everything is deterministic: same graphs in, same packs and bucket keys out.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Sequence

from repro_torch.core import features as F
from repro_torch.core.features import FeatureNormalizer, SparseGraphBatch
from repro_torch.core.graph import KernelGraph


def round_up_pow2(n: int, minimum: int = 1) -> int:
    """Smallest power of two ≥ max(n, minimum).

    >>> round_up_pow2(9)
    16
    >>> round_up_pow2(8, minimum=4)
    8
    >>> round_up_pow2(0)
    1
    """
    target = max(int(n), int(minimum), 1)
    cap = 1
    while cap < target:
        cap *= 2
    return cap


@dataclass(frozen=True)
class BucketSpec:
    """Static capacities of one packed batch; the jit cache key.

    Two packed batches with equal specs produce identically shaped pytrees,
    so a training/inference step compiles once per spec.
    """
    node_capacity: int
    edge_capacity: int
    graph_capacity: int
    reduce_capacity: int


def bucket_for(graphs: Sequence[KernelGraph], *, min_nodes: int = 32,
               min_edges: int = 32, min_graphs: int = 1,
               min_reduce: int = 8) -> BucketSpec:
    """Bucket key for a pack: every required capacity rounded up a
    power-of-two ladder. A graph exactly at a bucket edge stays in that
    bucket (round_up_pow2 is inclusive); one node more spills to the next.

    >>> from repro_torch.data.synthetic import random_kernel
    >>> spec = bucket_for([random_kernel(33, seed=0)])
    >>> (spec.node_capacity, spec.graph_capacity, spec.reduce_capacity)
    (64, 1, 64)
    """
    n = sum(g.num_nodes for g in graphs)
    e = sum(len(g.unique_edges()) for g in graphs)
    r = max(g.num_nodes for g in graphs)
    return BucketSpec(
        node_capacity=round_up_pow2(n, min_nodes),
        edge_capacity=round_up_pow2(e, min_edges),
        graph_capacity=round_up_pow2(len(graphs), min_graphs),
        reduce_capacity=round_up_pow2(r, min_reduce),
    )


def pack_graphs(graphs: Sequence[KernelGraph], node_budget: int,
                *, max_graphs_per_pack: int | None = None,
                oversized: str = "error") -> list[list[int]]:
    """First-fit-decreasing packing: returns packs of indices into `graphs`
    with Σ nodes ≤ node_budget per pack.

    A single graph larger than the budget can neither share a pack nor
    respect the budget. `oversized` picks the policy:

    * ``"error"`` (default) — raise a ValueError naming the graph and the
      budget. Callers that can segment should catch this upstream by
      routing big graphs through `repro.data.segmentation` /
      `encode_segmented` instead.
    * ``"singleton"`` — give the graph its own oversized singleton pack
      and let the bucket ladder absorb it (the historical behavior;
      batched inference over trusted kernel corpora keeps using this).

    A graph exactly at the budget is not oversized — it packs normally.

    >>> from repro_torch.data.synthetic import random_kernel
    >>> gs = [random_kernel(n, seed=n) for n in (5, 9, 3)]
    >>> pack_graphs(gs, node_budget=12)       # 9+3 share a pack, 5 spills
    [[1, 2], [0]]
    >>> pack_graphs(gs, node_budget=2, oversized="singleton")
    [[1], [0], [2]]
    >>> pack_graphs(gs, node_budget=2)
    Traceback (most recent call last):
        ...
    ValueError: graph 0 ('random_5_5', 5 nodes) exceeds node_budget=2; segment it (repro.data.segmentation) or pass oversized='singleton'
    """
    if oversized not in ("error", "singleton"):
        raise ValueError(f"unknown oversized policy {oversized!r}")
    if oversized == "error":
        for i, g in enumerate(graphs):
            if g.num_nodes > node_budget:
                raise ValueError(
                    f"graph {i} ({g.name!r}, {g.num_nodes} nodes) exceeds "
                    f"node_budget={node_budget}; segment it "
                    f"(repro.data.segmentation) or pass "
                    f"oversized='singleton'")
    order = sorted(range(len(graphs)),
                   key=lambda i: (-graphs[i].num_nodes, i))
    packs: list[list[int]] = []
    loads: list[int] = []
    for i in order:
        n = graphs[i].num_nodes
        placed = False
        for p, load in enumerate(loads):
            if load + n <= node_budget and (
                    max_graphs_per_pack is None
                    or len(packs[p]) < max_graphs_per_pack):
                packs[p].append(i)
                loads[p] += n
                placed = True
                break
        if not placed:
            packs.append([i])
            loads.append(n)
    for p in packs:
        p.sort()          # keep corpus order inside a pack
    return packs


def encode_packed(graphs: Sequence[KernelGraph],
                  normalizer: FeatureNormalizer | None = None,
                  *, include_static_perf: bool = True,
                  spec: BucketSpec | None = None) -> SparseGraphBatch:
    """Encode one pack of kernels into a SparseGraphBatch with bucketed
    capacities (slot g of the result is graphs[g])."""
    spec = spec or bucket_for(graphs)
    return F.encode_sparse_batch(
        graphs, normalizer, include_static_perf=include_static_perf,
        node_capacity=spec.node_capacity, edge_capacity=spec.edge_capacity,
        graph_capacity=spec.graph_capacity,
        reduce_capacity=spec.reduce_capacity)


def iter_packed_batches(graphs: Sequence[KernelGraph], node_budget: int,
                        normalizer: FeatureNormalizer | None = None,
                        *, include_static_perf: bool = True,
                        max_graphs_per_pack: int | None = None,
                        oversized: str = "singleton"
                        ) -> Iterator[tuple[SparseGraphBatch, list[int]]]:
    """Pack a kernel list and yield (batch, original_indices) pairs —
    `batch` slot g corresponds to graphs[original_indices[g]]. Used by
    batched inference to run an arbitrary corpus through a handful of
    compiled shapes. Kernels beyond `node_budget` default to oversized
    singleton packs (`oversized='singleton'`) — inference must score
    whatever corpus it is handed; pass `oversized='error'` to reject."""
    for pack in pack_graphs(graphs, node_budget,
                            max_graphs_per_pack=max_graphs_per_pack,
                            oversized=oversized):
        part = [graphs[i] for i in pack]
        yield encode_packed(part, normalizer,
                            include_static_perf=include_static_perf), pack

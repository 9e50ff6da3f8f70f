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

import numpy as np

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
      routing big graphs through `repro_torch.data.segmentation` /
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
    ValueError: graph 0 ('random_5_5', 5 nodes) exceeds node_budget=2; segment it (repro_torch.data.segmentation) or pass oversized='singleton'
    """
    if oversized not in ("error", "singleton"):
        raise ValueError(f"unknown oversized policy {oversized!r}")
    if oversized == "error":
        for i, g in enumerate(graphs):
            if g.num_nodes > node_budget:
                raise ValueError(
                    f"graph {i} ({g.name!r}, {g.num_nodes} nodes) exceeds "
                    f"node_budget={node_budget}; segment it "
                    f"(repro_torch.data.segmentation) or pass "
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


def encode_segmented(graphs: Sequence[KernelGraph], node_budget: int,
                     normalizer: FeatureNormalizer | None = None,
                     *, include_static_perf: bool = True
                     ) -> "F.SegmentedGraphBatch":
    """Encode whole-program graphs of *any* size into one
    `features.SegmentedGraphBatch` (DESIGN.md §12).

    Each graph is split by `segmentation.segment_graph` into blocks of at
    most `node_budget` nodes (owned + halo); all blocks of all graphs are
    packed into one inner `SparseGraphBatch` through the ordinary bucket
    ladder, and the outer arrays reassemble owned-node embeddings into
    whole-graph node order for the readout. Graphs that fit the budget
    take the identity path: their inner slots are bit-identical to
    `encode_packed(graphs)` on the same list.

    >>> from repro_torch.data.synthetic import random_kernel
    >>> gs = [random_kernel(40, seed=0), random_kernel(7, seed=1)]
    >>> sb = encode_segmented(gs, node_budget=16)
    >>> sb.batch_size, int(sb.graph_mask.sum())
    (2, 2)
    >>> int(sb.node_mask.sum())          # outer buffer holds 40 + 7 nodes
    47
    """
    from repro_torch.data.segmentation import segment_graph

    if not graphs:
        raise ValueError("empty graph list")
    segs = [segment_graph(g, node_budget) for g in graphs]
    parts = [s.graph for sg in segs for s in sg.segments]
    inner = encode_packed(parts, normalizer,
                          include_static_perf=include_static_perf)

    n_real = sum(g.num_nodes for g in graphs)
    M = round_up_pow2(n_real, 32)
    # outer graph capacity stays EXACT (like the sparse samplers): the
    # trainer's losses normalize by slot count, and slot g must be
    # graphs[g] for every caller
    G = len(graphs)
    R = round_up_pow2(max(g.num_nodes for g in graphs), 8)

    # inner nodes -> outer whole-graph slots (halo + padding -> dummy M)
    scatter = np.full((inner.num_nodes,), M, np.int32)
    node_mask = np.zeros((M,), np.float32)
    graph_ids = np.zeros((M,), np.int32)
    kf = np.zeros((G, F.KERNEL_FEATURE_DIM), np.float32)
    graph_mask = np.zeros((G,), np.float32)
    gather_idx = np.full((G, R), M, np.int32)
    gather_mask = np.zeros((G, R), np.float32)

    slot = 0          # inner graph slot (one per segment, in pack order)
    n_off = 0         # running node offset inside the inner flat buffer
    g_off = 0         # running node offset in the outer whole-graph buffer
    for gi, (g, sg) in enumerate(zip(graphs, segs)):
        for s in sg.segments:
            base = n_off                      # segment's inner node offset
            for loc, glob in zip(s.owned_local, s.owned_global):
                scatter[base + loc] = g_off + glob
            n_off += s.graph.num_nodes
            # whole-graph kernel feats for every segment slot, so the
            # kernel_feat_mode='node' broadcast sees the *program's*
            # features, not the block's (identity path: identical values)
            inner.kernel_feats[slot] = _whole_kernel_feats(
                g, normalizer, include_static_perf=include_static_perf)
            slot += 1
        n = g.num_nodes
        node_mask[g_off:g_off + n] = 1.0
        graph_ids[g_off:g_off + n] = gi
        kf[gi] = _whole_kernel_feats(
            g, normalizer, include_static_perf=include_static_perf)
        graph_mask[gi] = 1.0
        gather_idx[gi, :n] = np.arange(g_off, g_off + n, dtype=np.int32)
        gather_mask[gi, :n] = 1.0
        g_off += n
    return F.SegmentedGraphBatch(inner, scatter, node_mask, graph_ids,
                                 kf, graph_mask, gather_idx, gather_mask)


def _whole_kernel_feats(g: KernelGraph,
                        normalizer: FeatureNormalizer | None,
                        *, include_static_perf: bool) -> np.ndarray:
    kf = F.encode_structural(g).kernel_feats(
        g.tile_size, include_static_perf=include_static_perf)
    if normalizer is not None:
        kf = normalizer.transform_kernel(kf)
    return kf

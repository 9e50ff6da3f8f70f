"""Graph segmentation for whole-program graphs (DESIGN.md §12).

The bucketed sparse batcher (`repro_torch.data.batching`) compiles one
executable per `BucketSpec`, so a single 10k+-node program graph
(TpuGraphs-scale, PAPERS.md) would mint a giant one-off bucket — and the
dense path is quadratic in padded node count. Segmentation turns graph
size back into a data-shape problem:

* `segment_graph` partitions a `KernelGraph` into contiguous topological
  blocks of bounded size. Every node is *owned* by exactly one segment;
  a segment additionally carries read-only **halo** copies of the
  out-of-segment producers its owned nodes consume, so every original
  edge appears in exactly one segment (the one owning its destination).
* Halo copies have their `inputs` stripped (they are roots of the
  segment subgraph) and `is_output` cleared — a 1-hop approximation:
  a halo node contributes its layer-local embedding as a neighbor, but
  does not itself aggregate its own neighborhood across the cut. A graph
  that fits `max_nodes` yields one identity segment (the original graph
  object), so the sub-bucket path is bit-identical to the unsegmented
  batcher (`tests/test_segmentation.py` pins this).
* `repro_torch.data.batching.encode_segmented` packs the segments of many
  graphs through the ordinary bucketed batcher and emits a
  `features.SegmentedGraphBatch` whose `scatter_idx` reassembles owned
  per-node embeddings into whole-graph order before the readout
  (`core.model._cost_model_apply_segmented`).

Deterministic: same graph and budget in, same segments out.

>>> from repro_torch.data.synthetic import random_kernel
>>> g = random_kernel(40, seed=0)
>>> seg = segment_graph(g, max_nodes=16)
>>> seg.num_segments > 1
True
>>> sorted(i for s in seg.segments for i in s.owned_global) == list(range(40))
True
>>> segment_graph(g, max_nodes=64).segments[0].graph is g   # identity path
True
"""
from __future__ import annotations

from dataclasses import dataclass, replace

from repro_torch.core.graph import KernelGraph


@dataclass(frozen=True)
class GraphSegment:
    """One bounded-size block of a segmented `KernelGraph`.

    `graph` holds the segment subgraph: halo copies first (global order,
    inputs stripped), then the owned nodes (global order, inputs remapped
    to local indices). `owned_local[k]` is the local index of the node
    whose original index is `owned_global[k]`.
    """
    graph: KernelGraph
    owned_local: tuple[int, ...]
    owned_global: tuple[int, ...]
    halo_global: tuple[int, ...]

    @property
    def num_owned(self) -> int:
        return len(self.owned_global)


@dataclass(frozen=True)
class Segmentation:
    """All segments of one graph; owned sets partition `range(num_nodes)`."""
    graph: KernelGraph
    segments: tuple[GraphSegment, ...]

    @property
    def num_segments(self) -> int:
        return len(self.segments)

    @property
    def total_halo(self) -> int:
        return sum(len(s.halo_global) for s in self.segments)


def segment_graph(g: KernelGraph, max_nodes: int) -> Segmentation:
    """Partition `g` into contiguous topological blocks with
    `len(owned) + len(halo) <= max_nodes` per segment.

    The walk is greedy: nodes join the current block in topological order
    until the next node (plus the new halo producers it drags in) would
    overflow `max_nodes`, at which point the block closes and a new one
    starts. A graph already within budget returns a single identity
    segment that *is* the original graph object (no copies).

    Raises ValueError when one node's out-of-block fan-in alone exceeds
    the budget (such a node can never fit any segment).

    >>> from repro_torch.data.synthetic import random_kernel
    >>> g = random_kernel(30, seed=1)
    >>> seg = segment_graph(g, max_nodes=12)
    >>> all(s.graph.num_nodes <= 12 for s in seg.segments)
    True
    """
    n = g.num_nodes
    if max_nodes < 1:
        raise ValueError(f"max_nodes must be >= 1, got {max_nodes}")
    if n <= max_nodes:
        ident = GraphSegment(graph=g,
                             owned_local=tuple(range(n)),
                             owned_global=tuple(range(n)),
                             halo_global=())
        return Segmentation(graph=g, segments=(ident,))

    blocks: list[tuple[int, int, list[int]]] = []   # (lo, hi, halo sorted)
    lo = 0
    halo: set[int] = set()
    i = 0
    while i < n:
        new = {j for j in g.nodes[i].inputs if j < lo} - halo
        if (i - lo + 1) + len(halo) + len(new) > max_nodes:
            if i == lo:
                raise ValueError(
                    f"graph {g.name!r}: node {i} ({g.nodes[i].op.name}) has "
                    f"{len(new)} out-of-block producers; cannot fit any "
                    f"segment of max_nodes={max_nodes}")
            blocks.append((lo, i, sorted(halo)))
            lo = i
            halo = set()
            continue      # re-admit node i against the fresh block
        halo |= new
        i += 1
    blocks.append((lo, n, sorted(halo)))

    segments = []
    for lo, hi, halo_sorted in blocks:
        local = {}                       # global index -> local index
        nodes = []
        for j in halo_sorted:
            local[j] = len(nodes)
            nodes.append(replace(g.nodes[j], inputs=(), is_output=False))
        owned_local = []
        for j in range(lo, hi):
            local[j] = len(nodes)
            owned_local.append(len(nodes))
            src = g.nodes[j]
            nodes.append(replace(src,
                                 inputs=tuple(local[k] for k in src.inputs)))
        sub = KernelGraph(nodes, program=g.program,
                          name=f"{g.name}#seg{lo}:{hi}",
                          tile_size=g.tile_size)
        segments.append(GraphSegment(
            graph=sub, owned_local=tuple(owned_local),
            owned_global=tuple(range(lo, hi)),
            halo_global=tuple(halo_sorted)))
    return Segmentation(graph=g, segments=tuple(segments))

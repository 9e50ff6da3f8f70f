"""Kernel-graph IR.

Three representations:

* `Node` / `KernelGraph` — host-side (numpy / python) graph with full
  static semantics. This is what the generator, importer, simulator and
  analytical model operate on. Nodes are stored in topological order
  (guaranteed by construction in the generator/importer) — the paper's LSTM
  reduction runs over topologically sorted nodes.
* `features.GraphBatch` — a padded, masked, device-ready pytree produced
  by `features.encode_batch`. The adjacency is dense `[B, N, N]`
  (`adj[b, d, s] = 1` iff edge s→d), which on TPU turns neighbor
  aggregation into an MXU matmul (see DESIGN.md §3).
* `features.SparseGraphBatch` — the packed equivalent (flat node/edge
  buffers + segment ids) produced by `features.encode_sparse_batch` via
  the bucketing batcher in `repro_torch.data.batching` (DESIGN.md §4).

`KernelGraph.canonical_hash()` content-addresses a graph (structure +
tile, invariant to node renumbering) — the serving cache key
(`repro_torch.serving`, DESIGN.md §8).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from repro_torch.core import opset
from repro_torch.core.opset import OpInfo


@dataclass
class Node:
    """One tensor operation. `shape` is the output tensor shape."""
    op: OpInfo
    shape: tuple[int, ...]
    dtype_bytes: int = 4
    inputs: tuple[int, ...] = ()          # indices of producer nodes
    is_output: bool = False
    # contraction metadata (dot/conv): reduced dimension size
    contract_dim: int = 0
    # convolution filter spatial size (kh, kw) when op is CONV
    filter_size: tuple[int, int] = (0, 0)
    # reduction: which dims are reduced (sizes)
    reduced_dims: tuple[int, ...] = ()

    @property
    def volume(self) -> int:
        v = 1
        for d in self.shape:
            v *= int(d)
        return int(v)

    @property
    def bytes_out(self) -> int:
        return self.volume * self.dtype_bytes

    def flops(self) -> float:
        """Total FLOPs to produce this node's output tensor."""
        if self.op is opset.DOT:
            return 2.0 * self.volume * max(self.contract_dim, 1)
        if self.op is opset.CONV:
            kh, kw = self.filter_size
            return 2.0 * self.volume * max(self.contract_dim, 1) * max(kh, 1) * max(kw, 1)
        if self.op.unit in ("mem", "none"):
            return 0.0
        in_vol = self.volume
        if self.reduced_dims:
            red = 1
            for d in self.reduced_dims:
                red *= max(int(d), 1)
            in_vol = self.volume * red
        return self.op.flops_per_elem * in_vol

    def transcendental_count(self) -> float:
        if not self.op.transcendental:
            return 0.0
        return float(self.volume)

    # --- serialization (on-disk corpus store; repro.data.store) -------------
    def to_dict(self) -> dict:
        """JSON-able representation; exact inverse of `Node.from_dict`."""
        return {"op": self.op.name, "shape": list(self.shape),
                "dtype_bytes": int(self.dtype_bytes),
                "inputs": list(self.inputs),
                "is_output": bool(self.is_output),
                "contract_dim": int(self.contract_dim),
                "filter_size": list(self.filter_size),
                "reduced_dims": list(self.reduced_dims)}

    @staticmethod
    def from_dict(d: dict) -> "Node":
        return Node(opset.OP_BY_NAME[d["op"]], tuple(d["shape"]),
                    int(d["dtype_bytes"]), tuple(d["inputs"]),
                    bool(d["is_output"]), int(d["contract_dim"]),
                    tuple(d["filter_size"]), tuple(d["reduced_dims"]))


@dataclass
class KernelGraph:
    """A kernel: a fused subgraph executed as one unit."""
    nodes: list[Node]
    program: str = "synthetic"           # program this kernel came from
    name: str = "kernel"
    tile_size: tuple[int, ...] = ()      # set per-sample for the tile task

    def __post_init__(self):
        self._check_topo()

    def _check_topo(self) -> None:
        for i, n in enumerate(self.nodes):
            for j in n.inputs:
                if not (0 <= j < i):
                    raise ValueError(
                        f"nodes must be topologically ordered; node {i} "
                        f"({n.op.name}) has input {j}")

    @property
    def num_nodes(self) -> int:
        return len(self.nodes)

    @property
    def root(self) -> Node:
        """The kernel's dominant output node (last output, else last node)."""
        for n in reversed(self.nodes):
            if n.is_output:
                return n
        return self.nodes[-1]

    @property
    def output_nodes(self) -> list[Node]:
        outs = [n for n in self.nodes if n.is_output]
        return outs if outs else [self.nodes[-1]]

    @property
    def parameter_nodes(self) -> list[Node]:
        return [n for n in self.nodes if n.op is opset.PARAMETER]

    def edges(self) -> list[tuple[int, int]]:
        """(src, dst) pairs."""
        es = []
        for d, n in enumerate(self.nodes):
            for s in n.inputs:
                es.append((s, d))
        return es

    def unique_edges(self) -> list[tuple[int, int]]:
        """(src, dst) pairs with multi-edges collapsed (a node consuming the
        same producer twice, e.g. add(x, x), yields one edge) — the same
        set semantics as the dense `features.adjacency` matrix, which the
        sparse edge-list encoding must match for numerical equivalence.

        Memoized: the sparse batcher asks for the edge set several times
        per encode (bucketing + capacity checks + the write loop), every
        training step.
        """
        cached = getattr(self, "_unique_edges", None)
        if cached is None:
            seen: set[tuple[int, int]] = set()
            cached = []
            for e in self.edges():
                if e not in seen:
                    seen.add(e)
                    cached.append(e)
            self._unique_edges = cached
        return cached

    def fan_out(self) -> np.ndarray:
        fo = np.zeros((self.num_nodes,), np.int32)
        for d, n in enumerate(self.nodes):
            for s in n.inputs:
                fo[s] += 1
        return fo

    def depth(self) -> int:
        """Critical-path length (number of nodes on the longest chain)."""
        dep = np.zeros((self.num_nodes,), np.int64)
        for i, n in enumerate(self.nodes):
            dep[i] = 1 + max((dep[j] for j in n.inputs), default=0)
        return int(dep.max(initial=0))

    # --- static analysis (the paper's 4 optional kernel features) -----------
    def total_flops(self) -> float:
        return float(sum(n.flops() for n in self.nodes))

    def bytes_read(self) -> float:
        """Bytes read from HBM: kernel inputs (parameters/constants)."""
        return float(sum(n.bytes_out for n in self.nodes
                         if n.op in (opset.PARAMETER, opset.CONSTANT)))

    def bytes_written(self) -> float:
        return float(sum(n.bytes_out for n in self.output_nodes))

    def transcendental_total(self) -> float:
        return float(sum(n.transcendental_count() for n in self.nodes))

    def with_tile(self, tile: Sequence[int]) -> "KernelGraph":
        g = KernelGraph(self.nodes, self.program, self.name, tuple(int(t) for t in tile))
        cached = getattr(self, "_unique_edges", None)
        if cached is not None:       # same nodes ⇒ same edge set
            g._unique_edges = cached
        digests = getattr(self, "_node_digests", None)
        if digests is not None:      # same nodes ⇒ same node digests
            g._node_digests = digests
        return g

    # --- content addressing (serving cache key; docs/SERVING.md) ------------
    def _merkle_node_digests(self) -> list[bytes]:
        """Per-node Merkle digests: each covers the node's semantic content
        (op, shape, dtype size, output flag, contraction/filter/reduction
        metadata, fan-out) plus the digests of its producers in input
        order, so it identifies the node's whole ancestor cone —
        independent of node indices. Memoized, and copied by `with_tile`
        (same nodes ⇒ same digests)."""
        cached = getattr(self, "_node_digests", None)
        if cached is None:
            fan_out = self.fan_out()
            cached = []
            for i, n in enumerate(self.nodes):
                h = hashlib.blake2b(digest_size=16)
                h.update(repr((n.op.index, n.shape, n.dtype_bytes,
                               n.is_output, n.contract_dim, n.filter_size,
                               n.reduced_dims, int(fan_out[i]))).encode())
                for j in n.inputs:
                    h.update(cached[j])
                cached.append(h.digest())
            self._node_digests = cached
        return cached

    def structural_digest(self, *, order_sensitive: bool = False) -> bytes:
        """Digest of the graph structure: node count + the Merkle node
        digests. By default the digests are *sorted*, so any topological-
        order-preserving relabeling (`renumbered`) produces the same
        bytes; `order_sensitive=True` keeps them in stored node order,
        for consumers that are not permutation-invariant (the LSTM
        reduction runs over topologically sorted node order)."""
        digests = self._merkle_node_digests()
        top = hashlib.blake2b(digest_size=16)
        top.update(len(self.nodes).to_bytes(8, "little"))
        for d in (digests if order_sensitive else sorted(digests)):
            top.update(d)
        return top.digest()

    def canonical_hash(self, *, order_sensitive: bool = False) -> str:
        """Content-addressed identity of (structure, tile_size) — the
        prediction-cache key used by `repro_torch.serving`. Deliberately excludes
        `program`/`name` (labels don't affect predictions) and is invariant
        to node renumbering, mirroring the set semantics of `unique_edges`:
        two graphs with equal hashes encode to equivalent feature batches.

        `order_sensitive=True` additionally hashes the node *order*, for
        models whose predictions depend on it (`reduction="lstm"`;
        `CostModelService` selects this automatically).

        >>> from repro_torch.core import opset
        >>> from repro_torch.core.graph import KernelGraph, Node
        >>> g = KernelGraph([Node(opset.PARAMETER, (8, 8)),
        ...                  Node(opset.PARAMETER, (4, 8)),
        ...                  Node(opset.DOT, (4, 8), inputs=(1, 0),
        ...                       contract_dim=8, is_output=True)],
        ...                 name="demo")
        >>> g.canonical_hash() == g.renumbered([1, 0, 2]).canonical_hash()
        True
        >>> g.canonical_hash() == g.with_tile((8, 8)).canonical_hash()
        False
        >>> h = lambda x: x.canonical_hash(order_sensitive=True)
        >>> h(g) == h(g.renumbered([1, 0, 2]))     # distinct params swapped
        False
        """
        cached = getattr(self, "_canonical_hash", None)
        if cached is None:
            cached = self._canonical_hash = {}
        key = cached.get(order_sensitive)
        if key is None:
            h = hashlib.blake2b(digest_size=16)
            h.update(self.structural_digest(order_sensitive=order_sensitive))
            h.update(repr(self.tile_size).encode())
            key = cached[order_sensitive] = h.hexdigest()
        return key

    # --- serialization (on-disk corpus store; repro.data.store) -------------
    def to_dict(self) -> dict:
        """JSON-able representation of the full kernel (nodes + labels +
        tile). `from_dict` is an exact inverse: the round trip preserves
        content addressing, so a stored kernel dedups against its source.

        >>> from repro_torch.core import opset
        >>> from repro_torch.core.graph import KernelGraph, Node
        >>> g = KernelGraph([Node(opset.PARAMETER, (8, 4)),
        ...                  Node(opset.TANH, (8, 4), inputs=(0,),
        ...                       is_output=True)], program="mlp_0")
        >>> g2 = KernelGraph.from_dict(g.to_dict())
        >>> (g2.program, g2.canonical_hash() == g.canonical_hash())
        ('mlp_0', True)
        """
        return {"nodes": [n.to_dict() for n in self.nodes],
                "program": self.program, "name": self.name,
                "tile_size": list(self.tile_size)}

    @staticmethod
    def from_dict(d: dict) -> "KernelGraph":
        return KernelGraph([Node.from_dict(n) for n in d["nodes"]],
                           program=d["program"], name=d["name"],
                           tile_size=tuple(d["tile_size"]))

    def renumbered(self, perm: Sequence[int]) -> "KernelGraph":
        """Relabel nodes by `perm` (new order = [nodes[p] for p in perm]).

        Only valid if the permutation preserves topological order; used by
        tests for permutation-invariance checks at the encoding level.
        """
        inv = {p: i for i, p in enumerate(perm)}
        new_nodes = []
        for p in perm:
            n = self.nodes[p]
            new_nodes.append(Node(n.op, n.shape, n.dtype_bytes,
                                  tuple(inv[j] for j in n.inputs),
                                  n.is_output, n.contract_dim,
                                  n.filter_size, n.reduced_dims))
        return KernelGraph(new_nodes, self.program, self.name, self.tile_size)


@dataclass
class Program:
    """A tensor program: a list of primitive ops (pre-fusion graph) or, once
    fused, a list of kernels."""
    name: str
    kernels: list[KernelGraph] = field(default_factory=list)

    def total_runtime(self, timer) -> float:
        """Program runtime = Σ kernel runtimes (paper §2.1)."""
        return float(sum(timer(k) for k in self.kernels))


def validate_graph(g: KernelGraph, max_nodes: int | None = None) -> None:
    if g.num_nodes == 0:
        raise ValueError("empty kernel graph")
    if max_nodes is not None and g.num_nodes > max_nodes:
        raise ValueError(f"kernel has {g.num_nodes} nodes > cap {max_nodes}")
    for i, n in enumerate(g.nodes):
        if n.op.arity == 0 and n.inputs:
            raise ValueError(f"node {i} ({n.op.name}) is nullary but has inputs")
        if len(n.shape) > 6:
            raise ValueError(f"node {i}: rank {len(n.shape)} > 6 unsupported")

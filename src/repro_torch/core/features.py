"""Feature extraction — paper §3.1.

Node features: opcode (categorical, embedded by the model) + scalar features
describing the node: output shape (variable-length → fixed sub-vector + sum +
product, §3.1 "Variable-Sized Features"), rank, dtype size, layout flag,
parameter/output flags, fan-in/fan-out, reduction dims, conv filter size.

Kernel features: tile size (same variable-length encoding; zeros for the
fusion task) + the four optional static performance features (FLOPs, bytes
read, bytes written, transcendental-unit instruction count).

All magnitude features go through log1p before [0,1] min-max scaling; the
normalizer statistics are fit on the training set only (paper footnote 1).
"""
from __future__ import annotations

import os
import threading
import weakref
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from repro_torch.core import opset
from repro_torch.core.graph import KernelGraph

SHAPE_SUBVEC = 6          # fixed sub-vector length for per-dimension features
TILE_SUBVEC = 6


def _subvec(values: Sequence[int], k: int) -> np.ndarray:
    """Encode a variable-length list: pad/truncate to k, append sum, product,
    log1p(product). Product is 'critical' per the paper (tensor volume)."""
    v = np.zeros((k + 3,), np.float64)
    vals = [float(x) for x in values][:k]
    v[:len(vals)] = vals
    arr = np.asarray(list(values), np.float64)
    total = float(arr.sum()) if arr.size else 0.0
    prod = float(arr.prod()) if arr.size else 0.0    # f64: no int overflow
    v[k] = total
    v[k + 1] = prod
    v[k + 2] = np.log1p(prod)
    return v


def _subvec_rows(seqs: Sequence[Sequence[int]], k: int) -> np.ndarray:
    """Row-batched `_subvec`: one [len(seqs), k+3] array, no per-row numpy
    allocations. Bit-identical to stacking `_subvec(s, k)` per row (the
    values are small integers, exact in f64 regardless of reduction
    order)."""
    n = len(seqs)
    out = np.zeros((n, k + 3), np.float64)
    if n == 0:
        return out
    lens = np.fromiter((len(s) for s in seqs), np.int64, count=n)
    L = int(lens.max())
    if L == 0:
        return out
    total = int(lens.sum())
    flat = np.fromiter((float(x) for s in seqs for x in s), np.float64,
                       count=total)
    vals = np.zeros((n, L), np.float64)
    row = np.repeat(np.arange(n), lens)
    starts = np.zeros((n,), np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    col = np.arange(total) - np.repeat(starts, lens)
    vals[row, col] = flat
    out[:, :min(L, k)] = vals[:, :k]
    out[:, k] = vals.sum(axis=1)
    mask = np.arange(L)[None, :] < lens[:, None]
    out[:, k + 1] = np.where(lens > 0,
                             np.where(mask, vals, 1.0).prod(axis=1), 0.0)
    out[:, k + 2] = np.log1p(out[:, k + 1])
    return out


SHAPE_FEATS = SHAPE_SUBVEC + 3
TILE_FEATS = TILE_SUBVEC + 3

# node scalar features layout:
#   [shape subvec+3 | rank | dtype_bytes | row_major flag | is_param |
#    is_output | fan_in | fan_out | reduced subvec(2)+3 | filter(2)+3 |
#    contract_dim | log1p(flops) | log1p(bytes_out) | elementwise flag |
#    transcendental flag ]
NODE_FEATURE_DIM = SHAPE_FEATS + 7 + (2 + 3) + (2 + 3) + 1 + 2 + 2

# kernel scalar features layout:
#   [tile subvec+3 | 4 static perf features (log1p) | num_nodes | depth]
KERNEL_FEATURE_DIM = TILE_FEATS + 4 + 2
STATIC_PERF_SLICE = slice(TILE_FEATS, TILE_FEATS + 4)
TILE_SLICE = slice(0, TILE_FEATS)


def node_features(g: KernelGraph) -> np.ndarray:
    """Per-node scalar features, vectorized over nodes: one Python pass
    collects the scalars, then whole columns are written at once — no
    per-node `np.concatenate`/`np.array` churn. Matches
    `node_features_reference` bit for bit."""
    nodes = g.nodes
    n_nodes = g.num_nodes
    feats = np.empty((n_nodes, NODE_FEATURE_DIM), np.float64)
    feats[:, :SHAPE_FEATS] = _subvec_rows([n.shape for n in nodes],
                                          SHAPE_SUBVEC)
    c = SHAPE_FEATS
    feats[:, c] = [float(len(n.shape)) for n in nodes]          # rank
    feats[:, c + 1] = [float(n.dtype_bytes) for n in nodes]
    feats[:, c + 2] = 1.0                          # default row-major layout
    feats[:, c + 3] = [1.0 if n.op is opset.PARAMETER else 0.0 for n in nodes]
    feats[:, c + 4] = [1.0 if n.is_output else 0.0 for n in nodes]
    feats[:, c + 5] = [float(len(n.inputs)) for n in nodes]
    feats[:, c + 6] = g.fan_out()
    c += 7
    feats[:, c:c + 5] = _subvec_rows([n.reduced_dims for n in nodes], 2)
    c += 5
    feats[:, c:c + 5] = _subvec_rows(
        [n.filter_size if n.op is opset.CONV else () for n in nodes], 2)
    c += 5
    feats[:, c] = [float(n.contract_dim) for n in nodes]
    feats[:, c + 1] = np.log1p([n.flops() for n in nodes])
    feats[:, c + 2] = np.log1p([float(n.bytes_out) for n in nodes])
    feats[:, c + 3] = [1.0 if n.op.elementwise else 0.0 for n in nodes]
    feats[:, c + 4] = [1.0 if n.op.transcendental else 0.0 for n in nodes]
    return feats


def node_features_reference(g: KernelGraph) -> np.ndarray:
    """The original per-node-loop encoder. Kept as the equivalence oracle
    for tests and as the baseline for `benchmarks/bench_input_pipeline.py`
    — not used on any hot path."""
    n_nodes = g.num_nodes
    fan_out = g.fan_out()
    feats = np.zeros((n_nodes, NODE_FEATURE_DIM), np.float64)
    for i, n in enumerate(g.nodes):
        parts = [
            _subvec(n.shape, SHAPE_SUBVEC),
            np.array([
                len(n.shape),
                n.dtype_bytes,
                1.0,                                   # default row-major layout
                1.0 if n.op is opset.PARAMETER else 0.0,
                1.0 if n.is_output else 0.0,
                float(len(n.inputs)),
                float(fan_out[i]),
            ]),
            _subvec(n.reduced_dims, 2),
            _subvec(n.filter_size if n.op is opset.CONV else (), 2),
            np.array([float(n.contract_dim)]),
            np.array([np.log1p(n.flops()), np.log1p(n.bytes_out)]),
            np.array([1.0 if n.op.elementwise else 0.0,
                      1.0 if n.op.transcendental else 0.0]),
        ]
        feats[i] = np.concatenate(parts)
    return feats


def kernel_features(g: KernelGraph, *, include_static_perf: bool = True,
                    include_tile: bool = True) -> np.ndarray:
    tile = g.tile_size if include_tile else ()
    static = np.zeros((4,), np.float64)
    if include_static_perf:
        static = np.array([
            np.log1p(g.total_flops()),
            np.log1p(g.bytes_read()),
            np.log1p(g.bytes_written()),
            np.log1p(g.transcendental_total()),
        ])
    return np.concatenate([
        _subvec(tile, TILE_SUBVEC),
        static,
        np.array([float(g.num_nodes), float(g.depth())]),
    ])


def opcode_ids(g: KernelGraph) -> np.ndarray:
    return np.array([n.op.index for n in g.nodes], np.int32)


def adjacency(g: KernelGraph, n_max: int) -> np.ndarray:
    """Dense directed adjacency: adj[d, s] = 1 iff edge s -> d."""
    a = np.zeros((n_max, n_max), np.float32)
    for s, d in g.edges():
        if s < n_max and d < n_max:
            a[d, s] = 1.0
    return a


# ----------------------------------------------------------------------------
# Normalization (fit on train set only)
# ----------------------------------------------------------------------------
@dataclass
class FeatureNormalizer:
    """Per-feature min-max scaling to [0, 1], statistics fit on the
    training set only (paper footnote 1); out-of-range values clip.

    >>> import numpy as np
    >>> n = FeatureNormalizer(node_min=np.zeros(2), node_max=np.full(2, 2.0),
    ...                       kernel_min=np.zeros(1), kernel_max=np.ones(1))
    >>> n.transform_node(np.array([[1.0, 4.0]])).tolist()
    [[0.5, 1.0]]
    """
    node_min: np.ndarray
    node_max: np.ndarray
    kernel_min: np.ndarray
    kernel_max: np.ndarray

    @staticmethod
    def fit(node_feats: Sequence[np.ndarray],
            kernel_feats: Sequence[np.ndarray]) -> "FeatureNormalizer":
        nf = np.concatenate([f for f in node_feats], axis=0)
        kf = np.stack(list(kernel_feats), axis=0)
        return FeatureNormalizer(
            node_min=nf.min(axis=0), node_max=nf.max(axis=0),
            kernel_min=kf.min(axis=0), kernel_max=kf.max(axis=0))

    def transform_node(self, f: np.ndarray) -> np.ndarray:
        rng = np.maximum(self.node_max - self.node_min, 1e-9)
        return np.clip((f - self.node_min) / rng, 0.0, 1.0)

    def transform_kernel(self, f: np.ndarray) -> np.ndarray:
        rng = np.maximum(self.kernel_max - self.kernel_min, 1e-9)
        return np.clip((f - self.kernel_min) / rng, 0.0, 1.0)

    def to_dict(self) -> dict:
        return {"node_min": self.node_min.tolist(),
                "node_max": self.node_max.tolist(),
                "kernel_min": self.kernel_min.tolist(),
                "kernel_max": self.kernel_max.tolist()}

    @staticmethod
    def from_dict(d: dict) -> "FeatureNormalizer":
        return FeatureNormalizer(
            np.asarray(d["node_min"]), np.asarray(d["node_max"]),
            np.asarray(d["kernel_min"]), np.asarray(d["kernel_max"]))


# ----------------------------------------------------------------------------
# Encode-once structural cache (DESIGN.md §9)
# ----------------------------------------------------------------------------
@dataclass
class EncodedKernel:
    """The tile-independent ("structural") encoding of one kernel, computed
    once and shared by every tile configuration of that kernel.

    Node features, opcode ids, the unique edge list, and the kernel scalar
    features minus the tile sub-vector are all pure functions of the graph
    structure — only `TILE_SLICE` of the kernel features changes with
    `KernelGraph.with_tile`. The cached arrays are read-only; consumers
    copy into their own batch buffers.

    Per-consumer memos hang off the entry so repeated encodes stay cheap:
    a dense adjacency per `n_max`, and the normalized node features for
    the most recent `FeatureNormalizer` (held weakly; normalizers are
    fit once and never mutated — see `FeatureNormalizer.fit`).
    """
    key: bytes                     # structural_digest(order_sensitive=True)
    opcodes: np.ndarray            # [n] int32
    node_feats: np.ndarray         # [n, NODE_FEATURE_DIM] float64, raw
    kernel_feats_base: np.ndarray  # [KERNEL_FEATURE_DIM] f64, TILE_SLICE = 0
    edges: np.ndarray              # [e, 2] int32 unique (src, dst)
    _adj: dict = field(default_factory=dict, init=False, repr=False)
    _norm: tuple | None = field(default=None, init=False, repr=False)

    @property
    def num_nodes(self) -> int:
        return self.opcodes.shape[0]

    def kernel_feats(self, tile: Sequence[int] = (), *,
                     include_static_perf: bool = True) -> np.ndarray:
        """Assemble the per-config kernel feature vector: copy the cached
        structural part and rewrite only `TILE_SLICE` (and zero
        `STATIC_PERF_SLICE` when the ablation asks for it). Bit-identical
        to `kernel_features(g.with_tile(tile), ...)`."""
        kf = self.kernel_feats_base.copy()
        if len(tile):
            kf[TILE_SLICE] = _subvec(tile, TILE_SUBVEC)
        if not include_static_perf:
            kf[STATIC_PERF_SLICE] = 0.0
        return kf

    def normalized_node_feats(self, normalizer: "FeatureNormalizer | None"
                              ) -> np.ndarray:
        """Node features through `normalizer` (raw when None), memoized for
        the last normalizer seen (training/eval/serving each use one)."""
        if normalizer is None:
            return self.node_feats
        memo = self._norm
        if memo is not None and memo[0]() is normalizer:
            return memo[1]
        arr = normalizer.transform_node(self.node_feats)
        arr.setflags(write=False)
        self._norm = (weakref.ref(normalizer), arr)
        return arr

    def dense_adj(self, n_max: int) -> np.ndarray:
        """Dense directed adjacency padded/truncated to `n_max`, memoized
        per width. Same semantics as `adjacency(g, n_max)`."""
        a = self._adj.get(n_max)
        if a is None:
            a = np.zeros((n_max, n_max), np.float32)
            e = self.edges
            if e.size:
                keep = (e[:, 0] < n_max) & (e[:, 1] < n_max)
                a[e[keep, 1], e[keep, 0]] = 1.0
            a.setflags(write=False)
            self._adj[n_max] = a
        return a


def _build_encoded(g: KernelGraph) -> EncodedKernel:
    ops = opcode_ids(g)
    nf = node_features(g)
    kf = kernel_features(g, include_tile=False)
    edges = np.asarray(g.unique_edges(), np.int32).reshape(-1, 2)
    for a in (ops, nf, kf, edges):
        a.setflags(write=False)
    return EncodedKernel(key=g.structural_digest(order_sensitive=True),
                         opcodes=ops, node_feats=nf, kernel_feats_base=kf,
                         edges=edges)


@dataclass(frozen=True)
class EncodeCacheStats:
    hits: int
    misses: int
    evictions: int
    size: int
    capacity: int

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class EncodeCache:
    """Bounded, thread-safe LRU of `EncodedKernel` entries keyed by
    `KernelGraph.structural_digest(order_sensitive=True)` — the node-order-
    sensitive structural identity, so every `with_tile` variant of a kernel
    maps to one entry while reordered (even isomorphic) node lists encode
    separately (feature rows follow node order).

    Capacity 0 disables storage (every call encodes fresh). The process-
    wide default cache is sized by the `REPRO_ENCODE_CACHE` env var
    (default 4096 entries); swap it with `set_encode_cache`.

    >>> from repro_torch.core import opset
    >>> from repro_torch.core.graph import KernelGraph, Node
    >>> g = KernelGraph([Node(opset.PARAMETER, (8, 8), is_output=True)])
    >>> c = EncodeCache(4)
    >>> a = c.get_or_encode(g)
    >>> b = c.get_or_encode(g.with_tile((8, 8)))   # tile variant: same entry
    >>> a is b, c.stats().hits, c.stats().misses
    (True, 1, 1)
    >>> bool(np.any(a.kernel_feats((8, 8))[TILE_SLICE]
    ...             != a.kernel_feats(())[TILE_SLICE]))
    True
    """

    def __init__(self, capacity: int = 4096):
        self.capacity = int(capacity)
        self._entries: OrderedDict[bytes, EncodedKernel] = OrderedDict()
        self._lock = threading.Lock()
        self._hits = self._misses = self._evictions = 0

    def get_or_encode(self, g: KernelGraph) -> EncodedKernel:
        if self.capacity <= 0:
            with self._lock:
                self._misses += 1
            return _build_encoded(g)
        key = g.structural_digest(order_sensitive=True)
        with self._lock:
            enc = self._entries.get(key)
            if enc is not None:
                self._hits += 1
                self._entries.move_to_end(key)
                return enc
            self._misses += 1
        enc = _build_encoded(g)          # encode outside the lock
        with self._lock:
            racer = self._entries.get(key)
            if racer is not None:        # another thread encoded it first
                return racer
            self._entries[key] = enc
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self._evictions += 1
        return enc

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._hits = self._misses = self._evictions = 0

    def stats(self) -> EncodeCacheStats:
        with self._lock:
            return EncodeCacheStats(self._hits, self._misses,
                                    self._evictions, len(self._entries),
                                    self.capacity)


_ENCODE_CACHE = EncodeCache(int(os.environ.get("REPRO_ENCODE_CACHE", "4096")))


def encode_cache() -> EncodeCache:
    """The process-wide structural-encode cache all encoders share."""
    return _ENCODE_CACHE


def set_encode_cache(cache: EncodeCache) -> EncodeCache:
    """Swap the process-wide cache (benchmarks/tests); returns the old one.
    `EncodeCache(0)` effectively disables caching."""
    global _ENCODE_CACHE
    old = _ENCODE_CACHE
    _ENCODE_CACHE = cache
    return old


def encode_structural(g: KernelGraph,
                      cache: EncodeCache | None = None) -> EncodedKernel:
    """The cached tile-independent encoding of `g` (see `EncodedKernel`)."""
    return (cache if cache is not None else _ENCODE_CACHE).get_or_encode(g)


# ----------------------------------------------------------------------------
# Batched device encoding
# ----------------------------------------------------------------------------
@dataclass
class GraphBatch:
    """Padded batch. All arrays are numpy here; `core.model.batch_to_device`
    moves them to the device."""
    opcodes: np.ndarray        # [B, N] int32
    node_feats: np.ndarray     # [B, N, F_node] float32
    adj: np.ndarray            # [B, N, N] float32  (adj[b, d, s])
    node_mask: np.ndarray      # [B, N] float32
    kernel_feats: np.ndarray   # [B, F_kernel] float32

    @property
    def batch_size(self) -> int:
        return self.opcodes.shape[0]

    @property
    def max_nodes(self) -> int:
        return self.opcodes.shape[1]


def encode_graph(g: KernelGraph, n_max: int,
                 normalizer: FeatureNormalizer | None = None,
                 *, include_static_perf: bool = True,
                 cache: EncodeCache | None = None) -> dict:
    """Encode one kernel to padded arrays (raw, unnormalized by default).

    The tile-independent work comes from the structural `EncodeCache`
    (process default unless `cache` is given); per call only the tile
    sub-vector is rewritten and the padded copies made. The returned
    "adj" array is the cache's read-only memo — copy before mutating.
    """
    enc = encode_structural(g, cache)
    n = min(enc.num_nodes, n_max)
    ops = np.zeros((n_max,), np.int32)
    ops[:n] = enc.opcodes[:n]
    nf_raw = enc.normalized_node_feats(normalizer)[:n]
    kf_raw = enc.kernel_feats(g.tile_size,
                              include_static_perf=include_static_perf)
    if normalizer is not None:
        kf_raw = normalizer.transform_kernel(kf_raw)
    nf = np.zeros((n_max, NODE_FEATURE_DIM), np.float32)
    nf[:n] = nf_raw
    mask = np.zeros((n_max,), np.float32)
    mask[:n] = 1.0
    return {
        "opcodes": ops,
        "node_feats": nf,
        "adj": enc.dense_adj(n_max),
        "node_mask": mask,
        "kernel_feats": kf_raw.astype(np.float32),
    }


# ----------------------------------------------------------------------------
# Sparse packed encoding (DESIGN.md §4)
# ----------------------------------------------------------------------------
@dataclass
class SparseGraphBatch:
    """Packed sparse batch: every graph's nodes live in one flat node buffer
    and every edge in one flat edge list, so memory and aggregation cost are
    linear in Σ nodes / Σ edges instead of quadratic in the padded per-graph
    node count (contrast `GraphBatch`; see DESIGN.md §4).

    Padding conventions (all jit-safe, no dynamic shapes):
      * padding nodes: `node_mask == 0`, `graph_ids == 0` — their
        contributions are always multiplied by the mask before segment ops;
      * padding edges: `edge_mask == 0`, endpoints point at node 0;
      * `gather_idx[g, r]` maps (graph slot, node position) to a flat node
        index for the sequence reductions (LSTM/Transformer); padding
        positions hold the sentinel `num_nodes`, resolved against a zero row
        appended at apply time;
      * padding graph slots: `graph_mask == 0` — their predictions are
        garbage by construction and must be dropped via `valid`/`graph_mask`.
    """
    opcodes: np.ndarray        # [M] int32
    node_feats: np.ndarray     # [M, F_node] float32
    node_mask: np.ndarray      # [M] float32
    graph_ids: np.ndarray      # [M] int32 — graph slot per node
    edge_src: np.ndarray       # [E] int32
    edge_dst: np.ndarray       # [E] int32
    edge_mask: np.ndarray      # [E] float32
    kernel_feats: np.ndarray   # [G, F_kernel] float32
    graph_mask: np.ndarray     # [G] float32
    gather_idx: np.ndarray     # [G, R] int32
    gather_mask: np.ndarray    # [G, R] float32

    @property
    def batch_size(self) -> int:       # graph slots (mirrors GraphBatch API)
        return self.kernel_feats.shape[0]

    @property
    def num_nodes(self) -> int:
        return self.opcodes.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edge_src.shape[0]

    @property
    def reduce_capacity(self) -> int:
        return self.gather_idx.shape[1]


@dataclass
class SegmentedGraphBatch:
    """A batch of whole-program graphs too big for one bucket
    (`repro.data.segmentation`; DESIGN.md §12).

    `inner` is an ordinary `SparseGraphBatch` whose graph slots are the
    *segments* of every member graph (owned nodes plus halo copies), so
    message passing reuses the bucketed sparse path unchanged. After the
    GNN, `scatter_idx` reassembles owned-node embeddings into whole-graph
    node order — halo and padding rows scatter to the dummy slot
    `num_nodes` (one past the outer buffer) and are dropped. The outer
    arrays mirror `SparseGraphBatch`'s readout fields, one slot per
    *original* graph: `kernel_feats` / `gather_idx` / masks describe the
    whole graphs, with the same `gather_idx` sentinel convention
    (`num_nodes` → appended zero row).
    """
    inner: "SparseGraphBatch"
    scatter_idx: np.ndarray    # [M_inner] int32 — outer slot or num_nodes
    node_mask: np.ndarray      # [M_outer] float32
    graph_ids: np.ndarray      # [M_outer] int32
    kernel_feats: np.ndarray   # [G, F_kernel] float32 (whole graphs)
    graph_mask: np.ndarray     # [G] float32
    gather_idx: np.ndarray     # [G, R] int32
    gather_mask: np.ndarray    # [G, R] float32

    @property
    def batch_size(self) -> int:       # original-graph slots
        return self.kernel_feats.shape[0]

    @property
    def num_nodes(self) -> int:        # outer (reassembled) node capacity
        return self.node_mask.shape[0]

    @property
    def reduce_capacity(self) -> int:
        return self.gather_idx.shape[1]


def encode_sparse_batch(graphs: Sequence[KernelGraph],
                        normalizer: FeatureNormalizer | None = None,
                        *, include_static_perf: bool = True,
                        node_capacity: int | None = None,
                        edge_capacity: int | None = None,
                        graph_capacity: int | None = None,
                        reduce_capacity: int | None = None
                        ) -> SparseGraphBatch:
    """Pack `graphs` (in order — slot g holds graphs[g]) into one
    SparseGraphBatch. Capacities default to the exact required sizes; the
    bucketing batcher in `repro_torch.data.batching` passes rounded-up capacities
    so jit compiles one executable per bucket.
    """
    if not graphs:
        raise ValueError("empty graph list")
    n_real = sum(g.num_nodes for g in graphs)
    e_real = sum(len(g.unique_edges()) for g in graphs)
    r_real = max(g.num_nodes for g in graphs)
    M = node_capacity if node_capacity is not None else n_real
    E = max(edge_capacity if edge_capacity is not None else e_real, 1)
    G = graph_capacity if graph_capacity is not None else len(graphs)
    R = reduce_capacity if reduce_capacity is not None else r_real
    if M < n_real:
        raise ValueError(f"node_capacity {M} < total nodes {n_real}")
    if E < e_real:
        raise ValueError(f"edge_capacity {E} < total edges {e_real}")
    if G < len(graphs):
        raise ValueError(f"graph_capacity {G} < num graphs {len(graphs)}")
    if R < r_real:
        raise ValueError(f"reduce_capacity {R} < max graph size {r_real}")

    opcodes = np.zeros((M,), np.int32)
    nf = np.zeros((M, NODE_FEATURE_DIM), np.float32)
    node_mask = np.zeros((M,), np.float32)
    graph_ids = np.zeros((M,), np.int32)
    edge_src = np.zeros((E,), np.int32)
    edge_dst = np.zeros((E,), np.int32)
    edge_mask = np.zeros((E,), np.float32)
    kf = np.zeros((G, KERNEL_FEATURE_DIM), np.float32)
    graph_mask = np.zeros((G,), np.float32)
    gather_idx = np.full((G, R), M, np.int32)      # sentinel = zero row
    gather_mask = np.zeros((G, R), np.float32)

    n_off = e_off = 0
    for gi, g in enumerate(graphs):
        enc = encode_structural(g)
        n = enc.num_nodes
        opcodes[n_off:n_off + n] = enc.opcodes
        kf_raw = enc.kernel_feats(g.tile_size,
                                  include_static_perf=include_static_perf)
        if normalizer is not None:
            kf_raw = normalizer.transform_kernel(kf_raw)
        nf[n_off:n_off + n] = enc.normalized_node_feats(normalizer)
        node_mask[n_off:n_off + n] = 1.0
        graph_ids[n_off:n_off + n] = gi
        kf[gi] = kf_raw
        graph_mask[gi] = 1.0
        gather_idx[gi, :n] = np.arange(n_off, n_off + n, dtype=np.int32)
        gather_mask[gi, :n] = 1.0
        arr = enc.edges
        if arr.size:
            k = arr.shape[0]
            edge_src[e_off:e_off + k] = arr[:, 0] + n_off
            edge_dst[e_off:e_off + k] = arr[:, 1] + n_off
            edge_mask[e_off:e_off + k] = 1.0
            e_off += k
        n_off += n
    return SparseGraphBatch(opcodes, nf, node_mask, graph_ids,
                            edge_src, edge_dst, edge_mask, kf, graph_mask,
                            gather_idx, gather_mask)


def encode_batch(graphs: Sequence[KernelGraph], n_max: int,
                 normalizer: FeatureNormalizer | None = None,
                 *, include_static_perf: bool = True) -> GraphBatch:
    enc = [encode_graph(g, n_max, normalizer,
                        include_static_perf=include_static_perf)
           for g in graphs]
    return GraphBatch(
        opcodes=np.stack([e["opcodes"] for e in enc]),
        node_feats=np.stack([e["node_feats"] for e in enc]),
        adj=np.stack([e["adj"] for e in enc]),
        node_mask=np.stack([e["node_mask"] for e in enc]),
        kernel_feats=np.stack([e["kernel_feats"] for e in enc]),
    )


def fit_normalizer(graphs: Sequence[KernelGraph],
                   *, include_static_perf: bool = True) -> FeatureNormalizer:
    nfs = [node_features(g) for g in graphs]
    kfs = [kernel_features(g, include_static_perf=include_static_perf)
           for g in graphs]
    return FeatureNormalizer.fit(nfs, kfs)

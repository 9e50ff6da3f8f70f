"""`CostModelService` — the one public scoring entry point, on the card.

Counterpart of `repro.serving.service` (docs/SERVING.md) for a
`repro_torch` `CostModel`: the same cache, coalescer, batching and stats,
with every flush scored on the model's device (the card unless the model
was built with `device="cpu"`).

Composition of the serving pipeline:

    predict_many(graphs)
      └─ cache lookup (canonical_hash)          repro_torch.serving.cache
         └─ miss → coalescer ticket (deduped)   repro_torch.serving.coalescer
            └─ flush → pack + bucket + encode   repro_torch.data.batching
               │    (structural features from   repro_torch.core.features
               │     the shared EncodeCache —   .encode_cache(); tile
               │     sweeps re-encode only      sweeps over one kernel
               │     TILE_SLICE; DESIGN.md §9)  hit one cached entry
               └─ one forward per pack/chunk    repro_torch.core.model

A service instance is bound to one frozen (model, model config,
normalizer) triple — that is what makes content-addressed caching sound:
with the model fixed, a graph's prediction is a pure function of its
canonical hash. Train a new model → build a new service.

Both batched-graph representations are supported. The sparse backend packs
cache misses through the bucketed batcher (pow2 `BucketSpec`s); the dense
backend pads fixed-size chunks. The segmented backend and int8 weights
are not ported yet. The
facade also exposes drop-in scorers for the call sites that used to go
straight to `core.evaluate` — `tile_scorer()`, `runtime_predictor()`,
`cost_fn()` — and a `stats()` surface (hit rate, bucket occupancy, flush
sizes, p50/p99 latency).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np

from repro_torch.core import features as F
from repro_torch.core.graph import KernelGraph
from repro_torch.core.evaluate import make_predict_fn
from repro_torch.core.model import CostModel, CostModelConfig
from repro_torch.data.batching import BucketSpec, bucket_for, encode_packed, \
    pack_graphs
from repro_torch.serving.cache import CacheStats, PredictionCache
from repro_torch.serving.coalescer import RequestCoalescer, Ticket


def _percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile; 0.0 on empty input.

    >>> _percentile([], 50)
    0.0
    >>> _percentile([3.0, 1.0, 2.0], 50)
    2.0
    >>> _percentile([1.0, 2.0, 3.0, 4.0], 99)
    4.0
    """
    if not values:
        return 0.0
    return float(np.percentile(np.asarray(values, np.float64), q,
                               method="higher"))


@dataclass(frozen=True)
class BucketStats:
    """Aggregate use of one compiled bucket shape across flushes."""
    flushes: int
    graphs: int
    mean_node_occupancy: float    # real nodes / node_capacity, averaged


@dataclass(frozen=True)
class ServiceStats:
    """Snapshot of everything the service has done so far."""
    requests: int                 # predict_many / submit calls
    graphs: int                   # total graph queries seen
    cache: CacheStats             # hits/misses/evictions/size/capacity
    coalesced: int                # duplicate in-flight queries absorbed
    flushes: int
    flush_sizes: tuple[int, ...]  # graphs per flush (last 4096 flushes)
    buckets: dict[BucketSpec | str, BucketStats] = field(default_factory=dict)
    latency_p50_ms: float = 0.0   # per predict_many call
    latency_p99_ms: float = 0.0

    @property
    def hit_rate(self) -> float:
        return self.cache.hit_rate

    def summary(self) -> str:
        """Human-readable multi-line report (used by the replay CLI)."""
        lines = [
            f"requests={self.requests} graphs={self.graphs} "
            f"hit_rate={self.hit_rate:.1%} "
            f"(hits={self.cache.hits} misses={self.cache.misses} "
            f"coalesced={self.coalesced})",
            f"cache size={self.cache.size}/{self.cache.capacity} "
            f"evictions={self.cache.evictions}",
            f"flushes={self.flushes} "
            f"mean_flush={np.mean(self.flush_sizes):.1f} "
            f"max_flush={max(self.flush_sizes)}"
            if self.flush_sizes else "flushes=0",
            f"latency p50={self.latency_p50_ms:.2f}ms "
            f"p99={self.latency_p99_ms:.2f}ms",
        ]
        for spec, b in sorted(self.buckets.items(), key=lambda kv: str(kv[0])):
            lines.append(f"  bucket {spec}: flushes={b.flushes} "
                         f"graphs={b.graphs} "
                         f"occupancy={b.mean_node_occupancy:.1%}")
        return "\n".join(lines)


class PendingRequest:
    """Deferred result of `submit`: per-slot either a cached float or a
    coalescer `Ticket`. `result()` flushes whatever is still pending."""

    def __init__(self, service: "CostModelService",
                 entries: list[float | Ticket]):
        self._service = service
        self._entries = entries

    def result(self) -> np.ndarray:
        if any(isinstance(e, Ticket) and not e.ready for e in self._entries):
            self._service.flush()
        return np.array([e.value if isinstance(e, Ticket) else e
                         for e in self._entries], np.float32)


class CostModelService:
    """Cached, coalescing batch scorer over one trained cost model.

    Parameters mirror `core.evaluate.predict_kernels`: `adjacency` and
    `max_nodes` default to the model config's values, `node_budget`
    (sparse packing budget, also the coalescer auto-flush threshold)
    defaults to `8 * max_nodes`, `chunk` is the dense batch width. Pass
    `predict_fn` to share one predict closure across services.

    `model` is an fp32 `repro_torch.core.model.CostModel`; it is scored on
    its own device. `precision` is stamped into cache-snapshot meta, as in
    the reference, so a warm cache of another precision is refused.
    """

    def __init__(self, model: CostModel, model_cfg: CostModelConfig,
                 normalizer, *, adjacency: str | None = None,
                 cache_capacity: int = 65536,
                 node_budget: int | None = None, chunk: int = 128,
                 max_nodes: int | None = None, predict_fn=None,
                 include_static_perf: bool = True):
        if model_cfg.precision != "f32":
            raise NotImplementedError(
                "int8 serving is not ported to repro_torch yet")
        self.model = model
        self.model_cfg = model_cfg
        self.precision = model_cfg.precision
        self.normalizer = normalizer
        self.adjacency = adjacency or model_cfg.adjacency
        if self.adjacency == "segmented":
            raise NotImplementedError(
                "the segmented backend is not ported to repro_torch yet")
        if self.adjacency not in ("dense", "sparse"):
            raise ValueError(f"unknown adjacency {self.adjacency!r}")
        self.max_nodes = max_nodes or model_cfg.max_nodes
        self.node_budget = node_budget or 8 * self.max_nodes
        self.chunk = int(chunk)
        self.include_static_perf = include_static_perf
        self._predict = predict_fn or make_predict_fn(model_cfg)
        # the LSTM reduction consumes node *order*, so isomorphic-but-
        # reordered graphs may score differently — key the cache on order
        self._order_sensitive = model_cfg.reduction == "lstm"
        self.cache = PredictionCache(cache_capacity)
        score = {"sparse": self._score_sparse,
                 "dense": self._score_dense}[self.adjacency]
        self.coalescer = RequestCoalescer(score,
                                          node_budget=self.node_budget,
                                          on_scored=self.cache.put)
        self._bucket_use: dict[BucketSpec | str, list[float]] = {}
        # cache and coalescer are internally locked; this lock only guards
        # the service-level counters, so submit() is safe from any thread
        # (the socket server's connection threads + scoring worker)
        self._stats_lock = threading.Lock()
        self._requests = 0
        self._graphs = 0
        self._latencies_ms: deque[float] = deque(maxlen=4096)

    # --- scoring backends (one flush = one call) ---------------------------
    # Both backends encode through the process-wide `features.EncodeCache`:
    # a prediction-cache miss for a new tile of an already-seen kernel
    # costs a tile-slice rewrite, not a full structural re-encode.
    def _score_sparse(self, graphs: Sequence[KernelGraph]) -> np.ndarray:
        out = np.zeros((len(graphs),), np.float32)
        # inference scores whatever it is handed: kernels beyond the budget
        # keep their historical oversized singleton packs here
        for pack in pack_graphs(graphs, self.node_budget,
                                oversized="singleton"):
            part = [graphs[i] for i in pack]
            spec = bucket_for(part)
            enc = encode_packed(
                part, self.normalizer,
                include_static_perf=self.include_static_perf, spec=spec)
            preds = np.asarray(self._predict(self.model, enc))
            out[pack] = preds[:len(pack)]
            use = self._bucket_use.setdefault(spec, [0, 0, 0.0])
            use[0] += 1
            use[1] += len(pack)
            use[2] += sum(g.num_nodes for g in part) / spec.node_capacity
        return out

    def _score_dense(self, graphs: Sequence[KernelGraph]) -> np.ndarray:
        out = []
        key = f"dense[{self.chunk}x{self.max_nodes}]"
        for i in range(0, len(graphs), self.chunk):
            part = list(graphs[i:i + self.chunk])
            pad = self.chunk - len(part)
            enc = F.encode_batch(
                part + [part[-1]] * pad, self.max_nodes, self.normalizer,
                include_static_perf=self.include_static_perf)
            preds = np.asarray(self._predict(self.model, enc))
            out.append(preds[:len(part)])
            use = self._bucket_use.setdefault(key, [0, 0, 0.0])
            use[0] += 1
            use[1] += len(part)
            use[2] += len(part) / self.chunk
        return np.concatenate(out)

    # --- public API --------------------------------------------------------
    def cache_key(self, graph: KernelGraph) -> str:
        """The content-addressed key this service caches `graph` under
        (order-sensitive iff the model's reduction depends on node
        order)."""
        return graph.canonical_hash(order_sensitive=self._order_sensitive)

    def submit(self, graphs: Sequence[KernelGraph]) -> PendingRequest:
        """Queue a batch of queries without forcing a flush: cached graphs
        resolve immediately, misses coalesce with other in-flight requests
        (identical graphs share one ticket). Call `.result()` — or let the
        node-budget auto-flush fire — to resolve."""
        with self._stats_lock:
            self._requests += 1
            self._graphs += len(graphs)
        entries: list[float | Ticket] = []
        for g in graphs:
            key = self.cache_key(g)
            val = self.cache.get(key)
            entries.append(self.coalescer.add(key, g)
                           if val is None else val)
        return PendingRequest(self, entries)

    def predict_many(self, graphs: Sequence[KernelGraph]) -> np.ndarray:
        """Synchronous scoring of a list of kernels; the primary entry
        point. Returns one float32 score per graph, in input order."""
        t0 = time.perf_counter()
        out = self.submit(graphs).result()
        self._latencies_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def predict(self, graph: KernelGraph) -> float:
        return float(self.predict_many([graph])[0])

    def flush(self) -> None:
        """Force-score everything pending in the coalescer."""
        self.coalescer.flush()

    # --- warm-cache persistence (docs/SERVING.md §warm cache) --------------
    # A snapshot is only sound for a service bound to the same frozen
    # (model, model config, normalizer) triple that produced it — the
    # cache key does not encode the model. The server stamps its snapshot
    # path per model; these helpers just delegate to the cache.
    def snapshot_cache(self, path: str) -> int:
        """Persist the prediction cache to `path` (atomic npz; see
        `PredictionCache.snapshot`), stamped with this service's
        precision. Returns the entry count."""
        return self.cache.snapshot(path, meta={"precision": self.precision})

    def restore_cache(self, path: str) -> int:
        """Warm-start the prediction cache from a `snapshot_cache` file.
        Refuses (SnapshotFormatError) a snapshot stamped with a different
        precision. Returns the number of entries loaded."""
        return self.cache.restore(path,
                                  expect_meta={"precision": self.precision})

    def stats(self) -> ServiceStats:
        buckets = {
            spec: BucketStats(flushes=int(u[0]), graphs=int(u[1]),
                              mean_node_occupancy=u[2] / u[0])
            for spec, u in dict(self._bucket_use).items()}
        lat = list(self._latencies_ms)
        with self._stats_lock:
            requests, graphs = self._requests, self._graphs
        return ServiceStats(
            requests=requests, graphs=graphs,
            cache=self.cache.stats(), coalesced=self.coalescer.coalesced,
            flushes=self.coalescer.flushes,
            flush_sizes=tuple(self.coalescer.flush_sizes), buckets=buckets,
            latency_p50_ms=_percentile(lat, 50),
            latency_p99_ms=_percentile(lat, 99))

    # --- drop-in scorers for the existing call sites -----------------------
    def tile_scorer(self) -> Callable:
        """`scorer(kernel, tiles) -> scores` for the tile autotuner /
        `eval_tile_task` (lower = faster)."""
        def scorer(kernel: KernelGraph, tiles) -> np.ndarray:
            kernel.structural_digest()     # memoize once; tile variants share
            return self.predict_many([kernel.with_tile(t) for t in tiles])
        return scorer

    def runtime_predictor(self) -> Callable:
        """`predict_runtimes(kernels) -> seconds` for the fusion task
        (the model predicts log-runtime; exponentiate)."""
        def predict_runtimes(kernels) -> np.ndarray:
            return np.exp(self.predict_many(list(kernels)))
        return predict_runtimes

    def cost_fn(self, *, drop_above: int | None = None) -> Callable:
        """Program-cost objective for the fusion annealer:
        Σ exp(predicted log-runtime). `drop_above` reproduces the dense
        path's max-nodes truncation guard (see `model_cost_fn`)."""
        def cost(kernels) -> float:
            ks = list(kernels)
            if drop_above is not None:
                ks = [k for k in ks if k.num_nodes <= drop_above]
            if not ks:
                return 0.0
            return float(np.sum(np.exp(self.predict_many(ks))))
        return cost

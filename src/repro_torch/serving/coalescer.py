"""Request coalescer (docs/SERVING.md, stage 2).

Cache misses from interleaved requests accumulate here instead of hitting
the model one graph at a time. `add` returns a `Ticket` immediately;
identical graphs (same canonical hash) submitted while a flush is pending
share one ticket, so near-duplicate traffic — tile candidates of one
kernel, annealer revisits — is scored exactly once. When the pending node
count reaches `node_budget` (or on an explicit `flush()`), the whole
pending set is handed to the scoring backend in one call, which packs it
through the bucketed sparse batcher (`repro_torch.data.batching`) so only a few
jit executables serve arbitrary traffic.

`add` and `flush` are thread-safe: one re-entrant lock guards the pending
set *and* the scoring call, so concurrent clients (the socket server's
scoring worker, `CostModelService.submit` callers on other threads) can
never double-flush a batch or lose a ticket — a flush atomically claims
the pending set, and every claimed ticket is resolved before the lock
drops.

>>> import numpy as np
>>> from repro_torch.data.synthetic import random_kernel
>>> co = RequestCoalescer(
...     lambda gs: np.array([g.num_nodes for g in gs], np.float32),
...     node_budget=1 << 30)
>>> g = random_kernel(5, seed=0)
>>> t1 = co.add(g.canonical_hash(), g)
>>> t2 = co.add(g.canonical_hash(), g)     # coalesced: same ticket
>>> t1 is t2
True
>>> co.flush()
>>> t1.value
5.0
>>> (co.flushes, co.coalesced)
(1, 1)
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.graph import KernelGraph

ScoreFn = Callable[[Sequence[KernelGraph]], np.ndarray]


class Ticket:
    """Placeholder for one unique pending graph; resolved at flush time."""
    __slots__ = ("value",)

    def __init__(self):
        self.value: float | None = None

    @property
    def ready(self) -> bool:
        return self.value is not None


class RequestCoalescer:
    """Accumulate unique cache-miss graphs; flush them in one batched call.

    `score_fn(graphs) -> np.ndarray` is the batching backend (see
    `CostModelService`); `on_scored(key, value)` — when given — is invoked
    for every resolved graph, which the service uses to fill the prediction
    cache during the flush so later submits already hit.
    """

    def __init__(self, score_fn: ScoreFn, *, node_budget: int = 2048,
                 on_scored: Callable[[str, float], None] | None = None):
        if node_budget < 1:
            raise ValueError(f"node_budget must be >= 1, got {node_budget}")
        self.score_fn = score_fn
        self.node_budget = int(node_budget)
        self.on_scored = on_scored
        # re-entrant: the auto-flush inside `add` re-enters `flush`
        self._lock = threading.RLock()
        self._pending: dict[str, tuple[KernelGraph, Ticket]] = {}
        self._pending_nodes = 0
        self.flushes = 0
        self.coalesced = 0            # duplicate adds absorbed by a ticket
        # bounded history (long-lived services flush millions of times)
        self.flush_sizes: deque[int] = deque(maxlen=4096)  # graphs per flush
        self.flush_nodes: deque[int] = deque(maxlen=4096)  # nodes per flush

    @property
    def pending(self) -> int:
        return len(self._pending)

    @property
    def pending_nodes(self) -> int:
        return self._pending_nodes

    def add(self, key: str, graph: KernelGraph) -> Ticket:
        """Register a miss; returns its (possibly shared) ticket. Flushes
        automatically once the pending set reaches `node_budget` nodes."""
        with self._lock:
            entry = self._pending.get(key)
            if entry is not None:
                self.coalesced += 1
                return entry[1]
            ticket = Ticket()
            self._pending[key] = (graph, ticket)
            self._pending_nodes += graph.num_nodes
            if self._pending_nodes >= self.node_budget:
                self.flush()
            return ticket

    def flush(self) -> None:
        """Score every pending graph in one backend call and resolve all
        tickets. No-op when nothing is pending. If the backend raises
        (a dying worker, an injected fault), the claimed tickets stay
        unresolved and the pending set stays empty — callers observe a
        clean failure, later adds start a fresh batch."""
        with self._lock:
            if not self._pending:
                return
            keys = list(self._pending)
            graphs = [self._pending[k][0] for k in keys]
            tickets = [self._pending[k][1] for k in keys]
            self._pending = {}
            self._pending_nodes = 0
            preds = np.asarray(self.score_fn(graphs), np.float32)
            if preds.shape != (len(graphs),):
                raise ValueError(f"score_fn returned shape {preds.shape}, "
                                 f"expected ({len(graphs)},)")
            self.flushes += 1
            self.flush_sizes.append(len(graphs))
            self.flush_nodes.append(sum(g.num_nodes for g in graphs))
            for key, ticket, p in zip(keys, tickets, preds):
                ticket.value = float(p)
                if self.on_scored is not None:
                    self.on_scored(key, float(p))

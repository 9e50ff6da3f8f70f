"""Content-addressed prediction cache (docs/SERVING.md, stage 1).

Keys are `KernelGraph.canonical_hash()` strings, values are scalar model
predictions. The cache is a plain LRU over an `OrderedDict`: a `get` hit
refreshes recency, a `put` past capacity evicts the least-recently-used
entry. Everything is counted so `CostModelService.stats()` can report hit
rates and eviction pressure. All operations are thread-safe — the server
(`repro.serving.server`) fills the cache from its scoring worker while
connection threads probe it.

A cache can be persisted and restored: `snapshot(path)` writes the
entries to a single checksummed npz in the corpus-store style
(`repro.data.store` — canonical-JSON payload block + one binary float64
values block, atomic tmp-then-rename), and `restore(path)` loads them
back preserving LRU order, so a restarted server answers replayed
traffic from disk (docs/SERVING.md §warm cache).

>>> c = PredictionCache(capacity=2)
>>> c.put("a", 1.0); c.put("b", 2.0)
>>> c.get("a")
1.0
>>> c.put("c", 3.0)            # evicts "b" ("a" was refreshed by the hit)
>>> c.get("b") is None
True
>>> s = c.stats()
>>> (s.hits, s.misses, s.evictions, s.size)
(1, 1, 1, 2)

>>> import tempfile, os
>>> path = os.path.join(tempfile.mkdtemp(), "cache.npz")
>>> c.snapshot(path)
2
>>> warm = PredictionCache(capacity=8)
>>> warm.restore(path)
2
>>> warm.get("c"), warm.get("a")       # exact values, LRU order kept
(3.0, 1.0)
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np

# v1: header {format_version, kind, keys, values_sha256}
# v2: + optional "meta" dict (model binding, e.g. {"precision": "int8"}) —
#     restore() accepts both; a v1 file is a v2 file with empty meta
SNAPSHOT_FORMAT_VERSION = 2
_ACCEPTED_VERSIONS = (1, 2)


@dataclass(frozen=True)
class CacheStats:
    """Counters since construction (`hits`/`misses` only count `get`)."""
    hits: int
    misses: int
    evictions: int
    size: int
    capacity: int

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class PredictionCache:
    """Bounded LRU map: canonical graph hash -> predicted score."""

    def __init__(self, capacity: int = 65536):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._data: OrderedDict[str, float] = OrderedDict()
        self._lock = threading.RLock()
        self._hits = 0
        self._misses = 0
        self._evictions = 0

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: str) -> bool:
        """Peek without touching recency or hit/miss counters."""
        return key in self._data

    def get(self, key: str) -> float | None:
        """Counted lookup; a hit refreshes the entry's recency."""
        with self._lock:
            val = self._data.get(key)
            if val is None:
                self._misses += 1
                return None
            self._data.move_to_end(key)
            self._hits += 1
            return val

    def put(self, key: str, value: float) -> None:
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                self._data[key] = float(value)
                return
            self._data[key] = float(value)
            if len(self._data) > self.capacity:
                self._data.popitem(last=False)
                self._evictions += 1

    def clear(self) -> None:
        with self._lock:
            self._data.clear()

    def stats(self) -> CacheStats:
        with self._lock:
            return CacheStats(self._hits, self._misses, self._evictions,
                              len(self._data), self.capacity)

    # --- persistence (warm restarts; docs/SERVING.md §warm cache) ----------
    def snapshot(self, path: str, *, meta: dict | None = None) -> int:
        """Persist all entries to one npz at `path` (atomic: tmp sibling +
        rename, like `repro.data.store`). Returns the entry count.

        Layout mirrors a corpus shard: ``entries`` is a canonical-JSON
        header (format version, keys in LRU order — oldest first — and a
        sha256 over the raw value bytes), ``values`` is one float64 block,
        JSON never touches the floats. `meta` (string-valued, e.g. the
        serving precision) is stamped into the header so `restore` can
        refuse snapshots from a differently-configured model.
        """
        with self._lock:
            keys = list(self._data)
            values = np.asarray([self._data[k] for k in keys], np.float64)
        header = {"format_version": SNAPSHOT_FORMAT_VERSION,
                  "kind": "prediction_cache", "keys": keys,
                  "meta": dict(meta or {}),
                  "values_sha256": hashlib.sha256(
                      values.tobytes()).hexdigest()}
        blob = json.dumps(header, sort_keys=True,
                          separators=(",", ":")).encode("utf-8")
        tmp = path + f".tmp-{os.getpid()}"
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        try:
            with open(tmp, "wb") as f:
                np.savez(f, entries=np.frombuffer(blob, np.uint8),
                         values=values)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        return len(keys)

    def restore(self, path: str, *, expect_meta: dict | None = None) -> int:
        """Load a `snapshot` file into this cache (entries inserted in
        stored LRU order, so recency survives the round trip; capacity
        still applies — oldest entries evict first if the snapshot is
        larger). Returns the number of entries loaded. Raises
        `SnapshotFormatError` on a corrupt/mismatched file, or when a
        key in `expect_meta` contradicts the snapshot's stamped meta
        (keys absent from the snapshot — every v1 file — are accepted:
        pre-meta snapshots predate the precision tag and are f32)."""
        try:
            with np.load(path) as z:
                header = json.loads(bytes(z["entries"]).decode("utf-8"))
                values = np.asarray(z["values"], np.float64)
        except (OSError, ValueError, KeyError) as e:
            raise SnapshotFormatError(f"{path}: unreadable snapshot "
                                      f"({e})") from e
        if header.get("format_version") not in _ACCEPTED_VERSIONS:
            raise SnapshotFormatError(
                f"{path}: format_version {header.get('format_version')!r} "
                f"not in {_ACCEPTED_VERSIONS}")
        meta = header.get("meta", {})
        for k, want in (expect_meta or {}).items():
            if k in meta and meta[k] != want:
                raise SnapshotFormatError(
                    f"{path}: snapshot meta {k}={meta[k]!r} does not match "
                    f"this service ({k}={want!r}) — a warm cache is only "
                    "sound for the model configuration that wrote it")
        digest = hashlib.sha256(values.tobytes()).hexdigest()
        if digest != header["values_sha256"]:
            raise SnapshotFormatError(f"{path}: values checksum mismatch")
        keys = header["keys"]
        if len(keys) != values.shape[0]:
            raise SnapshotFormatError(
                f"{path}: {len(keys)} keys but {values.shape[0]} values")
        with self._lock:
            for k, v in zip(keys, values):
                self.put(k, float(v))
        return len(keys)


class SnapshotFormatError(Exception):
    """Raised for malformed or checksum-mismatched cache snapshots."""

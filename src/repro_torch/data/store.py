"""Content-addressed, sharded on-disk corpus store (DESIGN.md §11,
docs/DATA.md).

Every trainer, benchmark and autotuner in this repo used to regenerate its
corpus (synthetic families + jaxpr-imported architectures, labeled by the
simulator oracle) in RAM on every run. This module makes a corpus a
*durable artifact*:

* `CorpusWriter` — streams records into numbered npz shards
  (``shard-00000.npz`` …) under one directory, deduplicating by the
  kernels' `canonical_hash` content address, then writes a
  ``manifest.json`` with per-shard sha256 checksums, a per-record
  program/family index, dedup stats and a deterministic `manifest_hash`
  over all of it. Same records in ⇒ byte-identical shards and manifest
  out (npz and JSON are both reproducible), so rebuilding an unchanged
  spec is a manifest-hash no-op.
* `StreamingCorpus` — a lazy, read-only sequence over a stored corpus.
  The manifest alone provides ``len``, `record_programs` and split
  metadata, so samplers index the corpus without touching a shard;
  record access decodes one shard at a time through a small LRU
  (``max_cached_shards``) — the full corpus is never materialized.
  Records round-trip exactly (float64 runtimes bit-for-bit), so the
  existing samplers and the `repro_torch.data.prefetch.Prefetcher` produce
  byte-identical batch streams from a store and from the in-memory
  records it was written from, and `batch(step)` purity keeps the
  stream seek/resume-able.

A shard is a single ``.npz`` with two entries: ``records`` (the UTF-8
JSON record payloads — graphs via `KernelGraph.to_dict`, tile sweeps,
program labels, dedup keys) and ``runtimes`` (one concatenated float64
block, sliced per record on read — JSON never touches the label floats).

`python -m repro_torch.launch.build_corpus` fans corpus *generation* across
worker processes into a store. This module is a copy of
`repro.data.store` with its imports rewritten: both packages write
byte-identical stores (equal `manifest_hash` and `chain_hash` for the
same records) and each opens and chains the other's.

>>> import tempfile
>>> from repro_torch.data.fusion_dataset import FusionKernelRecord
>>> from repro_torch.data.store import StreamingCorpus, write_corpus
>>> from repro_torch.data.synthetic import random_kernel
>>> recs = [FusionKernelRecord(random_kernel(8, seed=s), 1e-5 * (s + 1),
...                            program=f"mlp_{s}") for s in range(3)]
>>> d = tempfile.mkdtemp()
>>> m = write_corpus(d, "fusion", recs + recs[:1])   # one duplicate
>>> (m["stats"]["records"], m["stats"]["duplicates_dropped"])
(3, 1)
>>> c = StreamingCorpus.open(d)
>>> (len(c), c.record_programs)
(3, ['mlp_0', 'mlp_1', 'mlp_2'])
>>> c[1].runtime == recs[1].runtime                  # exact float64
True
>>> write_corpus(tempfile.mkdtemp(), "fusion",       # deterministic
...              recs)["manifest_hash"] == write_corpus(
...     tempfile.mkdtemp(), "fusion", recs)["manifest_hash"]
True
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import re
import shutil
from collections import OrderedDict
from typing import Iterable, Sequence

import numpy as np

from repro_torch.core.graph import KernelGraph
from repro_torch.data.corpus import family_of
from repro_torch.data.fusion_dataset import FusionKernelRecord
from repro_torch.data.tile_dataset import TileKernelRecord

FORMAT_VERSION = 1
MANIFEST_NAME = "manifest.json"
_SHARD_FMT = "shard-{:05d}.npz"
_DELTA_MANIFEST_FMT = "delta-{:05d}.json"
_DELTA_SHARD_FMT = "delta-{:05d}-{:05d}.npz"
_DELTA_MANIFEST_RE = re.compile(r"^delta-(\d{5})\.json$")

KINDS = ("tile", "fusion")


class CorpusFormatError(Exception):
    """Raised for malformed, truncated, or checksum-mismatched stores."""


# ----------------------------------------------------------------------------
# Hashing
# ----------------------------------------------------------------------------
def _canonical_json(obj) -> bytes:
    return json.dumps(obj, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")


def spec_hash(spec: dict) -> str:
    """Short stable identity of a build spec (the cached-corpus key)."""
    return hashlib.sha256(_canonical_json(spec)).hexdigest()[:16]


def manifest_hash(manifest: dict) -> str:
    """Hash of everything in the manifest except the hash field itself —
    shard checksums, record index, spec, stats. Two builds of the same
    corpus agree on it; any content change flips it."""
    clean = {k: v for k, v in manifest.items() if k != "manifest_hash"}
    return hashlib.sha256(_canonical_json(clean)).hexdigest()


def record_key(record) -> str:
    """Content-addressed dedup key of one record.

    Fusion records: the kernel's ``canonical_hash(order_sensitive=True)``
    (structure + node order + tile — node order matters to the LSTM
    reduction, so order-insensitive dedup could merge records a model
    distinguishes). Tile records additionally fold in the tile sweep, so
    the same kernel measured under two different sweeps is two records.
    Labels (``program``/``name``) are deliberately excluded, exactly like
    the serving cache key.
    """
    base = record.kernel.canonical_hash(order_sensitive=True)
    tiles = getattr(record, "tiles", None)
    if tiles is None:
        return base
    h = hashlib.blake2b(digest_size=16)
    h.update(base.encode())
    h.update(repr([tuple(int(x) for x in t) for t in tiles]).encode())
    return h.hexdigest()


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


# ----------------------------------------------------------------------------
# Record <-> payload
# ----------------------------------------------------------------------------
def pack_record(kind: str, record) -> dict:
    """Serialize one dataset record to its transit form: the payload
    already encoded as canonical JSON text plus the dedup/index metadata
    and the float64 runtimes as a list.

    Encoding to JSON *here* (in the builder worker) rather than at shard-
    write time matters: the merging parent only joins strings, so on a
    host where it competes with its own workers for cores the merge stays
    off the critical path — and strings pickle across the process
    boundary much faster than nested dicts. Shard bytes are identical
    either way (canonical separators + sorted keys). Runtimes live in the
    shard's binary block, never as JSON text.
    """
    if kind == "tile":
        runtimes = np.asarray(record.runtimes, np.float64)
        payload = {"kernel": record.kernel.to_dict(),
                   "tiles": [list(map(int, t)) for t in record.tiles],
                   "program": record.program,
                   "kernel_id": int(record.kernel_id)}
    elif kind == "fusion":
        runtimes = np.asarray([record.runtime], np.float64)
        payload = {"kernel": record.kernel.to_dict(),
                   "program": record.program}
    else:
        raise ValueError(f"unknown corpus kind {kind!r}")
    payload["key"] = record_key(record)
    payload["samples"] = int(runtimes.shape[0])
    return {"json": json.dumps(payload, sort_keys=True,
                               separators=(",", ":")),
            "key": payload["key"], "program": payload["program"],
            "samples": payload["samples"], "runtimes": runtimes.tolist()}


def unpack_record(kind: str, payload: dict, runtimes: np.ndarray):
    """Inverse of `pack_record` (runtimes: float64 [payload['samples']])."""
    kernel = KernelGraph.from_dict(payload["kernel"])
    if kind == "tile":
        return TileKernelRecord(
            kernel=kernel,
            tiles=[tuple(t) for t in payload["tiles"]],
            runtimes=np.asarray(runtimes, np.float64),
            program=payload["program"],
            kernel_id=int(payload.get("kernel_id", -1)))
    return FusionKernelRecord(kernel=kernel,
                              runtime=float(runtimes[0]),
                              program=payload["program"])


# ----------------------------------------------------------------------------
# Writer
# ----------------------------------------------------------------------------
class CorpusWriter:
    """Streams records into a sharded store; atomic at the directory level.

    Shards and the manifest are written into a hidden ``.tmp-<pid>``
    sibling and moved over `out_dir` in one rename at `finalize()` — a
    killed build never leaves a half-written corpus behind. Records are
    deduplicated on their `record_key` as they arrive (first occurrence
    wins, insertion order preserved), so merging per-worker outputs in a
    fixed task order yields the same store no matter how the work was
    partitioned.
    """

    def __init__(self, out_dir: str, kind: str, *, spec: dict | None = None,
                 shard_records: int = 256, dedup: bool = True):
        if kind not in KINDS:
            raise ValueError(f"unknown corpus kind {kind!r}")
        if shard_records < 1:
            raise ValueError("shard_records must be >= 1")
        self.out_dir = out_dir
        self.kind = kind
        self.spec = spec or {}
        self.shard_records = int(shard_records)
        self.dedup = dedup
        self._tmp = out_dir.rstrip("/\\") + f".tmp-{os.getpid()}"
        if os.path.exists(self._tmp):
            shutil.rmtree(self._tmp)
        os.makedirs(self._tmp)
        self._seen: set[str] = set()
        self._buf: list[dict] = []          # packed records awaiting a shard
        self._shards: list[dict] = []
        self._index: list[dict] = []
        self._dropped = 0
        self._finalized = False

    # -- adding ------------------------------------------------------------
    def add(self, record) -> bool:
        """Add one dataset record; returns False if deduplicated away."""
        return self.add_packed(pack_record(self.kind, record))

    def add_packed(self, packed: dict) -> bool:
        """Add one `pack_record` output (the worker-transit form)."""
        if self.dedup:
            if packed["key"] in self._seen:
                self._dropped += 1
                return False
            self._seen.add(packed["key"])
        self._buf.append(packed)
        if len(self._buf) >= self.shard_records:
            self._flush_shard()
        return True

    def add_many(self, records: Iterable) -> int:
        return sum(self.add(r) for r in records)

    # -- shard + manifest emission -----------------------------------------
    def _flush_shard(self) -> None:
        if not self._buf:
            return
        runtimes = np.concatenate(
            [np.asarray(p["runtimes"], np.float64) for p in self._buf])
        fname = _SHARD_FMT.format(len(self._shards))
        path = os.path.join(self._tmp, fname)
        # payloads are pre-encoded canonical JSON objects (pack_record);
        # joining them IS the canonical dump of the payload list
        blob = ("[" + ",".join(p["json"] for p in self._buf)
                + "]").encode("utf-8")
        with open(path, "wb") as f:
            np.savez(f, records=np.frombuffer(blob, np.uint8),
                     runtimes=runtimes)
        self._shards.append({
            "file": fname, "sha256": _sha256_file(path),
            "records": len(self._buf),
            "samples": int(sum(p["samples"] for p in self._buf)),
        })
        self._index.extend({"program": p["program"], "key": p["key"],
                            "samples": p["samples"]} for p in self._buf)
        self._buf = []

    def finalize(self) -> dict:
        """Flush the tail shard, write the manifest, move into place.
        Returns the manifest dict."""
        if self._finalized:
            raise RuntimeError("CorpusWriter already finalized")
        self._flush_shard()
        families: dict[str, int] = {}
        programs: set[str] = set()
        for e in self._index:
            families[family_of(e["program"])] = \
                families.get(family_of(e["program"]), 0) + 1
            programs.add(e["program"])
        manifest = {
            "format_version": FORMAT_VERSION,
            "kind": self.kind,
            "spec": self.spec,
            "spec_hash": spec_hash(self.spec),
            "shards": self._shards,
            "index": self._index,
            "stats": {
                "records": len(self._index),
                "samples": int(sum(e["samples"] for e in self._index)),
                "duplicates_dropped": self._dropped,
                "families": dict(sorted(families.items())),
                "programs": sorted(programs),
            },
        }
        manifest["manifest_hash"] = manifest_hash(manifest)
        with open(os.path.join(self._tmp, MANIFEST_NAME), "w") as f:
            json.dump(manifest, f, sort_keys=True, indent=1)
        if os.path.exists(self.out_dir):
            if not _looks_like_store(self.out_dir):
                raise CorpusFormatError(
                    f"{self.out_dir} exists and is not a corpus store; "
                    "refusing to overwrite")
            shutil.rmtree(self.out_dir)
        os.makedirs(os.path.dirname(os.path.abspath(self.out_dir)),
                    exist_ok=True)
        os.replace(self._tmp, self.out_dir)
        self._finalized = True
        return manifest

    def abort(self) -> None:
        shutil.rmtree(self._tmp, ignore_errors=True)

    # -- delta shards (the data-flywheel append path, DESIGN.md §15) --------
    @classmethod
    def append_delta(cls, store_dir: str, records: Sequence, *,
                     shard_records: int = 256, note: str = "") -> dict | None:
        """Append `records` to a finalized store as one **delta shard set**
        without rewriting the base: ``delta-00000-00000.npz`` … files plus
        a chained ``delta-00000.json`` manifest.

        Chaining: each delta manifest records the base's `manifest_hash`
        plus ``prev_hash`` — the previous delta's `manifest_hash` (the base
        hash for the first delta). `load_delta_manifests` re-verifies the
        whole chain on read, so a delta written against a different base,
        an out-of-order replay, or a gap in the sequence all raise
        `CorpusFormatError` instead of silently merging.

        Records are deduplicated (first occurrence wins) against the base
        index, every prior delta, and within the batch — the same
        `record_key` content address the base writer uses — so re-measuring
        a kernel the corpus already holds is a no-op. Returns the delta
        manifest, or ``None`` when every record was a duplicate (nothing is
        written). Shard files land first and the manifest is renamed into
        place last, so a crash mid-append leaves at worst orphan ``.npz``
        files that the chain loader never sees (single writer assumed).
        """
        base = load_manifest(store_dir)
        if base is None:
            raise CorpusFormatError(
                f"no readable corpus manifest in {store_dir}; "
                "append_delta needs a finalized base store")
        deltas = load_delta_manifests(store_dir, base)
        kind = base["kind"]
        seen = {e["key"] for e in base["index"]}
        for d in deltas:
            seen.update(e["key"] for e in d["index"])
        packed, dropped = [], 0
        for r in records:
            p = pack_record(kind, r)
            if p["key"] in seen:
                dropped += 1
                continue
            seen.add(p["key"])
            packed.append(p)
        if not packed:
            return None
        seq = len(deltas)
        shards: list[dict] = []
        index: list[dict] = []
        for lo in range(0, len(packed), int(shard_records)):
            chunk = packed[lo:lo + int(shard_records)]
            fname = _DELTA_SHARD_FMT.format(seq, len(shards))
            path = os.path.join(store_dir, fname)
            tmp = path + f".tmp-{os.getpid()}"
            runtimes = np.concatenate(
                [np.asarray(p["runtimes"], np.float64) for p in chunk])
            blob = ("[" + ",".join(p["json"] for p in chunk)
                    + "]").encode("utf-8")
            with open(tmp, "wb") as f:
                np.savez(f, records=np.frombuffer(blob, np.uint8),
                         runtimes=runtimes)
            os.replace(tmp, path)
            shards.append({
                "file": fname, "sha256": _sha256_file(path),
                "records": len(chunk),
                "samples": int(sum(p["samples"] for p in chunk)),
            })
            index.extend({"program": p["program"], "key": p["key"],
                          "samples": p["samples"]} for p in chunk)
        manifest = {
            "format_version": FORMAT_VERSION,
            "kind": kind,
            "delta_seq": seq,
            "base_manifest_hash": base["manifest_hash"],
            "prev_hash": (deltas[-1]["manifest_hash"] if deltas
                          else base["manifest_hash"]),
            "shards": shards,
            "index": index,
            "note": note,
            "stats": {
                "records": len(index),
                "samples": int(sum(e["samples"] for e in index)),
                "duplicates_dropped": dropped,
                "programs": sorted({e["program"] for e in index}),
            },
        }
        manifest["manifest_hash"] = manifest_hash(manifest)
        fname = _DELTA_MANIFEST_FMT.format(seq)
        tmp = os.path.join(store_dir, fname + f".tmp-{os.getpid()}")
        with open(tmp, "w") as f:
            json.dump(manifest, f, sort_keys=True, indent=1)
        os.replace(tmp, os.path.join(store_dir, fname))
        return manifest


def _looks_like_store(path: str) -> bool:
    if not os.path.isdir(path):
        return False
    entries = os.listdir(path)
    return (not entries or MANIFEST_NAME in entries
            or any(e.startswith("shard-") for e in entries))


def write_corpus(out_dir: str, kind: str, records: Sequence, *,
                 spec: dict | None = None, shard_records: int = 256,
                 dedup: bool = True) -> dict:
    """One-shot write of an in-memory record list. Returns the manifest."""
    w = CorpusWriter(out_dir, kind, spec=spec, shard_records=shard_records,
                     dedup=dedup)
    try:
        w.add_many(records)
        return w.finalize()
    except BaseException:
        w.abort()
        raise


def load_manifest(path: str) -> dict | None:
    """Read `path`'s manifest, or None if absent/unreadable/wrong version."""
    try:
        with open(os.path.join(path, MANIFEST_NAME)) as f:
            m = json.load(f)
        return m if m.get("format_version") == FORMAT_VERSION else None
    except (OSError, ValueError):
        return None


def load_delta_manifests(path: str, base: dict | None = None) -> list[dict]:
    """Ordered, chain-verified delta manifests of the store at `path`.

    Verifies the full chain: contiguous ``delta_seq`` from 0, every
    ``base_manifest_hash`` equal to the base's `manifest_hash`, every
    ``prev_hash`` equal to the predecessor's `manifest_hash`, and each
    manifest's own `manifest_hash` recomputing exactly. Any break raises
    `CorpusFormatError` — a tampered or half-copied chain never loads.
    Returns ``[]`` for a store with no deltas.
    """
    if base is None:
        base = load_manifest(path)
        if base is None:
            raise CorpusFormatError(f"no readable corpus manifest in {path}")
    seqs = sorted(int(m.group(1)) for m in
                  (_DELTA_MANIFEST_RE.match(e) for e in os.listdir(path))
                  if m is not None)
    if seqs != list(range(len(seqs))):
        raise CorpusFormatError(
            f"{path}: delta chain is not contiguous from 0: {seqs}")
    out: list[dict] = []
    prev = base["manifest_hash"]
    for seq in seqs:
        fname = _DELTA_MANIFEST_FMT.format(seq)
        try:
            with open(os.path.join(path, fname)) as f:
                m = json.load(f)
        except (OSError, ValueError) as e:
            raise CorpusFormatError(f"{path}/{fname}: unreadable delta "
                                    f"manifest ({e})") from e
        if m.get("format_version") != FORMAT_VERSION:
            raise CorpusFormatError(f"{path}/{fname}: format version "
                                    f"{m.get('format_version')!r}")
        if m.get("kind") != base["kind"]:
            raise CorpusFormatError(
                f"{path}/{fname}: delta kind {m.get('kind')!r} does not "
                f"match base kind {base['kind']!r}")
        if m.get("delta_seq") != seq:
            raise CorpusFormatError(f"{path}/{fname}: delta_seq "
                                    f"{m.get('delta_seq')!r} != {seq}")
        if m.get("base_manifest_hash") != base["manifest_hash"]:
            raise CorpusFormatError(
                f"{path}/{fname}: delta was written against base "
                f"{str(m.get('base_manifest_hash'))[:12]}…, store base is "
                f"{base['manifest_hash'][:12]}…")
        if m.get("prev_hash") != prev:
            raise CorpusFormatError(
                f"{path}/{fname}: broken delta chain (prev_hash "
                f"{str(m.get('prev_hash'))[:12]}… != {prev[:12]}…)")
        if manifest_hash(m) != m.get("manifest_hash"):
            raise CorpusFormatError(f"{path}/{fname}: manifest hash "
                                    "mismatch (tampered delta manifest)")
        prev = m["manifest_hash"]
        out.append(m)
    return out


# ----------------------------------------------------------------------------
# Reader
# ----------------------------------------------------------------------------
class StreamingCorpus(Sequence):
    """Lazy random-access + shard-streaming view of a stored corpus.

    Acts as a read-only sequence of dataset records
    (`TileKernelRecord` / `FusionKernelRecord`). ``len`` and
    `record_programs` come from the manifest alone; ``corpus[i]`` decodes
    the owning shard on demand (verifying its checksum) and keeps up to
    ``max_cached_shards`` decoded shards in an LRU, so both samplers can
    draw uniformly from a corpus much larger than RAM. Iteration walks
    shard by shard in record order.
    """

    def __init__(self, path: str, manifest: dict, *,
                 max_cached_shards: int = 4):
        if max_cached_shards < 1:
            raise ValueError("max_cached_shards must be >= 1")
        self.path = path
        self.manifest = manifest
        self.kind = manifest["kind"]
        self.max_cached_shards = int(max_cached_shards)
        self._cache: OrderedDict[int, list] = OrderedDict()
        # record i lives in shard s iff bounds[s] <= i < bounds[s+1]
        self._bounds = np.cumsum(
            [0] + [s["records"] for s in manifest["shards"]])
        if int(self._bounds[-1]) != len(manifest["index"]):
            raise CorpusFormatError(
                f"{path}: manifest index has {len(manifest['index'])} "
                f"records but shards declare {int(self._bounds[-1])}")

    @classmethod
    def open(cls, path: str, *, max_cached_shards: int = 4,
             verify: bool = False) -> "StreamingCorpus":
        manifest = load_manifest(path)
        if manifest is None:
            raise CorpusFormatError(f"no readable corpus manifest in {path}")
        c = cls(path, manifest, max_cached_shards=max_cached_shards)
        if verify:
            c.verify()
        return c

    # -- manifest-only metadata (no shard decode) --------------------------
    @property
    def record_programs(self) -> list[str]:
        """Program name of every record, in record order — lets the
        samplers build their per-program index without decoding shards."""
        return [e["program"] for e in self.manifest["index"]]

    @property
    def manifest_hash(self) -> str:
        return self.manifest["manifest_hash"]

    @property
    def spec(self) -> dict:
        return self.manifest["spec"]

    @property
    def num_samples(self) -> int:
        return int(self.manifest["stats"]["samples"])

    def programs(self) -> list[str]:
        return list(self.manifest["stats"]["programs"])

    # -- record access ------------------------------------------------------
    def __len__(self) -> int:
        return len(self.manifest["index"])

    def __getitem__(self, i: int):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        n = len(self)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(i)
        s = int(np.searchsorted(self._bounds, i, side="right")) - 1
        return self._shard_records(s)[i - int(self._bounds[s])]

    def __iter__(self):
        for s in range(len(self.manifest["shards"])):
            yield from self._shard_records(s)

    def iter_shards(self):
        """Yield each shard's decoded record list in order — the
        sequential-scan path (build pipelines, eval sweeps)."""
        for s in range(len(self.manifest["shards"])):
            yield self._shard_records(s)

    def _shard_records(self, s: int) -> list:
        hit = self._cache.get(s)
        if hit is not None:
            self._cache.move_to_end(s)
            return hit
        records = self._decode_shard(s)
        self._cache[s] = records
        while len(self._cache) > self.max_cached_shards:
            self._cache.popitem(last=False)
        return records

    def _decode_shard(self, s: int) -> list:
        entry = self.manifest["shards"][s]
        path = os.path.join(self.path, entry["file"])
        with open(path, "rb") as f:
            raw = f.read()
        digest = hashlib.sha256(raw).hexdigest()
        if digest != entry["sha256"]:
            raise CorpusFormatError(
                f"{path}: checksum mismatch (manifest {entry['sha256'][:12]}"
                f"…, file {digest[:12]}…)")
        with np.load(io.BytesIO(raw)) as z:
            payloads = json.loads(bytes(z["records"]).decode("utf-8"))
            runtimes = z["runtimes"]
        records, off = [], 0
        for p in payloads:
            n = int(p["samples"])
            records.append(unpack_record(self.kind, p,
                                         runtimes[off:off + n]))
            off += n
        if off != runtimes.shape[0] or len(records) != entry["records"]:
            raise CorpusFormatError(f"{path}: shard contents disagree with "
                                    "manifest record/sample counts")
        return records

    # -- splits -------------------------------------------------------------
    def select_programs(self, names) -> "CorpusSubset":
        """Streaming equivalent of `data.corpus.filter_by_programs`: a lazy
        view of the records whose program is in `names` (order preserved).
        Built from the manifest index alone — nothing is decoded."""
        name_set = set(names)
        idx = [i for i, e in enumerate(self.manifest["index"])
               if e["program"] in name_set]
        return CorpusSubset(self, idx)

    # -- worker sharding ----------------------------------------------------
    def shard(self, idx: int, num: int) -> "CorpusSubset":
        """Worker `idx`'s deterministic round-robin slice of the corpus
        (records ``idx, idx+num, idx+2·num, …``), as a lazy manifest-only
        view — the `ShardableDataset.shard(idx, num)` pattern that
        data-parallel training shards the stream with.

        Shards are **disjoint** and **exhaustive**: position-interleaving
        the `num` shards reproduces the unsharded record stream
        byte-identically (``full[i] == shard(i % num, num)[i // num]``).
        ``shard(0, 1)`` is the identity view; every shard shares the
        parent's decoded-shard LRU, so co-located workers don't decode a
        file twice. Nothing is decoded by this call itself.

        >>> import tempfile
        >>> from repro_torch.data.fusion_dataset import FusionKernelRecord
        >>> from repro_torch.data.synthetic import random_kernel
        >>> recs = [FusionKernelRecord(random_kernel(6, seed=s), 1e-5,
        ...                            program=f"p{s}") for s in range(5)]
        >>> d = tempfile.mkdtemp()
        >>> _ = write_corpus(d, "fusion", recs)
        >>> c = StreamingCorpus.open(d)
        >>> [len(c.shard(i, 2)) for i in (0, 1)]
        [3, 2]
        >>> (c.shard(0, 2).record_programs, c.shard(1, 2).record_programs)
        (['p0', 'p2', 'p4'], ['p1', 'p3'])
        """
        _check_shard(idx, num)
        return CorpusSubset(self, range(idx, len(self), num))

    # -- delta shards --------------------------------------------------------
    def delta_manifests(self) -> list[dict]:
        """Chain-verified delta manifests appended to this store (may be
        empty). See `load_delta_manifests` for the verification rules."""
        return load_delta_manifests(self.path, self.manifest)

    def with_deltas(self, *, max_cached_shards: int | None = None
                    ) -> "ChainedCorpus":
        """Base+delta view of this store: the base records followed by
        every delta's records in chain order. Because `append_delta`
        dedups each delta against the base and all prior deltas with the
        same first-wins `record_key` rule the base writer uses, this
        stream is byte-identical to a from-scratch ``write_corpus(...,
        dedup=True)`` rebuild over the concatenated raw record streams
        (provided the base itself was written with ``dedup=True``) —
        the parity `chip_smoke.py`'s `[flywheel]` phase gates on.

        >>> import tempfile
        >>> from repro_torch.data.fusion_dataset import FusionKernelRecord
        >>> from repro_torch.data.synthetic import random_kernel
        >>> recs = [FusionKernelRecord(random_kernel(6, seed=s), 1e-5,
        ...                            program=f"p{s}") for s in range(4)]
        >>> d = tempfile.mkdtemp()
        >>> _ = write_corpus(d, "fusion", recs[:2])
        >>> m = CorpusWriter.append_delta(d, recs[1:])   # recs[1] is a dup
        >>> (m["delta_seq"], m["stats"]["records"],
        ...  m["stats"]["duplicates_dropped"])
        (0, 2, 1)
        >>> CorpusWriter.append_delta(d, recs[:2]) is None   # all dups
        True
        >>> c = StreamingCorpus.open(d).with_deltas()
        >>> (len(c), c.record_programs)
        (4, ['p0', 'p1', 'p2', 'p3'])
        """
        mcs = (self.max_cached_shards if max_cached_shards is None
               else max_cached_shards)
        parts = [StreamingCorpus(self.path, m, max_cached_shards=mcs)
                 for m in self.delta_manifests()]
        return ChainedCorpus(self, parts)

    # -- integrity ----------------------------------------------------------
    def verify(self) -> None:
        """Recompute every shard checksum; raises CorpusFormatError on any
        mismatch or missing shard file."""
        for entry in self.manifest["shards"]:
            path = os.path.join(self.path, entry["file"])
            if not os.path.exists(path):
                raise CorpusFormatError(f"missing shard {path}")
            if _sha256_file(path) != entry["sha256"]:
                raise CorpusFormatError(f"{path}: checksum mismatch")
        if manifest_hash(self.manifest) != self.manifest["manifest_hash"]:
            raise CorpusFormatError(f"{self.path}: manifest hash mismatch")


def _check_shard(idx: int, num: int) -> None:
    if num < 1:
        raise ValueError(f"num shards must be >= 1, got {num}")
    if not 0 <= idx < num:
        raise ValueError(f"shard idx must be in [0, {num}), got {idx}")


class ChainedCorpus(Sequence):
    """Read-only base+deltas record stream (`StreamingCorpus.with_deltas`).

    A sequence of dataset records: all base records first, then each
    delta's records in chain order — exactly the first-wins dedup order a
    from-scratch rebuild would produce. Exposes the same manifest-only
    surface the samplers and `CorpusSubset` rely on (``record_programs``,
    ``manifest["index"]``, `select_programs`, `shard`), so everything
    downstream of a `StreamingCorpus` — `TileBatchSampler`,
    `BalancedSampler`, worker sharding, `launch/train.py --from-store`
    — consumes a chained view unchanged.
    """

    def __init__(self, base: StreamingCorpus,
                 deltas: Sequence[StreamingCorpus]):
        self.base = base
        self.deltas = list(deltas)
        self.parts: list[StreamingCorpus] = [base, *self.deltas]
        self.kind = base.kind
        self.path = base.path
        self._bounds = np.cumsum([0] + [len(p) for p in self.parts])
        index = [e for p in self.parts for e in p.manifest["index"]]
        self.manifest = {
            "kind": self.kind,
            "index": index,
            "stats": {
                "records": len(index),
                "samples": int(sum(e["samples"] for e in index)),
                "programs": sorted({e["program"] for e in index}),
            },
        }

    @property
    def num_deltas(self) -> int:
        return len(self.deltas)

    @property
    def chain_hash(self) -> str:
        """Deterministic identity of the full base+delta chain (changes
        whenever a delta is appended — the retrain trigger key)."""
        h = hashlib.sha256()
        for p in self.parts:
            h.update(p.manifest["manifest_hash"].encode())
        return h.hexdigest()

    @property
    def record_programs(self) -> list[str]:
        return [e["program"] for e in self.manifest["index"]]

    def programs(self) -> list[str]:
        return list(self.manifest["stats"]["programs"])

    def __len__(self) -> int:
        return int(self._bounds[-1])

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        n = len(self)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(i)
        s = int(np.searchsorted(self._bounds, i, side="right")) - 1
        return self.parts[s][i - int(self._bounds[s])]

    def __iter__(self):
        for p in self.parts:
            yield from p

    def select_programs(self, names) -> "CorpusSubset":
        name_set = set(names)
        idx = [i for i, e in enumerate(self.manifest["index"])
               if e["program"] in name_set]
        return CorpusSubset(self, idx)

    def shard(self, idx: int, num: int) -> "CorpusSubset":
        _check_shard(idx, num)
        return CorpusSubset(self, range(idx, len(self), num))

    def verify(self) -> None:
        """Checksum-verify the base and every delta shard (and re-verify
        the manifest chain, since construction already walked it)."""
        for p in self.parts:
            p.verify()


class CorpusSubset(Sequence):
    """Lazy index-mapped view over a `StreamingCorpus` (a train/val/test
    split or a worker shard). Shares the parent's shard LRU; exposes
    `record_programs` so the samplers index it without decoding anything."""

    def __init__(self, corpus: StreamingCorpus, indices: Sequence[int]):
        self._corpus = corpus
        self._indices = list(indices)

    @property
    def record_programs(self) -> list[str]:
        index = self._corpus.manifest["index"]
        return [index[i]["program"] for i in self._indices]

    def shard(self, idx: int, num: int) -> "CorpusSubset":
        """Round-robin sub-shard of this view (see `StreamingCorpus.shard`)
        — composes with `select_programs`, so a worker can shard its train
        split without materializing either."""
        _check_shard(idx, num)
        return CorpusSubset(self._corpus, self._indices[idx::num])

    def __len__(self) -> int:
        return len(self._indices)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        return self._corpus[self._indices[i]]

"""Balanced, deterministic, shard-aware batch sampling.

* Balanced: the paper draws examples evenly per program ("model type") to
  counter corpus imbalance; we sample programs uniformly, then kernels.
* Deterministic: the batch at step k is a pure function of (seed, step,
  host shard) — a preempted-and-restarted worker reproduces its exact batch
  stream, which the fault-tolerance tests rely on.
* Shard-aware: with H data-parallel workers, worker h draws from its own
  disjoint round-robin shard of the records (`shard_records`; a
  `StreamingCorpus`/`CorpusSubset` shards through its manifest-only
  `.shard(idx, num)` view, so no shard file is decoded for records other
  workers own) with an h-distinct RNG stream. `ShardPlanner` reassigns
  shards away from hosts flagged as stragglers (deterministically), so a
  slow host's work is taken over by backups without coordination.
* Mesh-ready: `GlobalBatchSampler` stacks the per-shard sub-batches of dp
  sampler views into one global batch with a leading device axis — sparse
  sub-batches are re-bucketed to one shared `BucketSpec` so a single
  compiled executable serves every device (DESIGN.md §13).

Both samplers encode each draw with `adjacency='dense'` (padded GraphBatch,
truncated at max_nodes) or `adjacency='sparse'` (packed SparseGraphBatch —
no per-graph padding or truncation; capacities pow2-bucketed so jit sees a
bounded set of shapes). See DESIGN.md §4.

Because `batch(step)` is pure, both samplers compose with
`repro.data.prefetch.Prefetcher` (encode-ahead on a background thread;
`TrainerConfig.prefetch` enables it) without changing the batch stream,
and every draw's structural encode is served by the `features.EncodeCache`
— a tile sweep re-encodes only the tile sub-vector (DESIGN.md §9).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from repro_torch.core.features import FeatureNormalizer, encode_batch
from repro_torch.data import batching


@dataclass
class TileBatch:
    graphs: object           # GraphBatch | SparseGraphBatch
    targets: np.ndarray      # [B] seconds
    group_ids: np.ndarray    # [B] int32 — same kernel => same group
    valid: np.ndarray        # [B] float32


@dataclass
class FusionBatch:
    graphs: object           # GraphBatch | SparseGraphBatch
    targets: np.ndarray      # [B] seconds
    valid: np.ndarray        # [B] float32


def shard_records(records, idx: int, num: int):
    """Worker `idx`'s deterministic round-robin shard of `records`.

    Dispatches to the sequence's own manifest-only ``.shard(idx, num)``
    when it has one (`StreamingCorpus` / `CorpusSubset` — nothing decoded)
    and falls back to a strided slice for in-memory lists. Shards are
    disjoint and exhaustive: position-interleaving them reproduces the
    unsharded record stream.
    """
    if num < 1:
        raise ValueError(f"num shards must be >= 1, got {num}")
    if not 0 <= idx < num:
        raise ValueError(f"shard idx must be in [0, {num}), got {idx}")
    if num == 1:
        return records
    shard = getattr(records, "shard", None)
    if shard is not None:
        return shard(idx, num)
    return records[idx::num]


def _program_index(records) -> dict[str, list[int]]:
    """record index -> per-program draw lists. A `StreamingCorpus` (or any
    sequence exposing `record_programs`) is indexed from its manifest
    metadata alone — no shard is decoded until a batch actually draws
    from it, which is what keeps store-backed sampling shard-by-shard."""
    programs = getattr(records, "record_programs", None)
    if programs is None:
        programs = [r.program for r in records]
    by_program: dict[str, list[int]] = {}
    for i, p in enumerate(programs):
        by_program.setdefault(p, []).append(i)
    return by_program


def sparse_draw_spec(graphs) -> batching.BucketSpec:
    """The `BucketSpec` a sparse encode of this draw uses: pow2-bucketed
    node/edge/reduce capacities, graph capacity EXACT (the per-step draw
    count is fixed, so jit still sees one G): padded graph slots would
    dilute losses normalized by slot count (pairwise_rank_loss's n(n-1)/2)
    relative to an identical dense run."""
    return dataclasses.replace(batching.bucket_for(graphs),
                               graph_capacity=len(graphs))


def _encode(graphs, adjacency: str, max_nodes: int, normalizer, spec=None):
    """Encode a drawn graph list with the configured representation.

    dense     — `features.encode_batch`, one padded [N, N] slot per graph.
    sparse    — `batching.encode_packed`, the whole draw packed into one
                flat node/edge buffer with pow2-bucketed capacities, so
                only a few shapes reach jit (slot order == draw order, so
                targets/groups line up unchanged). `spec` overrides the
                draw's own bucket — `GlobalBatchSampler` passes the max
                bucket over its shards so all sub-batches share one shape.
    segmented — `batching.encode_segmented`, for whole-program graphs of
                any size: each graph split into ≤ max_nodes segments,
                owned-node embeddings reassembled before readout
                (DESIGN.md §12). Slot order == draw order here too.
    """
    if adjacency == "dense":
        return encode_batch(graphs, max_nodes, normalizer)
    if adjacency == "sparse":
        if spec is None:
            spec = sparse_draw_spec(graphs)
        return batching.encode_packed(graphs, normalizer, spec=spec)
    if adjacency == "segmented":
        return batching.encode_segmented(graphs, max_nodes, normalizer)
    raise ValueError(f"unknown adjacency {adjacency!r}")


class _ShardedSampler:
    """Shared worker-shard plumbing of both samplers.

    `host_id`/`num_hosts` select BOTH the RNG stream and the record shard:
    worker h of H draws only from `shard_records(records, h, H)` — the
    disjoint round-robin slice whose union over workers is the full record
    list. With `num_hosts == 1` the records are untouched (the historical
    single-worker behavior, bit-for-bit).
    """

    def _init_shard(self, records, *, seed: int, host_id: int,
                    num_hosts: int, what: str):
        if not records:
            raise ValueError(f"empty {what} dataset")
        self._all_records = records      # pre-shard; `with_host` re-slices
        self.seed = seed
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.records = shard_records(records, host_id, num_hosts)
        if not len(self.records):
            raise ValueError(
                f"{what} shard {host_id}/{num_hosts} is empty "
                f"({len(records)} records total)")
        self._by_program = _program_index(self.records)
        self._programs = sorted(self._by_program)

    def with_host(self, host_id: int, num_hosts: int):
        """A copy of this sampler re-sharded as worker `host_id` of
        `num_hosts` over the SAME underlying records — how the mesh
        trainer derives its dp per-device sampler views."""
        import copy
        s = copy.copy(self)
        s._init_shard(self._all_records, seed=self.seed, host_id=host_id,
                      num_hosts=num_hosts, what=self._what)
        return s

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))

    def batch(self, step: int):
        return self.encode_draw(self.draw(step))


class TileBatchSampler(_ShardedSampler):
    """Yields batches of (kernel, tile) samples grouped for the rank loss."""

    _what = "tile"

    def __init__(self, records, normalizer: FeatureNormalizer, *,
                 kernels_per_batch: int = 4, configs_per_kernel: int = 16,
                 max_nodes: int = 64, seed: int = 0, host_id: int = 0,
                 num_hosts: int = 1, adjacency: str = "dense"):
        self.normalizer = normalizer
        self.kernels_per_batch = kernels_per_batch
        self.configs_per_kernel = configs_per_kernel
        self.max_nodes = max_nodes
        self.adjacency = adjacency
        self._init_shard(records, seed=seed, host_id=host_id,
                         num_hosts=num_hosts, what=self._what)

    @property
    def batch_size(self) -> int:
        return self.kernels_per_batch * self.configs_per_kernel

    def draw(self, step: int) -> tuple:
        """The step's raw draw: (graphs, targets, group_ids, valid) before
        encoding — `batch` = `encode_draw(draw(step))`."""
        rng = self._rng(step)
        graphs, targets, groups, valid = [], [], [], []
        for ki in range(self.kernels_per_batch):
            prog = self._programs[int(rng.integers(len(self._programs)))]
            rec = self.records[int(rng.choice(self._by_program[prog]))]
            rec.kernel.structural_digest()   # memoize node digests + edge
            rec.kernel.unique_edges()        # set once: every with_tile
            #   draw below shares them, so the encode cache's key costs one
            #   top-level hash per variant and the sparse pack-sizing pass
            #   (bucket_for's edge counts) reuses one edge list
            n_cfg = len(rec.tiles)
            take = min(self.configs_per_kernel, n_cfg)
            idx = rng.choice(n_cfg, take, replace=False)
            for j in idx:
                graphs.append(rec.kernel.with_tile(rec.tiles[int(j)]))
                targets.append(float(rec.runtimes[int(j)]))
                groups.append(ki)
                valid.append(1.0)
            if take < self.configs_per_kernel:                # pad group
                # one shared graph object for every pad slot (valid=0.0):
                # it is encoded once, not re-encoded per slot
                pad_graph = rec.kernel.with_tile(rec.tiles[0])
                for _ in range(self.configs_per_kernel - take):
                    graphs.append(pad_graph)
                    targets.append(float(rec.runtimes[0]))
                    groups.append(ki)
                    valid.append(0.0)
        return (graphs, np.asarray(targets, np.float32),
                np.asarray(groups, np.int32), np.asarray(valid, np.float32))

    def encode_draw(self, draw: tuple, *, spec=None) -> TileBatch:
        graphs, targets, groups, valid = draw
        gb = _encode(graphs, self.adjacency, self.max_nodes, self.normalizer,
                     spec=spec)
        return TileBatch(gb, targets, groups, valid)


class BalancedSampler(_ShardedSampler):
    """Fusion-task sampler: batch of kernels balanced across programs."""

    _what = "fusion"

    def __init__(self, records, normalizer: FeatureNormalizer, *,
                 batch_size: int = 64, max_nodes: int = 64, seed: int = 0,
                 host_id: int = 0, num_hosts: int = 1,
                 adjacency: str = "dense"):
        self.normalizer = normalizer
        self.batch_size = batch_size
        self.max_nodes = max_nodes
        self.adjacency = adjacency
        self._init_shard(records, seed=seed, host_id=host_id,
                         num_hosts=num_hosts, what=self._what)

    def draw(self, step: int) -> tuple:
        """The step's raw draw: (graphs, targets, valid) before encoding."""
        rng = self._rng(step)
        graphs, targets = [], []
        for _ in range(self.batch_size):
            prog = self._programs[int(rng.integers(len(self._programs)))]
            rec = self.records[int(rng.choice(self._by_program[prog]))]
            graphs.append(rec.kernel)
            targets.append(rec.runtime)
        return (graphs, np.asarray(targets, np.float32),
                np.ones((len(graphs),), np.float32))

    def encode_draw(self, draw: tuple, *, spec=None) -> FusionBatch:
        graphs, targets, valid = draw
        gb = _encode(graphs, self.adjacency, self.max_nodes, self.normalizer,
                     spec=spec)
        return FusionBatch(gb, targets, valid)


class GlobalBatchSampler:
    """Stacks the per-shard sub-batches of `dp` sampler views into ONE
    global batch with a leading device axis — the input contract of the
    mesh train step (DESIGN.md §13).

    Every field of the delivered batch has shape ``[dp, ...]``; the mesh
    step shards that leading axis over the data mesh axis, so device d
    trains on shard-d's sub-batch. For ``adjacency='sparse'`` the dp draws
    are encoded against ONE shared `BucketSpec` (the per-field max of the
    shards' pow2 buckets), so a single compiled executable serves all
    devices; graph capacity is identical across shards by construction
    (fixed per-step draw counts).

    `batch(step)` stays a pure function of (seed, step, shard ids), so the
    wrapper composes with `repro.data.prefetch.Prefetcher` unchanged and a
    1-shard global stream is the base sampler's stream with a length-1
    leading axis — nothing else differs, which is what the dp=1
    bit-parity gate in benchmarks/bench_scaling.py checks end to end.
    """

    def __init__(self, samplers):
        if not samplers:
            raise ValueError("GlobalBatchSampler needs >= 1 sampler")
        kinds = {type(s) for s in samplers}
        if len(kinds) > 1:
            raise ValueError(f"mixed sampler types {kinds}")
        adjs = {s.adjacency for s in samplers}
        if len(adjs) > 1:
            raise ValueError(f"mixed adjacencies {adjs}")
        if samplers[0].adjacency == "segmented":
            raise ValueError("segmented batches are not mesh-shardable "
                             "(no uniform leading axis) — use adjacency="
                             "'dense' or 'sparse' for data-parallel "
                             "training")
        self.samplers = list(samplers)
        self.adjacency = samplers[0].adjacency

    @classmethod
    def for_mesh(cls, sampler, dp: int) -> "GlobalBatchSampler":
        """dp per-device views of `sampler`: its own host shard is
        subdivided dp ways (host h of H, device d → global worker
        ``h·dp + d`` of ``H·dp``), so multi-host × multi-device layouts
        compose and every record still belongs to exactly one worker."""
        return cls([sampler.with_host(sampler.host_id * dp + d,
                                      sampler.num_hosts * dp)
                    for d in range(dp)])

    @property
    def num_shards(self) -> int:
        return len(self.samplers)

    @property
    def batch_size(self) -> int:       # per-device sub-batch size
        return self.samplers[0].batch_size

    @staticmethod
    def _shared_spec(draws):
        specs = [sparse_draw_spec(d[0]) for d in draws]
        return batching.BucketSpec(
            node_capacity=max(s.node_capacity for s in specs),
            edge_capacity=max(s.edge_capacity for s in specs),
            graph_capacity=max(s.graph_capacity for s in specs),
            reduce_capacity=max(s.reduce_capacity for s in specs))

    def batch(self, step: int):
        draws = [s.draw(step) for s in self.samplers]
        spec = None
        if self.adjacency == "sparse":
            spec = self._shared_spec(draws)
        parts = [s.encode_draw(d, spec=spec)
                 for s, d in zip(self.samplers, draws)]
        return _stack_batches(parts)

    def shard(self, step: int, d: int):
        """``batch(step)`` at index `d` of its leading axis, encoding only
        shard d (a sparse shard still takes every shard's draw, for the
        shared `BucketSpec`): what the rank of data index d trains on in
        the port's data-parallel step."""
        if self.adjacency != "sparse":
            return self.samplers[d].encode_draw(self.samplers[d].draw(step))
        draws = [s.draw(step) for s in self.samplers]
        return self.samplers[d].encode_draw(draws[d],
                                            spec=self._shared_spec(draws))


def _stack_batches(parts):
    """Stack equally-shaped sub-batches leaf-wise into a [dp, ...] batch.
    Works on the batch dataclasses directly (numpy, no jax import) so the
    Prefetcher worker thread can run it too."""
    b0 = parts[0]
    kw = {}
    for f in dataclasses.fields(b0):
        vals = [getattr(p, f.name) for p in parts]
        if dataclasses.is_dataclass(vals[0]):        # the graphs pytree
            g0 = vals[0]
            kw[f.name] = type(g0)(**{
                gf.name: np.stack([np.asarray(getattr(v, gf.name))
                                   for v in vals])
                for gf in dataclasses.fields(g0)})
        else:
            kw[f.name] = np.stack([np.asarray(v) for v in vals])
    return type(b0)(**kw)


class ShardPlanner:
    """Deterministic shard→host assignment with straggler takeover.

    Each step has `num_hosts` shards. Healthy path: shard i → host i. When
    hosts are flagged slow, their shards are deterministically reassigned to
    the healthy host with the fewest shards (ties broken by host id), so all
    data is still consumed exactly once per step.
    """

    def __init__(self, num_hosts: int):
        self.num_hosts = num_hosts

    def plan(self, step: int, slow_hosts: frozenset[int] = frozenset()
             ) -> dict[int, list[int]]:
        healthy = [h for h in range(self.num_hosts) if h not in slow_hosts]
        if not healthy:
            raise RuntimeError("no healthy hosts")
        assign: dict[int, list[int]] = {h: [] for h in healthy}
        for shard in range(self.num_hosts):
            if shard in slow_hosts:
                tgt = min(healthy, key=lambda h: (len(assign[h]), h))
            else:
                tgt = shard
            assign[tgt].append(shard)
        return assign

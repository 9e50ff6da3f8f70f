"""MeasurementLog: the measure→store tap of the data flywheel.

Every measurement a `HardwareEstimator` charges to the `BudgetMeter` is
a labeled training example the run already paid hardware seconds for.
`MeasurementLog` collects those (kernel, runtime) pairs — grouping tile
variants of the same kernel into one `TileKernelRecord` sweep so the
pairwise rank loss has within-kernel contrast — and `flush_to` appends
them to a corpus store as a chain-verified delta shard
(`CorpusWriter.append_delta`). A copy of `repro.flywheel.log` with its
imports rewritten.

>>> from repro_torch.core.simulator import TPUSimulator
>>> from repro_torch.data.synthetic import random_kernel
>>> from repro_torch.flywheel import MeasurementLog
>>> from repro_torch.search import HardwareEstimator
>>> log = MeasurementLog("tile")
>>> hw = HardwareEstimator(TPUSimulator(), log=log)
>>> g = random_kernel(8, seed=0)
>>> _ = hw.estimate([g.with_tile((8, 8)), g.with_tile((16, 8))])
>>> _ = hw.estimate([g.with_tile((8, 8))])      # repeat: deduplicated
>>> (len(log), log.duplicates, len(log.records()))
(2, 1, 1)
>>> log.records()[0].tiles
[(8, 8), (16, 8)]
>>> len(log.take_pending())                     # flush 1: the sweep
1
>>> _ = hw.estimate([g.with_tile((4, 4))])      # sweep grows...
>>> [r.tiles for r in log.take_pending()]       # flush 2: re-emitted whole
[[(8, 8), (16, 8), (4, 4)]]
>>> log.take_pending()                          # nothing new -> nothing
[]
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np

from repro_torch.core.graph import KernelGraph
from repro_torch.data.fusion_dataset import FusionKernelRecord
from repro_torch.data.store import KINDS, CorpusWriter
from repro_torch.data.tile_dataset import TileKernelRecord


class MeasurementLog:
    """Accumulates charged (kernel, runtime) measurements into dataset
    records, deduplicating repeats of the same (kernel, tile).

    Tile kind: measurements are grouped by the kernel's order-sensitive
    `structural_digest` — every tile variant of one kernel lands in the
    same group, so one flushed `TileKernelRecord` carries a multi-config
    sweep (the within-kernel contrast the rank loss trains on). Fusion
    kind: one `FusionKernelRecord` per distinct kernel (first runtime
    wins, matching the store's first-occurrence dedup).

    Flushing does NOT reset the groups: a flush emits the *cumulative*
    sweep of every group that gained measurements since the last flush,
    and later flushes re-emit a group's full sweep once it grows again.
    A search loop that measures one tile per kernel per round therefore
    still produces multi-config records from round 1 on — per-round
    incremental records would be 1-config sweeps the pairwise rank loss
    is blind to, and the fine-tune stage would never actually learn the
    kernels being tuned.
    """

    def __init__(self, kind: str = "tile"):
        if kind not in KINDS:
            raise ValueError(f"unknown corpus kind {kind!r}")
        self.kind = kind
        # digest -> {"kernel": base, "program": str,
        #            "tiles": [...], "runtimes": [...], "seen": set,
        #            "flushed": int}  (tiles already emitted by a flush;
        #            fusion groups use a bool)
        self._groups: OrderedDict = OrderedDict()
        self.total = 0        # record() calls observed
        self.duplicates = 0   # repeats of an already-logged (kernel, tile)

    def record(self, kernel: KernelGraph, runtime: float) -> bool:
        """Log one measured (kernel, runtime); False if already logged."""
        self.total += 1
        if self.kind == "fusion":
            key = kernel.canonical_hash(order_sensitive=True)
            if key in self._groups:
                self.duplicates += 1
                return False
            self._groups[key] = {"kernel": kernel,
                                 "runtime": float(runtime),
                                 "flushed": False}
            return True
        key = kernel.structural_digest(order_sensitive=True)
        tile = tuple(int(x) for x in kernel.tile_size)
        g = self._groups.get(key)
        if g is None:
            base = kernel.with_tile(()) if kernel.tile_size else kernel
            g = self._groups[key] = {"kernel": base,
                                     "program": kernel.program,
                                     "tiles": [], "runtimes": [],
                                     "seen": set(), "flushed": 0}
        if tile in g["seen"]:
            self.duplicates += 1
            return False
        g["seen"].add(tile)
        g["tiles"].append(tile)
        g["runtimes"].append(float(runtime))
        return True

    def __len__(self) -> int:
        """Distinct measurements retained (post-dedup)."""
        if self.kind == "fusion":
            return len(self._groups)
        return sum(len(g["tiles"]) for g in self._groups.values())

    def _materialize(self, groups) -> list:
        if self.kind == "fusion":
            return [FusionKernelRecord(g["kernel"], g["runtime"],
                                       program=g["kernel"].program)
                    for g in groups]
        return [TileKernelRecord(kernel=g["kernel"], tiles=list(g["tiles"]),
                                 runtimes=np.asarray(g["runtimes"],
                                                     np.float64),
                                 program=g["program"])
                for g in groups]

    def records(self, *, min_configs: int = 1) -> list:
        """Materialize ALL grouped measurements as dataset records.
        Tile groups with fewer than `min_configs` measured tiles are
        dropped (a 1-config sweep contributes no rank-loss signal)."""
        if self.kind == "fusion":
            return self._materialize(self._groups.values())
        return self._materialize(g for g in self._groups.values()
                                 if len(g["tiles"]) >= min_configs)

    def take_pending(self, *, min_configs: int = 1) -> list:
        """Records for every group that changed since the last take:
        the group's full *cumulative* sweep (see class docstring), with
        tile groups below `min_configs` held back — unmarked — until
        they grow past it. Marks what it returns as flushed."""
        if self.kind == "fusion":
            pend = [g for g in self._groups.values() if not g["flushed"]]
            for g in pend:
                g["flushed"] = True
            return self._materialize(pend)
        pend = [g for g in self._groups.values()
                if len(g["tiles"]) > g["flushed"]
                and len(g["tiles"]) >= min_configs]
        recs = self._materialize(pend)
        for g in pend:
            g["flushed"] = len(g["tiles"])
        return recs

    def clear(self) -> None:
        self._groups.clear()

    def flush_to(self, store_dir: str, *, min_configs: int = 1,
                 note: str = "") -> dict | None:
        """Append everything new since the last flush to `store_dir` as
        one delta shard (`CorpusWriter.append_delta` of `take_pending`).
        Groups stay live — a kernel measured again later flushes again,
        as a fresh record of its grown sweep. Returns the delta
        manifest, or None if nothing new to append."""
        recs = self.take_pending(min_configs=min_configs)
        return (CorpusWriter.append_delta(store_dir, recs, note=note)
                if recs else None)

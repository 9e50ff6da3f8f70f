"""Fusion dataset (paper §4, 'Fusion Dataset').

For each program, run random-search fusion configuration generation (the
paper's data-collection strategy), decompose into kernels, measure each with
the hardware oracle, and de-duplicate structurally identical kernels.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.graph import KernelGraph
from repro_torch.core.simulator import TPUSimulator
from repro_torch.data.corpus import kernel_hash
from repro_torch.data.fusion import apply_fusion, default_fusion, random_fusion


@dataclass
class FusionKernelRecord:
    kernel: KernelGraph
    runtime: float                     # seconds, min of 3 runs
    program: str = ""


@dataclass
class FusionDataset:
    records: list[FusionKernelRecord] = field(default_factory=list)

    @property
    def num_samples(self) -> int:
        return len(self.records)

    def programs(self) -> list[str]:
        return sorted({r.program for r in self.records})

    def by_program(self) -> dict[str, list[FusionKernelRecord]]:
        out: dict[str, list[FusionKernelRecord]] = {}
        for r in self.records:
            out.setdefault(r.program, []).append(r)
        return out


def build_fusion_records(program: KernelGraph, sim: TPUSimulator,
                         *, configs_per_program: int = 24,
                         max_kernel_nodes: int = 64,
                         seed: int = 0) -> list[FusionKernelRecord]:
    """Partition-invariant record builder for the corpus store.

    `build_fusion_dataset` threads one rng and one dedup set through the
    whole program list, coupling every program's records to the ones
    before it. Here the rng is seeded from (seed, program name) and dedup
    is within-program only — `repro.launch.build_corpus` fans programs
    across workers and the corpus writer dedups across programs by
    content hash at merge time, so the result is independent of how the
    corpus was partitioned.
    """
    rng = np.random.default_rng(np.random.SeedSequence(
        [seed, zlib.crc32(program.program.encode()) % (2 ** 31)]))
    decisions = [default_fusion(program)]
    for _ in range(configs_per_program - 1):
        decisions.append(random_fusion(program, rng))
    records, seen = [], set()
    for dec in decisions:
        for k in apply_fusion(program, dec):
            if k.num_nodes > max_kernel_nodes:
                continue
            h = kernel_hash(k)
            if h in seen:
                continue
            seen.add(h)
            records.append(FusionKernelRecord(
                kernel=k, runtime=sim.measure(k), program=program.program))
    return records


def build_fusion_dataset(programs: list[KernelGraph], sim: TPUSimulator,
                         *, configs_per_program: int = 24,
                         max_kernel_nodes: int = 64,
                         seed: int = 0) -> FusionDataset:
    ds = FusionDataset()
    seen: set[str] = set()
    rng = np.random.default_rng(seed)
    for prog in programs:
        decisions = [default_fusion(prog)]
        for _ in range(configs_per_program - 1):
            decisions.append(random_fusion(prog, rng))
        for dec in decisions:
            for k in apply_fusion(prog, dec):
                if k.num_nodes > max_kernel_nodes:
                    continue
                h = kernel_hash(k)
                if h in seen:
                    continue
                seen.add(h)
                ds.records.append(FusionKernelRecord(
                    kernel=k, runtime=sim.measure(k), program=prog.program))
    return ds

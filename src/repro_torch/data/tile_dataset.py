"""Tile-size dataset (paper §4, 'Tile-Size Dataset').

For each kernel of each program (fused with the compiler-default heuristic),
enumerate valid tile sizes (per-dim powers of two within the root output
shape, filtered by VMEM fit) and measure each with the hardware oracle
(min of 3 runs). Samples are grouped per kernel — the rank loss only
compares within a group.
"""
from __future__ import annotations

import itertools
import zlib
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.graph import KernelGraph
from repro_torch.core.simulator import HardwareSpec, TPUSimulator, V5E, tile_fits_vmem
from repro_torch.data.fusion import apply_fusion, default_fusion


def _dim_options(d: int) -> list[int]:
    opts = []
    t = 1
    while t < d:
        opts.append(t)
        t *= 2
    opts.append(int(d))
    # mimic XLA: prefer the last-dim options aligned to the vector lane width
    return opts


def enumerate_tiles(g: KernelGraph, max_configs: int = 128,
                    hw: HardwareSpec = V5E,
                    seed: int = 0) -> list[tuple[int, ...]]:
    """All valid tiles for the kernel's root output, subsampled
    deterministically if the cross-product explodes (paper: up to 500k
    options, measured as many as possible within a budget)."""
    shape = g.root.shape if g.root.shape else (1,)
    per_dim = [_dim_options(int(d)) for d in shape]
    total = int(np.prod([len(o) for o in per_dim]))
    combos: list[tuple[int, ...]]
    if total <= max_configs * 4:
        combos = list(itertools.product(*per_dim))
    else:
        rng = np.random.default_rng(seed)
        combos_set = set()
        # always include the extremes
        combos_set.add(tuple(o[-1] for o in per_dim))
        combos_set.add(tuple(o[0] for o in per_dim))
        tries = 0
        while len(combos_set) < max_configs * 2 and tries < max_configs * 20:
            combos_set.add(tuple(int(rng.choice(o)) for o in per_dim))
            tries += 1
        combos = sorted(combos_set)
    valid = [t for t in combos if tile_fits_vmem(g, t, hw)]
    if len(valid) > max_configs:
        rng = np.random.default_rng(seed + 1)
        idx = rng.choice(len(valid), max_configs, replace=False)
        valid = [valid[i] for i in sorted(idx)]
    return valid


@dataclass
class TileKernelRecord:
    """One kernel with its measured tile-size sweep."""
    kernel: KernelGraph
    tiles: list[tuple[int, ...]]
    runtimes: np.ndarray               # [num_tiles] seconds (min of 3 runs)
    program: str = ""
    kernel_id: int = -1


@dataclass
class TileDataset:
    records: list[TileKernelRecord] = field(default_factory=list)

    @property
    def num_samples(self) -> int:
        return sum(len(r.tiles) for r in self.records)

    def programs(self) -> list[str]:
        return sorted({r.program for r in self.records})

    def by_program(self) -> dict[str, list[TileKernelRecord]]:
        out: dict[str, list[TileKernelRecord]] = {}
        for r in self.records:
            out.setdefault(r.program, []).append(r)
        return out


def fit_tile_normalizer(records: list["TileKernelRecord"]):
    """Fit the feature normalizer over kernels *with representative tiles*.

    The tile sub-vector is a kernel feature: min/max statistics must span
    the actual tile range or every tile encodes to the same clipped value
    (and the model cannot rank). Samples the smallest / median / largest
    tile of every kernel.
    """
    from repro_torch.core.features import fit_normalizer
    graphs = []
    for r in records:
        picks = {0, len(r.tiles) // 2, len(r.tiles) - 1}
        for i in picks:
            graphs.append(r.kernel.with_tile(r.tiles[i]))
    return fit_normalizer(graphs)


def build_tile_records(kernels: list[KernelGraph], sim: TPUSimulator,
                       *, max_configs_per_kernel: int = 48,
                       max_kernel_nodes: int = 64, min_configs: int = 2,
                       seed: int = 0) -> list[TileKernelRecord]:
    """Partition-invariant record builder for the corpus store.

    `build_tile_dataset` seeds each kernel's tile enumeration with a
    running record counter, which couples every record to all kernels
    before it — fine in one process, wrong when
    `repro.launch.build_corpus` splits the corpus across workers. Here
    the enumeration seed derives from (seed, kernel content hash), so any
    partitioning of `kernels` yields the same records, and the store's
    manifest hash is a pure function of the build spec.
    """
    records = []
    for k in kernels:
        if k.num_nodes > max_kernel_nodes:
            continue
        kseed = zlib.crc32(
            f"{seed}:{k.canonical_hash(order_sensitive=True)}".encode())
        tiles = enumerate_tiles(k, max_configs_per_kernel, sim.hw,
                                seed=int(kseed % (2 ** 31)))
        if len(tiles) < min_configs:
            continue
        runtimes = np.array([sim.measure(k.with_tile(t)) for t in tiles])
        records.append(TileKernelRecord(
            kernel=k, tiles=tiles, runtimes=runtimes, program=k.program))
    return records


def build_tile_dataset(programs: list[KernelGraph], sim: TPUSimulator,
                       *, max_configs_per_kernel: int = 48,
                       max_kernel_nodes: int = 64,
                       min_configs: int = 2,
                       extra_kernels: list[KernelGraph] | None = None,
                       ) -> TileDataset:
    """Fuse each program with the default heuristic, enumerate + measure."""
    ds = TileDataset()
    kid = 0
    all_kernels: list[KernelGraph] = []
    for prog in programs:
        all_kernels.extend(apply_fusion(prog, default_fusion(prog)))
    if extra_kernels:
        all_kernels.extend(extra_kernels)
    for k in all_kernels:
        if k.num_nodes > max_kernel_nodes:
            continue
        tiles = enumerate_tiles(k, max_configs_per_kernel, sim.hw, seed=kid)
        if len(tiles) < min_configs:
            continue
        runtimes = np.array([sim.measure(k.with_tile(t)) for t in tiles])
        ds.records.append(TileKernelRecord(
            kernel=k, tiles=tiles, runtimes=runtimes,
            program=k.program, kernel_id=kid))
        kid += 1
    return ds

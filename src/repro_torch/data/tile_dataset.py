"""Tile-size candidates (paper §4, 'Tile-Size Dataset').

`enumerate_tiles` lists the valid tile sizes of a kernel (per-dim powers
of two within the root output shape, filtered by VMEM fit) — what the
tile-search replay scores. The measured tile dataset built on it
(`repro.data.tile_dataset`) belongs to training and is not ported yet.
"""
from __future__ import annotations

import itertools

import numpy as np

from repro_torch.core.graph import KernelGraph
from repro_torch.core.simulator import HardwareSpec, V5E, tile_fits_vmem


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

"""Tile-search query-stream replay (docs/SERVING.md §worked-example).

The service's target workload is an autotuner hammering the model with
small, highly redundant kernel graphs. This module reconstructs that
traffic deterministically so the replay CLI
(`python -m repro_torch.launch.serve_costmodel`) and the gating benchmark
(`benchmarks/bench_serving.py`) share one corpus: several search rounds
per kernel, each round scoring an overlapping random subset of the
kernel's tile candidates — exactly the revisit pattern of top-k
re-ranking and annealing.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core import features as F
from repro_torch.core.features import FeatureNormalizer
from repro_torch.core.graph import KernelGraph
from repro_torch.data.fusion import apply_fusion, default_fusion
from repro_torch.data.synthetic import generate_corpus
from repro_torch.data.tile_dataset import enumerate_tiles


@dataclass
class TileReplay:
    """A deterministic query stream: `requests[i]` is one scoring call
    (a list of (kernel, tile) graphs, i.e. what a tile scorer submits)."""
    requests: list[list[KernelGraph]]
    normalizer: FeatureNormalizer
    num_kernels: int

    @property
    def num_queries(self) -> int:
        return sum(len(r) for r in self.requests)

    @property
    def num_unique(self) -> int:
        return len({g.canonical_hash() for r in self.requests for g in r})


def build_tile_replay(num_programs: int = 8, *, max_configs: int = 16,
                      rounds: int = 4, subset: float = 0.75,
                      seed: int = 0) -> TileReplay:
    """Build the replay stream.

    `rounds` search passes visit every kernel; each pass scores a random
    `subset` fraction of that kernel's tile candidates, so each unique
    (kernel, tile) graph is queried ~`rounds * subset` times — the cache
    hit rate of a replay approaches `1 - 1/(rounds * subset)`. Kernel
    order is shuffled per round to interleave traffic across kernels.
    """
    rng = np.random.default_rng(seed)
    kernels: list[KernelGraph] = []
    for prog in generate_corpus(num_programs, seed=seed):
        kernels.extend(apply_fusion(prog, default_fusion(prog)))
    tiles_by_kernel = []
    for k in kernels:
        tiles = enumerate_tiles(k, max_configs)
        if len(tiles) >= 2:
            k.structural_digest()      # memoize; all tile variants share it
            tiles_by_kernel.append((k, tiles))
    if not tiles_by_kernel:
        raise ValueError("corpus produced no tunable kernels")

    # normalizer statistics from the per-kernel tile extremes (the first /
    # last enumerated combos are the all-min / all-max tiles) — clipping
    # absorbs the interior
    fit_graphs = [k.with_tile(t)
                  for k, tiles in tiles_by_kernel
                  for t in (tiles[0], tiles[-1])]
    normalizer = F.fit_normalizer(fit_graphs)

    requests: list[list[KernelGraph]] = []
    for _ in range(rounds):
        for ki in rng.permutation(len(tiles_by_kernel)):
            k, tiles = tiles_by_kernel[int(ki)]
            n = max(int(round(subset * len(tiles))), 1)
            chosen = rng.choice(len(tiles), size=n, replace=False)
            requests.append([k.with_tile(tiles[int(t)]) for t in chosen])
    return TileReplay(requests, normalizer, len(tiles_by_kernel))


def run_replay(score_request, requests) -> tuple[list[np.ndarray], float]:
    """Feed every request through `score_request(graphs) -> scores`;
    returns (per-request predictions, elapsed seconds)."""
    import time
    preds = []
    t0 = time.perf_counter()
    for req in requests:
        preds.append(np.asarray(score_request(req)))
    return preds, time.perf_counter() - t0

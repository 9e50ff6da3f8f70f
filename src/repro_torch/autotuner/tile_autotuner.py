"""Tile-size autotuner (paper §7.1/§7.2) — a thin wrapper over the
budgeted search engine (`repro_torch.search`, DESIGN.md §10).

Modes:
  * 'exhaustive' — measure every valid tile on hardware (the baseline
    autotuner; expensive). Each tile is measured exactly once and the
    measurements double as the regret oracle.
  * model top-k  — rank candidates with a cost model (learned, analytical
    or a cascade), measure only the top-k on hardware, keep the best.
    k=1 == direct compiler integration (no hardware in the loop).

Rankings come either from a legacy `scorer(kernel, tiles)` callable or —
preferably — a `repro_torch.search.CostEstimator`: with an estimator,
`autotune_program_tiles` scores ALL kernels' candidates of a program in
one coalesced service flush, and an optional `BudgetMeter` caps the
hardware verification across the whole program.

Counterpart of `repro.autotuner.tile_autotuner`; `model_scorer` takes
the port's `CostModel` (or `QuantizedCostModel`) and scores on its
device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.graph import KernelGraph
from repro_torch.core.simulator import TPUSimulator
from repro_torch.data.tile_dataset import enumerate_tiles
from repro_torch.search import BudgetMeter, CostEstimator, topk_rerank

Scorer = Callable[[KernelGraph, Sequence[tuple[int, ...]]], np.ndarray]


def model_scorer(model, model_cfg, normalizer, *, max_nodes: int = 64,
                 chunk: int = 128, node_budget: int | None = None,
                 service=None, cache_capacity: int = 65536) -> Scorer:
    """Learned-model scorer for `tune_kernel_tiles`, scoring through the
    prediction service (`repro_torch.serving.CostModelService`): tile
    candidates of one kernel are near-duplicate graphs, so across tuning
    passes the content-addressed cache absorbs most queries, and misses
    flush through the bucketed batcher in `model_cfg.adjacency` representation ('sparse'
    packs candidates into flat bucketed batches — markedly higher scoring
    throughput on big candidate sets — while 'dense' keeps the padded
    [B, N, N] layout). Pass `service` to share one cache across scorers."""
    from repro_torch.core.evaluate import learned_tile_scorer
    return learned_tile_scorer(model, model_cfg, normalizer,
                               max_nodes=max_nodes, chunk=chunk,
                               node_budget=node_budget, service=service,
                               cache_capacity=cache_capacity)


@dataclass
class TileTuneResult:
    kernel_name: str
    chosen_tile: tuple[int, ...]
    chosen_runtime: float            # measured on hardware (NaN: model-only)
    best_runtime: float              # exhaustive-best (if known)
    hardware_evals: int
    candidates: int

    @property
    def regret(self) -> float:
        """Relative slowdown of the chosen tile vs the exhaustive best.

        >>> r = TileTuneResult("k", (8,), chosen_runtime=1.2,
        ...                    best_runtime=1.0, hardware_evals=3,
        ...                    candidates=10)
        >>> round(r.regret, 6)
        0.2
        """
        if self.best_runtime <= 0:
            return 0.0
        return self.chosen_runtime / self.best_runtime - 1.0


def _measure_all(kernel: KernelGraph, sim: TPUSimulator,
                 tiles: Sequence[tuple[int, ...]]) -> list[float]:
    """One hardware pass over every tile — the regret oracle. Measured
    once and reused (the old exhaustive mode measured everything twice)."""
    return [sim.measure(kernel.with_tile(t)) for t in tiles]


def _tune_group(kernel: KernelGraph, sim: TPUSimulator,
                tiles: list[tuple[int, ...]], scores: np.ndarray, *,
                top_k: int, exhaustive_truth: bool,
                meter: BudgetMeter | None) -> TileTuneResult:
    """Shared top-k verification for one kernel, with the oracle pass (if
    requested) reused for the top-k measurements (the simulator's
    measurements are deterministic per (kernel, tile))."""
    oracle = _measure_all(kernel, sim, tiles) if exhaustive_truth else None
    candidates = [kernel.with_tile(t) for t in tiles]
    by_id = {} if oracle is None else \
        {id(g): rt for g, rt in zip(candidates, oracle)}

    def measure(g: KernelGraph) -> float:
        rt = by_id.get(id(g))
        return sim.measure(g) if rt is None else rt

    choice, = topk_rerank([candidates], scores=[np.asarray(scores)],
                          measure=measure, top_k=top_k, meter=meter)
    true_best = min(oracle) if oracle is not None else choice.chosen_runtime
    return TileTuneResult(kernel.name, tiles[choice.chosen],
                          choice.chosen_runtime, true_best,
                          hardware_evals=choice.hardware_evals,
                          candidates=len(tiles))


def tune_kernel_tiles(kernel: KernelGraph, sim: TPUSimulator, *,
                      scorer: Scorer | None = None, top_k: int = 10,
                      max_configs: int = 128,
                      tiles: Sequence[tuple[int, ...]] | None = None,
                      exhaustive_truth: bool = True,
                      estimator: CostEstimator | None = None,
                      meter: BudgetMeter | None = None) -> TileTuneResult:
    """Tune one kernel. scorer=None and estimator=None => exhaustive
    hardware search. `meter` (model-ranked modes) caps hardware
    verification; the oracle pass (`exhaustive_truth`) is evaluation
    harness, not tuning, and is never charged."""
    if scorer is not None and estimator is not None:
        raise ValueError("pass scorer or estimator, not both")
    if tiles is None:
        tiles = enumerate_tiles(kernel, max_configs, sim.hw)
    tiles = list(tiles)
    if not tiles:
        raise ValueError(f"no valid tiles for kernel {kernel.name}")

    if scorer is None and estimator is None:     # exhaustive autotuner
        runtimes = _measure_all(kernel, sim, tiles)
        i = int(np.argmin(runtimes))
        return TileTuneResult(kernel.name, tiles[i], float(runtimes[i]),
                              min(runtimes) if exhaustive_truth
                              else float(runtimes[i]),
                              hardware_evals=len(tiles),
                              candidates=len(tiles))

    if estimator is not None:
        kernel.structural_digest()   # memoize once; tile variants share
        scores = estimator.estimate([kernel.with_tile(t) for t in tiles])
    else:
        scores = np.asarray(scorer(kernel, tiles))
    return _tune_group(kernel, sim, tiles, scores, top_k=top_k,
                       exhaustive_truth=exhaustive_truth, meter=meter)


@dataclass
class ProgramTuneResult:
    results: list[TileTuneResult] = field(default_factory=list)

    @property
    def total_runtime(self) -> float:
        """Sum of chosen runtimes. Deliberately NaN when any kernel went
        unverified (a budget-exhausted `meter` run) — check `unverified`
        / use `measured_runtime` before comparing against thresholds."""
        return sum(r.chosen_runtime for r in self.results)

    @property
    def unverified(self) -> int:
        """Kernels whose top-k verification got no hardware budget."""
        return sum(1 for r in self.results if r.hardware_evals == 0)

    @property
    def measured_runtime(self) -> float:
        """Total over the hardware-verified kernels only."""
        return sum(r.chosen_runtime for r in self.results
                   if r.hardware_evals > 0)

    @property
    def best_runtime(self) -> float:
        return sum(r.best_runtime for r in self.results)

    @property
    def hardware_evals(self) -> int:
        return sum(r.hardware_evals for r in self.results)

    def speedup_over(self, other_total: float) -> float:
        return other_total / max(self.total_runtime, 1e-30)


def autotune_program_tiles(kernels: Sequence[KernelGraph],
                           sim: TPUSimulator, *,
                           scorer: Scorer | None = None,
                           top_k: int = 10, max_configs: int = 128,
                           estimator: CostEstimator | None = None,
                           meter: BudgetMeter | None = None,
                           exhaustive_truth: bool = True
                           ) -> ProgramTuneResult:
    """Tune every kernel of a program.

    With an `estimator`, all kernels' tile candidates are scored in ONE
    batched call (one coalesced service flush for a `LearnedEstimator` /
    per-stage flushes for a cascade) before any hardware is touched; a
    shared `meter` then budgets the top-k verification across the whole
    program. The legacy `scorer` path ranks kernel-by-kernel."""
    if scorer is not None and estimator is not None:
        raise ValueError("pass scorer or estimator, not both")
    out = ProgramTuneResult()
    if estimator is None:
        for k in kernels:
            out.results.append(
                tune_kernel_tiles(k, sim, scorer=scorer, top_k=top_k,
                                  max_configs=max_configs, meter=meter,
                                  exhaustive_truth=exhaustive_truth))
        return out

    tiles_per_kernel: list[list[tuple[int, ...]]] = []
    groups: list[list[KernelGraph]] = []
    for k in kernels:
        tiles = list(enumerate_tiles(k, max_configs, sim.hw))
        if not tiles:
            raise ValueError(f"no valid tiles for kernel {k.name}")
        k.structural_digest()        # memoize once; tile variants share
        tiles_per_kernel.append(tiles)
        groups.append([k.with_tile(t) for t in tiles])
    scores = estimator.estimate_groups(groups)   # ONE coalesced flush
    for k, tiles, s in zip(kernels, tiles_per_kernel, scores):
        out.results.append(
            _tune_group(k, sim, tiles, s, top_k=top_k,
                        exhaustive_truth=exhaustive_truth, meter=meter))
    return out

"""Fusion autotuner: simulated annealing with a hardware-minutes budget
(paper §7.3) — a thin wrapper over the budgeted search engine
(`repro_torch.search`, DESIGN.md §10).

Two operating modes, mirroring Fig. 5:
  * 'HW m'            — anneal directly against hardware measurements for an
    m-minute hardware budget.
  * 'Cost model + HW' — anneal against the learned model (cheap, CPU), then
    re-rank the most promising configs on hardware within a (much smaller)
    hardware budget.

Hardware time is *simulated* wall-clock: each hardware evaluation of a
config charges its compile+run cost to a `BudgetMeter` (`eval_seconds`
per eval) **as it happens**, inside the annealing loop — the search stops
when the next eval no longer fits, so `hardware_seconds_used` can never
overshoot `hardware_budget_s`.

`population > 1` proposes that many flips per temperature step and scores
them in ONE batched flush through the estimator (`CostEstimator
.program_costs` → one coalesced service call) instead of one-by-one —
the model-scoring-throughput win gated by benchmarks/bench_autotune.py.
`population=1` reproduces the classic sequential annealer bit-exactly.

Counterpart of `repro.autotuner.fusion_autotuner`; `model_cost_fn` takes
the port's `CostModel` (or `QuantizedCostModel`) and scores on its
device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.graph import KernelGraph
from repro_torch.core.simulator import TPUSimulator
from repro_torch.data.fusion import (
    FusionDecision,
    FusionMaterializer,
    default_fusion,
    fusable_edges,
    random_fusion,
)
from repro_torch.search import BudgetMeter, CostEstimator, HardwareEstimator, \
    anneal

CostFn = Callable[[Sequence[KernelGraph]], float]


def model_cost_fn(model, model_cfg, normalizer, *, max_nodes: int = 64,
                  chunk: int = 128, node_budget: int | None = None,
                  predict_fn=None, service=None,
                  cache_capacity: int = 65536) -> CostFn:
    """Program cost under the learned model: Σ exp(predicted log-runtime).

    Built on `search.LearnedEstimator.from_params` — the one home of the
    service-construction kwargs. Scores through the prediction service:
    neighboring annealing steps share most of their kernels, so the
    content-addressed cache turns the per-step cost into scoring only the
    few kernels the last flip changed. (To also batch across a
    `population`, pass the estimator itself via
    `simulated_annealing_fusion(..., estimator=...)` instead.)

    Representation follows `model_cfg.adjacency`. The dense path must drop
    kernels above `max_nodes` (its padded slots truncate them anyway); the
    sparse path scores every kernel — packed candidate batches have no
    per-graph cap, which also removes a systematic bias of the dense
    annealer objective on large fusion groups.
    """
    from repro_torch.search import LearnedEstimator
    est = LearnedEstimator.from_params(model, model_cfg, normalizer,
                                       max_nodes=max_nodes, chunk=chunk,
                                       node_budget=node_budget,
                                       predict_fn=predict_fn,
                                       service=service,
                                       cache_capacity=cache_capacity)
    return est.cost_fn()


@dataclass
class FusionSearchResult:
    best_decision: FusionDecision
    best_runtime: float             # measured on hardware
    default_runtime: float
    hardware_evals: int
    model_evals: int
    hardware_seconds_used: float
    trace: list[float] = field(default_factory=list)

    @property
    def speedup(self) -> float:
        return self.default_runtime / max(self.best_runtime, 1e-30)


def _propose_flips(n_edges: int):
    """The classic move: flip one edge, sometimes two (30%)."""
    def propose(cur: FusionDecision,
                rng: np.random.Generator) -> FusionDecision:
        flips = 1 + int(rng.random() < 0.3)
        cand = cur
        for _ in range(flips):
            cand = cand.flip(int(rng.integers(n_edges)))
        return cand
    return propose


def simulated_annealing_fusion(
        program: KernelGraph, sim: TPUSimulator, *,
        model_cost: CostFn | None = None,
        estimator: CostEstimator | None = None,
        hardware_budget_s: float = 60.0,
        model_steps: int = 300,
        eval_seconds: float = 2.0,
        seed: int = 0,
        start: str = "default",
        max_group: int = 48,
        population: int = 1,
        meter: BudgetMeter | None = None,
        rerank_top: int | None = None) -> FusionSearchResult:
    """Search fusion configs for one program.

    Neither model_cost nor estimator => 'HW m' mode (anneal on hardware
    directly, budget enforced per-eval inside the loop).
    model_cost (a `CostFn`) or estimator (a `CostEstimator`; enables
    population batching) => 'Cost model + HW': anneal on the model, then
    spend the hardware budget re-ranking the model's best configs.

    Pass a shared `meter` to budget several searches jointly (e.g. the
    cross-scenario driver in examples/autotune_zoo.py); by default a
    fresh meter with `hardware_budget_s` / `eval_seconds` is used.
    `rerank_top` caps how many model-ranked configs the hardware re-rank
    may verify (default: whatever the budget affords) — set it when a
    shared meter must keep budget for later searches. The
    compiler-default config measurement is the baseline, not tuning, and
    is not charged.
    """
    if model_cost is not None and estimator is not None:
        raise ValueError("pass model_cost or estimator, not both")
    rng = np.random.default_rng(seed)
    start_dec = default_fusion(program) if start == "default" \
        else random_fusion(program, rng)
    if meter is None:
        meter = BudgetMeter(budget_s=hardware_budget_s,
                            eval_seconds=eval_seconds)
    evals0, seconds0 = meter.evals, meter.spent_s
    hw = HardwareEstimator(sim, meter=meter)
    n_edges = len(fusable_edges(program))
    propose = _propose_flips(n_edges)
    # one memoized materializer per search: candidates share almost all
    # groups, so kernel construction + content hashing is paid once per
    # unique group, not once per candidate
    materialize = FusionMaterializer(program, max_group)

    default_runtime = sim.measure_program(
        materialize(default_fusion(program)))
    model_evals = 0
    trace: list[float] = []

    if model_cost is None and estimator is None:
        # anneal directly on hardware; the meter stops the loop. The step
        # cap mirrors the meter's actual eval capacity (a shared meter
        # may afford more than this call's hardware_budget_s default);
        # an unbounded meter falls back to the budget argument.
        budget_steps = max(meter.affordable(1 << 20), 1)
        if budget_steps >= 1 << 20:
            budget_steps = max(int(hardware_budget_s / eval_seconds), 1)
        res = anneal(
            start_dec, propose=propose,
            cost_many=lambda decs: [hw.measure_program(materialize(d))
                                    for d in decs],
            steps=budget_steps if n_edges else 0, rng=rng,
            key=lambda d: d.fuse, meter=meter)
        if res.visited:
            best_cost, best_dec = res.best
            trace = [c for c, _ in res.visited[:20]]
        else:                                  # budget afforded nothing
            best_cost, best_dec = float("inf"), start_dec
    else:
        # anneal on the model (free), validate top configs on hardware
        if estimator is not None:
            drop = getattr(estimator, "max_nodes", None) \
                if getattr(estimator, "adjacency", None) == "dense" else None

            def cost_many(decs: list[FusionDecision]) -> np.ndarray:
                groups = []
                for d in decs:
                    ks = materialize(d)
                    if drop is not None:
                        ks = [k for k in ks if k.num_nodes <= drop]
                    groups.append(ks)
                return estimator.program_costs(groups)   # ONE batched flush
        else:
            def cost_many(decs: list[FusionDecision]) -> list[float]:
                return [model_cost(materialize(d)) for d in decs]

        res = anneal(start_dec, propose=propose, cost_many=cost_many,
                     steps=model_steps if n_edges else 0, rng=rng,
                     population=population, key=lambda d: d.fuse)
        model_evals = res.evals
        best_cost, best_dec = float("inf"), start_dec
        top = res.visited if rerank_top is None else \
            res.visited[:max(rerank_top, 0)]
        for _, dec in top:
            if meter.affordable(1) < 1:
                break
            rt = hw.measure_program(materialize(dec))
            trace.append(rt)
            if rt < best_cost:
                best_cost, best_dec = rt, dec

    # the compiler default is always available as a fallback
    if default_runtime < best_cost:
        best_cost = default_runtime
        best_dec = default_fusion(program)
    return FusionSearchResult(best_dec, best_cost, default_runtime,
                              meter.evals - evals0, model_evals,
                              meter.spent_s - seconds0, trace)

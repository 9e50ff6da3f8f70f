"""Generic budgeted search loops (DESIGN.md §10).

Two primitives, each scoring candidates through a `CostEstimator` in as
few batched calls as possible:

* `topk_rerank` — score EVERY candidate of every group in one coalesced
  estimator call, then verify each group's model-top-k on hardware within
  the shared `BudgetMeter`. Generalizes the tile autotuner: a whole
  program's kernels × tile candidates reach the prediction service as a
  single flush instead of a per-kernel Python loop.
* `anneal` — population-based simulated annealing: every temperature step
  proposes `population` candidate states and scores the unseen ones in ONE
  batched call. With `population=1` it replays the classic sequential
  annealer exactly (same RNG draw sequence, same visit order, bit-equal
  costs); with `population>1` each flush amortizes dispatch overhead
  across the whole population — the autotuner's scoring-throughput win.

Both loops only ever *stop* on budget exhaustion (never over-charge): the
meter is asked what is affordable before any hardware is touched.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Hashable, Sequence

import numpy as np

from repro_torch.core.graph import KernelGraph
from repro_torch.search.estimator import BudgetMeter, CostEstimator


# ----------------------------------------------------------------------------
# top-k rerank
# ----------------------------------------------------------------------------
@dataclass
class RerankChoice:
    """Outcome for one candidate group."""
    chosen: int                   # candidate index within the group
    chosen_runtime: float         # measured; NaN if budget allowed none
    measured: list[tuple[int, float]] = field(default_factory=list)
    scores: np.ndarray | None = None

    @property
    def hardware_evals(self) -> int:
        return len(self.measured)


def score_groups(estimator: CostEstimator,
                 groups: Sequence[Sequence[KernelGraph]]
                 ) -> list[np.ndarray]:
    """All groups' candidates through one batched estimator call."""
    return estimator.estimate_groups(groups)


def topk_rerank(groups: Sequence[Sequence[KernelGraph]], *,
                measure: Callable[[KernelGraph], float],
                estimator: CostEstimator | None = None,
                scores: Sequence[np.ndarray] | None = None,
                top_k: int = 10,
                meter: BudgetMeter | None = None) -> list[RerankChoice]:
    """Model-rank every group, measure each group's top-k on hardware.

    Exactly one of `estimator` / `scores` supplies the model ranking
    (`scores[g][i]` = model score of candidate i of group g; lower =
    faster). `measure(graph) -> seconds` is the raw hardware call — the
    engine charges `meter` (one eval per measurement) and simply stops
    measuring when the budget runs out, leaving later groups to fall back
    to their model-best candidate (`chosen_runtime=NaN`, zero evals).
    """
    if (estimator is None) == (scores is None):
        raise ValueError("exactly one of estimator/scores required")
    if scores is None:
        scores = score_groups(estimator, groups)
    if len(scores) != len(groups):
        raise ValueError(f"{len(scores)} score arrays for "
                         f"{len(groups)} groups")
    out = []
    for group, s in zip(groups, scores):
        s = np.asarray(s)
        if len(s) != len(group):
            raise ValueError("scores misaligned with group")
        order = np.argsort(s)[:max(top_k, 1)]
        measured: list[tuple[int, float]] = []
        for i in order:
            if meter is not None:
                if meter.affordable(1) < 1:
                    break
                meter.charge(1)
            measured.append((int(i), float(measure(group[int(i)]))))
        if measured:
            bi, bt = min(measured, key=lambda x: x[1])
        else:                       # budget allowed nothing: trust the model
            bi, bt = int(order[0]), float("nan")
        out.append(RerankChoice(chosen=bi, chosen_runtime=bt,
                                measured=measured, scores=s))
    return out


# ----------------------------------------------------------------------------
# population-based simulated annealing
# ----------------------------------------------------------------------------
@dataclass
class AnnealResult:
    visited: list[tuple[float, Any]]   # (cost, state), best-first
    evals: int                         # unique states scored
    steps: int                         # temperature steps taken
    budget_stopped: bool = False       # ended early on budget exhaustion

    @property
    def best(self) -> tuple[float, Any]:
        return self.visited[0]


def anneal(initial: Any, *,
           propose: Callable[[Any, np.random.Generator], Any],
           cost_many: Callable[[list[Any]], Sequence[float]],
           steps: int, rng: np.random.Generator,
           t0: float = 0.1, t1: float = 1e-3,
           population: int = 1,
           key: Callable[[Any], Hashable] = lambda s: s,
           meter: BudgetMeter | None = None) -> AnnealResult:
    """Simulated annealing over arbitrary states.

    `propose(cur, rng)` draws one candidate from the current state;
    `cost_many(states)` scores a batch in one call (this is where the
    population batching pays — back it with
    `CostEstimator.program_costs` / one service flush). `key` makes
    states hashable for the visited-cache (revisits are free). `meter`,
    when given, limits *evaluations*: a step that cannot afford all its
    unseen proposals scores only the affordable prefix and ends the
    search (`cost_many` is expected to do the actual charging — e.g.
    `HardwareEstimator.measure_program`).

    With `population=1` and the same `rng`, the visit sequence is
    bit-identical to the classic sequential loop this generalizes
    (`fusion_autotuner._anneal` pre-refactor): one `rng.random()` for the
    flip count, one `rng.integers` per flip, and the Metropolis draw only
    when the candidate is not already an improvement.
    """
    if population < 1:
        raise ValueError(f"population must be >= 1, got {population}")
    if meter is not None and meter.affordable(1) < 1:
        return AnnealResult([], evals=0, steps=0, budget_stopped=True)
    cur = initial
    cur_cost = float(cost_many([cur])[0])
    visited: dict[Hashable, float] = {key(cur): cur_cost}
    best: list[tuple[float, Any]] = [(cur_cost, cur)]
    evals = 1
    budget_stopped = False
    steps_taken = 0
    for i in range(steps):
        temp = t0 * (t1 / t0) ** (i / max(steps - 1, 1))
        cands = [propose(cur, rng) for _ in range(population)]
        # unseen unique states, in proposal order
        need: list[tuple[Hashable, Any]] = []
        batch_keys: set[Hashable] = set()
        for c in cands:
            k = key(c)
            if k not in visited and k not in batch_keys:
                batch_keys.add(k)
                need.append((k, c))
        if need:
            allowed = len(need) if meter is None \
                else meter.affordable(len(need))
            if allowed < len(need):
                need = need[:allowed]
                budget_stopped = True
            if need:
                costs = cost_many([c for _, c in need])
                for (k, c), cv in zip(need, costs):
                    cv = float(cv)
                    visited[k] = cv
                    best.append((cv, c))
                    evals += 1
        # Metropolis sweep in proposal order; unscored (budget-cut)
        # candidates are skipped
        for c in cands:
            k = key(c)
            if k not in visited:
                continue
            c_cost = visited[k]
            if c_cost < cur_cost or rng.random() < np.exp(
                    -(c_cost - cur_cost) / max(temp * cur_cost, 1e-30)):
                cur, cur_cost = c, c_cost
        steps_taken = i + 1
        if budget_stopped:
            break
    best.sort(key=lambda x: x[0])
    return AnnealResult(best, evals=evals, steps=steps_taken,
                        budget_stopped=budget_stopped)

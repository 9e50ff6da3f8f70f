"""Cost estimators + the shared hardware budget (DESIGN.md §10).

One protocol for every way this repo can price a kernel:

* `HardwareEstimator`  — the simulator ("run it on the accelerator");
  every measurement charges a shared `BudgetMeter`, which replaces the two
  autotuners' ad-hoc `hardware_evals` / `eval_seconds` bookkeeping.
* `AnalyticalEstimator` — the Appendix-A baseline (free, rough).
* `LearnedEstimator`    — the GNN through `serving.CostModelService`
  (cached + coalesced); `from_params` is the one place service-construction
  kwargs live — `evaluate.learned_tile_scorer`,
  `evaluate.learned_runtime_predictor` and `autotuner.model_cost_fn` all
  build through it.
* `CascadeEstimator`    — staged filtering: a cheap stage prunes, an
  expensive stage refines the survivors (optionally ending in hardware).

Estimator scores are *rankings with units attached*: hardware/analytical
return seconds, the learned model returns predicted log-runtime. Callers
that need seconds use `runtimes()` / `program_costs()`, which apply each
estimator's score→runtime transform (`exp` for the learned model).
Every `estimate` call is accounted in `.queries`, which is how the
cascade acceptance gate ("≤ half the learned-model queries") is measured.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.graph import KernelGraph
from repro_torch.core.simulator import TPUSimulator


class BudgetExhausted(RuntimeError):
    """Raised when a charge would push a `BudgetMeter` past its budget."""


class BudgetMeter:
    """Hardware wall-clock budget, charged *as evaluations happen*.

    One eval = one config measured on the accelerator (a kernel for tile
    search, a whole program for fusion search), costing `eval_seconds` of
    simulated hardware time — the same apples-to-apples accounting the
    fusion autotuner used, now enforced inside every search loop instead
    of tallied after the fact.

    >>> m = BudgetMeter(budget_s=5.0, eval_seconds=2.0)
    >>> m.affordable(4)
    2
    >>> m.charge(2); (m.evals, m.spent_s, m.exhausted)
    (2, 4.0, True)
    """

    def __init__(self, budget_s: float = math.inf, eval_seconds: float = 2.0):
        if eval_seconds <= 0:
            raise ValueError(f"eval_seconds must be > 0, got {eval_seconds}")
        self.budget_s = float(budget_s)
        self.eval_seconds = float(eval_seconds)
        self.evals = 0
        self.spent_s = 0.0

    @property
    def remaining_s(self) -> float:
        return max(self.budget_s - self.spent_s, 0.0)

    def affordable(self, n: int = 1) -> int:
        """How many of `n` requested evals fit in the remaining budget."""
        if math.isinf(self.budget_s):
            return n
        fit = int((self.remaining_s + 1e-9) / self.eval_seconds)
        return min(n, max(fit, 0))

    @property
    def exhausted(self) -> bool:
        return self.affordable(1) == 0

    def charge(self, n: int = 1, seconds: float | None = None) -> None:
        """Record `n` evals (costing `seconds`, default n*eval_seconds).
        Raises `BudgetExhausted` — without charging — if it won't fit."""
        s = n * self.eval_seconds if seconds is None else float(seconds)
        if self.spent_s + s > self.budget_s + 1e-9:
            raise BudgetExhausted(
                f"charge of {s:.3g}s exceeds budget "
                f"({self.spent_s:.3g}/{self.budget_s:.3g}s spent)")
        self.evals += n
        self.spent_s += s


class CostEstimator:
    """`estimate(kernels) -> np.ndarray` + query accounting.

    Subclasses implement `_estimate`; the public wrapper counts `.queries`
    (graphs scored) only on success. Scores are comparable *within* one
    estimator (lower = faster); `_to_runtime` maps them to seconds.

    `adjacency` / `max_nodes` advertise the batched-graph representation
    behind the estimator (None = representation-free). The fusion
    autotuner keys its dense-path oversized-kernel drop off these, so
    wrappers around a dense learned backend must forward them
    (`CascadeEstimator` inherits its final stage's).
    """

    name = "estimator"
    adjacency: str | None = None
    max_nodes: int | None = None

    def __init__(self):
        self._queries = 0

    @property
    def queries(self) -> int:
        """Total graphs this estimator has been asked to score."""
        return self._queries

    def estimate(self, kernels: Sequence[KernelGraph]) -> np.ndarray:
        kernels = list(kernels)
        if not kernels:
            return np.zeros((0,), np.float64)
        out = np.asarray(self._estimate(kernels), np.float64)
        if out.shape != (len(kernels),):
            raise ValueError(f"{self.name}: estimate returned shape "
                             f"{out.shape}, expected ({len(kernels)},)")
        self._queries += len(kernels)
        return out

    def _estimate(self, kernels: list[KernelGraph]) -> np.ndarray:
        raise NotImplementedError

    def _to_runtime(self, scores: np.ndarray) -> np.ndarray:
        return scores

    def runtimes(self, kernels: Sequence[KernelGraph]) -> np.ndarray:
        """Scores converted to (estimated) seconds."""
        return self._to_runtime(self.estimate(kernels))

    def estimate_groups(self, groups: Sequence[Sequence[KernelGraph]]
                        ) -> list[np.ndarray]:
        """Score many candidate groups in ONE batched `estimate` call —
        the whole flattened set reaches the backend as a single coalesced
        flush (the engine's per-program / per-population fast path)."""
        groups = [list(g) for g in groups]
        flat = [k for g in groups for k in g]
        scores = self.estimate(flat)
        out, i = [], 0
        for g in groups:
            out.append(scores[i:i + len(g)])
            i += len(g)
        return out

    def program_costs(self, groups: Sequence[Sequence[KernelGraph]]
                      ) -> np.ndarray:
        """Σ runtime per group (the fusion objective), batched the same
        way. Empty groups cost 0."""
        per_group = self.estimate_groups(groups)
        return np.array([float(np.sum(self._to_runtime(s))) if len(s) else 0.0
                         for s in per_group], np.float64)


class HardwareEstimator(CostEstimator):
    """The measurement oracle as an estimator. Every kernel measured
    charges one eval to the shared `BudgetMeter` (if given); a whole
    program measured as one config charges one eval.

    `log` (anything with ``record(kernel, runtime)``, e.g. the
    reference's `repro.flywheel.MeasurementLog`) observes every charged
    per-kernel measurement — the data-flywheel tap that turns paid hardware evals
    into corpus delta shards (DESIGN.md §15). `measure_program` totals
    are NOT logged: one program eval yields a single end-to-end runtime
    that can't be attributed back to per-kernel labels.
    """

    name = "hardware"

    def __init__(self, sim: TPUSimulator, *, meter: BudgetMeter | None = None,
                 runs: int = 3, log=None):
        super().__init__()
        self.sim = sim
        self.meter = meter
        self.runs = runs
        self.log = log

    def _estimate(self, kernels: list[KernelGraph]) -> np.ndarray:
        if self.meter is not None:
            self.meter.charge(len(kernels))
        out = np.array([self.sim.measure(k, runs=self.runs)
                        for k in kernels], np.float64)
        if self.log is not None:
            for k, rt in zip(kernels, out):
                self.log.record(k, float(rt))
        return out

    def measure(self, kernel: KernelGraph) -> float:
        return float(self.estimate([kernel])[0])

    def measure_program(self, kernels: Sequence[KernelGraph]) -> float:
        """One fusion config = one hardware eval (the config runs end to
        end once), regardless of how many kernels it fused into."""
        if self.meter is not None:
            self.meter.charge(1)
        self._queries += 1
        return float(self.sim.measure_program(list(kernels), runs=self.runs))


class AnalyticalEstimator(CostEstimator):
    """The hand-tuned Appendix-A model: free, good at within-kernel tile
    ranking, poor at absolute cross-kernel runtimes — i.e. a pruning
    stage, not a verdict."""

    name = "analytical"

    def __init__(self, model=None):
        super().__init__()
        if model is None:
            from repro_torch.core.analytical import AnalyticalModel
            model = AnalyticalModel()
        self.model = model

    def _estimate(self, kernels: list[KernelGraph]) -> np.ndarray:
        return np.array([self.model.predict(k) for k in kernels], np.float64)


class LearnedEstimator(CostEstimator):
    """The GNN cost model as an estimator. Scores are predicted
    log-runtimes; `runtimes()` exponentiates. Backed either by a
    `serving.CostModelService` (cached + coalesced — the default) or by
    the direct uncached `predict_kernels` path (`cache_capacity=0`)."""

    name = "learned"

    def __init__(self, service=None, *,
                 direct: Callable[[list[KernelGraph]], np.ndarray] | None = None,
                 adjacency: str | None = None, max_nodes: int | None = None):
        super().__init__()
        if (service is None) == (direct is None):
            raise ValueError("exactly one of service/direct required")
        self.service = service
        self._direct = direct
        self.adjacency = service.adjacency if service is not None else adjacency
        self.max_nodes = service.max_nodes if service is not None else max_nodes

    @classmethod
    def from_params(cls, model, model_cfg, normalizer, *,
                    max_nodes: int = 64, chunk: int = 128,
                    adjacency: str | None = None,
                    node_budget: int | None = None, predict_fn=None,
                    service=None, cache_capacity: int = 65536
                    ) -> "LearnedEstimator":
        """THE constructor for learned scoring plumbing — every scorer /
        predictor / cost-fn in `core.evaluate` and `repro_torch.autotuner`
        builds through here. `model` is a `core.model.CostModel`, scored
        on its own device by either route. Pass an existing `service` to
        share one prediction cache across clients; `cache_capacity=0`
        (and no service) opts out into direct uncached scoring
        (`core.evaluate.predict_kernels`). `model` may be a
        `repro_torch.quant.QuantizedCostModel` — scoring then runs the
        int8 serving path under the model's embedded config."""
        from repro_torch.quant.quantize import QuantizedCostModel
        if isinstance(model, QuantizedCostModel):
            model_cfg = model.serving_config(model_cfg)
            model = model.model(model_cfg)
        if service is None and cache_capacity:
            from repro_torch.serving import CostModelService
            service = CostModelService(model, model_cfg, normalizer,
                                       adjacency=adjacency,
                                       max_nodes=max_nodes, chunk=chunk,
                                       node_budget=node_budget,
                                       predict_fn=predict_fn,
                                       cache_capacity=cache_capacity)
        if service is not None:
            return cls(service)

        from repro_torch.core.evaluate import make_predict_fn, \
            predict_kernels
        predict = predict_fn or make_predict_fn(model_cfg)

        def direct(graphs: list[KernelGraph]) -> np.ndarray:
            return predict_kernels(model, model_cfg, graphs, normalizer,
                                   max_nodes=max_nodes, chunk=chunk,
                                   predict_fn=predict, adjacency=adjacency,
                                   node_budget=node_budget)
        return cls(None, direct=direct,
                   adjacency=adjacency or model_cfg.adjacency,
                   max_nodes=max_nodes)

    def _estimate(self, kernels: list[KernelGraph]) -> np.ndarray:
        if self.service is not None:
            return self.service.predict_many(kernels)
        return self._direct(kernels)

    def _to_runtime(self, scores: np.ndarray) -> np.ndarray:
        return np.exp(scores)

    # --- drop-in adapters for the pre-search call sites --------------------
    def tile_scorer(self) -> Callable:
        """`scorer(kernel, tiles) -> scores` (tile autotuner contract)."""
        def scorer(kernel: KernelGraph, tiles) -> np.ndarray:
            kernel.structural_digest()   # memoize once; tile variants share
            return self.estimate([kernel.with_tile(t) for t in tiles])
        return scorer

    def runtime_predictor(self) -> Callable:
        """`predict_runtimes(kernels) -> seconds` (fusion eval contract)."""
        def predict_runtimes(kernels) -> np.ndarray:
            return self._to_runtime(self.estimate(list(kernels)))
        return predict_runtimes

    def _default_drop(self) -> int | None:
        # the dense path's padded slots truncate oversized kernels anyway;
        # drop them from objectives so the bias is explicit (model_cost_fn)
        return self.max_nodes if self.adjacency == "dense" else None

    def cost_fn(self, *, drop_above: int | None | str = "auto") -> Callable:
        """Program-cost objective Σ exp(score) (fusion annealer
        contract)."""
        drop = self._default_drop() if drop_above == "auto" else drop_above

        def cost(kernels) -> float:
            ks = list(kernels)
            if drop is not None:
                ks = [k for k in ks if k.num_nodes <= drop]
            if not ks:
                return 0.0
            return float(np.sum(np.exp(self.estimate(ks))))
        return cost


class CascadeEstimator(CostEstimator):
    """Staged filtering: each stage scores the survivors of the previous
    one and keeps its top fraction; the final stage scores what's left
    (analytical prune → learned refine → optional hardware verify).

    Returned scores are *rank-faithful*, not calibrated: survivors carry
    the final stage's scores; pruned candidates are shifted above the
    survivor maximum (later-stage prunees ranking better than earlier
    ones, each set ordered by the stage that pruned it). Rankings — which
    is all top-k search consumes — are exact; don't feed cascade scores
    to an absolute-error metric.

    `keep` is a fraction (0,1] or an absolute count, scalar or per
    non-final stage — applied PER GROUP under `estimate_groups`, so every
    kernel keeps its own refine candidates regardless of how expensive
    it is in absolute terms (a flat cross-kernel prune would starve the
    analytically-expensive kernels, exactly the ones worth refining).
    Budgeted final stages (a `HardwareEstimator` with a meter) charge as
    usual; `queries` of each stage tell you what the cascade saved.
    `adjacency`/`max_nodes` are inherited from the final (refine) stage.
    """

    name = "cascade"

    def __init__(self, stages: Sequence[CostEstimator],
                 keep: float | int | Sequence[float | int] = 0.5,
                 min_keep: int = 1):
        super().__init__()
        if len(stages) < 1:
            raise ValueError("need at least one stage")
        self.stages = list(stages)
        n_prune = len(self.stages) - 1
        keeps = list(keep) if isinstance(keep, (list, tuple)) \
            else [keep] * n_prune
        if len(keeps) != n_prune:
            raise ValueError(f"{len(keeps)} keep values for {n_prune} "
                             "pruning stages")
        self.keeps = keeps
        self.min_keep = int(min_keep)
        self.adjacency = getattr(self.stages[-1], "adjacency", None)
        self.max_nodes = getattr(self.stages[-1], "max_nodes", None)

    def _keep_count(self, stage_i: int, n: int) -> int:
        k = self.keeps[stage_i]
        k = int(math.ceil(k * n)) if isinstance(k, float) and k <= 1.0 \
            else int(k)
        return max(min(k, n), min(self.min_keep, n))

    def _run(self, groups: list[list[KernelGraph]]) -> list[np.ndarray]:
        """The staged loop over per-group active sets; every stage still
        scores ALL groups' survivors in one batched call."""
        actives = [np.arange(len(g)) for g in groups]
        outs = [np.empty((len(g),), np.float64) for g in groups]
        pruned: list[list[tuple[np.ndarray, np.ndarray]]] = \
            [[] for _ in groups]
        for si, stage in enumerate(self.stages):
            flat = [groups[gi][int(j)]
                    for gi, act in enumerate(actives) for j in act]
            s = stage.estimate(flat)
            off = 0
            last = si == len(self.stages) - 1
            for gi, act in enumerate(actives):
                sg = s[off:off + len(act)]
                off += len(act)
                if last:
                    outs[gi][act] = sg
                    continue
                k = self._keep_count(si, len(act))
                order = np.argsort(sg, kind="stable")
                pruned[gi].append((act[order[k:]], sg[order[k:]]))
                actives[gi] = act[order[:k]]
        for gi, out in enumerate(outs):
            final = out[actives[gi]]
            hi = float(final.max()) if len(final) else 0.0
            # later-stage prunees outrank earlier ones; within a chunk
            # the pruning stage's own order is preserved (squashed into
            # (0, 1))
            for idx, sg in reversed(pruned[gi]):
                if not len(idx):
                    continue
                rank = np.empty(len(sg))
                rank[np.argsort(sg, kind="stable")] = np.arange(len(sg))
                out[idx] = hi + 1.0 + rank / max(len(sg), 1)
                hi = float(out[idx].max())
        return outs

    def _estimate(self, kernels: list[KernelGraph]) -> np.ndarray:
        return self._run([kernels])[0]

    def estimate_groups(self, groups: Sequence[Sequence[KernelGraph]]
                        ) -> list[np.ndarray]:
        """Per-group staged pruning (each group keeps its own top
        fraction), with every stage batched across all groups."""
        groups = [list(g) for g in groups]
        outs = self._run(groups)
        self._queries += sum(len(g) for g in groups)
        return outs

    # Cascade scores are ordinal: prunees carry synthetic rank-shift
    # values, and survivor scores keep the final stage's units. Summing
    # or exponentiating them would be comparing noise, so the
    # calibrated-output surfaces refuse loudly.
    def runtimes(self, kernels: Sequence[KernelGraph]) -> np.ndarray:
        raise TypeError(
            "CascadeEstimator scores are rank-only (pruned candidates "
            "carry synthetic rank scores); query a calibrated stage "
            "(e.g. the learned refine estimator) directly for runtimes")

    def program_costs(self, groups: Sequence[Sequence[KernelGraph]]
                      ) -> np.ndarray:
        raise TypeError(
            "CascadeEstimator cannot serve as a program-cost objective "
            "(its scores are rank-only) — pass the learned or analytical "
            "estimator itself to the fusion autotuner and keep the "
            "cascade for top-k candidate ranking")

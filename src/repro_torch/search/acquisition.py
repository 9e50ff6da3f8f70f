"""Uncertainty-driven acquisition (DESIGN.md §15): spend the hardware
budget where the model is least sure. Counterpart of
`repro.search.acquisition`.

`AcquisitionEstimator` is a `LearnedEstimator`-shaped scorer with an
MC-dropout variance head: K stochastic forward passes (dropout live,
one generator per sample) through the same batched `predict_kernels`
machinery the deterministic path uses, on the model's device. `estimate`
returns the MC-mean score (a drop-in learned estimator);
`estimate_with_variance` adds the per-kernel std. `route_variance` (a
copy of the reference's) turns per-candidate stds into a measurement
plan under a fixed eval budget, and `acquire` executes the plan through
a (metered, logged) `HardwareEstimator` — closing the search side of the
data flywheel.

Dropout sits after the GNN, so a pass with dropout live is still an
inference forward: it runs under `torch.inference_mode()` and, with
``use_pallas_aggregate``, through the `graph_aggregate` /
`segment_aggregate` kernels. The masks come from `torch.Generator`s,
not from `jax.random`, so the samples differ from the reference's while
their statistics agree.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graph import KernelGraph
from repro_torch.core.model import batch_to_device, cost_model_apply
from repro_torch.search.estimator import CostEstimator, HardwareEstimator

__all__ = ["AcquisitionEstimator", "route_variance"]


def route_variance(stds, budget: int, *, spread: str = "kernel",
                   exclude=None, means=None,
                   kappa: float = 1.0) -> list[tuple[int, int]]:
    """Plan which (group, candidate) pairs to measure under `budget`
    total evals, most *attractive* candidate first.

    Attraction is highest predictive std by default (pure exploration).
    With `means`, candidates are ranked by the lower confidence bound
    ``mean - kappa * std`` instead (lowest first): predicted-fast OR
    uncertain candidates win, so the plan exploits the model's belief
    while still spending where it self-disagrees — the flywheel's
    policy (a kappa of 0 is pure exploitation, large kappa approaches
    pure variance routing).

    spread='global' — one flat ranking: take the `budget` most
    attractive candidates wherever they live. spread='kernel' —
    round-robin passes: every group contributes its next-most-attractive
    unmeasured candidate (groups ordered by that candidate within a
    pass) before any group gets a second pick, so each kernel's sweep
    keeps accumulating the ≥2 measured configs a pairwise rank loss
    needs.

    `exclude` is a set of already-measured (group, candidate) pairs —
    budget is never wasted re-measuring.

    >>> stds = [[0.9, 0.1], [0.5, 0.4]]
    >>> route_variance(stds, 3, spread='global')
    [(0, 0), (1, 0), (1, 1)]
    >>> route_variance(stds, 3, spread='kernel')
    [(0, 0), (1, 0), (1, 1)]
    >>> route_variance(stds, 3, spread='kernel', exclude={(1, 0)})
    [(0, 0), (1, 1), (0, 1)]
    >>> route_variance(stds, 2, spread='global',
    ...                means=[[2.0, 0.0], [1.0, 3.0]], kappa=1.0)
    [(0, 1), (1, 0)]
    """
    if spread not in ("kernel", "global"):
        raise ValueError(f"unknown spread policy {spread!r}")
    exclude = set(exclude or ())
    budget = max(int(budget), 0)
    if means is None:
        def score(gi, ci):
            return -float(np.asarray(stds[gi])[ci])
    else:
        def score(gi, ci):
            return (float(np.asarray(means[gi])[ci])
                    - kappa * float(np.asarray(stds[gi])[ci]))
    cands = [[(score(gi, ci), gi, ci) for ci in range(len(np.asarray(g)))
              if (gi, ci) not in exclude]
             for gi, g in enumerate(stds)]
    for g in cands:
        g.sort(key=lambda t: t[0])
    if spread == "global":
        flat = sorted((t for g in cands for t in g), key=lambda t: t[0])
        return [(gi, ci) for _, gi, ci in flat[:budget]]
    plan: list[tuple[int, int]] = []
    depth = 0
    while len(plan) < budget and any(depth < len(g) for g in cands):
        layer = sorted((g[depth] for g in cands if depth < len(g)),
                       key=lambda t: t[0])
        for _, gi, ci in layer[:budget - len(plan)]:
            plan.append((gi, ci))
        depth += 1
    return plan


class AcquisitionEstimator(CostEstimator):
    """MC-dropout mean/variance scoring over the GNN cost model.

    Scores are predicted log-runtimes averaged over `samples` stochastic
    forward passes (`runtimes()` exponentiates, like `LearnedEstimator`);
    the std across passes is the model's self-disagreement — high where
    the training corpus never covered a candidate, which is exactly
    where the next hardware eval teaches the most.

    Deterministic for a fixed (model, seed): pass s draws its masks from
    a generator on the model's device seeded from
    ``SeedSequence([seed, s])``, built afresh for every chunk that
    `predict_kernels` scores — one key per sample reused for every
    chunk, as the reference's ``fold_in(key(seed), s)`` is.

    Built `from_params` like every learned scorer, from the port's
    `CostModel`; requires ``model_cfg.dropout > 0`` (no dropout ⇒ zero
    variance ⇒ nothing to route on) and at least two samples.
    """

    name = "acquisition"

    def __init__(self, model, model_cfg, normalizer, *,
                 samples: int = 8, seed: int = 0, max_nodes: int = 64,
                 chunk: int = 128, adjacency: str | None = None,
                 node_budget: int | None = None):
        super().__init__()
        if samples < 2:
            raise ValueError(f"need >= 2 MC samples, got {samples}")
        if model_cfg.dropout <= 0.0:
            raise ValueError(
                "MC-dropout acquisition needs model_cfg.dropout > 0 "
                f"(got {model_cfg.dropout}) — variance would be "
                "identically zero")
        self.model = model
        self.model_cfg = model_cfg
        self.normalizer = normalizer
        self.samples = int(samples)
        self.seed = int(seed)
        self._kw = dict(max_nodes=max_nodes, chunk=chunk,
                        adjacency=adjacency, node_budget=node_budget)
        self.adjacency = adjacency or model_cfg.adjacency
        self.max_nodes = max_nodes

    @classmethod
    def from_params(cls, model, model_cfg, normalizer,
                    **kw) -> "AcquisitionEstimator":
        """Mirror of `LearnedEstimator.from_params` for call-site
        symmetry (MC passes are uncached by construction — every sample
        must re-roll dropout — so there is no service variant)."""
        return cls(model, model_cfg, normalizer, **kw)

    # -- scoring -------------------------------------------------------------
    def _predict_mc(self, sample: int):
        """`predict_fn` of MC pass `sample`: the forward with dropout
        live, every chunk's masks from the same seed."""
        cfg = self.model_cfg
        seed = int(np.random.SeedSequence([self.seed, sample])
                   .generate_state(1, np.uint64)[0])

        def predict(model, batch) -> np.ndarray:
            dev = model.device
            with torch.inference_mode():
                tb = batch_to_device(batch, dev)
                gen = torch.Generator(device=dev).manual_seed(seed)
                y = cost_model_apply(model.tree(), cfg, tb, generator=gen,
                                     training=True)
                return y.float().cpu().numpy()
        return predict

    def _mc_stack(self, kernels: list[KernelGraph]) -> np.ndarray:
        from repro_torch.core.evaluate import predict_kernels
        return np.stack([predict_kernels(
            self.model, self.model_cfg, kernels, self.normalizer,
            predict_fn=self._predict_mc(s), **self._kw)
            for s in range(self.samples)])         # [samples, kernels]

    def _estimate(self, kernels: list[KernelGraph]) -> np.ndarray:
        return self._mc_stack(kernels).mean(axis=0)

    def _to_runtime(self, scores: np.ndarray) -> np.ndarray:
        return np.exp(scores)

    def estimate_with_variance(self, kernels) -> tuple[np.ndarray,
                                                       np.ndarray]:
        """(mean, std) of the MC score samples, per kernel."""
        kernels = list(kernels)
        if not kernels:
            z = np.zeros((0,), np.float64)
            return z, z.copy()
        stack = self._mc_stack(kernels)
        self._queries += len(kernels)
        return stack.mean(axis=0), stack.std(axis=0)

    def group_variance(self, groups) -> tuple[list[np.ndarray],
                                              list[np.ndarray]]:
        """`estimate_with_variance` over many candidate groups in one
        batched flush (the `estimate_groups` idiom)."""
        groups = [list(g) for g in groups]
        mean, std = self.estimate_with_variance(
            [k for g in groups for k in g])
        means, stds, i = [], [], 0
        for g in groups:
            means.append(mean[i:i + len(g)])
            stds.append(std[i:i + len(g)])
            i += len(g)
        return means, stds

    # -- budgeted acquisition ------------------------------------------------
    def acquire(self, groups, hardware: HardwareEstimator, *,
                budget: int | None = None, spread: str = "kernel",
                exclude=None,
                kappa: float | None = None) -> list[tuple[int, int, float]]:
        """Measure the most acquisition-worthy candidates within budget.

        Scores all `groups` (lists of candidate `KernelGraph`s) with the
        variance head, plans via `route_variance` — pure highest-std
        when `kappa` is None, the ``mean - kappa * std`` lower
        confidence bound otherwise — and measures the plan through
        `hardware` in ONE batched `estimate` call — charging its
        `BudgetMeter` and feeding its `MeasurementLog`, if attached.
        `budget` defaults to everything the meter still affords (all
        candidates, if unmetered). Returns ``(group, candidate,
        measured_runtime)`` triples.
        """
        groups = [list(g) for g in groups]
        total = sum(len(g) for g in groups) - len(set(exclude or ()))
        if budget is None:
            budget = total
        if hardware.meter is not None:
            budget = hardware.meter.affordable(min(budget, total))
        means, stds = self.group_variance(groups)
        plan = route_variance(stds, budget, spread=spread, exclude=exclude,
                              means=None if kappa is None else means,
                              kappa=0.0 if kappa is None else kappa)
        if not plan:
            return []
        runtimes = hardware.estimate([groups[gi][ci] for gi, ci in plan])
        return [(gi, ci, float(rt)) for (gi, ci), rt in zip(plan, runtimes)]

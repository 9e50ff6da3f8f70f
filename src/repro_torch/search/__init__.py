"""Unified cost estimation + budgeted search (DESIGN.md §10).

Counterpart of `repro.search`: `CostEstimator` adapters (hardware /
analytical / learned / cascade) with shared `BudgetMeter` accounting, and
the batched search engine (`topk_rerank`, population `anneal`) both
autotuners are thin wrappers over, and the data flywheel's MC-dropout
`AcquisitionEstimator` with its `route_variance` planner. The learned
and acquisition estimators score on the port's `CostModel` device.
"""
from repro_torch.search.acquisition import AcquisitionEstimator, \
    route_variance
from repro_torch.search.engine import (
    AnnealResult,
    RerankChoice,
    anneal,
    score_groups,
    topk_rerank,
)
from repro_torch.search.estimator import (
    AnalyticalEstimator,
    BudgetExhausted,
    BudgetMeter,
    CascadeEstimator,
    CostEstimator,
    HardwareEstimator,
    LearnedEstimator,
)

__all__ = [
    "AcquisitionEstimator", "AnalyticalEstimator", "AnnealResult",
    "BudgetExhausted", "BudgetMeter", "CascadeEstimator", "CostEstimator",
    "HardwareEstimator", "LearnedEstimator", "RerankChoice", "anneal",
    "route_variance", "score_groups", "topk_rerank",
]

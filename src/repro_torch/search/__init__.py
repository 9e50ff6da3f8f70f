"""Unified cost estimation + budgeted search (DESIGN.md §10).

Counterpart of `repro.search`: `CostEstimator` adapters (hardware /
analytical / learned / cascade) with shared `BudgetMeter` accounting, and
the batched search engine (`topk_rerank`, population `anneal`) both
autotuners are thin wrappers over. The learned estimator scores on the
port's `CostModel` device. Not ported yet: the MC-dropout
`AcquisitionEstimator` and `route_variance` of the data flywheel
(`repro.search.acquisition`; ROADMAP Queue 1 item 4).
"""
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
    "AnalyticalEstimator", "AnnealResult", "BudgetExhausted",
    "BudgetMeter", "CascadeEstimator", "CostEstimator",
    "HardwareEstimator", "LearnedEstimator", "RerankChoice", "anneal",
    "score_groups", "topk_rerank",
]

"""Autotuners driven by the learned performance model (paper §7).

* Tile-size autotuner: rank all valid tiles with a model, evaluate the top-k
  on hardware (§7.2); k=1 is direct compiler integration (§7.1).
* Fusion autotuner: simulated annealing over fusion configurations with a
  hardware-minutes budget; the learned model pre-screens candidates on CPU
  so scarce accelerator time is spent only on the most promising configs
  (§7.3).

Both are thin wrappers over the budgeted search engine in `repro_torch.search`
(estimators, `BudgetMeter`, `topk_rerank`, population `anneal`) — pass
`estimator=` / `meter=` for batched scoring and shared hardware budgets
(DESIGN.md §10).
"""
from repro_torch.autotuner.tile_autotuner import (
    TileTuneResult,
    autotune_program_tiles,
    model_scorer,
    tune_kernel_tiles,
)
from repro_torch.autotuner.fusion_autotuner import (
    FusionSearchResult,
    model_cost_fn,
    simulated_annealing_fusion,
)

__all__ = [
    "TileTuneResult", "autotune_program_tiles", "model_scorer",
    "tune_kernel_tiles",
    "FusionSearchResult", "model_cost_fn", "simulated_annealing_fusion",
]

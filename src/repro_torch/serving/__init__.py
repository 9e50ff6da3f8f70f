"""Cost-model prediction serving: content-addressed `PredictionCache`,
`RequestCoalescer`, the replay stream, and the `CostModelService` facade
that scores on the card."""
from repro_torch.serving.service import CostModelService

__all__ = ["CostModelService"]

"""Architecture configs — one module per assigned architecture plus the
paper's own cost-model config. Access via repro_torch.models.registry
(copies of the JAX package's `configs/`, imports rewritten)."""

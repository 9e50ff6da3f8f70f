"""Training of the cost model: AdamW (`optim`), the checkpoint format
shared with the JAX package (`checkpoint`) and the single-device
`CostModelTrainer` (`trainer`)."""

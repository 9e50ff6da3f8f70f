"""PyTorch/CUDA port of the learned TPU cost model, for an NVIDIA H100.

A package beside `repro` (the JAX reference), with subpackages that
mirror it: `core` (graph IR, features, GraphSAGE cost model, losses,
inference), `data` (synthetic corpus, fusion, batching, datasets,
samplers, the corpus store, the prefetching input pipeline), `nn`
(building blocks), `kernels` (hand-written CUDA kernels with their
plain PyTorch versions), `serving` (cache, coalescer,
`CostModelService`), `training` (AdamW, checkpoints,
`CostModelTrainer`), `search` (estimators, the search engine, MC-dropout
acquisition), `flywheel` (measure→store→fine-tune rounds) and `launch`
(CLIs). It imports torch and numpy, never jax, and nothing of `repro`.
"""

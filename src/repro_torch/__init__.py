"""PyTorch/CUDA port of the learned TPU cost model, for an NVIDIA H100.

A package beside `repro` (the JAX reference), with subpackages that
mirror it: `core` (graph IR, features, GraphSAGE cost model, inference),
`data` (synthetic corpus, fusion, batching), `nn` (building blocks),
`kernels` (hand-written CUDA kernels with their plain PyTorch versions),
`serving` (cache, coalescer, `CostModelService`) and `launch` (CLIs).
It imports torch and numpy, never jax, and nothing of `repro`.
"""

"""Hand-written CUDA kernels for Hopper (sm_90a), one per TPU kernel of the
reference on the serving path, each beside its plain PyTorch version:

  graph_aggregate   — fused dense GraphSAGE hop   (csrc/graph_aggregate.cu)
  segment_aggregate — fused sparse GraphSAGE hop  (csrc/segment_aggregate.cu)

Sources build with nvcc at first CUDA use (`build.py`) into
`kernels/build/`. Wrappers launch the kernel for CUDA tensors and run the
plain version for CPU tensors.
"""

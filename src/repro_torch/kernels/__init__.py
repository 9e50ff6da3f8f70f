"""Hand-written CUDA kernels for Hopper (sm_90a), one per TPU kernel of the
reference, each beside its plain PyTorch version:

  graph_aggregate   — fused dense GraphSAGE hop   (csrc/graph_aggregate.cu)
  segment_aggregate — fused sparse GraphSAGE hop  (csrc/segment_aggregate.cu)
  flash_attention   — forward attention of the LM zoo on the tensor
                      cores: bf16 (csrc/flash_attention_sm90.cu), f32 in
                      split TF32 (csrc/flash_attention_tf32.cu)
  ssd_scan          — Mamba2 inter-chunk state recurrence (csrc/ssd_scan.cu)

Sources build with nvcc at first CUDA use (`build.py`) into
`kernels/build/`. Wrappers launch the kernel for CUDA tensors and run the
plain version for CPU tensors. Each module's `block_candidates` lists
the tiles its kernel is built at, for the tile-size autotuner.
"""

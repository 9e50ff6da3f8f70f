"""Fused dense GraphSAGE aggregation: `out[b] = A[b] @ act(X[b] @ W)`.

Counterpart of `repro.kernels.graph_aggregate` (the Pallas TPU kernel
`graph_aggregate_bnd`). `graph_aggregate` launches the hand-written
CUDA kernel `csrc/graph_aggregate.cu` for CUDA tensors and runs the plain
PyTorch version `graph_aggregate_plain` for CPU tensors; any other device
raises. `launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0
_ACTS = ("relu", "none")


def graph_aggregate_plain(adj: torch.Tensor, x: torch.Tensor,
                          w: torch.Tensor, *, act: str = "relu",
                          mean: bool = True) -> torch.Tensor:
    """adj: [B,N,N] (adj[b,d,s]); x: [B,N,D]; w: [D,F] -> [B,N,F]."""
    msg = x @ w
    if act == "relu":
        msg = torch.relu(msg)
    agg = torch.bmm(adj, msg)
    if mean:
        agg = agg / torch.clamp(adj.sum(dim=-1, keepdim=True), min=1.0)
    return agg


def _lib():
    lib = build.load("graph_aggregate")
    if lib.graph_aggregate_f32.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.graph_aggregate_f32.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
        lib.graph_aggregate_f32.restype = i
        lib.graph_aggregate_smem_bytes.argtypes = [i]
        lib.graph_aggregate_smem_bytes.restype = i
    return lib


def graph_aggregate(adj: torch.Tensor, x: torch.Tensor, w: torch.Tensor, *,
                    act: str = "relu", mean: bool = True) -> torch.Tensor:
    """Fused transform+aggregate of one dense GraphSAGE hop; mean divides
    each row by max(rowsum(adj[b]), 1). All inputs fp32 on one device."""
    if act not in _ACTS:
        raise ValueError(f"act must be one of {_ACTS}, got {act!r}")
    if x.device.type == "cpu":
        return graph_aggregate_plain(adj, x, w, act=act, mean=mean)
    if x.device.type != "cuda":
        raise ValueError(f"graph_aggregate runs on cuda or cpu, not "
                         f"{x.device}")
    B, N, D = x.shape
    F = w.shape[1]
    for name, t, shape in (("adj", adj, (B, N, N)), ("x", x, (B, N, D)),
                           ("w", w, (D, F))):
        if (t.device != x.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"graph_aggregate: {name} must be a contiguous float32 "
                f"{shape} tensor on {x.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    lib = _lib()
    smem = lib.graph_aggregate_smem_bytes(N)
    limit = torch.cuda.get_device_properties(
        x.device).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"graph_aggregate: N={N} needs {smem} bytes of "
                         f"shared memory, the card allows {limit}")
    out = torch.empty((B, N, F), device=x.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.graph_aggregate_f32(adj.data_ptr(), x.data_ptr(),
                                  w.data_ptr(), out.data_ptr(), B, N, D, F,
                                  int(act == "relu"), int(mean), stream)
    if err:
        raise RuntimeError(f"graph_aggregate launch failed: CUDA error "
                           f"{err}")
    global launches
    launches += 1
    return out

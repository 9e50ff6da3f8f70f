"""Fused dense GraphSAGE aggregation: `out[b] = A[b] @ act(X[b] @ W)`.

Counterpart of `repro.kernels.graph_aggregate` (the Pallas TPU kernel
`graph_aggregate_bnd`). `graph_aggregate` launches the hand-written
CUDA kernel `csrc/graph_aggregate.cu` for CUDA tensors and runs the plain
PyTorch version `graph_aggregate_plain` for CPU tensors; any other device
raises, and so does a call in grad mode on an input that requires grad
(the kernel has no backward). `launches` counts kernel launches.
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


_fns = None
_scratch_bytes: dict[tuple, int] = {}  # (device, B, N, D, F) -> bytes


def _bind(lib):
    """(graph_aggregate_f32, graph_aggregate_scratch_bytes) of a loaded
    library, argument types set."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.graph_aggregate_f32.argtypes = [p] * 5 + [i] * 6 + [p]
    lib.graph_aggregate_f32.restype = i
    lib.graph_aggregate_scratch_bytes.argtypes = [i] * 4
    lib.graph_aggregate_scratch_bytes.restype = ctypes.c_longlong
    return lib.graph_aggregate_f32, lib.graph_aggregate_scratch_bytes


def _kernel():
    """The entry points of `csrc/graph_aggregate.cu`, set up once."""
    global _fns
    if _fns is None:
        _fns = _bind(build.load("graph_aggregate"))
    return _fns


def _check(name, t, shape, device) -> None:
    if not (t.dtype is torch.float32 and t.shape == shape
            and t.device == device and t.is_contiguous()):
        raise ValueError(
            f"graph_aggregate: {name} must be a contiguous float32 "
            f"{tuple(shape)} tensor on {device}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}")


def graph_aggregate(adj: torch.Tensor, x: torch.Tensor, w: torch.Tensor, *,
                    act: str = "relu", mean: bool = True) -> torch.Tensor:
    """Fused transform+aggregate of one dense GraphSAGE hop; mean divides
    each row by max(rowsum(adj[b]), 1). All inputs fp32 on one device
    (the kernel launches on it).
    On the card, graphs too large for the kernel to keep their messages
    on chip (N > 192 at D = 192) take a message scratch in device
    memory, allocated for the call."""
    if act not in _ACTS:
        raise ValueError(f"act must be one of {_ACTS}, got {act!r}")
    build.check_no_grad("graph_aggregate", "use_pallas_aggregate", adj=adj,
                        x=x, w=w)
    if x.device.type == "cpu":
        return graph_aggregate_plain(adj, x, w, act=act, mean=mean)
    if x.device.type != "cuda":
        raise ValueError(f"graph_aggregate runs on cuda or cpu, not "
                         f"{x.device}")
    build.check_one_device("graph_aggregate", adj=adj, x=x, w=w)
    B, N, D = x.shape
    F = w.shape[1]
    dev = x.device
    _check("adj", adj, (B, N, N), dev)
    _check("x", x, (B, N, D), dev)
    _check("w", w, (D, F), dev)
    fn, scratch_bytes = _kernel()
    key = (dev.index, B, N, D, F)
    nbytes = _scratch_bytes.get(key)
    if nbytes is None:
        nbytes = _scratch_bytes[key] = scratch_bytes(B, N, D, F)
    scratch = (torch.empty(nbytes // 4, device=dev, dtype=torch.float32)
               if nbytes else None)
    out = torch.empty((B, N, F), device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        err = fn(adj.data_ptr(), x.data_ptr(), w.data_ptr(), out.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), B, N, D,
                 F, act == "relu", mean,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"graph_aggregate launch failed: CUDA error "
                           f"{err}")
    global launches
    launches += 1
    return out

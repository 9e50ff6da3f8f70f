"""Fused sparse GraphSAGE aggregation over a packed edge list.

Counterpart of `repro.kernels.segment_aggregate` (the Pallas TPU kernel
`segment_aggregate_mf`):

    msg    = act((x * node_mask) @ (w * w_scale))
    out[d] = sum_{e: scatter[e] = d} edge_mask[e] * msg[gather[e]]
    mean:    divide by the masked in-degree, floored at 1

`segment_aggregate` launches the hand-written CUDA kernel
`csrc/segment_aggregate.cu` for CUDA tensors and runs the plain PyTorch
version `segment_aggregate_plain` for CPU tensors; any other device
raises. The kernel walks each destination's edges in CSR order, so the
caller groups the edges once per batch and direction with `edge_csr`
and reuses the result across hops. `launches` counts kernel launches
(one per call: the transform and the aggregation pass).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.kernels import build

launches = 0
_ACTS = ("relu", "none")


@dataclass(frozen=True)
class EdgeCSR:
    """A packed edge list, as given and grouped by destination.

    `gather`/`scatter`/`edge_mask` [E] are the edges in their own order
    (the plain version reads these). `src` (int32) and `weight` (float32)
    [E] are the same edges sorted stably by destination, with the edges
    whose mask is 0 (batch padding) moved past the last destination:
    destination d owns positions rowptr[d]..rowptr[d+1] of the [M+1]
    int32 `rowptr`, in the edges' original relative order, and no
    destination walks a masked edge (it would add 0 · msg)."""
    gather: torch.Tensor
    scatter: torch.Tensor
    edge_mask: torch.Tensor
    rowptr: torch.Tensor
    src: torch.Tensor
    weight: torch.Tensor


def edge_csr(gather: torch.Tensor, scatter: torch.Tensor,
             edge_mask: torch.Tensor, num_nodes: int) -> EdgeCSR:
    """Group edges by `scatter` (message read at `gather`, summed into
    `scatter`). Runs on the edges' device without a host sync."""
    scatter = scatter.long()
    # padding edges all point at node 0: walking them would serialise one
    # warp over most of the edge buffer, so they sort to the end instead
    key = torch.where(edge_mask != 0, scatter,
                      torch.full_like(scatter, num_nodes))
    order = torch.argsort(key, stable=True)
    counts = torch.zeros(num_nodes + 1, dtype=torch.int64,
                         device=scatter.device)
    counts.scatter_add_(0, key, torch.ones_like(key))
    rowptr = torch.zeros(num_nodes + 1, dtype=torch.int32,
                         device=scatter.device)
    rowptr[1:] = torch.cumsum(counts[:num_nodes], 0)
    return EdgeCSR(gather.long(), scatter, edge_mask.float(), rowptr,
                   gather[order].to(torch.int32).contiguous(),
                   edge_mask[order].to(torch.float32).contiguous())


def segment_aggregate_plain(x: torch.Tensor, w: torch.Tensor,
                            w_scale: torch.Tensor, gather: torch.Tensor,
                            scatter: torch.Tensor, edge_mask: torch.Tensor,
                            node_mask: torch.Tensor, *, act: str = "relu",
                            mean: bool = True) -> torch.Tensor:
    """x: [M,D]; w: [D,F]; w_scale: [F] or [1,F]; gather/scatter/
    edge_mask: [E]; node_mask: [M]. Returns [M,F] float32."""
    msg = (x * node_mask[:, None]) @ (w.float() * w_scale.reshape(1, -1))
    if act == "relu":
        msg = torch.relu(msg)
    M, F = msg.shape
    scatter = scatter.long()
    out = torch.zeros((M, F), dtype=msg.dtype, device=msg.device)
    out.index_add_(0, scatter, msg[gather.long()] * edge_mask[:, None])
    if mean:
        deg = torch.zeros((M,), dtype=msg.dtype, device=msg.device)
        deg.index_add_(0, scatter, edge_mask.to(msg.dtype))
        out = out / torch.clamp(deg, min=1.0)[:, None]
    return out


def _lib():
    lib = build.load("segment_aggregate")
    if lib.segment_aggregate_f32.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.segment_aggregate_f32.argtypes = [p] * 9 + [i] * 5 + [p]
        lib.segment_aggregate_f32.restype = i
    return lib


def segment_aggregate(x: torch.Tensor, w: torch.Tensor,
                      w_scale: torch.Tensor, edges: EdgeCSR,
                      node_mask: torch.Tensor, *, act: str = "relu",
                      mean: bool = True) -> torch.Tensor:
    """Fused transform+aggregate of one sparse GraphSAGE hop over
    `edges` (see `edge_csr`). fp32 weights with a per-channel scale."""
    if act not in _ACTS:
        raise ValueError(f"act must be one of {_ACTS}, got {act!r}")
    if x.device.type == "cpu":
        return segment_aggregate_plain(x, w, w_scale, edges.gather,
                                       edges.scatter, edges.edge_mask,
                                       node_mask, act=act, mean=mean)
    if x.device.type != "cuda":
        raise ValueError(f"segment_aggregate runs on cuda or cpu, not "
                         f"{x.device}")
    M, D = x.shape
    F = w.shape[1]
    E = edges.src.shape[0]
    scale = w_scale.reshape(-1)
    for name, t, shape, dtype in (
            ("x", x, (M, D), torch.float32), ("w", w, (D, F), torch.float32),
            ("w_scale", scale, (F,), torch.float32),
            ("node_mask", node_mask, (M,), torch.float32),
            ("rowptr", edges.rowptr, (M + 1,), torch.int32),
            ("src", edges.src, (E,), torch.int32),
            ("weight", edges.weight, (E,), torch.float32)):
        if (t.device != x.device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"segment_aggregate: {name} must be a contiguous {dtype} "
                f"{shape} tensor on {x.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    lib = _lib()
    msg = torch.empty((M, F), device=x.device, dtype=torch.float32)
    out = torch.empty((M, F), device=x.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.segment_aggregate_f32(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), node_mask.data_ptr(),
        edges.rowptr.data_ptr(), edges.src.data_ptr(),
        edges.weight.data_ptr(), msg.data_ptr(), out.data_ptr(), M, D, F,
        int(act == "relu"), int(mean), stream)
    if err:
        raise RuntimeError(f"segment_aggregate launch failed: CUDA error "
                           f"{err}")
    global launches
    launches += 1
    return out

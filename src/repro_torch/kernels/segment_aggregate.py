"""Fused sparse GraphSAGE aggregation over a packed edge list.

Counterpart of `repro.kernels.segment_aggregate` (the Pallas TPU kernel
`segment_aggregate_mf`):

    msg    = act((x * node_mask) @ (w * w_scale))
    out[d] = sum_{e: scatter[e] = d} edge_mask[e] * msg[gather[e]]
    mean:    divide by the masked in-degree, floored at 1

`segment_aggregate` launches the hand-written CUDA kernel
`csrc/segment_aggregate.cu` for CUDA tensors and runs the plain PyTorch
version `segment_aggregate_plain` for CPU tensors; any other device
raises, and so does a call in grad mode on an input that requires grad
(the kernel has no backward). The kernel has one entry point per
weight type, as the TPU kernel has one instantiation per type:
`segment_aggregate_f32` for a float32 `w` and `segment_aggregate_i8`
for an int8 `w` (the int8 serving path; `w_scale` holds its
per-channel scales). It walks each
destination's edges in CSR order, so the caller groups the edges once
per batch and direction with `edge_csr` and reuses the result across
hops. `launches` and `launches_i8` count the calls of the two variants
that launched the kernel (one per call, whether it took one launch or
two).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.kernels import build

launches = 0        # float32-weight variant
launches_i8 = 0     # int8-weight variant
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


_fns = None


def _bind(lib):
    """(segment_aggregate_f32, segment_aggregate_i8, the fused launch's
    largest M) of a loaded library, argument types set."""
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.segment_aggregate_f32, lib.segment_aggregate_i8):
        fn.argtypes = [p] * 9 + [i] * 5 + [p]
        fn.restype = i
    lib.segment_aggregate_fused_max_rows.restype = i
    return (lib.segment_aggregate_f32, lib.segment_aggregate_i8,
            lib.segment_aggregate_fused_max_rows())


def _kernel():
    """The entry points of `csrc/segment_aggregate.cu`, set up once."""
    global _fns
    if _fns is None:
        _fns = _bind(build.load("segment_aggregate"))
    return _fns


def _check(name, t, shape, dtype, device) -> None:
    if not (t.dtype is dtype and t.shape == shape and t.device == device
            and t.is_contiguous()):
        raise ValueError(
            f"segment_aggregate: {name} must be a contiguous {dtype} "
            f"{tuple(shape)} tensor on {device}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}")


def segment_aggregate(x: torch.Tensor, w: torch.Tensor,
                      w_scale: torch.Tensor, edges: EdgeCSR,
                      node_mask: torch.Tensor, *, act: str = "relu",
                      mean: bool = True) -> torch.Tensor:
    """Fused transform+aggregate of one sparse GraphSAGE hop over
    `edges` (see `edge_csr`). `w` is float32 or int8, with a float32
    per-channel scale `w_scale` ([F] or [1, F]). On the card, batches of
    up to 512 nodes take one launch (the kernel keeps the messages on
    chip); larger ones a transform and an aggregation launch with an
    [M, F] message scratch between them."""
    if act not in _ACTS:
        raise ValueError(f"act must be one of {_ACTS}, got {act!r}")
    build.check_no_grad("segment_aggregate", "use_pallas_aggregate", x=x,
                        w=w, w_scale=w_scale, node_mask=node_mask)
    if x.device.type == "cpu":
        return segment_aggregate_plain(x, w, w_scale, edges.gather,
                                       edges.scatter, edges.edge_mask,
                                       node_mask, act=act, mean=mean)
    if x.device.type != "cuda":
        raise ValueError(f"segment_aggregate runs on cuda or cpu, not "
                         f"{x.device}")
    build.check_one_device("segment_aggregate", x=x, w=w, w_scale=w_scale,
                           node_mask=node_mask, rowptr=edges.rowptr,
                           src=edges.src, weight=edges.weight)
    return _launch(x, w, w_scale, edges, node_mask, act, mean)


def _launch(x, w, w_scale, edges, node_mask, act, mean,
            two_launch: bool = False) -> torch.Tensor:
    """Checks the CUDA operands and launches the kernel: one launch where
    M allows it, else (or with `two_launch`, which `chip_smoke.py` uses to
    time the plan not taken) the transform and the aggregation with a
    message scratch between them."""
    int8 = w.dtype is torch.int8
    if not (int8 or w.dtype is torch.float32):
        raise ValueError(f"segment_aggregate: w must be a contiguous "
                         f"float32 or int8 tensor, got {w.dtype}")
    M, D = x.shape
    F = w.shape[1]
    E = edges.src.shape[0]
    scale = w_scale.reshape(-1)
    dev = x.device
    f32, i32 = torch.float32, torch.int32
    _check("x", x, (M, D), f32, dev)
    _check("w", w, (D, F), w.dtype, dev)
    _check("w_scale", scale, (F,), f32, dev)
    _check("node_mask", node_mask, (M,), f32, dev)
    _check("rowptr", edges.rowptr, (M + 1,), i32, dev)
    _check("src", edges.src, (E,), i32, dev)
    _check("weight", edges.weight, (E,), f32, dev)
    fn_f32, fn_i8, fused_max_rows = _kernel()
    out = torch.empty((M, F), device=dev, dtype=f32)
    msg = (torch.empty((M, F), device=dev, dtype=f32)
           if two_launch or M > fused_max_rows else None)
    with torch.cuda.device(dev):
        err = (fn_i8 if int8 else fn_f32)(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(),
            node_mask.data_ptr(), edges.rowptr.data_ptr(),
            edges.src.data_ptr(), edges.weight.data_ptr(),
            None if msg is None else msg.data_ptr(), out.data_ptr(), M, D,
            F, act == "relu", mean,
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"segment_aggregate launch failed: CUDA error "
                           f"{err}")
    global launches, launches_i8
    if int8:
        launches_i8 += 1
    else:
        launches += 1
    return out


def block_candidates(edge_capacity: int) -> list[int]:
    """block_e candidates for the tile-size autotuner. The reference's TPU
    kernel walks the packed edges in blocks of block_e (64..1024, its
    `ops.block_candidates`), each a one-hot matmul; this kernel walks
    each destination's row of a CSR (`edge_csr`) and has no edge block
    (csrc/segment_aggregate.cu). Its one candidate is the whole edge
    capacity, taken in one pass."""
    return [edge_capacity]

"""Int8 gradient compression with error feedback, over torch.distributed.

Counterpart of `repro.training.compression`. Gradients are quantized to
int8 with one scale per leaf, shared by every rank, before the
cross-rank sum, and each rank's quantization error is fed back into its
next step's gradient (error feedback keeps SGD/Adam convergence;
Karimireddy et al., 2019).

The algorithm per leaf g, on each rank of the data group:
  1. scale = all_reduce(max|g|, MAX) / 127
  2. q     = round(g / scale)  ∈ int8
  3. s     = all_reduce(q as int32, SUM)     (exact integer sum)
  4. ĝ     = s · scale / n                    (mean over the n ranks)
  5. e'    = g - q · scale                    (local error, fed back)

The reference takes one `pmax` and one `psum` per leaf. Here the leaves'
maxima travel as one float32 vector and their codes as one int32 vector,
two collectives a step whatever the number of leaves; the arithmetic is
elementwise, so every leaf's numbers are the per-leaf algorithm's. gloo
has no average, so the mean is a SUM followed by a division. The scale,
clip and round primitives are `repro_torch.quant.scale`'s, shared with
the weight quantizer.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.quant.scale import amax_scale, dequantize_int8, \
    quantize_int8
from repro_torch.training.optim import divide, tree_leaves, tree_map, \
    tree_unflatten


def compress_int8(g: torch.Tensor, scale: torch.Tensor):
    """Quantize with a given positive scale; returns (q_int8, local_error)."""
    q = quantize_int8(g, scale)
    return q, g - q.to(g.dtype) * scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return dequantize_int8(q, scale, dtype)


def compressed_allreduce(grads, error_feedback, group=None):
    """All-reduce `grads` (a tree of tensors) with int8 quantization and
    error feedback over the process group `group`. With `group=None` it
    is the identity algorithm on one device: it still quantizes, so the
    error-feedback arithmetic runs everywhere.

    Returns (the mean of the ranks' gradients, the new error feedback),
    both trees like `grads`."""
    g = [a + e for a, e in zip(tree_leaves(grads),
                               tree_leaves(error_feedback))]
    if not g:
        return grads, error_feedback
    amax = torch.stack([torch.max(torch.abs(x)) for x in g])
    if group is not None:
        dist.all_reduce(amax, dist.ReduceOp.MAX, group=group)
    scales = amax_scale(amax)
    q, err = zip(*(compress_int8(x, scales[i]) for i, x in enumerate(g)))
    s = torch.cat([c.reshape(-1).to(torch.int32) for c in q])
    n = 1
    if group is not None:
        dist.all_reduce(s, dist.ReduceOp.SUM, group=group)
        n = dist.get_world_size(group)
    red, start = [], 0
    for i, x in enumerate(g):
        part = s[start:start + x.numel()].view(x.shape)
        start += x.numel()
        red.append(divide(decompress_int8(part, scales[i], x.dtype), n))
    return tree_unflatten(grads, red), tree_unflatten(grads, list(err))


def zeros_like_error(params):
    return tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32,
                                               requires_grad=False), params)

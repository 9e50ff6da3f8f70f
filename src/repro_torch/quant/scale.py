"""Symmetric int8 scale math, in PyTorch.

Counterpart of `repro.quant.scale`: one home for
``clip(round(x / scale), -127, 127)`` in the port. The scheme maps
``x ≈ q * scale`` with ``q ∈ int8`` and no zero point: scales are always
positive (floored at 1e-12, so an all-zero channel quantizes to zeros),
zero is exactly representable, and dequantize∘quantize of an
already-quantized array is the identity. `torch.round` rounds half to
even, like `jnp.round`, and the division runs in float32, so `q` and
`scale` are bit-identical to the reference's on the same input.

`QuantizedLeaf` holds one quantized array: ``q`` (int8) plus its
broadcast-ready ``scale`` (float32). `CostModel` keeps the two as
buffers (state_dict keys ``….w.q`` / ``….w.scale``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

INT8_MAX = 127.0
_TINY = 1e-12       # scale floor: an all-zero channel quantizes to zeros


def amax_scale(amax) -> torch.Tensor:
    """Symmetric int8 scale for a (per-tensor or per-channel) abs-max.

    >>> float(amax_scale(torch.tensor(127.0)))
    1.0
    >>> float(amax_scale(torch.tensor(0.0))) > 0      # floored, never 0
    True
    """
    a = torch.as_tensor(amax, dtype=torch.float32)
    return torch.clamp(a / INT8_MAX, min=_TINY)


def quantize_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / scale), -127, 127)`` as int8 (`scale` broadcasts;
    round half to even).

    >>> q = quantize_int8(torch.tensor([1.0, -0.6, 300.0]), torch.tensor(1.0))
    >>> q.tolist(), q.dtype
    ([1, -1, 127], torch.int8)
    """
    q = torch.clamp(torch.round(x / scale), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    """``q * scale`` in `dtype`; exact inverse on quantized values."""
    return q.to(dtype) * scale


def per_channel_scale(w: torch.Tensor, *, channel_axis: int = -1
                      ) -> torch.Tensor:
    """Per-output-channel scales: abs-max over every axis except
    `channel_axis`, kept for broadcasting against `w`. For a dense
    ``w [in, out]`` one scale per output column, the layout the
    `segment_aggregate` kernel dequantizes as it stages the weight.

    >>> s = per_channel_scale(torch.tensor([[1.0, -8.0], [2.0, 4.0]]))
    >>> [round(float(v) * 127, 4) for v in s[0]]
    [2.0, 8.0]
    """
    axes = tuple(i for i in range(w.ndim) if i != channel_axis % w.ndim)
    return amax_scale(_amax(w, axes))


def _amax(x: torch.Tensor, axes: tuple) -> torch.Tensor:
    """|x| max-reduced over `axes`, kept; over no axis it is |x| itself
    (as `jnp.max(axis=())`; `torch.amax(dim=())` would reduce them all)."""
    return torch.amax(x.abs(), dim=axes, keepdim=True) if axes else x.abs()


@dataclass
class QuantizedLeaf:
    """One int8-quantized array: ``dequantize() == q * scale``."""
    q: torch.Tensor           # int8, the original array's shape
    scale: torch.Tensor       # float32, broadcastable against ``q``

    @property
    def shape(self):
        return self.q.shape

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return dequantize_int8(self.q, self.scale, dtype)

    @classmethod
    def quantize(cls, w: torch.Tensor, *, channel_axis: int = -1
                 ) -> "QuantizedLeaf":
        scale = per_channel_scale(w, channel_axis=channel_axis)
        return cls(quantize_int8(w, scale), scale)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def tree_is_quantized(tree) -> bool:
    """True iff any leaf of `tree` is a `QuantizedLeaf`."""
    return any(isinstance(x, QuantizedLeaf) for x in _leaves(tree))


def leaf_f32(x, dtype=torch.float32):
    """`QuantizedLeaf` → dequantized tensor; plain tensors pass through."""
    return x.dequantize(dtype) if isinstance(x, QuantizedLeaf) else x


def dequantize_tree(tree, dtype=torch.float32):
    """The float view of a (possibly) quantized parameter tree:
    `QuantizedLeaf`s become ``q * scale``, everything else passes
    through."""
    if isinstance(tree, dict):
        return {k: dequantize_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [dequantize_tree(v, dtype) for v in tree]
    return leaf_f32(tree, dtype)

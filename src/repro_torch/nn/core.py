"""Core building blocks: dense, embedding, layernorm, l2_normalize, MLP,
dropout.

Counterpart of `repro.nn.core`. Parameters are the same nested dicts of
leaves (`{"w": ...}`, `{"table": ...}`, `{"layers": [...]}`), here holding
`torch.Tensor`s; the forward code is plain functions on tensors.
Initialisers and dropout take an explicit `torch.Generator`.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch


# ----------------------------------------------------------------------------
# Initializers
# ----------------------------------------------------------------------------
def glorot(gen: torch.Generator, shape: tuple,
           dtype=torch.float32) -> torch.Tensor:
    """Glorot/Xavier uniform over the last two dims (or fan of whole shape)."""
    if len(shape) >= 2:
        fan_in, fan_out = shape[-2], shape[-1]
    else:
        fan_in = fan_out = shape[-1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=gen, dtype=dtype)
    return u * (2.0 * limit) - limit


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-6) -> torch.Tensor:
    # eps sits inside the rsqrt, as in the reference (not F.normalize)
    return x * torch.rsqrt(torch.sum(x * x, dim=dim, keepdim=True) + eps)


# ----------------------------------------------------------------------------
# Dense
# ----------------------------------------------------------------------------
def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, *,
               bias: bool = True, dtype=torch.float32) -> dict:
    params = {"w": glorot(gen, (in_dim, out_dim), dtype)}
    if bias:
        params["b"] = torch.zeros((out_dim,), dtype=dtype)
    return params


def dense_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ params["w"]
    if "b" in params:
        y = y + params["b"]
    return y


# ----------------------------------------------------------------------------
# Embedding
# ----------------------------------------------------------------------------
def embedding_init(gen: torch.Generator, vocab: int, dim: int, *,
                   stddev: float = 0.02, dtype=torch.float32) -> dict:
    return {"table": torch.randn((vocab, dim), generator=gen,
                                 dtype=dtype) * stddev}


def embedding_apply(params: dict, ids: torch.Tensor) -> torch.Tensor:
    return params["table"][ids.long()]


# ----------------------------------------------------------------------------
# Norms
# ----------------------------------------------------------------------------
def layernorm_init(dim: int, dtype=torch.float32) -> dict:
    return {"scale": torch.ones((dim,), dtype=dtype),
            "bias": torch.zeros((dim,), dtype=dtype)}


def layernorm_apply(params: dict, x: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    # eps 1e-6 as in the reference (torch's LayerNorm default is 1e-5)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    y = (x - mu) * torch.rsqrt(var + eps)
    return y * params["scale"] + params["bias"]


# ----------------------------------------------------------------------------
# MLP stack (used heavily by the cost model: f1, f2^k, f3^k, heads)
# ----------------------------------------------------------------------------
def mlp_init(gen: torch.Generator, dims: Sequence[int], *,
             bias: bool = False, dtype=torch.float32) -> dict:
    """A stack of Dense layers: dims = [in, h1, ..., out]."""
    return {"layers": [dense_init(gen, dims[i], dims[i + 1], bias=bias,
                                  dtype=dtype)
                       for i in range(len(dims) - 1)]}


def mlp_apply(params: dict, x: torch.Tensor, *,
              act: Callable = torch.relu,
              final_act: bool = False) -> torch.Tensor:
    n = len(params["layers"])
    for i, layer in enumerate(params["layers"]):
        x = dense_apply(layer, x)
        if i < n - 1 or final_act:
            x = act(x)
    return x


# ----------------------------------------------------------------------------
# Dropout (explicit generator, identity unless training)
# ----------------------------------------------------------------------------
def dropout(x: torch.Tensor, rate: float, *,
            generator: torch.Generator | None,
            training: bool) -> torch.Tensor:
    """Inverted dropout: keep each element with probability 1 - rate and
    scale the kept ones by 1 / (1 - rate). The identity when not
    training, when rate <= 0 or when no generator is given. The generator
    must live on `x`'s device."""
    if not training or rate <= 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))

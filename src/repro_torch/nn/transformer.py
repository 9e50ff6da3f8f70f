"""Transformer encoder used as a kernel-embedding reduction (paper §3.2).

Counterpart of `repro.nn.transformer`: pre-norm encoder blocks with masked
multi-head self-attention over node embeddings, in plain tensor ops.
Dropout on the attention branch runs only when training with a
generator (`nn.core.dropout`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.nn.core import (
    dense_apply,
    dense_init,
    dropout,
    layernorm_apply,
    layernorm_init,
)


def mha_init(gen: torch.Generator, dim: int, num_heads: int,
             dtype=torch.float32) -> dict:
    if dim % num_heads:
        raise ValueError(f"dim {dim} not divisible by {num_heads} heads")
    return {name: dense_init(gen, dim, dim, bias=False, dtype=dtype)
            for name in ("q", "k", "v", "o")}


def mha_apply(params: dict, x: torch.Tensor, mask: torch.Tensor | None,
              num_heads: int) -> torch.Tensor:
    """x: [B, N, D]; mask: [B, N] validity (1=real node)."""
    B, N, D = x.shape
    H = num_heads
    hd = D // H
    q = dense_apply(params["q"], x).reshape(B, N, H, hd)
    k = dense_apply(params["k"], x).reshape(B, N, H, hd)
    v = dense_apply(params["v"], x).reshape(B, N, H, hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(float(hd))
    if mask is not None:
        # the finite dtype minimum, not -inf: an all-masked row stays a
        # uniform softmax, exactly as in the reference
        neg = torch.finfo(logits.dtype).min
        logits = torch.where(mask[:, None, None, :] > 0, logits,
                             torch.full_like(logits, neg))
    attn = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, N, D)
    return dense_apply(params["o"], out)


def encoder_init(gen: torch.Generator, dim: int, num_heads: int,
                 num_layers: int, mlp_factor: int = 4,
                 dtype=torch.float32) -> dict:
    blocks = []
    for _ in range(num_layers):
        blocks.append({
            "ln1": layernorm_init(dim, dtype),
            "attn": mha_init(gen, dim, num_heads, dtype),
            "ln2": layernorm_init(dim, dtype),
            "fc1": dense_init(gen, dim, mlp_factor * dim, bias=True,
                              dtype=dtype),
            "fc2": dense_init(gen, mlp_factor * dim, dim, bias=True,
                              dtype=dtype),
        })
    return {"blocks": blocks, "ln_f": layernorm_init(dim, dtype)}


def encoder_apply(params: dict, x: torch.Tensor, mask: torch.Tensor | None,
                  num_heads: int, *, dropout_rate: float = 0.0,
                  generator: torch.Generator | None = None,
                  training: bool = False) -> torch.Tensor:
    """Returns per-node encodings [B, N, D] (reduction handled by caller)."""
    for blk in params["blocks"]:
        h = mha_apply(blk["attn"], layernorm_apply(blk["ln1"], x), mask,
                      num_heads)
        x = x + dropout(h, dropout_rate, generator=generator,
                        training=training)
        h = dense_apply(blk["fc1"], layernorm_apply(blk["ln2"], x))
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(h, approximate="tanh")
        x = x + dense_apply(blk["fc2"], h)
    return layernorm_apply(params["ln_f"], x)

"""Node-embedding → kernel-embedding reductions (paper §3.2).

Counterpart of `repro.core.reductions`, all mask-aware:
  * per-node:     scalar head per node, summed (handled in `core.model`)
  * column-wise:  concat(masked mean, masked max) — Table 5's fixed choice
  * LSTM:         final state over topologically sorted node embeddings
  * Transformer:  encoder over node embeddings, sum-reduced (Table 5)
"""
from __future__ import annotations

import torch

from repro_torch.nn.lstm import lstm_apply, lstm_init
from repro_torch.nn.transformer import encoder_apply, encoder_init


def reduction_init(gen: torch.Generator, kind: str, dim: int, *,
                   transformer_layers: int = 1, transformer_heads: int = 4,
                   dtype=torch.float32) -> dict:
    if kind in ("per_node", "column_wise"):
        return {}
    if kind == "lstm":
        return {"lstm": lstm_init(gen, dim, dim, dtype)}
    if kind == "transformer":
        return {"encoder": encoder_init(gen, dim, transformer_heads,
                                        transformer_layers, dtype=dtype)}
    raise ValueError(f"unknown reduction {kind!r}")


def reduction_out_dim(kind: str, dim: int) -> int:
    if kind == "column_wise":
        return 2 * dim
    if kind == "per_node":
        return 0      # per-node predicts directly; no kernel embedding
    return dim


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    s = torch.sum(x * mask[..., None], dim=1)
    n = torch.clamp(torch.sum(mask, dim=1, keepdim=True), min=1.0)
    return s / n


def masked_max(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    neg = torch.finfo(x.dtype).min
    xm = torch.where(mask[..., None] > 0, x, torch.full_like(x, neg))
    return torch.amax(xm, dim=1)


def reduction_apply(params: dict, kind: str, eps: torch.Tensor,
                    node_mask: torch.Tensor, *,
                    transformer_heads: int = 4, dropout_rate: float = 0.0,
                    generator: torch.Generator | None = None,
                    training: bool = False) -> torch.Tensor:
    """eps: [B, N, D] -> kernel embedding [B, out_dim]. Dropout (the
    Transformer's attention branch) runs only when training."""
    if kind == "column_wise":
        return torch.cat([masked_mean(eps, node_mask),
                          masked_max(eps, node_mask)], dim=-1)
    if kind == "lstm":
        return lstm_apply(params["lstm"], eps, node_mask)
    if kind == "transformer":
        enc = encoder_apply(params["encoder"], eps, node_mask,
                            transformer_heads, dropout_rate=dropout_rate,
                            generator=generator, training=training)
        return torch.sum(enc * node_mask[..., None], dim=1)   # Table 5: sum
    raise ValueError(f"unknown reduction {kind!r}")

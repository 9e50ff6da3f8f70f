"""LSTM used for the paper's sequence reduction (topo-sorted node
embeddings).

Counterpart of `repro.nn.lstm`: the same parameter tree (`wx` [in, 4h],
`wh` [h, 4h], `b` [4h], gates in the order i, f, g, o, +1.0 on the
forget gate's pre-activation) and a validity mask so padded nodes leave
the state unchanged. The reference's `lax.scan` is a Python loop over
the sequence axis here: one step's handful of launches per element.
"""
from __future__ import annotations

import torch

from repro_torch.nn.core import glorot


def lstm_init(gen: torch.Generator, in_dim: int, hidden: int,
              dtype=torch.float32) -> dict:
    return {
        "wx": glorot(gen, (in_dim, 4 * hidden), dtype),
        "wh": glorot(gen, (hidden, 4 * hidden), dtype),
        "b": torch.zeros((4 * hidden,), dtype=dtype),
    }


def lstm_cell(params: dict, carry, x: torch.Tensor):
    """One step. carry = (h, c); x: [B, in_dim]."""
    h, c = carry
    gates = x @ params["wx"] + h @ params["wh"] + params["b"]
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    i = torch.sigmoid(i)
    f = torch.sigmoid(f + 1.0)  # forget-gate bias init trick
    g = torch.tanh(g)
    o = torch.sigmoid(o)
    c_new = f * c + i * g
    h_new = o * torch.tanh(c_new)
    return (h_new, c_new)


def lstm_apply(params: dict, xs: torch.Tensor,
               mask: torch.Tensor | None = None) -> torch.Tensor:
    """Run over sequence axis 1. xs: [B, T, in_dim]; mask: [B, T] (1=valid).

    Returns the final hidden state [B, hidden], where masked (padded)
    steps leave the state unchanged, so the "final" state is the state
    after the last *valid* element even with right-padding. The blend is
    m·new + (1 − m)·old, as in the reference (not a select), so a NaN or
    inf propagates the same way.
    """
    B, T, _ = xs.shape
    hidden = params["wh"].shape[0]
    h = xs.new_zeros((B, hidden))
    c = xs.new_zeros((B, hidden))
    if mask is None:
        mask = xs.new_ones((B, T))
    mask = mask.to(xs.dtype)
    for t in range(T):
        h_new, c_new = lstm_cell(params, (h, c), xs[:, t])
        m = mask[:, t, None]
        h = m * h_new + (1 - m) * h
        c = m * c_new + (1 - m) * c
    return h

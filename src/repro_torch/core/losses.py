"""Training objectives (paper §3.3), in PyTorch.

Counterpart of `repro.core.losses`.

* Tile-size task: pairwise rank loss, Eq. (1) —
    L = Σ_i Σ_j φ(y'_i − y'_j) · pos(y_i − y_j) / (n(n−1)/2)
  with φ = hinge (1−z)_+ or logistic log(1+e^(−z)). Pairs are only compared
  within the same ranking group (same kernel, different tile sizes) — group
  ids mask cross-kernel pairs.

* Fusion task: squared error on log-transformed targets (runtimes span ns→s).
"""
from __future__ import annotations

import torch


def _phi(z: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "hinge":
        return torch.relu(1.0 - z)
    if kind == "logistic":
        # as the reference writes it (softplus thresholds differently)
        return torch.log1p(torch.exp(-z))
    raise ValueError(f"unknown rank loss {kind!r}")


def pairwise_rank_loss(preds: torch.Tensor, targets: torch.Tensor,
                       group_ids: torch.Tensor | None = None,
                       valid: torch.Tensor | None = None,
                       *, phi: str = "hinge") -> torch.Tensor:
    """preds/targets: [n]. group_ids: [n] int — pairs must share a group.

    pos(y_i - y_j) selects pairs where i is truly slower than j; the model is
    pushed to predict y'_i > y'_j for those (φ penalizes small/negative
    margins y'_i − y'_j).
    """
    n = preds.shape[0]
    dz = preds[:, None] - preds[None, :]
    dy = targets[:, None] - targets[None, :]
    pair = (dy > 0).to(preds.dtype)
    if group_ids is not None:
        pair = pair * (group_ids[:, None] == group_ids[None, :]).to(
            preds.dtype)
    if valid is not None:
        v = valid.to(preds.dtype)
        pair = pair * v[:, None] * v[None, :]
    pair = pair * (1.0 - torch.eye(n, dtype=preds.dtype,
                                   device=preds.device))
    loss = torch.sum(_phi(dz, phi) * pair)
    return loss / (n * (n - 1) / 2.0)


def _masked_mean(err: torch.Tensor, valid: torch.Tensor | None):
    if valid is None:
        return torch.mean(err)
    v = valid.to(err.dtype)
    return torch.sum(err * v) / torch.clamp(torch.sum(v), min=1.0)


def log_mse_loss(preds: torch.Tensor, targets: torch.Tensor,
                 valid: torch.Tensor | None = None,
                 *, eps: float = 1e-12) -> torch.Tensor:
    """preds are log-runtime estimates; targets are raw runtimes (seconds)."""
    return _masked_mean((preds - torch.log(targets + eps)) ** 2, valid)


def mse_loss(preds: torch.Tensor, targets: torch.Tensor,
             valid: torch.Tensor | None = None) -> torch.Tensor:
    """Plain MSE on raw targets — the 'MSE loss (not rank)' ablation row."""
    return _masked_mean((preds - targets) ** 2, valid)

"""AdamW + gradient clipping + LR schedules, in PyTorch.

Counterpart of `repro.training.optim` (not `torch.optim.AdamW`): the same
global-norm clip with its `max(gn, 1e-12)` floor, the bias correction as
`1 / (1 - b^step)`, weight decay added to the update before the learning
rate, and the constant, exponential and cosine schedules with a linear
warmup, computed in float32. Parameters, gradients and the moments are
nested dicts/lists of tensors, the optimizer state is
`{"m": tree, "v": tree, "step": int32 scalar}` keyed like the parameter
tree, so it checkpoints as the reference's does. The step counter and
the learning rate live on the CPU (no device round trip per step).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip_norm: float | None = 1.0      # None = no clipping
    schedule: str = "exponential"            # constant | exponential | cosine
    lr_decay: float = 0.99                   # per decay_every steps
    decay_every: int = 10_000
    warmup_steps: int = 0
    total_steps: int = 100_000               # cosine horizon


def tree_map(fn, tree, *rest):
    """`fn` over the leaves of nested dicts/lists (structure of `tree`)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in the reference's flatten order: dict keys sorted, list
    items in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def schedule_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step_f = step.to(torch.float32)
    if cfg.warmup_steps > 0:
        warm = torch.clamp(step_f / cfg.warmup_steps, max=1.0)
    else:
        warm = _f32(1.0)
    if cfg.schedule == "constant":
        base = _f32(cfg.lr)
    elif cfg.schedule == "exponential":
        base = cfg.lr * torch.pow(_f32(cfg.lr_decay),
                                  step_f / cfg.decay_every)
    elif cfg.schedule == "cosine":
        frac = torch.clamp(step_f / max(cfg.total_steps, 1), 0.0, 1.0)
        base = cfg.lr * 0.5 * (1.0 + torch.cos(math.pi * frac))
    else:
        raise ValueError(f"unknown schedule {cfg.schedule!r}")
    return base * warm


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    gn = global_norm(tree)
    # a tensor numerator: `float / tensor` would take a reciprocal first
    scale = torch.clamp(_f32(max_norm) / torch.clamp(gn, min=1e-12), max=1.0)
    return tree_map(lambda x: x * scale, tree), gn


def adamw_init(params) -> dict:
    zeros = tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32,
                                                requires_grad=False),
                     params)
    return {"m": zeros, "v": tree_map(torch.zeros_like, zeros),
            "step": torch.zeros((), dtype=torch.int32)}


def adamw_update(params, grads, state, cfg: AdamWConfig):
    """Returns (new_params, new_state, stats); `stats` holds `lr` and
    `grad_norm` (taken before the clip). Pure: nothing is updated in
    place. Run it under `torch.no_grad()`."""
    step = state["step"] + 1
    lr = schedule_lr(cfg, step)
    gn = global_norm(grads)
    if cfg.grad_clip_norm is not None:
        grads, _ = clip_by_global_norm(grads, cfg.grad_clip_norm)

    b1, b2 = cfg.b1, cfg.b2
    m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(torch.float32),
                 state["m"], grads)
    v = tree_map(lambda v_, g: b2 * v_
                 + (1 - b2) * torch.square(g.to(torch.float32)),
                 state["v"], grads)
    step_f = step.to(torch.float32)
    mhat_scale = 1.0 / (1.0 - torch.pow(_f32(b1), step_f))
    vhat_scale = 1.0 / (1.0 - torch.pow(_f32(b2), step_f))

    def upd(p, m_, v_):
        u = (m_ * mhat_scale) / (torch.sqrt(v_ * vhat_scale) + cfg.eps)
        if cfg.weight_decay > 0:
            u = u + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * u).to(p.dtype)

    new_params = tree_map(upd, params, m, v)
    return new_params, {"m": m, "v": v, "step": step}, \
        {"lr": lr, "grad_norm": gn}

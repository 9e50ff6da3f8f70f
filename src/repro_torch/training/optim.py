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

`adamw_update` is pure, as the reference's, and the tests' reference
for `adamw_update_`, the twin that the trainers run: JAX donates the old
buffers to the new ones, PyTorch cannot, so it writes the parameters and
moments in place, one leaf at a time and a stacked leaf one layer at a
time, with the same operations in the same order — bit for bit the pure
update's result (`tests/test_torch_lm_train.py`). At the LM zoo's full
width the pure update would not fit on the card beside the moments.
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


def tree_leaves_up_to(like, tree) -> list:
    """The nodes of `tree` that sit where `like` has its leaves, in
    `tree_leaves(like)`'s order (a node may itself be a dict, as an
    optimizer's per-leaf state is)."""
    if isinstance(like, dict):
        return [x for k in sorted(like)
                for x in tree_leaves_up_to(like[k], tree[k])]
    if isinstance(like, (list, tuple)):
        return [x for i, v in enumerate(like)
                for x in tree_leaves_up_to(v, tree[i])]
    return [tree]


def tree_unflatten(like, leaves):
    """`like`'s structure with `leaves` (in `tree_leaves(like)`'s order)
    in place of its leaves."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    return build(like)


def divide(x: torch.Tensor, n: int) -> torch.Tensor:
    """x / n as a true division, as the reference's: given a CPU scalar,
    a CUDA kernel multiplies by its reciprocal, which rounds otherwise
    (n = 3, say)."""
    return x / torch.full((), n, dtype=x.dtype, device=x.device)


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


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    # a tensor numerator: `float / tensor` would take a reciprocal first
    return torch.clamp(_f32(max_norm) / torch.clamp(gn, min=1e-12), max=1.0)


def clip_by_global_norm(tree, max_norm: float):
    """Every leaf times min(1, max_norm / global norm), in float32: as in
    the reference, where a bf16 leaf times the f32 scale promotes."""
    gn = global_norm(tree)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda x: x.to(torch.float32) * scale, tree), gn


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


def _layers(t: torch.Tensor) -> list[torch.Tensor]:
    """A stacked leaf ([layers, ...], ndim >= 3) as views of one layer
    each; any other leaf whole. Elementwise work on the views gives the
    whole leaf's bits with a layer's worth of temporaries."""
    return list(t) if t.ndim >= 3 else [t]


def adamw_update_(params, grads, state, cfg: AdamWConfig):
    """`adamw_update` in place: writes the new parameters into `params`
    and the new moments into `state["m"]`, `state["v"]`, and returns
    (params, state, stats) with the same bits as the pure update. Run it
    under `torch.no_grad()`. `grads` is read, not written."""
    step = state["step"] + 1
    lr = schedule_lr(cfg, step)
    gn = global_norm(grads)
    scale = (_clip_scale(gn, cfg.grad_clip_norm)
             if cfg.grad_clip_norm is not None else None)
    b1, b2 = cfg.b1, cfg.b2
    step_f = step.to(torch.float32)
    mhat_scale = 1.0 / (1.0 - torch.pow(_f32(b1), step_f))
    vhat_scale = 1.0 / (1.0 - torch.pow(_f32(b2), step_f))
    for leaf in zip(tree_leaves(params), tree_leaves(grads),
                    tree_leaves(state["m"]), tree_leaves(state["v"])):
        for p, g, m, v in zip(*map(_layers, leaf)):
            g = g.to(torch.float32)
            if scale is not None:
                g = g * scale
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_(torch.square(g).mul_(1 - b2))
            del g
            u = m * mhat_scale
            u.div_(torch.sqrt(v * vhat_scale).add_(cfg.eps))
            if cfg.weight_decay > 0:
                u.add_(cfg.weight_decay * p.to(torch.float32))
            u.mul_(lr)
            if p.dtype == torch.float32:
                p.sub_(u)
            else:
                p.copy_(p.to(torch.float32).sub_(u))
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": gn}

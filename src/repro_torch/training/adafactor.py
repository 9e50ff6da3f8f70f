"""Adafactor (Shazeer & Stern, 2018), simplified, in PyTorch.

Counterpart of `repro.training.adafactor`: a factored second moment and
no first moment. State per leaf with ndim >= 2: row and column factors
of the second moment (O(n + m) instead of O(nm)); per 1-D leaf: the full
second moment. The update is RMS-clipped and scaled by the parameter's
RMS, as in the paper; beta2 rises as 1 - step^-0.8, capped at
`beta2_base`. The state is `{"factored": tree, "step": int32 scalar}`,
keyed like the parameter tree; `factored` holds one dict a leaf
(`{"v_row", "v_col"}` or `{"v"}`), float32, on the leaf's device.

`adafactor_update` is pure; `adafactor_update_` writes the parameters
and the factors in place, with the same operations in the same order, so
its bits are the pure update's (`tests/test_torch_lm_train.py`). The
RMS clip is a mean over the whole leaf, so, unlike AdamW's, this update
cannot walk a stacked leaf layer by layer: its temporaries are a few
copies of the largest leaf in float32.
"""
from __future__ import annotations

import torch

from repro_torch.training.optim import tree_leaves, tree_leaves_up_to, \
    tree_map, tree_unflatten

_EPS1 = 1e-30
_EPS2 = 1e-3


def _leaf_init(p: torch.Tensor) -> dict:
    if p.ndim >= 2:
        return {"v_row": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                     device=p.device),
                "v_col": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                     dtype=torch.float32, device=p.device)}
    return {"v": torch.zeros(p.shape, dtype=torch.float32, device=p.device)}


def adafactor_init(params) -> dict:
    return {"factored": tree_map(_leaf_init, params),
            "step": torch.zeros((), dtype=torch.int32)}


def _beta2(step: torch.Tensor, beta2_base: float) -> torch.Tensor:
    # the paper's increasing-beta2 schedule
    beta2 = 1.0 - torch.pow(step.to(torch.float32), -0.8)
    return torch.clamp(beta2, max=beta2_base)


def _leaf_update(p, g, s, beta2, lr: float, clip_threshold: float = 1.0):
    g = g.to(torch.float32)
    g2 = torch.square(g) + _EPS1
    if p.ndim >= 2:
        v_row = beta2 * s["v_row"] + (1 - beta2) * torch.mean(g2, dim=-1)
        v_col = beta2 * s["v_col"] + (1 - beta2) * torch.mean(g2, dim=-2)
        row_mean = torch.mean(v_row, dim=-1, keepdim=True)
        r = v_row / torch.clamp(row_mean, min=_EPS1)
        u = g * torch.rsqrt(r[..., None] * v_col[..., None, :] + _EPS1)
        new_s = {"v_row": v_row, "v_col": v_col}
    else:
        v = beta2 * s["v"] + (1 - beta2) * g2
        u = g * torch.rsqrt(v + _EPS1)
        new_s = {"v": v}
    rms = torch.sqrt(torch.mean(torch.square(u)) + _EPS1)
    u = u / torch.clamp(rms / clip_threshold, min=1.0)
    p32 = p.to(torch.float32)
    scale = torch.clamp(torch.sqrt(torch.mean(torch.square(p32))),
                        min=_EPS2)
    return (p32 - lr * scale * u).to(p.dtype), new_s


def _leaf_update_(p, g, s, beta2, lr: float,
                  clip_threshold: float = 1.0) -> None:
    """`_leaf_update` written into `p` and `s`, freeing each temporary
    as soon as the pure version's expression is done with it."""
    g = g.to(torch.float32)
    g2 = torch.square(g).add_(_EPS1)
    if p.ndim >= 2:
        row = torch.mean(g2, dim=-1)
        col = torch.mean(g2, dim=-2)
        del g2
        s["v_row"].mul_(beta2).add_((1 - beta2) * row)
        s["v_col"].mul_(beta2).add_((1 - beta2) * col)
        v_row, v_col = s["v_row"], s["v_col"]
        row_mean = torch.mean(v_row, dim=-1, keepdim=True)
        r = v_row / torch.clamp(row_mean, min=_EPS1)
        u = r[..., None] * v_col[..., None, :]
        u.add_(_EPS1).rsqrt_().mul_(g)
    else:
        s["v"].mul_(beta2).add_((1 - beta2) * g2)
        del g2
        u = torch.rsqrt(s["v"] + _EPS1).mul_(g)
    del g
    rms = torch.sqrt(torch.mean(torch.square(u)) + _EPS1)
    u.div_(torch.clamp(rms / clip_threshold, min=1.0))
    p32 = p.to(torch.float32)
    scale = torch.clamp(torch.sqrt(torch.mean(torch.square(p32))),
                        min=_EPS2)
    u.mul_(lr * scale)
    if p.dtype == torch.float32:
        p.sub_(u)
    else:
        p.copy_(p32.sub_(u))


def _stats(grads, lr: float) -> dict:
    return {"lr": torch.tensor(lr, dtype=torch.float32),
            "grad_norm": torch.sqrt(sum(
                torch.sum(torch.square(g.to(torch.float32)))
                for g in tree_leaves(grads)))}


def adafactor_update(params, grads, state, *, lr: float = 1e-2,
                     beta2_base: float = 0.999):
    """Returns (new_params, new_state, stats) with stats `lr` and
    `grad_norm`. Pure. Run it under `torch.no_grad()`."""
    step = state["step"] + 1
    beta2 = _beta2(step, beta2_base)
    out = [_leaf_update(p, g, s, beta2, lr) for p, g, s in zip(
        tree_leaves(params), tree_leaves(grads),
        tree_leaves_up_to(params, state["factored"]))]
    return (tree_unflatten(params, [o[0] for o in out]),
            {"factored": tree_unflatten(params, [o[1] for o in out]),
             "step": step},
            _stats(grads, lr))


def adafactor_update_(params, grads, state, *, lr: float = 1e-2,
                      beta2_base: float = 0.999):
    """`adafactor_update` in place: the new parameters go into `params`,
    the new factors into `state["factored"]`; returns (params, state,
    stats) with the pure update's bits. Run it under `torch.no_grad()`."""
    step = state["step"] + 1
    beta2 = _beta2(step, beta2_base)
    stats = _stats(grads, lr)
    for p, g, s in zip(tree_leaves(params), tree_leaves(grads),
                       tree_leaves_up_to(params, state["factored"])):
        _leaf_update_(p, g, s, beta2, lr)
    state["step"] = step
    return params, state, stats

"""GPipe-style pipeline parallelism over a torch.distributed group.

Counterpart of `repro.training.pipeline`. Stage s (the rank's index in
the group) holds its own slice of the layer stack; microbatch m flows
through stage s at schedule step t = s + m, so a run takes
T = S + M - 1 steps for S stages and M microbatches; activations hop
from stage s to s + 1 by point-to-point sends (`lax.ppermute` in the
reference). The bubble is the usual (S - 1) / (M + S - 1). At the end
the final stage's outputs are summed over the group, as the reference's
closing `psum` does, so every rank returns them.

Every rank runs the same schedule: stage 0 reads microbatch
min(t, M - 1) at step t, the others the activation received from the
stage before (zeros at their first step, as `ppermute` delivers to the
stage nothing sends to), and only the last stage's outputs of steps
S - 1 .. S + M - 2 are kept.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.training.optim import tree_map


def pipeline_apply(stage_fn, stage_params, x_micro: torch.Tensor,
                   group=None) -> torch.Tensor:
    """Run a pipeline of `n_stages = size of group` stages.

    stage_fn(params_slice, x) -> y with y.shape == x.shape (inter-stage
    activations are homogeneous).
    stage_params: a tree with leading dim n_stages on every leaf
    (`pipeline_stage_split`); this rank uses slice [its rank in group].
    x_micro: [M, mb, ...] microbatched input, the same on every rank.
    Returns the final stage's outputs [M, mb, ...] on every rank.
    """
    n_stages = dist.get_world_size(group)
    stage = dist.get_rank(group)
    M = x_micro.shape[0]
    T = n_stages + M - 1
    params = tree_map(lambda a: a[stage], stage_params)

    def peer(s: int) -> int:
        return s if group is None else dist.get_global_rank(group, s)

    buf = torch.zeros_like(x_micro[0])
    outs = torch.zeros_like(x_micro)
    for t in range(T):
        inp = x_micro[min(t, M - 1)] if stage == 0 else buf
        y = stage_fn(params, inp)
        m = t - (n_stages - 1)
        if stage == n_stages - 1 and 0 <= m < M:
            outs[m] = y
        reqs = []
        if stage < n_stages - 1:
            reqs.append(dist.isend(y.contiguous(), peer(stage + 1),
                                   group=group))
        if stage > 0:
            buf = torch.empty_like(x_micro[0])
            reqs.append(dist.irecv(buf, peer(stage - 1), group=group))
        for req in reqs:
            req.wait()
    if n_stages > 1:
        dist.all_reduce(outs, dist.ReduceOp.SUM, group=group)
    return outs


def pipeline_stage_split(params_stacked, n_stages: int):
    """Split a [L, ...]-stacked layer tree into [n_stages, L/S, ...]."""
    def one(a):
        L = a.shape[0]
        if L % n_stages:
            raise ValueError(f"{L} layers do not split into {n_stages} "
                             "stages")
        return a.reshape((n_stages, L // n_stages) + tuple(a.shape[1:]))
    return tree_map(one, params_stacked)

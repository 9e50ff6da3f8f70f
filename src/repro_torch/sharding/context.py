"""Activation-sharding context: the port of `repro.sharding.context`.

Model code stays mesh-agnostic: it calls `constrain(x, name)` at key points
(post-embedding, block outputs, MoE dispatch buffers, microbatch split).
When a launcher wraps a step in `activation_sharding(mapping)`, those calls
redistribute a DTensor to the named placement (the reference's
`with_sharding_constraint`); otherwise, and for a plain tensor, they are
the identity. The mapping values are specs (tuples, as in
`sharding.partition`) or rank-indexed spec factories; the special keys
are "dp" (the data-parallel axis or axes) and "axis_sizes". A DTensor's
own mesh places it.

The reference's `shard_map_nocheck` is a jax spelling shim; its callers
(the compressed all-reduce, the pipeline) run over `torch.distributed`
in the port, so it has no counterpart.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

import torch
from torch.utils import _pytree as pytree

_CTX = threading.local()


@contextmanager
def activation_sharding(mapping: dict):
    """mapping: name -> spec | callable(rank)->spec. Special key 'dp': the
    data-parallel mesh axis (str or tuple) used for batch/microbatch
    constraints."""
    prev = getattr(_CTX, "map", None)
    _CTX.map = mapping
    try:
        yield
    finally:
        _CTX.map = prev


def _lookup(name: str):
    m = getattr(_CTX, "map", None)
    if not m:
        return None
    return m.get(name)


def dp_axes():
    """The data-parallel axis name(s), or None outside a context."""
    return _lookup("dp")


def _axis_size(axes) -> int:
    sizes = _lookup("axis_sizes") or {}
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= sizes.get(a, 1)
    return n


def _divides(shape, spec) -> bool:
    for dim, axes in zip(shape, tuple(spec)):
        if axes is not None and dim % _axis_size(axes) != 0:
            return False
    return True


def _is_dtensor(x) -> bool:
    if not isinstance(x, torch.Tensor) or type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _redistribute(x, spec):
    from repro_torch.sharding.partition import to_placements
    placements = to_placements(spec, x.device_mesh)
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def constrain(x, name: str):
    spec = _lookup(name)
    if spec is None or not _is_dtensor(x):
        return x
    if callable(spec):
        spec = spec(x.ndim)
    spec = tuple(spec) + (None,) * (x.ndim - len(tuple(spec)))
    if not _divides(x.shape, spec):
        return x           # constraint would be invalid; leave x as it is
    return _redistribute(x, spec)


def constrain_batch_tree(tree, leading: int = 1):
    """Constrain every tensor in a batch tree: dims [0:leading] unsharded,
    dim `leading` over the dp axes, rest unsharded (the train step's
    [n_micro, mb, ...] microbatches, `leading=1`). Where the dp axes do
    not divide that dim, the leaf is replicated: what GSPMD makes of the
    reference's step then ("the batch replicates per microbatch"), and
    DTensor can neither pad nor unflatten an uneven shard."""
    dp = dp_axes()
    if dp is None:
        return tree

    def one(x):
        if not _is_dtensor(x) or x.ndim <= leading:
            return x
        spec = (None,) * leading + (dp,) + (None,) * (x.ndim - leading - 1)
        if not _divides(x.shape, spec):
            spec = (None,) * x.ndim
        return _redistribute(x, spec)

    return pytree.tree_map(one, tree)

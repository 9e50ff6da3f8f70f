"""The model's weights, made by the benchmark from the run's seed.

The program's parameter tree is taken as shapes alone (its abstract tree
on the meta device). Every leaf of one dtype that is drawn at random
comes from one normal draw of a flat buffer on the device, with one
generator seeded by `--seed`, and is a view of that buffer scaled by the
configuration file's `init["std"]`; the leaves named in `init["ones"]`
and `init["zeros"]` are constant. The program and the reference get the
same tensors.
"""
from __future__ import annotations

import torch


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (i,))
    else:
        yield prefix, tree


def _rebuild(tree, made, prefix=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, made, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, made, prefix + (i,))
                          for i, v in enumerate(tree))
    return made[prefix]


def seed_of(seed: int, stream: int = 0) -> int:
    """A generator seed for `stream` of the run's seed (any whole number)."""
    return (seed * 0x9E3779B97F4A7C15 + stream) % (2 ** 63)


def make(abstract: dict, init: dict, seed: int, device) -> dict:
    """Real tensors on `device` for every leaf of `abstract`."""
    device = torch.device(device)
    gen = torch.Generator(device).manual_seed(seed_of(seed))
    made, drawn = {}, {}
    for path, meta in _paths(abstract):
        name = path[-1]
        if name in init.get("ones", ()):
            made[path] = torch.ones(meta.shape, dtype=meta.dtype,
                                    device=device)
        elif name in init.get("zeros", ()):
            made[path] = torch.zeros(meta.shape, dtype=meta.dtype,
                                     device=device)
        else:
            drawn.setdefault(meta.dtype, []).append((path, meta))
    for dtype, leaves in drawn.items():
        flat = torch.empty(sum(m.numel() for _, m in leaves), dtype=dtype,
                           device=device)
        flat.normal_(generator=gen)
        off = 0
        for path, meta in leaves:
            made[path] = flat[off:off + meta.numel()].view(meta.shape) \
                .mul_(init["std"])
            off += meta.numel()
    return _rebuild(abstract, made)

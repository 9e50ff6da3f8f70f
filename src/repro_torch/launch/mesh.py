"""Production meshes: the port of `repro.launch.mesh`.

The reference's meshes are 256 or 512 TPU chips that XLA fakes on the
host. Here they are `DeviceMesh`es over a "fake" process group (torch's
`FakeStore`), which has a rank 0 of the full world size and no peers: a
collective on it returns at once, and the dry-run counts what it would
have moved. The group is the process's default group, so `fake_world`
creates it and destroys it again; the meshes are functions, never
module-level state. On H100s the 16x16 and 2x16x16 meshes stand for 256
and 512 cards (32 or 64 nodes of 8).
"""
from __future__ import annotations

import math
from contextlib import contextmanager


@contextmanager
def fake_world(world_size: int):
    """A fake default process group of `world_size` ranks (this process is
    rank 0) for the duration of the block. Refuses to replace a group
    that is already up."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a default process group is already up: the "
                           "fake mesh needs a process of its own")
    dist.init_process_group("fake", store=FakeStore(),
                            world_size=world_size, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def production_mesh_shape(multi_pod: bool = False):
    """(shape, axis names) of the single-pod 16x16 or the 2x16x16 mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_mesh(shape, axes):
    """A CPU `DeviceMesh` of `shape` over the default group's ranks (a
    fake group's, under `fake_world`)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """Single pod: 16×16 = 256 ranks ("data","model").
    Multi-pod: 2×16×16 = 512 ranks ("pod","data","model").
    Call it inside `fake_world(256)` or `fake_world(512)`."""
    return make_mesh(*production_mesh_shape(multi_pod))


def make_host_mesh(shape=None, axes=("data", "model")):
    """Small mesh over the ranks that exist (the default group's world
    size): (world, 1) unless `shape` says otherwise."""
    import torch.distributed as dist
    n = dist.get_world_size()
    if shape is None:
        shape = (n, 1)
    if math.prod(shape) != n:
        raise ValueError(f"mesh {tuple(shape)} needs {math.prod(shape)} "
                         f"ranks, the group has {n}")
    return make_mesh(shape, axes)


def activation_mapping(mesh) -> dict:
    """The activation-sharding context used by all launchers (specs in
    `sharding.partition`'s tuple form): the reference's `act_btd` and
    `moe_ecd`, and two of the port's own for `chunked_attention`, which
    DTensor would otherwise run replicated wherever the heads do not
    split over the model axis (GQA's [KH, rep] view of 32 heads on 16
    ranks): queries split by position over "model" (`attn_q`), keys and
    values whole there (`attn_kv`)."""
    names = tuple(mesh.mesh_dim_names)
    dp = ("pod", "data") if "pod" in names else "data"
    return {
        "dp": dp,
        "axis_sizes": {a: int(n) for a, n in zip(names, mesh.shape)},
        "act_btd": (dp, None, None),
        "moe_ecd": ("model", dp, None),
        "attn_q": (dp, "model", None, None),
        "attn_kv": (dp, None, None, None),
    }

"""Cell lowering: build (step_fn, abstract args, specs) for any
(architecture × input shape × mesh) and run it once on meta DTensors —
the port of `repro.launch.lowering`, shared by the dry-run CLI, the
roofline pass and the sharding tests.

The reference lowers and compiles the step under GSPMD and reads XLA's
per-device `cost_analysis()`, `memory_analysis()` and the collectives of
its HLO text. Here the step's arguments are DTensors whose local shards
live on the meta device, over a mesh of a fake process group
(`launch.mesh.fake_world`); the step runs once, under the
activation-sharding context, with fresh tensors treated as replicated
(`implicit_replication`). A dispatch mode (`CostCounter`) sees every op
that DTensor runs on the local shards, and counts per device:

  flops           — `torch.utils.flop_counter`'s formulas (matmuls,
                    convolutions, attention), so products only: XLA's
                    count adds one flop per elementwise op
  bytes accessed  — each counted op's input and output bytes (views and
                    collectives excluded), XLA's unfused count
  transcendentals — elements out of exp/log/sin/cos/sigmoid/tanh/sqrt/
                    rsqrt/erf
  collectives     — each functional collective's output bytes by the
                    reference's five names, with `_counts`

Sharding propagation's own shape inference (under a FakeTensorMode) is
not counted. Views that DTensor's rules refuse or get wrong, and pads of
an unsharded dim, run on the local shard with no collective. An op that
DTensor refuses for a known reason (`_refusal`) runs replicated, and is
listed in `LoweredCell.fallbacks` with the collective bytes it causes
(`fallback_collectives`); any other error propagates. The FSDP / data-parallel collectives appear where the step's
outputs are redistributed to their specs, as the reference's
`out_shardings` make them appear, and where gradients (`Partial` sums)
meet their accumulators. The memory fields come from the local shards'
sizes: arguments, outputs, and what the donated arguments alias. There
is no compiled module, so the peak is an estimate
(`LoweredCell.memory_estimated`): the most bytes of local storage alive
at once while the step runs eagerly, the arguments included, each
storage counted from the op that makes it until the step drops it; the
temp size is that peak less the arguments. The reference's HLO text
parsers (`_shape_bytes`, `collective_bytes_from_hlo`) have no
counterpart.
"""
from __future__ import annotations

import math
import weakref
from contextlib import contextmanager
from dataclasses import dataclass, field
from types import SimpleNamespace

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch.mesh import activation_mapping
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig, ShapeSpec
from repro_torch.models.inputs import input_specs
from repro_torch.sharding import partition
from repro_torch.sharding.context import activation_sharding

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# functional-collective (and DTensor's all-to-all) op name -> the
# reference's HLO name
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
    "shard_dim_alltoall": "all-to-all",
}
_COLLECTIVE_NS = ("_c10d_functional", "c10d_functional", "_dtensor")
# bookkeeping of the functional collectives: no data moves
_FREE_OPS = ("wait_tensor", "_wrap_tensor_autograd")

_TRANSCENDENTAL = frozenset((
    "exp", "exp2", "expm1", "log", "log1p", "log2", "log_softmax",
    "_log_softmax", "_softmax", "sin", "cos", "tanh", "sigmoid", "sqrt",
    "rsqrt", "erf", "pow", "logaddexp"))


_META_LIB = []


def _bincount_meta(x, weights=None, minlength=0):
    # the length of a bincount is max(x) + 1 or `minlength`, whichever is
    # larger: on the meta device there is no max; the MoE's counts (its
    # only caller) take expert ids below minlength = E
    dtype = torch.int64 if weights is None else torch.float64
    return torch.empty((minlength,), dtype=dtype, device="meta")


def _register_meta_kernels() -> None:
    """Meta kernels for the ops of the zoo that have none (`bincount`),
    registered once a process."""
    if _META_LIB:
        return
    lib = torch.library.Library("aten", "IMPL")
    lib.impl("bincount", _bincount_meta, "Meta")
    _META_LIB.append(lib)


def _dtensor_type():
    from torch.distributed.tensor import DTensor
    return DTensor


def _tensors(tree) -> list:
    return [x for x in pytree.tree_leaves(tree)
            if isinstance(x, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _unstride(t):
    """A DTensor whose placements hold a `_StridedShard` (a view that
    splits a sharded dim, as an einsum's reshapes do) relabeled with
    plain `Shard`s of the same dims. Each device keeps the same local
    size, so every count that follows is the one of a block layout; a dry
    run has no values to misplace. Without it DTensor plans each later
    redistribution by a graph search over the mesh, minutes an op on a
    three-axis mesh."""
    from torch.distributed.tensor import DTensor, Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    if not isinstance(t, DTensor) or not any(
            isinstance(p, _StridedShard) for p in t.placements):
        return t
    pl = [Shard(p.dim) if isinstance(p, _StridedShard) else p
          for p in t.placements]
    return DTensor.from_local(t.to_local(), t.device_mesh, pl,
                              run_check=False, shape=t.shape,
                              stride=t.stride())


@contextmanager
def _alltoall_on_cpu_meshes():
    """DTensor turns a Shard(i) -> Shard(j) move on a CPU mesh into an
    all-gather and a chunk (gloo has no all-to-all), which would count
    mesh-size times the bytes of the all-to-all a card's group runs. For
    the block, the move calls DTensor's all-to-all op itself (the fake
    group only shapes its output)."""
    import torch.distributed.tensor.placement_types as pt
    orig = getattr(pt, "shard_dim_alltoall", None)
    if orig is None or not hasattr(torch.ops._dtensor,
                                   "shard_dim_alltoall"):
        yield
        return

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        name = getattr(mesh.get_group(mesh_dim), "group_name", None)
        if name is None:
            return orig(input, gather_dim, shard_dim, mesh, mesh_dim)
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, name)

    pt.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        pt.shard_dim_alltoall = orig


def _writes_plain(func, args) -> bool:
    """`func` writes its first argument in place, and that is a plain
    tensor (a fresh buffer the model fills from DTensors)."""
    from torch.distributed.tensor import DTensor
    schema_args = func._schema.arguments
    if not schema_args or not args:
        return False
    alias = schema_args[0].alias_info
    return (alias is not None and alias.is_write
            and isinstance(args[0], torch.Tensor)
            and not isinstance(args[0], DTensor))


def _refusal(func, exc: Exception) -> str | None:
    """Why DTensor could not run `func`, where that is one of its known
    gaps and not a fault of the step: the name `fallbacks` lists the op
    under. None for any other error, which propagates."""
    msg = str(exc)
    if func._overloadpacket is torch.ops.aten.bincount:
        # its output length depends on the data: DTensor's shape
        # inference (fake tensors) cannot run it
        return "no sharding rule"
    if isinstance(exc, NotImplementedError) and \
            "sharding strategy" in msg:
        return "no sharding rule"
    if "Cannot unflatten unevenly sharded tensor" in msg:
        return "uneven unflatten"
    if "requires redistribution. Please redistribute the input" in msg:
        # a view that splits or merges a sharded dim other than as
        # `_view_placements` can
        return "view needs a redistribution"
    if func._overloadpacket is torch.ops.aten.constant_pad_nd and \
            isinstance(exc, IndexError):
        # torch 2.11's redistribution planner indexes past the
        # placements of some pads of a sharded dim
        return "torch 2.11 pad planner"
    if func._overloadpacket is torch.ops.aten.index_put and \
            "must be normalized" in msg:
        # torch 2.11's index_put rule makes a Shard(-1) of the
        # embedding's gradient
        return "torch 2.11 index_put rule"
    return None


_VIEWS = ("view", "_unsafe_view")


def _resolve(shape, numel: int) -> list:
    shape = list(shape)
    if -1 in shape:
        i = shape.index(-1)
        shape[i] = numel // math.prod(s for s in shape if s != -1)
    return shape


def _view_groups(old, new):
    """The dims of `old` and `new` (size-1 dims left out) in groups of
    equal size, in order: ([old dims], [new dims]) each."""
    oi = [i for i, n in enumerate(old) if n != 1]
    ni = [j for j, n in enumerate(new) if n != 1]
    groups, a, b = [], 0, 0
    while a < len(oi) and b < len(ni):
        go, gn = [oi[a]], [ni[b]]
        po, pn = old[oi[a]], new[ni[b]]
        a, b = a + 1, b + 1
        while po != pn:
            if po < pn:
                go.append(oi[a])
                po *= old[oi[a]]
                a += 1
            else:
                gn.append(ni[b])
                pn *= new[ni[b]]
                b += 1
        groups.append((go, gn))
    return groups


def _view_placements(x, shape):
    """(placements, local shape) of `x.view(shape)` with no data moved,
    for a view that keeps each sharded dim of `x` whole, unflattens it
    into several dims (the mesh dims that shard it split them in mesh
    order, outermost first, each where the dim before it is used up), or
    flattens it with others. A flatten whose sharded dims are not its
    leading ones, outermost mesh dim first, holds the same local sizes as
    a `Shard` of the flat dim, and is so relabeled, as `_unstride`
    relabels the `_StridedShard`s DTensor makes of it elsewhere. DTensor's
    own view rules refuse some of these (a size-1 dim beside a split one;
    torch 2.11 every flatten of a dim that is not the leading one), and
    get the dims that several mesh dims shard wrong (they hand the local
    op a shape the local shard does not have); torch 2.11 also makes
    replicated DTensors whose placements do not cover their mesh, here
    given one `Replicate` a mesh dim. "uneven" where the mesh does not
    divide an unflattened dim; None for any other view, which DTensor
    runs."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    old = tuple(x.shape)
    new = _resolve(shape, x.numel())
    pls = tuple(x.placements)
    ndim = x.device_mesh.ndim
    if len(pls) != ndim:
        if not all(isinstance(p, Replicate) for p in pls):
            return None
        pls = (Replicate(),) * ndim
    if (math.prod(new) != math.prod(old)
            or any(isinstance(p, _StridedShard) for p in pls)
            or any(isinstance(p, Shard) and old[p.dim] == 1 for p in pls)):
        return None
    group_of = {}
    for go, gn in _view_groups(old, new):
        for d in go:
            group_of[d] = (go, gn)
    local = tuple(x.to_local().shape)
    rem = list(new)
    rem_old = list(old)
    cursor = {}
    out = []
    for m, p in enumerate(pls):
        if not isinstance(p, Shard):
            out.append(p)
            continue
        go, gn = group_of[p.dim]
        n = x.device_mesh.size(m)
        if len(go) == 1 and len(gn) == 1:
            # the dim kept whole, even or not
            rem[gn[0]] = local[go[0]]
            out.append(Shard(gn[0]))
            continue
        if len(go) > 1:
            # a flatten, of evenly sharded dims
            if len(gn) > 1 or rem_old[p.dim] % n:
                return None
            rem_old[p.dim] //= n
            rem[gn[0]] //= n
            out.append(Shard(gn[0]))
            continue
        t = cursor.get(p.dim, 0)
        while rem[gn[t]] == 1 and t < len(gn) - 1:
            t += 1
        cursor[p.dim] = t
        if rem[gn[t]] % n:
            return "uneven"
        rem[gn[t]] //= n
        out.append(Shard(gn[t]))
    if math.prod(rem) != math.prod(local):
        return None
    return out, rem


def _pad_placements(x, pad, value=0.0):
    """The placements of `constant_pad_nd(x, pad, value)` run on the local
    shard, where no padded dim is sharded (and a pending sum is padded
    with zeros): `x`'s. None otherwise, for DTensor to run. torch 2.11's
    redistribution planner fails on some pads of a sharded tensor that
    need no redistribution at all."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    padded = range(x.ndim - len(pad) // 2, x.ndim)
    pls = tuple(x.placements)
    if len(pls) != x.device_mesh.ndim or any(
            isinstance(p, (Shard, _StridedShard)) and p.dim in padded
            for p in pls):
        return None
    if value != 0 and any(isinstance(p, Partial) for p in pls):
        return None
    return list(pls)


class _Local(TorchDispatchMode):
    """The counting half of `CostCounter`, on the mode stack while DTensor
    runs an op: it hands DTensor ops on and counts plain ones into
    `parent`."""

    def __init__(self, parent):
        super().__init__()
        self.parent = parent

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        return self.parent.count(func, args, kwargs or {})


class CostCounter(TorchDispatchMode):
    """Counts one device's work: the ops that reach it on plain (local)
    tensors. An op on DTensors runs through DTensor's dispatch with a
    `_Local` mode on the stack, which counts its local ops and
    collectives; ops under a FakeTensorMode (DTensor's shape inference)
    run uncounted. A view that keeps, unflattens or leads a flatten of
    each sharded dim runs here on the local shard (`_view_placements`),
    with no collective. An op that DTensor refuses for a known reason
    (`_refusal`: no sharding rule, an uneven unflatten, a view that needs
    a redistribution) or
    that writes into a plain tensor runs replicated: its DTensor inputs
    are replicated (the all-gathers and all-reduces are counted, and
    also in `fallback_collectives`), the op runs on the full local
    tensors, and its outputs are replicated DTensors. `fallbacks` counts
    those ops by name and reason. Any other error propagates.
    """

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.transcendentals = 0
        self.collectives = {k: 0 for k in COLLECTIVES}
        self.counts = {k: 0 for k in COLLECTIVES}
        self.fallbacks: dict[str, int] = {}
        # the collective bytes that the replicated ops cause (a part of
        # `collectives`)
        self.fallback_collectives = {k: 0 for k in COLLECTIVES}
        self._in_fallback = 0
        # one device's live bytes: every storage an op makes, until the
        # step lets it go (as the caching allocator sees an eager step)
        self.live = 0
        self.peak = 0
        self._storages: set[int] = set()

    def track(self, tree) -> None:
        """Counts the storages of `tree`'s tensors as live until freed."""
        for t in _tensors(tree):
            if isinstance(t, _dtensor_type()):
                t = t.to_local()
            st = t.untyped_storage()
            key = id(st)
            if key in self._storages:
                continue
            n = st.nbytes()
            self._storages.add(key)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, n)

    def _free(self, key: int, n: int) -> None:
        self._storages.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if not any(issubclass(t, DTensor) for t in types):
            return self.count(func, args, kwargs)
        if _writes_plain(func, args):
            # DTensor asserts that an in-place op's target is a DTensor
            return self._replicated(func, args, kwargs,
                                    "writes a plain tensor")
        name = func._schema.name.split("::")[-1]
        x = args[0] if args and isinstance(args[0], DTensor) else None
        if x is not None and name in _VIEWS:
            split = _view_placements(x, args[1])
            if split == "uneven":
                return self._replicated(func, args, kwargs,
                                        "uneven unflatten")
            if split is not None:
                placements, local_shape = split
                return self._on_local(func, x, (local_shape,), placements,
                                      _resolve(args[1], x.numel()))
        if x is not None and name == "constant_pad_nd" and not kwargs:
            placements = _pad_placements(x, *args[1:])
            if placements is not None:
                pad = args[1]
                shape = list(x.shape)
                for k in range(len(pad) // 2):
                    shape[-1 - k] += pad[2 * k] + pad[2 * k + 1]
                return self._on_local(func, x, args[1:], placements, shape)
        why = None
        with _Local(self):
            try:
                out = func(*args, **kwargs)
            except Exception as e:
                why = _refusal(func, e)
                if why is None:
                    raise
        if why is not None:
            return self._replicated(func, args, kwargs, why)
        if func._schema.is_mutable:
            return out
        return pytree.tree_map(_unstride, out)

    def _on_local(self, func, x, local_args, placements, shape):
        """`func` run on `x`'s local shard (then `local_args`), as a
        DTensor of `shape` with `placements`."""
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor._utils import \
            compute_global_tensor_info
        with _Local(self):
            local = func(x.to_local(), *local_args)
        # the strides of the local shard's layout (a view of a permuted
        # tensor is permuted too)
        _, stride = compute_global_tensor_info(local, x.device_mesh,
                                               placements)
        return DTensor.from_local(local, x.device_mesh, placements,
                                  run_check=False, shape=torch.Size(shape),
                                  stride=tuple(stride))

    def _replicated(self, func, args, kwargs, why: str):
        from torch.distributed.tensor import DTensor, Replicate
        name = f"{func} ({why})"
        self.fallbacks[name] = self.fallbacks.get(name, 0) + 1
        mesh = next(x.device_mesh for x in pytree.tree_leaves((args, kwargs))
                    if isinstance(x, DTensor))
        rep = [Replicate()] * mesh.ndim

        def unwrap(x):
            if isinstance(x, DTensor):
                return x.redistribute(mesh, rep).to_local()
            return x

        self._in_fallback += 1
        try:
            with _Local(self):
                args, kwargs = pytree.tree_map(unwrap, (args, kwargs))
                out = func(*args, **kwargs)
        finally:
            self._in_fallback -= 1
        if _writes_plain(func, args):
            return out
        return pytree.tree_map(
            lambda t: DTensor.from_local(t, mesh, rep, run_check=False)
            if isinstance(t, torch.Tensor) else t, out)

    def count(self, func, args, kwargs):
        out = func(*args, **kwargs)
        if torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None:
            return out
        self.track(out)
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns in _COLLECTIVE_NS:
            kind = _COLLECTIVE_OPS.get(name)
            if kind is not None:
                n = sum(map(_nbytes, _tensors(out)))
                self.collectives[kind] += n
                self.counts[kind] += 1
                if self._in_fallback:
                    self.fallback_collectives[kind] += n
            elif name not in _FREE_OPS:
                raise NotImplementedError(f"uncounted collective {func}")
            return out
        packet = func._overloadpacket
        if packet in self._flop_registry:
            self.flops += int(self._flop_registry[packet](
                *args, **kwargs, out_val=out))
        if not func.is_view and ns == "aten":
            self.bytes += sum(map(_nbytes, _tensors((args, kwargs)))) + \
                sum(map(_nbytes, _tensors(out)))
            if name.rstrip("_") in _TRANSCENDENTAL:
                self.transcendentals += sum(t.numel() for t in _tensors(out))
        return out

    def cost_analysis(self) -> dict:
        return {"flops": float(self.flops),
                "bytes accessed": float(self.bytes),
                "transcendentals": float(self.transcendentals)}

    def collective_bytes(self) -> dict:
        out = {k: float(v) for k, v in self.collectives.items() if v}
        out["_counts"] = {k: v for k, v in self.counts.items() if v}
        return out

    def fallback_collective_bytes(self) -> dict:
        return {k: float(v) for k, v in self.fallback_collectives.items()
                if v}


@dataclass
class LoweredCell:
    arch: str
    shape: str
    mesh_name: str
    lowered: object
    compiled: object
    memory_analysis: object
    cost_analysis: dict
    collective_bytes: dict
    params_bytes: int
    # ops run replicated, "op (reason)" -> count
    fallbacks: dict = field(default_factory=dict)
    # the collective bytes those ops cause, by kind (a part of
    # `collective_bytes`)
    fallback_collectives: dict = field(default_factory=dict)
    # memory fields that are estimates (the live storages of an eager
    # run), not sizes of the local shards
    memory_estimated: tuple = ()


_ESTIMATED = ("temp_size_in_bytes", "peak_memory_in_bytes")


_DONATE = {"train": (0, 1), "decode": (1,), "prefill": ()}


def build_arg_specs(cfg: ModelConfig, shape: ShapeSpec, mesh):
    """(args, in_specs, donate): the step's tensor arguments as meta
    tensors, their spec trees, and which of them the step updates in
    place (params and optimizer state for train, the cache for decode:
    the reference's donation)."""
    p_abs = lm.init_abstract(cfg)
    p_specs = partition.param_specs(cfg, p_abs, mesh)
    batch_abs = input_specs(cfg, shape)
    if shape.kind == "train":
        opt_init, _ = lm.make_optimizer(cfg)
        o_abs = opt_init(p_abs)
        o_specs = partition.opt_specs(p_specs, p_abs, o_abs)
        args = (p_abs, o_abs, batch_abs)
        in_sh = (p_specs, o_specs, partition.batch_specs(batch_abs, mesh))
    elif shape.kind == "prefill":
        args = (p_abs, batch_abs)
        in_sh = (p_specs, partition.batch_specs(batch_abs, mesh))
    elif shape.kind == "decode":
        cache_abs = lm.cache_abstract(cfg, shape.global_batch, shape.seq_len)
        c_specs = partition.cache_specs(cfg, cache_abs, mesh,
                                        batch_size=shape.global_batch)
        dp = partition.mesh_dp_axes(mesh)
        tok_spec = (dp, None) if shape.global_batch > 1 else (None, None)
        args = (p_abs, cache_abs, batch_abs["tokens"])
        in_sh = (p_specs, c_specs, tok_spec)
    else:
        raise ValueError(shape.kind)
    return args, in_sh, _DONATE[shape.kind]


def build_cell(cfg: ModelConfig, shape: ShapeSpec, mesh):
    """Returns (fn, args, in_specs, out_specs): the step, its arguments as
    meta DTensors on `mesh` (decode's position a Python int, the last
    slot, as `make_batch` gives it), and the spec trees. On a mesh of one
    device the arguments are the plain meta tensors: there is nothing to
    shard, and DTensor would only add its dispatch to every op."""
    args, in_sh, _ = build_arg_specs(cfg, shape, mesh)
    if shape.kind == "train":
        fn = lm.train_step_fn(cfg)
        out_sh = (in_sh[0], in_sh[1], None)
    elif shape.kind == "prefill":
        fn = lm.prefill_step_fn(cfg, capacity=shape.seq_len)
        cache_abs = lm.cache_abstract(cfg, shape.global_batch, shape.seq_len)
        out_sh = (None, partition.cache_specs(cfg, cache_abs, mesh,
                                              batch_size=shape.global_batch))
    else:
        fn = lm.decode_step_fn(cfg)
        out_sh = (None, in_sh[1])
    if math.prod(mesh.shape) == 1:
        dargs = args
    else:
        dargs = tuple(partition.abstract_with_sharding(a, s, mesh)
                      for a, s in zip(args, in_sh))
    if shape.kind == "decode":
        dargs = dargs + (shape.seq_len - 1,)
    return fn, dargs, in_sh, out_sh


def params_bytes(cfg: ModelConfig) -> int:
    """All the params' bytes (the whole model, not a device's)."""
    return int(sum(math.prod(x.shape) * x.element_size()
                   for x in pytree.tree_leaves(lm.init_abstract(cfg))))


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    return int(sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
                   for t in _tensors(tree)))


def _to_specs(out, specs, mesh):
    """`out` with each DTensor leaf under a spec redistributed to it (the
    reference's out_shardings); leaves under a None spec stay."""
    if specs is None:
        return out
    from torch.distributed.tensor import DTensor
    leaves, treedef = pytree.tree_flatten(out)
    spec_list = partition.spec_leaves(specs)
    if len(spec_list) != len(leaves):
        raise ValueError(f"{len(leaves)} outputs but {len(spec_list)} "
                         "specs")
    new = []
    for x, s in zip(leaves, spec_list):
        if isinstance(x, DTensor):
            pl = partition.to_placements(s, mesh)
            if tuple(x.placements) != tuple(pl):
                x = x.redistribute(mesh, pl)
        new.append(x)
    return pytree.tree_unflatten(new, treedef)


@contextmanager
def _lowering(mesh, counter):
    """The context a step is lowered in: the activation mapping of
    `mesh`, fresh tensors replicated, DTensor's all-to-all, `counter`."""
    from torch.distributed.tensor.experimental import implicit_replication
    with activation_sharding(activation_mapping(mesh)), \
            implicit_replication(), _alltoall_on_cpu_meshes(), counter:
        yield


def _count(mesh, run):
    """(counter, result) of `run(counter)`, counted. DTensor works out a sharding the first
    time it meets an op at a shape, and some of that work runs ops on
    plain tensors, which a counter cannot tell from the step's: the
    first run fills those caches, the second is counted (its counts
    repeat run after run)."""
    _register_meta_kernels()
    if math.prod(mesh.shape) > 1:
        run(CostCounter())
    counter = CostCounter()
    return counter, run(counter)


def lower_microbatch_split(cfg: ModelConfig, shape: ShapeSpec,
                           mesh) -> CostCounter:
    """One device's counts of a train cell's microbatch split alone
    (`lm.split_microbatches` on its batch, as `train_step` splits it).
    Its cost is the one part of a train step that is not linear in the
    microbatch count: nothing at one microbatch (the [1, mb] view keeps
    the batch's sharding), a redistribution of the batch from its
    leading dim to the microbatch dim at two or more. The probes
    (`roofline.probes`) take it out before their algebra and add it back
    at the full count."""
    batch = input_specs(cfg, shape)
    if math.prod(mesh.shape) > 1:
        batch = partition.abstract_with_sharding(
            batch, partition.batch_specs(batch, mesh), mesh)
    n_micro = shape.global_batch // min(cfg.microbatch, shape.global_batch)

    def run(counter):
        with _lowering(mesh, counter):
            lm.split_microbatches(batch, n_micro)

    return _count(mesh, run)[0]


def lower_cell(arch: str, cfg: ModelConfig, shape: ShapeSpec, mesh,
               mesh_name: str) -> LoweredCell:
    """Runs the cell's step on meta DTensors over `mesh` (a `DeviceMesh`
    of the fake group) and fills a `LoweredCell` with one device's
    counts."""
    fn, args, in_sh, out_sh = build_cell(cfg, shape, mesh)
    donate = _DONATE[shape.kind]
    arg_bytes = _local_bytes(args)
    alias_bytes = sum(_local_bytes(args[i]) for i in donate)

    def run(counter):
        counter.track(args)
        with _lowering(mesh, counter):
            out = fn(*args)
            return tuple(_to_specs(o, s, mesh) for o, s in zip(out, out_sh))

    counter, out = _count(mesh, run)
    mem = SimpleNamespace(argument_size_in_bytes=arg_bytes,
                          output_size_in_bytes=_local_bytes(out),
                          alias_size_in_bytes=alias_bytes,
                          temp_size_in_bytes=counter.peak - arg_bytes,
                          peak_memory_in_bytes=counter.peak)
    return LoweredCell(arch, shape.name, mesh_name, None, None, mem,
                       counter.cost_analysis(), counter.collective_bytes(),
                       params_bytes(cfg), fallbacks=dict(counter.fallbacks),
                       fallback_collectives=counter.fallback_collective_bytes(),
                       memory_estimated=_ESTIMATED)

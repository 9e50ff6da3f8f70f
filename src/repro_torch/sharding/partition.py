"""Parameter / optimizer / batch / cache partition rules: the port of
`repro.sharding.partition`.

Mesh axes: ("data", "model") single-pod, ("pod", "data", "model") multi-pod.
  * dp   = ("pod","data") or "data" — batch & FSDP axis
  * tp   = "model"                  — heads / d_ff / vocab / experts axis

A spec is the reference's PartitionSpec as a plain tuple: one entry per
tensor dim, each `None`, an axis name or a tuple of axis names. The rules
read only a mesh's `axis_names` and its `shape` (axis name -> size), so
they take a `DeviceMesh` (through `mesh_axes`) or any object with those
two attributes, and need no process group.

Rules are *candidate lists*: the first spec whose sharded dims evenly divide
the leaf's shape wins. This is how e.g.:
  * yi-34b's 56 q-heads fall back to head-dim (128) sharding on 16-way TP,
  * recurrentgemma's MQA kv=1 falls back to replicated KV,
  * granite's 40 experts fall back from EP to TP over the expert FFN dim,
  * mamba2's vocab 50280 falls back to embedding-column sharding.
Each fallback is a real, coherent TP variant (its extra collectives appear
in the dry-run's counts and are priced by the roofline).

`to_placements` turns a spec into DTensor placements (the reference's
`to_named`) and `abstract_with_sharding` gives meta DTensors of a tree of
meta tensors (the reference's sharded ShapeDtypeStructs).
"""
from __future__ import annotations

import math
from types import SimpleNamespace

import torch
from torch.utils import _pytree as pytree


def mesh_axes(mesh):
    """`mesh` with `axis_names` and `shape` as the rules read them: a
    `DeviceMesh` gives its `mesh_dim_names` and sizes; anything that has
    both attributes already (a duck-typed mesh) is returned as it is."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        return mesh
    return SimpleNamespace(axis_names=tuple(names),
                           shape=dict(zip(names, mesh.shape)))


def mesh_dp_axes(mesh):
    axes = mesh_axes(mesh).axis_names
    if "pod" in axes:
        return ("pod", "data")
    return "data"


def axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = mesh_axes(mesh).shape
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def spec_divides(spec: tuple, shape, mesh) -> bool:
    for dim, axes in zip(shape, tuple(spec)):
        if axes is None:
            continue
        if dim % axis_size(mesh, axes) != 0:
            return False
    return True


def choose_spec(shape, candidates, mesh) -> tuple:
    for c in candidates:
        c = tuple(c) + (None,) * (len(shape) - len(tuple(c)))
        if spec_divides(c, shape, mesh):
            return c
    return (None,) * len(shape)


def _path_str(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def _candidates(name: str, ndim: int, dp, fsdp: bool):
    """Candidate specs (most → least preferred) over non-scan dims."""
    f = dp if fsdp else None
    tp = "model"
    table = {
        # embeddings / head: vocab over tp, else d_model over tp
        ("embed", 2): [(tp, f), (None, tp)],
        ("lm_head", 2): [(f, tp), (tp, None)],
        # attention qkv [D, H, hd]: heads over tp, else head_dim over tp
        ("wq", 3): [(f, tp, None), (f, None, tp), (f, None, None)],
        ("wk", 3): [(f, tp, None), (f, None, tp), (f, None, None)],
        ("wv", 3): [(f, tp, None), (f, None, tp), (f, None, None)],
        ("wo", 3): [(tp, None, f), (None, tp, f), (None, None, f)],
        # MLA
        ("wdq", 2): [(f, tp), (f, None)],
        ("wuq", 3): [(None, tp, None), (tp, None, None)],
        ("wdkv", 2): [(f, None)],
        ("wuk", 3): [(None, tp, None), (tp, None, None)],
        ("wuv", 3): [(None, tp, None), (tp, None, None)],
        # dense MLP [D, F]
        ("w_gate", 2): [(f, tp), (None, tp)],
        ("w_up", 2): [(f, tp), (None, tp)],
        ("w_down", 2): [(tp, f), (tp, None)],
        # MoE experts [E, D, F]: EP over tp, else TP over F
        ("router", 2): [(f, None)],
        ("w_gate", 3): [(tp, f, None), (None, f, tp)],
        ("w_up", 3): [(tp, f, None), (None, f, tp)],
        ("w_down", 3): [(tp, None, f), (None, tp, f)],
        ("e_bias", 1): [(None,)],
        # SSD / RG-LRU
        ("w_in", 2): [(f, tp), (f, None)],
        ("w_x", 2): [(f, tp), (f, None)],
        ("w_out", 2): [(tp, f), (None, f)],
        ("w_rg", 2): [(None, tp)],
        ("w_ig", 2): [(None, tp)],
        ("conv_w", 2): [(None, tp)],
        ("conv_b", 1): [(tp,)],
        ("lam", 1): [(tp,)],
    }
    return table.get((name, ndim), [])


def _flatten(tree):
    return pytree.tree_flatten_with_path(tree)


def param_specs(cfg, params_like, mesh):
    """A spec tree matching the params tree (`lm.init_abstract`'s keys are
    the reference's, so a leaf's path names its rule)."""
    dp = mesh_dp_axes(mesh)
    flat, treedef = _flatten(params_like)
    specs = []
    for path, leaf in flat:
        p = _path_str(path)
        name = None
        for part in reversed(p.split("/")):
            if not part.isdigit():
                name = part
                break
        in_stack = "stacks" in p
        shape = tuple(leaf.shape)
        eff_shape = shape[1:] if in_stack else shape
        cands = _candidates(name, len(eff_shape), dp, cfg.fsdp)
        if name == "embed" and getattr(cfg, "embed_shard", "vocab") == \
                "dmodel":
            cands = [(None, "model")]
        if name == "lm_head" and getattr(cfg, "embed_shard", "vocab") == \
                "dmodel":
            cands = [(None, "model"), (dp if cfg.fsdp else None, "model")]
        spec = choose_spec(eff_shape, cands, mesh)
        if in_stack:
            spec = (None,) + spec
        specs.append(spec)
    return pytree.tree_unflatten(specs, treedef)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        a is None or isinstance(a, (str, tuple)) for a in x) and not any(
        isinstance(a, tuple) and not all(isinstance(b, str) for b in a)
        for a in x)


def spec_leaves(specs) -> list:
    """The specs of a spec tree, in its leaves' order (a spec is a tuple,
    which a tree walk would otherwise open)."""
    return pytree.tree_leaves(specs, is_leaf=_is_spec)


def opt_specs(p_specs, params_like, opt_like):
    """Optimizer-state specs derived from param specs by shape matching
    (AdamW m/v mirror params; Adafactor row/col factors drop a dim)."""
    # the first param of a shape wins, in JAX's flatten order (dict keys
    # sorted), as the reference's
    flat_p, _ = _flatten(params_like)
    flat_spec = spec_leaves(p_specs)
    order = sorted(range(len(flat_p)), key=lambda i: tuple(
        getattr(k, "key", getattr(k, "idx", k)) for k in flat_p[i][0]))
    shape_to_spec = {}
    for i in order:
        leaf, spec = flat_p[i][1], flat_spec[i]
        sh = tuple(leaf.shape)
        t = tuple(spec)
        shape_to_spec.setdefault(sh, t)
        if len(sh) >= 1:
            shape_to_spec.setdefault(sh[:-1], t[:-1])
        if len(sh) >= 2:
            shape_to_spec.setdefault(sh[:-2] + sh[-1:], t[:-2] + t[-1:])

    def one(leaf):
        sh = tuple(leaf.shape)
        return shape_to_spec.get(sh, (None,) * len(sh))

    return pytree.tree_map(one, opt_like)


def batch_specs(batch_like, mesh):
    """Input batch: dim 0 over dp (when divisible)."""
    dp = mesh_dp_axes(mesh)

    def one(leaf):
        sh = tuple(leaf.shape)
        if not sh:
            return ()
        return choose_spec(sh, [(dp,)], mesh)

    return pytree.tree_map(one, batch_like)


def cache_specs(cfg, cache_like, mesh, *, batch_size: int):
    """Decode caches. Layout per leaf: [repeats, B, ...].

    * B > 1: batch over dp; heads/latent/head-dim over tp (candidates).
    * B == 1 (long_500k): sequence parallelism — the cache length dim is
      sharded over dp instead (cfg.seq_shard_decode).
    """
    dp = mesh_dp_axes(mesh)
    tp = "model"
    seq_shard = batch_size == 1 and cfg.seq_shard_decode

    def cands_for(name: str, nd: int):
        if name in ("k", "v") and nd == 5:            # [R,B,C,KH,hd]
            if seq_shard:
                return [(None, None, dp, tp, None),
                        (None, None, dp, None, tp),
                        (None, None, dp, None, None)]
            return [(None, dp, None, tp, None),
                    (None, dp, None, None, tp),
                    (None, dp, tp, None, None),
                    (None, dp, None, None, None)]
        if name in ("ckv", "krope") and nd == 4:      # [R,B,C,r]
            if seq_shard:
                return [(None, None, dp, tp), (None, None, dp, None)]
            return [(None, dp, None, tp), (None, dp, None, None)]
        if name == "k_pos" and nd == 3:               # [R,B,C]
            if seq_shard:
                return [(None, None, dp)]
            return [(None, dp, None)]
        if name == "state" and nd == 5:               # ssd [R,B,H,N,P]
            b = None if seq_shard else dp
            return [(None, b, tp, None, None), (None, b, None, None, None)]
        if name == "state" and nd == 3:               # rglru [R,B,W]
            b = None if seq_shard else dp
            return [(None, b, tp), (None, b, None)]
        if name == "conv" and nd == 4:                # [R,B,W-1,C]
            b = None if seq_shard else dp
            return [(None, b, None, tp), (None, b, None, None)]
        return []

    flat, treedef = _flatten(cache_like)
    specs = []
    for path, leaf in flat:
        name = _path_str(path).split("/")[-1]
        sh = tuple(leaf.shape)
        specs.append(choose_spec(sh, cands_for(name, len(sh)), mesh))
    return pytree.tree_unflatten(specs, treedef)


# ----------------------------------------------------------------------------
# DTensor placements
# ----------------------------------------------------------------------------
def to_placements(spec: tuple, mesh) -> list:
    """DTensor placements of `spec` on a `DeviceMesh`: one per mesh dim,
    `Shard(d)` where tensor dim d names that mesh axis, else
    `Replicate()`. A dim over several axes ("pod", "data") shards over
    each in mesh order (the reference's row-major device order)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, axes in enumerate(tuple(spec)):
        if axes is None:
            continue
        for a in ((axes,) if isinstance(axes, str) else axes):
            i = names.index(a)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {a!r} shards two dims of "
                                 f"{spec}")
            out[i] = Shard(d)
    return out


def local_shape(shape, spec: tuple, mesh) -> tuple:
    """One device's shard of a tensor of `shape` under `spec` (the rules
    only pick specs that divide)."""
    out = list(shape)
    for d, axes in enumerate(tuple(spec)):
        n = axis_size(mesh, axes)
        if out[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"{n} ways ({spec})")
        out[d] //= n
    return tuple(out)


def abstract_with_sharding(abstract, specs, mesh):
    """Meta DTensors for a tree of meta tensors: each leaf's local shard
    on the meta device, placed by its spec through `DTensor.from_local`
    (no collective, no allocation; `distribute_tensor` would scatter)."""
    from torch.distributed.tensor import DTensor

    leaves, treedef = pytree.tree_flatten(abstract)
    spec_list = spec_leaves(specs)
    if len(spec_list) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves but {len(spec_list)} specs")
    out = []
    for a, s in zip(leaves, spec_list):
        loc = torch.empty(local_shape(a.shape, s, mesh), dtype=a.dtype,
                          device="meta")
        out.append(DTensor.from_local(
            loc, mesh, to_placements(s, mesh), run_check=False,
            shape=torch.Size(a.shape), stride=_contiguous_stride(a.shape)))
    return pytree.tree_unflatten(out, treedef)


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def spec_bytes(abstract, specs, mesh) -> int:
    """Bytes of one device's shards of a tree of meta tensors."""
    return int(sum(
        math.prod(local_shape(a.shape, s, mesh)) * a.element_size()
        for a, s in zip(pytree.tree_leaves(abstract), spec_leaves(specs))))

"""Import the port's PyTorch forwards as cost-model programs.

Counterpart of `repro.core.hlo_import`, which walks a function's jaxpr:
`import_fn(fn, *args)` runs `fn` on real tensors under a
`TorchFunctionMode` that records every torch call whose result is a
tensor as one `Node` (op, output shape cut to 6 dims, dtype bytes, the
first 3 inputs, contract dim, reduced dims), the same pre-fusion program
representation the synthetic generator emits. Torch calls at this level
(`@`, `einsum`, `exp`, `reshape`, `where`, ...) are the nearest to jaxpr
primitives: below it, at the dispatcher, an einsum is already a `bmm`
over flattened dims. `torch.einsum` is recorded as `jnp.einsum` lowers:
one `dot_general` per pairwise contraction, in opt_einsum's optimal
order, with reduce-sums for indices of one operand alone and a transpose
where the product's dims are not the result's. The other ops map through
`opset.TORCH_OP_MAP`; a composite op (`log_softmax`, `logaddexp`) is one
node where the jaxpr holds its primitives, so the two programs' opcode
histograms differ (tests/test_torch_hlo_import.py lists each
difference).

The reference inlines each `scan` body one iteration deep and binds the
scan's outputs to the body's outputs. In the port, Python loops stand for
those scans; they go through `loop(n)` (or `scan(xs, n)`, which also
hands out the i-th slice of stacked params). Without a recorder that is
`range(n)`. Under `import_fn`, iteration 0 is recorded; later iterations
still run, so every shape stays right, but each of their ops is bound to
the node of the same op in iteration 0 (by position, nested loops each
by their own), so a value carried out of the loop is the first
iteration's node.

`import_arch_program(arch)` traces the port's `lm.loss_fn` at the arch's
smoke config (seed-0 params, `make_batch`) into the program
`arch_<name>`. Programs are deterministic: the same nodes, so the same
`kernel_hash`, run after run.
"""
from __future__ import annotations

import itertools
import math

import torch
from torch.overrides import TorchFunctionMode, resolve_name

from repro_torch.core import opset
from repro_torch.core.graph import KernelGraph, Node

_MAX_NODES_PER_PROGRAM = 4096
_active: "_Recorder | None" = None        # the recorder of import_fn


def loop(n: int):
    """`range(n)` for a loop that stands for one of the reference's
    scans; under `import_fn` only iteration 0 is recorded."""
    return range(n) if _active is None else _active.loop(n)


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_index(t, i) for t in tree)
    return tree[i]


def scan(xs, n: int):
    """For i in `loop(n)`: `xs` (a tree of tensors with a leading [n]
    axis) at i. Under `import_fn` the slices are not recorded: each is
    bound to the node of its stacked tensor, as the reference binds a
    scan body's inputs to the scan's operands."""
    for i in loop(n):
        rec = _active
        if rec is None:
            yield _index(xs, i)
            continue
        rec.quiet += 1
        try:
            sliced = _index(xs, i)
        finally:
            rec.quiet -= 1
        for whole, part in zip(_leaves(xs), _leaves(sliced)):
            rec.bind(part, rec.input_node(whole))
        yield sliced


def _leaves(tree):
    """Tensors of a tree (of dicts, lists and tuples) in JAX's flatten
    order: dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _leaves(t)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _shape(t: torch.Tensor) -> tuple[int, ...]:
    shape = tuple(int(d) for d in t.shape)
    return shape[:6] if shape else (1,)


def _op_name(func) -> str:
    """`add` for torch.add, Tensor.add, Tensor.__add__ and __radd__;
    `T` for the Tensor.T getter."""
    name = getattr(func, "__name__", "")
    if name in ("__get__", "__set__", ""):
        name = resolve_name(func) or ""
        name = name.split(".")[-2] if name.endswith((".__get__",
                                                      ".__set__")) else name
    if name.startswith("__r") and name.endswith("__") and \
            name[3:-2] in opset.TORCH_OP_MAP:
        return name[3:-2]
    if name.startswith("__i") and name.endswith("__") and \
            name[3:-2] in opset.TORCH_OP_MAP:
        return name[3:-2] + "_"
    return name.strip("_") if name.startswith("__") else name


def _inplace(name: str) -> bool:
    return name == "setitem" or (name.endswith("_")
                                 and not name.endswith("__"))


_REDUCE = (opset.REDUCE_SUM, opset.REDUCE_MAX, opset.REDUCE_MIN,
           opset.REDUCE_PROD, opset.REDUCE_AND, opset.REDUCE_OR)


def _reduced(op, args, kwargs) -> tuple[int, ...]:
    """Sizes of the dims a reduction reduces, the first two (the
    reference's `reduce_*` primitives; not cumsum, as there)."""
    if op not in _REDUCE:
        return ()
    x = args[0]
    dim = kwargs.get("dim", args[1] if len(args) > 1 and not isinstance(
        args[1], torch.Tensor) else None)
    if dim is None:
        dims = range(x.dim())
    else:
        dims = (dim,) if isinstance(dim, int) else tuple(dim)
    return tuple(int(x.shape[d]) for d in dims)[:2]


class _Frame:
    """One running `loop`: its iteration, and the nodes its iteration 0
    gave, in order (`seq`), which a later iteration's ops map to."""

    def __init__(self):
        self.it, self.pos, self.seq = 0, 0, []


class _Recorder(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.nodes: list[Node] = []
        self.of: dict[int, int] = {}         # id(tensor) -> node
        self.keep: list[torch.Tensor] = []   # keeps those ids unique
        self.frames: list[_Frame] = []
        self.quiet = 0                       # > 0: run calls unrecorded

    # -- nodes --------------------------------------------------------
    def add(self, node: Node) -> int:
        self.nodes.append(node)
        return len(self.nodes) - 1

    def bind(self, t: torch.Tensor, idx: int) -> None:
        self.of[id(t)] = idx
        self.keep.append(t)

    def input_node(self, t: torch.Tensor) -> int:
        """t's node; a tensor that no recorded call made is a parameter,
        as an unbound jaxpr var is."""
        idx = self.of.get(id(t))
        if idx is None:
            idx = self.add(Node(opset.PARAMETER, _shape(t),
                                max(t.element_size(), 1)))
            self.bind(t, idx)
        return idx

    def node(self, op, out: torch.Tensor, ins, contract: int = 0,
             reduced: tuple = ()) -> int:
        inputs = tuple(self.input_node(t) for t in ins)
        return self.add(Node(op, _shape(out), max(out.element_size(), 1),
                             inputs[:3], False, contract, (0, 0), reduced))

    # -- loops --------------------------------------------------------
    def loop(self, n: int):
        frame = _Frame()
        self.frames.append(frame)
        try:
            for i in range(n):
                frame.it, frame.pos = i, 0
                yield i
        finally:
            self.frames.remove(frame)

    def _later(self) -> int | None:
        """Index in `frames` of the innermost loop past its iteration 0."""
        for k in range(len(self.frames) - 1, -1, -1):
            if self.frames[k].it > 0:
                return k
        return None

    # -- calls --------------------------------------------------------
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.quiet or len(self.nodes) >= _MAX_NODES_PER_PROGRAM:
            return out
        name = _op_name(func)
        ins = list(_leaves((args, kwargs)))
        outs = ([args[0]] if _inplace(name) and ins
                else list(_leaves(out)))
        if not outs or (not _inplace(name) and all(
                any(o is i for i in ins) for o in outs)):
            return out                   # no value, or an input handed back
        k = self._later()
        if k is None:
            idx = self.record(name, args, kwargs, ins, outs[0])
            for frame in self.frames:
                frame.seq.append(idx)
        else:
            frame = self.frames[k]
            if not frame.seq:
                return out
            idx = frame.seq[min(frame.pos, len(frame.seq) - 1)]
            frame.pos += 1
            for inner in self.frames[k + 1:]:
                inner.seq.append(idx)
        for o in outs:
            self.bind(o, idx)
        return out

    def record(self, name, args, kwargs, ins, out) -> int:
        if name == "einsum":
            return self.einsum(args, out)
        op = opset.TORCH_OP_MAP.get(name.rstrip("_") if _inplace(name)
                                    and name != "setitem" else name,
                                    opset.CUSTOM_CALL)
        if name == "getitem":
            index = args[1] if isinstance(args[1], tuple) else (args[1],)
            if any(True for _ in _leaves(index)):
                op = opset.GATHER                 # indexing by a tensor
            elif all(a is None or a is Ellipsis or a == slice(None)
                     for a in index):
                # x[..., None] is expand_dims: broadcast_in_dim in JAX
                op = opset.BROADCAST
        elif name in ("max", "min") and len(ins) > 1:
            op = opset.MAX if name == "max" else opset.MIN   # elementwise
        elif name in ("clamp", "clip") and kwargs.get("max") is None and (
                len(args) < 3 or args[2] is None):
            op = opset.MAX                        # clamp(min=): jnp.maximum
        contract = int(ins[0].shape[-1]) if op is opset.DOT else 0
        return self.node(op, out, ins, contract, _reduced(op, args, kwargs))

    # -- einsum as jnp.einsum lowers it ---------------------------------
    def einsum(self, args, out: torch.Tensor) -> int:
        eq = args[0].replace(" ", "")
        ops = list(args[1:]) if len(args) > 2 or not isinstance(
            args[1], (list, tuple)) else list(args[1])
        ins_str, res = eq.split("->")
        names = ins_str.split(",")
        if "." in eq or len(names) != len(ops) or len(ops) < 2:
            return self.node(opset.DOT, out, ops)
        size = {c: int(d) for n, t in zip(names, ops)
                for c, d in zip(n, t.shape)}
        # (subscripts, node, dtype bytes, shape) of the live operands
        live = [(n, self.input_node(t), t) for n, t in zip(names, ops)]
        steps = _einsum_path(names, res, size)
        idx = None
        for s, (i, j) in enumerate(steps):
            hi, lo = max(i, j), min(i, j)
            (lhs_n, lhs, lt), (rhs_n, rhs, rt) = live.pop(hi), live.pop(lo)
            keep = set(res).union(*(n for n, _, _ in live))
            last = s == len(steps) - 1
            result = res if last else "".join(
                sorted((set(lhs_n) | set(rhs_n)) & keep,
                       key=(lhs_n + rhs_n).find))
            idx, names_out = self.pair(lhs_n, lhs, rhs_n, rhs, result, size,
                                       out.element_size())
            if names_out != result:
                idx = self.add(Node(opset.TRANSPOSE, _dims(result, size),
                                    out.element_size(), (idx,)))
            live.append((result, idx, None))
        return idx

    def pair(self, lhs_n, lhs, rhs_n, rhs, result, size, nbytes):
        """One pairwise contraction of jnp.einsum: reduce-sums of the
        indices one side holds alone and the result drops, then the
        dot_general. Returns (its node, its output's subscripts)."""
        def sum_uniques(n, idx, other):
            uniq = [c for c in n if c not in result and c not in other]
            if not uniq:
                return n, idx
            kept = "".join(c for c in n if c not in uniq)
            node = self.add(Node(opset.REDUCE_SUM, _dims(kept, size), nbytes,
                                 (idx,), False, 0, (0, 0),
                                 tuple(size[c] for c in uniq)[:2]))
            return kept, node
        lhs_n2, lhs = sum_uniques(lhs_n, lhs, rhs_n)
        rhs_n2, rhs = sum_uniques(rhs_n, rhs, lhs_n)
        both = set(lhs_n2) & set(rhs_n2)
        contracted = sorted(c for c in both if c not in result)
        batch = "".join(c for c in result if c in both)
        gone = batch + "".join(contracted)
        rem_l = "".join(c for c in lhs_n2 if c not in gone)
        rem_r = "".join(c for c in rhs_n2 if c not in gone)
        names = batch + rem_r + rem_l
        operands = (rhs, lhs)
        if names != result:
            names = batch + rem_l + rem_r
            operands = (lhs, rhs)
        contract = math.prod(size[c] for c in contracted)
        node = self.add(Node(opset.DOT, _dims(names, size), nbytes, operands,
                             False, contract))
        return node, names


def _dims(names: str, size: dict) -> tuple[int, ...]:
    shape = tuple(size[c] for c in names)
    return shape[:6] if shape else (1,)


def _einsum_path(names: list[str], res: str, size: dict) -> list:
    """The pairwise contractions (positions in the live list, which drops
    both and appends their result) of opt_einsum's 'optimal' path, the
    one `jnp.einsum(optimize="auto")` takes for up to four operands:
    depth-first over pair orders, the least total flop_count(indices,
    inner, 2), the first found at equal cost, and opt_einsum's cache of
    pair costs keyed by the two index sets alone (a pair met again under
    other remaining operands keeps its first cost)."""
    output = frozenset(res)
    best = {"flops": math.inf, "ssa": ()}
    cache: dict = {}

    def walk(path, remaining, inputs, flops):
        if len(remaining) == 1:
            best["flops"], best["ssa"] = flops, path
            return
        for i, j in itertools.combinations(sorted(remaining), 2):
            key = (inputs[i], inputs[j])
            if key not in cache:
                either, shared = key[0] | key[1], key[0] & key[1]
                keep = output.union(*(inputs[r] for r in remaining
                                      - {i, j}))
                cache[key] = (either & keep, math.prod(
                    size[c] for c in either) * (1 + bool(shared - keep)))
            k12, cost = cache[key]
            if flops + cost >= best["flops"]:
                continue
            walk(path + ((i, j),), remaining - {i, j} | {len(inputs)},
                 inputs + (k12,), flops + cost)
    walk((), set(range(len(names))), tuple(frozenset(n) for n in names), 0)
    # static single assignment ids -> positions in the live list
    ids = list(range(len(names) + len(best["ssa"])))
    linear = []
    for pair in best["ssa"]:
        linear.append(tuple(ids[k] for k in pair))
        for k in pair:
            ids[k:] = [x - 1 for x in ids[k:]]
    return linear


def import_fn(fn, *args, name: str = "imported",
              program: str | None = None) -> KernelGraph:
    """Run `fn(*args)` under the recorder (no grad) and return its
    program. Counterpart of `import_jaxpr`: every tensor leaf of `args`
    (dict keys sorted, as JAX flattens) is first a parameter node, as the
    jaxpr's input vars are; the tensors `fn` returns are its outputs."""
    global _active
    if _active is not None:
        raise RuntimeError("import_fn does not nest")
    rec = _Recorder()
    for t in _leaves(args):
        if id(t) not in rec.of:
            rec.bind(t, rec.add(Node(opset.PARAMETER, _shape(t),
                                     max(t.element_size(), 1))))
    _active = rec
    try:
        with torch.no_grad(), rec:
            result = fn(*args)
    finally:
        _active = None
    nodes = rec.nodes
    outs = sorted({rec.of[id(t)] for t in _leaves(result) if id(t) in rec.of})
    for i in outs or [len(nodes) - 1]:
        n = nodes[i]
        nodes[i] = Node(n.op, n.shape, n.dtype_bytes, n.inputs, True,
                        n.contract_dim, n.filter_size, n.reduced_dims)
    return KernelGraph(nodes, program=program or name, name=name)


def import_arch_program(arch: str, seq: int = 64, batch: int = 2,
                        device="cuda") -> KernelGraph:
    """Trace one smoke-scale `loss_fn` of an assigned architecture (its
    seed-0 params, `make_batch`'s seed-0 batch) into a cost-model
    program (corpus entry `arch_<name>`); every arch of the registry
    imports."""
    from repro_torch.core.device import resolve_device
    from repro_torch.models import lm, registry
    from repro_torch.models.config import ShapeSpec
    from repro_torch.models.inputs import make_batch

    dev = resolve_device(device)
    cfg = registry.get_smoke_config(arch)
    batch_data = make_batch(cfg, ShapeSpec("import", seq, batch, "train"),
                            device=dev)
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                            device=dev)
    return import_fn(lambda p, b: lm.loss_fn(p, cfg, b), params, batch_data,
                     name=f"arch_{arch}", program=f"arch_{arch}")

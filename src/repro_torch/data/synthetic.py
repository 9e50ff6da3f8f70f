"""Synthetic tensor-program corpus.

The paper's dataset is 104 production XLA programs; we cannot ship those, so
the corpus here is (a) a parameterized family of generator templates shaped
like common workloads (MLP, CNN, attention, RNN cell, normalization stacks,
embedding/DLRM, elementwise soups) plus (b) programs imported from the 10
assigned LM architectures via `repro.core.hlo_import`.

Each generated program is a *pre-fusion* graph of primitive ops (one
`KernelGraph` whose nodes are single HLO-level ops). The fusion machinery in
`repro_torch.data.fusion` partitions it into kernels.

Program names are `<family>_<idx>`; the family prefix drives the paper's
"manual split" (hold out whole families) and the balanced sampler ("draw
examples evenly from each model type").
"""
from __future__ import annotations

import zlib

import numpy as np

from repro_torch.core import opset
from repro_torch.core.graph import KernelGraph, Node


class _Builder:
    """Incremental topological graph builder."""

    def __init__(self, program: str):
        self.nodes: list[Node] = []
        self.program = program

    def add(self, op, shape, inputs=(), dtype_bytes=4, **kw) -> int:
        self.nodes.append(Node(op, tuple(int(s) for s in shape),
                               dtype_bytes, tuple(inputs), **kw))
        return len(self.nodes) - 1

    def param(self, shape, dtype_bytes=4) -> int:
        return self.add(opset.PARAMETER, shape, (), dtype_bytes)

    def mark_outputs(self) -> None:
        """Any node with no consumer is a program output."""
        consumed = set()
        for n in self.nodes:
            consumed.update(n.inputs)
        for i, n in enumerate(self.nodes):
            if i not in consumed and n.op is not opset.PARAMETER:
                self.nodes[i] = Node(n.op, n.shape, n.dtype_bytes, n.inputs,
                                     True, n.contract_dim, n.filter_size,
                                     n.reduced_dims)

    def build(self) -> KernelGraph:
        self.mark_outputs()
        return KernelGraph(self.nodes, program=self.program,
                           name=self.program)


def _pow2(rng: np.random.Generator, lo: int, hi: int) -> int:
    los, his = int(np.log2(lo)), int(np.log2(hi))
    return int(2 ** rng.integers(los, his + 1))


def _dtype(rng: np.random.Generator) -> int:
    return int(rng.choice([2, 4], p=[0.6, 0.4]))


def _act(b: _Builder, rng, x: int, shape, dt) -> int:
    op = rng.choice([opset.MAX, opset.TANH, opset.LOGISTIC, opset.EXP])
    if op is opset.MAX:  # relu = max(x, 0-const)
        zero = b.add(opset.CONSTANT, (1,), (), dt)
        zb = b.add(opset.BROADCAST, shape, (zero,), dt)
        return b.add(opset.MAX, shape, (x, zb), dt)
    return b.add(op, shape, (x,), dt)


# ----------------------------------------------------------------------------
# Families
# ----------------------------------------------------------------------------
def mlp(rng: np.random.Generator, name: str) -> KernelGraph:
    b = _Builder(name)
    batch = _pow2(rng, 16, 256)
    width = _pow2(rng, 128, 2048)
    dt = _dtype(rng)
    x = b.param((batch, width), dt)
    layers = int(rng.integers(2, 6))
    for _ in range(layers):
        out_w = _pow2(rng, 128, 2048)
        w = b.param((width, out_w), dt)
        y = b.add(opset.DOT, (batch, out_w), (x, w), dt, contract_dim=width)
        bias = b.param((out_w,), dt)
        bb = b.add(opset.BROADCAST, (batch, out_w), (bias,), dt)
        y = b.add(opset.ADD, (batch, out_w), (y, bb), dt)
        x = _act(b, rng, y, (batch, out_w), dt)
        width = out_w
    return b.build()


def cnn(rng: np.random.Generator, name: str) -> KernelGraph:
    b = _Builder(name)
    nimg = _pow2(rng, 4, 32)
    hw_dim = _pow2(rng, 16, 64)
    ch = _pow2(rng, 8, 64)
    dt = _dtype(rng)
    x = b.param((nimg, hw_dim, hw_dim, ch), dt)
    layers = int(rng.integers(2, 5))
    for li in range(layers):
        out_ch = min(_pow2(rng, 16, 256), 256)
        k = int(rng.choice([1, 3, 5]))
        w = b.param((k, k, ch, out_ch), dt)
        y = b.add(opset.CONV, (nimg, hw_dim, hw_dim, out_ch), (x, w), dt,
                  contract_dim=ch, filter_size=(k, k))
        bias = b.param((out_ch,), dt)
        bb = b.add(opset.BROADCAST, (nimg, hw_dim, hw_dim, out_ch), (bias,), dt)
        y = b.add(opset.ADD, (nimg, hw_dim, hw_dim, out_ch), (y, bb), dt)
        x = _act(b, rng, y, (nimg, hw_dim, hw_dim, out_ch), dt)
        ch = out_ch
        if li % 2 == 1 and hw_dim > 8:
            hw_dim //= 2
            x = b.add(opset.REDUCE_MAX, (nimg, hw_dim, hw_dim, ch), (x,), dt,
                      reduced_dims=(2, 2))
    # global pool + classifier
    x = b.add(opset.REDUCE_SUM, (nimg, ch), (x,), dt,
              reduced_dims=(hw_dim, hw_dim))
    w = b.param((ch, 128), dt)
    b.add(opset.DOT, (nimg, 128), (x, w), dt, contract_dim=ch)
    return b.build()


def attention(rng: np.random.Generator, name: str) -> KernelGraph:
    b = _Builder(name)
    batch = _pow2(rng, 2, 16)
    seq = _pow2(rng, 64, 512)
    d = _pow2(rng, 128, 512)
    dt = _dtype(rng)
    x = b.param((batch, seq, d), dt)
    for _ in range(int(rng.integers(1, 3))):
        wq = b.param((d, d), dt)
        wk = b.param((d, d), dt)
        wv = b.param((d, d), dt)
        q = b.add(opset.DOT, (batch, seq, d), (x, wq), dt, contract_dim=d)
        kk = b.add(opset.DOT, (batch, seq, d), (x, wk), dt, contract_dim=d)
        v = b.add(opset.DOT, (batch, seq, d), (x, wv), dt, contract_dim=d)
        scores = b.add(opset.DOT, (batch, seq, seq), (q, kk), dt,
                       contract_dim=d)
        mx = b.add(opset.REDUCE_MAX, (batch, seq), (scores,), dt,
                   reduced_dims=(seq,))
        mxb = b.add(opset.BROADCAST, (batch, seq, seq), (mx,), dt)
        sub = b.add(opset.SUB, (batch, seq, seq), (scores, mxb), dt)
        ex = b.add(opset.EXP, (batch, seq, seq), (sub,), dt)
        ssum = b.add(opset.REDUCE_SUM, (batch, seq), (ex,), dt,
                     reduced_dims=(seq,))
        ssb = b.add(opset.BROADCAST, (batch, seq, seq), (ssum,), dt)
        attn = b.add(opset.DIV, (batch, seq, seq), (ex, ssb), dt)
        ctx = b.add(opset.DOT, (batch, seq, d), (attn, v), dt,
                    contract_dim=seq)
        wo = b.param((d, d), dt)
        o = b.add(opset.DOT, (batch, seq, d), (ctx, wo), dt, contract_dim=d)
        x = b.add(opset.ADD, (batch, seq, d), (x, o), dt)
    return b.build()


def rnn_cell(rng: np.random.Generator, name: str) -> KernelGraph:
    b = _Builder(name)
    batch = _pow2(rng, 16, 128)
    d = _pow2(rng, 128, 1024)
    dt = _dtype(rng)
    x = b.param((batch, d), dt)
    h = b.param((batch, d), dt)
    steps = int(rng.integers(1, 4))
    for _ in range(steps):
        wx = b.param((d, 4 * d), dt)
        wh = b.param((d, 4 * d), dt)
        gx = b.add(opset.DOT, (batch, 4 * d), (x, wx), dt, contract_dim=d)
        gh = b.add(opset.DOT, (batch, 4 * d), (h, wh), dt, contract_dim=d)
        g = b.add(opset.ADD, (batch, 4 * d), (gx, gh), dt)
        i = b.add(opset.SLICE, (batch, d), (g,), dt)
        f = b.add(opset.SLICE, (batch, d), (g,), dt)
        o = b.add(opset.SLICE, (batch, d), (g,), dt)
        c = b.add(opset.SLICE, (batch, d), (g,), dt)
        si = b.add(opset.LOGISTIC, (batch, d), (i,), dt)
        sf = b.add(opset.LOGISTIC, (batch, d), (f,), dt)
        so = b.add(opset.LOGISTIC, (batch, d), (o,), dt)
        tc = b.add(opset.TANH, (batch, d), (c,), dt)
        ig = b.add(opset.MUL, (batch, d), (si, tc), dt)
        fg = b.add(opset.MUL, (batch, d), (sf, h), dt)
        cnew = b.add(opset.ADD, (batch, d), (ig, fg), dt)
        tcn = b.add(opset.TANH, (batch, d), (cnew,), dt)
        h = b.add(opset.MUL, (batch, d), (so, tcn), dt)
    return b.build()


def norm_stack(rng: np.random.Generator, name: str) -> KernelGraph:
    b = _Builder(name)
    batch = _pow2(rng, 16, 128)
    d = _pow2(rng, 256, 2048)
    dt = _dtype(rng)
    x = b.param((batch, d), dt)
    for _ in range(int(rng.integers(1, 4))):
        mu = b.add(opset.REDUCE_SUM, (batch,), (x,), dt, reduced_dims=(d,))
        mub = b.add(opset.BROADCAST, (batch, d), (mu,), dt)
        cen = b.add(opset.SUB, (batch, d), (x, mub), dt)
        sq = b.add(opset.MUL, (batch, d), (cen, cen), dt)
        var = b.add(opset.REDUCE_SUM, (batch,), (sq,), dt, reduced_dims=(d,))
        rs = b.add(opset.RSQRT, (batch,), (var,), dt)
        rsb = b.add(opset.BROADCAST, (batch, d), (rs,), dt)
        y = b.add(opset.MUL, (batch, d), (cen, rsb), dt)
        scale = b.param((d,), dt)
        sb = b.add(opset.BROADCAST, (batch, d), (scale,), dt)
        y = b.add(opset.MUL, (batch, d), (y, sb), dt)
        w = b.param((d, d), dt)
        x = b.add(opset.DOT, (batch, d), (y, w), dt, contract_dim=d)
    return b.build()


def embedding(rng: np.random.Generator, name: str) -> KernelGraph:
    b = _Builder(name)
    batch = _pow2(rng, 64, 512)
    vocab = _pow2(rng, 1024, 65536)
    d = _pow2(rng, 32, 256)
    dt = _dtype(rng)
    table = b.param((vocab, d), dt)
    ids = b.param((batch, 16), 4)
    emb = b.add(opset.GATHER, (batch, 16, d), (table, ids), dt)
    pooled = b.add(opset.REDUCE_SUM, (batch, d), (emb,), dt,
                   reduced_dims=(16,))
    dense = b.param((batch, d), dt)
    cat = b.add(opset.CONCATENATE, (batch, 2 * d), (pooled, dense), dt)
    w = b.param((2 * d, d), dt)
    y = b.add(opset.DOT, (batch, d), (cat, w), dt, contract_dim=2 * d)
    y = _act(b, rng, y, (batch, d), dt)
    w2 = b.param((d, 1), dt)
    y = b.add(opset.DOT, (batch, 1), (y, w2), dt, contract_dim=d)
    b.add(opset.LOGISTIC, (batch, 1), (y,), dt)
    return b.build()


def elementwise_soup(rng: np.random.Generator, name: str) -> KernelGraph:
    b = _Builder(name)
    rank = int(rng.integers(1, 4))
    shape = tuple(_pow2(rng, 8, 256) for _ in range(rank))
    dt = _dtype(rng)
    live = [b.param(shape, dt) for _ in range(int(rng.integers(1, 4)))]
    n_ops = int(rng.integers(4, 24))
    for _ in range(n_ops):
        kind = rng.random()
        if kind < 0.5 and len(live) >= 2:
            a, c = rng.choice(len(live), 2, replace=False)
            op = rng.choice([opset.ADD, opset.MUL, opset.SUB, opset.MAX,
                             opset.DIV])
            live.append(b.add(op, shape, (live[a], live[c]), dt))
        elif kind < 0.85:
            a = int(rng.integers(len(live)))
            op = rng.choice([opset.EXP, opset.TANH, opset.NEG, opset.ABS,
                             opset.RSQRT, opset.LOGISTIC])
            live.append(b.add(op, shape, (live[a],), dt))
        else:
            a = int(rng.integers(len(live)))
            red = b.add(opset.REDUCE_SUM, shape[:-1] or (1,), (live[a],), dt,
                        reduced_dims=(shape[-1],))
            live.append(b.add(opset.BROADCAST, shape, (red,), dt))
    return b.build()


def conv_draw(rng: np.random.Generator, name: str) -> KernelGraph:
    """Conv + recurrent-ish mixing, subjectively unlike the rest (the paper's
    hardest holdout)."""
    b = _Builder(name)
    nimg = _pow2(rng, 2, 8)
    hw_dim = _pow2(rng, 8, 32)
    ch = _pow2(rng, 8, 32)
    dt = _dtype(rng)
    x = b.param((nimg, hw_dim, hw_dim, ch), dt)
    canvas = b.param((nimg, hw_dim, hw_dim, ch), dt)
    for _ in range(int(rng.integers(1, 3))):
        k = int(rng.choice([3, 5]))
        w = b.param((k, k, ch, ch), dt)
        y = b.add(opset.CONV, (nimg, hw_dim, hw_dim, ch), (x, w), dt,
                  contract_dim=ch, filter_size=(k, k))
        g = b.add(opset.LOGISTIC, (nimg, hw_dim, hw_dim, ch), (y,), dt)
        mix = b.add(opset.MUL, (nimg, hw_dim, hw_dim, ch), (g, canvas), dt)
        canvas = b.add(opset.ADD, (nimg, hw_dim, hw_dim, ch), (mix, y), dt)
        x = b.add(opset.TANH, (nimg, hw_dim, hw_dim, ch), (canvas,), dt)
    return b.build()


FAMILIES = {
    "mlp": mlp,
    "cnn": cnn,
    "attention": attention,
    "rnn": rnn_cell,
    "norm": norm_stack,
    "embedding": embedding,
    "soup": elementwise_soup,
    "convdraw": conv_draw,
}

# program-count weights loosely mirroring the paper's imbalance note
# (many ResNet/Inception-like variants, few DLRM/auto-completion-like ones)
FAMILY_WEIGHTS = {
    "mlp": 3, "cnn": 5, "attention": 4, "rnn": 3, "norm": 2,
    "embedding": 1, "soup": 1, "convdraw": 1,
}


def generate_program(family: str, idx: int, seed: int) -> KernelGraph:
    # zlib.crc32 — deterministic across processes (unlike builtin hash())
    fam_key = zlib.crc32(family.encode()) % (2 ** 31)
    rng = np.random.default_rng(np.random.SeedSequence([seed, idx, fam_key]))
    return FAMILIES[family](rng, f"{family}_{idx}")


def corpus_plan(num_programs: int) -> list[tuple[str, int]]:
    """The (family, idx) schedule `generate_corpus` materializes, without
    building any graph — the corpus-builder CLI fans exactly this plan
    across worker processes (repro.launch.build_corpus), so a sharded
    parallel build reproduces the in-process corpus program-for-program."""
    total_w = sum(FAMILY_WEIGHTS.values())
    plan: list[tuple[str, int]] = []
    idx = 0
    while len(plan) < num_programs:
        for fam, w in FAMILY_WEIGHTS.items():
            count = max(1, round(num_programs * w / total_w))
            for _ in range(count):
                if len(plan) >= num_programs:
                    break
                plan.append((fam, idx))
                idx += 1
    return plan[:num_programs]


def generate_corpus(num_programs: int = 104, seed: int = 0) -> list[KernelGraph]:
    """Generate a corpus of pre-fusion program graphs."""
    return [generate_program(fam, idx, seed)
            for fam, idx in corpus_plan(num_programs)]


def whole_model_graph(target_nodes: int, seed: int = 0, *,
                      arch_blocks: tuple = (),
                      name: str | None = None) -> KernelGraph:
    """A whole-program graph (TpuGraphs-scale; DESIGN.md §12): many model
    blocks stitched end-to-end until the graph reaches `target_nodes`.

    Blocks come from the synthetic family generators. `arch_blocks`
    (imported LM architectures, `repro.core.hlo_import` in the reference)
    needs the jaxpr importer, which the port does not have yet: passing
    any raises NotImplementedError. Consecutive blocks are bridged the way real programs chain
    layers: the previous block's root output is reduced to a scalar
    (`REDUCE_SUM` → shape ``(1,)``) and the next block's first `PARAMETER`
    is replaced by a `BROADCAST` of that scalar to the parameter's shape —
    one connected dataflow graph, still topologically ordered.

    Deterministic in (target_nodes, seed, arch_blocks). The result exceeds
    `target_nodes` by at most one block.

    >>> g = whole_model_graph(500, seed=0)
    >>> g.num_nodes >= 500
    True
    >>> max(abs(d - s) for s, d in g.unique_edges()) > 1   # cross-block edges
    True
    """
    if arch_blocks:
        raise NotImplementedError(
            "arch_blocks needs the jaxpr importer (repro.core.hlo_import), "
            "which the port does not have yet")
    rng = np.random.default_rng(np.random.SeedSequence([seed, target_nodes]))
    label = name or f"wholemodel_{target_nodes}_{seed}"
    fams = list(FAMILIES)
    nodes: list[Node] = []
    prev_out = None          # global index of the previous block's root
    bi = 0
    while len(nodes) < target_nodes:
        fam = fams[int(rng.integers(len(fams)))]
        block = FAMILIES[fam](rng, f"{label}_blk{bi}")
        off = len(nodes)
        if prev_out is not None:
            # bridge: scalar summary of the previous block's output
            prev = nodes[prev_out]
            nodes.append(Node(opset.REDUCE_SUM, (1,), prev.dtype_bytes,
                              (prev_out,), reduced_dims=prev.shape))
            off += 1
        bridged = prev_out is None      # first block keeps all its params
        for i, n in enumerate(block.nodes):
            if not bridged and n.op is opset.PARAMETER:
                nodes.append(Node(opset.BROADCAST, n.shape, n.dtype_bytes,
                                  (off - 1,)))
                bridged = True
                continue
            nodes.append(Node(n.op, n.shape, n.dtype_bytes,
                              tuple(j + off for j in n.inputs), False,
                              n.contract_dim, n.filter_size, n.reduced_dims))
        # root of this block = its last non-parameter node
        for j in range(len(nodes) - 1, -1, -1):
            if nodes[j].op is not opset.PARAMETER:
                prev_out = j
                break
        bi += 1
    b = _Builder(label)
    b.nodes = nodes
    return b.build()


def whole_model_records(num_programs: int, target_nodes: int, seed: int = 0,
                        *, arch_blocks: tuple = (), simulator=None) -> list:
    """`FusionKernelRecord`s for whole-model graphs, runtime-labeled by the
    simulator — the training/serving payload for the giant-graph path
    (`benchmarks/bench_giant_graphs.py` streams these through the corpus
    store and the segmented sampler)."""
    raise NotImplementedError(
        "whole_model_records needs the fusion dataset "
        "(repro.data.fusion_dataset), which the port does not have yet")


def random_kernel(num_nodes: int, seed: int = 0, *,
                  program: str = "random") -> KernelGraph:
    """A random topologically ordered DAG kernel of exactly `num_nodes`
    nodes — the mixed-size workload generator for the sparse-batching tests
    and `benchmarks/bench_batching.py`. Structure mimics fused HLO kernels:
    a few parameters feeding a soup of unary/binary elementwise ops with
    occasional dots."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, num_nodes]))
    b = _Builder(f"{program}_{num_nodes}_{seed}")
    shape = (_pow2(rng, 8, 64), _pow2(rng, 8, 64))
    dt = _dtype(rng)
    n_params = min(max(1, num_nodes // 8), num_nodes)
    for _ in range(n_params):
        b.param(shape, dt)
    unary = [opset.EXP, opset.TANH, opset.NEG, opset.ABS, opset.LOGISTIC]
    binary = [opset.ADD, opset.MUL, opset.SUB, opset.MAX]
    while len(b.nodes) < num_nodes:
        i = len(b.nodes)
        if i >= 2 and num_nodes - i >= 1 and rng.random() < 0.02:
            lhs, rhs = rng.integers(i, size=2)
            k = shape[1]
            b.add(opset.DOT, shape, (int(lhs), int(rhs)), dt, contract_dim=k)
        elif i >= 2 and rng.random() < 0.4:
            lhs, rhs = rng.integers(i, size=2)
            b.add(rng.choice(binary), shape, (int(lhs), int(rhs)), dt)
        else:
            src = int(rng.integers(i))
            b.add(rng.choice(unary), shape, (src,), dt)
    return b.build()

"""The port's program importer (repro_torch.core.hlo_import) against the
reference's jaxpr importer (repro.core.hlo_import), on the CPU.

Per arch, at the smoke config (seq 64, batch 2, seed-0 params): the
matrix products are held equal (their count, the multiset of contract
dims, the total DOT FLOPs) and their output shapes equal up to a
permutation of dims (each permuted shape listed below). The other
opcodes are compared as a histogram: every difference is listed per
arch, and each opcode that differs is traced, in WHY, to the call the
two tracers break down differently. The cases of tests/test_hlo_import.py
are mirrored on the port's importer.
"""
import collections
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core.hlo_import import import_arch_program as jimport_arch
from repro_torch.core import hlo_import as H
from repro_torch.core import opset
from repro_torch.core.simulator import TPUSimulator
from repro_torch.data.corpus import kernel_hash
from repro_torch.data.fusion import apply_fusion, default_fusion

ARCHS = ["yi-9b", "mamba2-2.7b", "granite-moe-3b-a800m",
         "recurrentgemma-9b", "musicgen-large", "h2o-danube-3-4b",
         "yi-34b", "qwen3-14b", "llava-next-34b", "deepseek-v3-671b"]

# DOT output shapes that differ by a permutation: (reference, port). Each
# is chunked attention's scores: the reference's einsum "bsgrd,btgd->
# bgrst" is a dot_general whose output keeps (b, g, s, r, t) (batch dims,
# lhs free, rhs free) before a transpose; the port's matmul of q
# [B,KH,rep,S,hd] by k^T gives (b, g, r, s, t)
PERMUTED_DOTS = {
    "yi-9b": [((2, 2, 32, 64, 2), (2, 2, 2, 64, 32))],
    "mamba2-2.7b": [],
    "granite-moe-3b-a800m": [((2, 2, 16, 64, 2), (2, 2, 2, 64, 16))],
    "recurrentgemma-9b": [((2, 1, 16, 64, 2), (2, 1, 2, 64, 16))],
    "musicgen-large": [((2, 4, 32, 64, 1), (2, 4, 1, 64, 32))],
    "h2o-danube-3-4b": [((2, 2, 32, 64, 2), (2, 2, 2, 64, 32))],
    "yi-34b": [((2, 2, 32, 64, 3), (2, 2, 3, 64, 32))],
    "qwen3-14b": [((2, 2, 32, 64, 2), (2, 2, 2, 64, 32))],
    "llava-next-34b": [((2, 2, 32, 64, 3), (2, 2, 3, 64, 32))],
    # MLA's scores, once a stack (one MLA layer each): every head is a kv
    # head (k is broadcast over them), rep 1
    "deepseek-v3-671b": [((2, 4, 16, 64, 1), (2, 4, 1, 64, 16))] * 2,
}

# opcode counts, port minus reference
HIST_DIFF = {
    "yi-9b": {"add": -2, "broadcast": -10, "compare": -3, "constant": -25,
              "convert": -1, "copy": -1, "custom-call": -2, "divide": -3,
              "exponential": -1, "iota": -1, "multiply": -1,
              "parameter": -1, "reduce-max": -1, "reduce-sum": -1,
              "reshape": -4, "select": -2, "slice": 4, "subtract": -2},
    "mamba2-2.7b": {"abs": -1, "add": -6, "broadcast": -13, "compare": -5,
                    "concatenate": 1, "constant": -26, "convert": -2,
                    "copy": -1, "custom-call": -1, "divide": -3,
                    "dynamic-slice": -1, "exponential": -2, "iota": -2,
                    "maximum": -1, "negate": -1, "parameter": -3,
                    "reduce-max": -1, "reduce-sum": -1, "reshape": -7,
                    "select": -4, "slice": 4, "subtract": -3,
                    "transpose": -2},
    "granite-moe-3b-a800m": {"add": -11, "and": -1, "broadcast": -26,
                             "compare": -13, "constant": -54, "convert": -4,
                             "copy": -2, "custom-call": -2, "divide": -4,
                             "exponential": -1, "gather": -1, "iota": -2,
                             "maximum": -1, "multiply": -1, "parameter": -3,
                             "reduce-max": -2, "reduce-sum": -2,
                             "remainder": -1, "reshape": -4, "scatter": 1,
                             "select": -11, "sign": -2, "slice": 5,
                             "subtract": -4, "transpose": 1},
    "recurrentgemma-9b": {"abs": -3, "add": -47, "broadcast": -22,
                          "compare": -9, "concatenate": 36,
                          "constant": -146, "convert": -4, "copy": -1,
                          "custom-call": -2, "divide": -9,
                          "dynamic-slice": -3, "exponential": -4,
                          "iota": -1, "maximum": -3, "multiply": -1,
                          "negate": -3, "pad": -72, "parameter": -3,
                          "reduce-max": -1, "reduce-sum": -1, "reshape": 17,
                          "select": -8, "slice": 43, "subtract": -5},
    "musicgen-large": {"add": -1, "broadcast": -9, "compare": -2,
                       "constant": -23, "convert": -1, "copy": -1,
                       "custom-call": -2, "divide": -3, "exponential": -1,
                       "iota": -1, "multiply": -1, "parameter": -1,
                       "reduce-max": -1, "reduce-sum": -1, "reshape": -4,
                       "select": -1, "slice": 4, "subtract": -2},
    "h2o-danube-3-4b": {"add": -2, "broadcast": -10, "compare": -3,
                        "constant": -26, "convert": -1, "copy": -1,
                        "custom-call": -2, "divide": -3, "exponential": -1,
                        "iota": -1, "multiply": -1, "parameter": -1,
                        "reduce-max": -1, "reduce-sum": -1, "reshape": -4,
                        "select": -2, "slice": 4, "subtract": -2},
    "yi-34b": {"add": -2, "broadcast": -10, "compare": -3, "constant": -25,
               "convert": -1, "copy": -1, "custom-call": -2, "divide": -3,
               "exponential": -1, "iota": -1, "multiply": -1,
               "parameter": -1, "reduce-max": -1, "reduce-sum": -1,
               "reshape": -4, "select": -2, "slice": 4, "subtract": -2},
    "qwen3-14b": {"add": -2, "broadcast": -14, "compare": -3,
                  "constant": -29, "convert": -1, "copy": -1,
                  "custom-call": -2, "divide": -5, "exponential": -1,
                  "iota": -1, "multiply": -1, "parameter": -1,
                  "reduce-max": -1, "reduce-sum": -1, "reshape": -4,
                  "select": -2, "slice": 4, "subtract": -2},
    "llava-next-34b": {"add": -2, "broadcast": -10, "compare": -3,
                       "constant": -25, "convert": -1, "copy": -1,
                       "custom-call": -2, "divide": -3, "exponential": -1,
                       "iota": -1, "multiply": -1, "parameter": -1,
                       "reduce-max": -1, "reduce-sum": -1, "reshape": -4,
                       "select": -2, "slice": 4, "subtract": -2},
    "deepseek-v3-671b": {"add": -12, "and": -1, "broadcast": -41,
                         "compare": -15, "constant": -81, "convert": -7,
                         "copy": -1, "custom-call": -4, "divide": -9,
                         "exponential": -1, "gather": -3, "iota": -3,
                         "multiply": -2, "parameter": -4, "reduce-max": -1,
                         "reduce-sum": -1, "remainder": -1, "reshape": -9,
                         "scatter": 1, "select": -12, "sign": -2,
                         "slice": 11, "subtract": -3},
}

# each differing opcode, traced to the calls the two tracers break down
# differently
WHY = {
    "constant": "the jaxpr reads literals (1e-6, -1e30, 0, 2.0, the scan's "
                "step counts) and the reference makes a constant node at "
                "each use; a torch call takes a Python scalar, which is no "
                "tensor and no node",
    "broadcast": "jnp gives operands of unequal shapes an explicit "
                 "broadcast_in_dim, and jnp.zeros/full are broadcasts of a "
                 "literal; torch broadcasts inside the elementwise call "
                 "(x[..., None] and unsqueeze are broadcasts in both)",
    "reduce-max": "log_softmax: max, subtract, exp, sum, log and subtract "
                  "in the jaxpr (one log node in the port)",
    "reduce-sum": "log_softmax's sum (above)",
    "exponential": "log_softmax's exp and softplus's exp (jnp.logaddexp; "
                   "one log node each in the port)",
    "subtract": "log_softmax's two subtractions and logaddexp's",
    "copy": "stop_gradient inside jax.nn.log_softmax",
    "custom-call": "jnp.split (rope; the SSD's projection split) has no "
                   "opset entry; torch.split is one slice node",
    "slice": "torch.split is a slice (above); the port slices each key "
             "and value block inside the loop and the RG-LRU scan's "
             "strided halves with one getitem each, where the reference "
             "reshapes K and V into blocks before its scan and slices "
             "with lax.slice_in_dim; MLA's rope-key columns "
             "(dkv[..., None, kv_lora:]) are a slice in the port and a "
             "gather in the reference",
    "reshape": "the reference reshapes K and V into [nb, B, blk, KH, hd] "
               "blocks before its scan, squeezes after each integer index "
               "(x[:, -1]), and reshapes the MoE's routing; the port's "
               "interleave of the RG-LRU scan flattens each stacked pair "
               "(one reshape a level)",
    "transpose": "the reference transposes its K/V blocks for the scan and "
                 "an einsum's product where its dims are not the result's; "
                 "the port permutes q once before the block loop",
    "iota": "the scan over KV blocks takes jnp.arange(nb) as xs; the "
            "reference's masks take broadcasted iotas where the port takes "
            "one arange",
    "compare": "the reference's mask adds `k_pos < T` for padded blocks and "
               "the log-softmax/logaddexp's nan checks; granite's capacity "
               "check compares positions element by element",
    "select": "jnp.where for the padded-block mask, logaddexp's nan guard, "
              "and the MoE's capacity masks (the port multiplies or indexes)",
    "add": "jnp.logaddexp (max + log1p(exp(-|d|))), the mean's sum, the "
           "associative scan's interleave (lax.pad + add a level, the port "
           "stacks) and the MoE's position cumsum arithmetic",
    "divide": "jnp.mean is sum then divide; the port's torch.mean is one "
              "reduce node; the loss's mean over its mask",
    "multiply": "the reference scales q by a weakly typed scalar inside the "
                "block loop body; the port scales it once before",
    "convert": "casts one package writes where the other has none (int32 "
               "indices for take_along_axis, the mask's astype)",
    "parameter": "inputs that one tracer binds to a node and the other "
                 "first sees as a new parameter (the scan's xs, a cache "
                 "kept outside the traced function)",
    "abs": "jnp.logaddexp (softplus) takes |x - y|",
    "negate": "jnp.logaddexp takes -|x - y|",
    "maximum": "jnp.logaddexp takes max(x, y)",
    "pad": "the reference's associative scan interleaves each level's odd "
           "and even results by lax.pad with interior padding and an add; "
           "the port stacks and flattens them",
    "concatenate": "the port's interleave (torch.stack) and the odd-length "
                   "tail of a level; the SSD's state list stacked after the "
                   "chunk loop",
    "dynamic-slice": "jnp indexing with an integer (h[:, -1], cum[:, :, -1]) "
                     "lowers to dynamic_slice; the port's getitem is a slice",
    "gather": "the MoE's dispatch: the reference gathers the expert inputs "
              "with take_along_axis, the port indexes by the sorted order; "
              "jnp indexing that mixes None and a slice (MLA's "
              "dkv[..., None, kv_lora:]) is a gather in the jaxpr, one "
              "slice in the port",
    "scatter": "the MoE's combine: the port scatters the expert outputs "
               "back with index_add_ (one node)",
    "and": "the MoE's capacity mask (capacity and validity) in the "
           "reference",
    "remainder": "the MoE's slot arithmetic in the reference",
    "sign": "the MoE's position arithmetic in the reference",
}


def _dots(g):
    return [n for n in g.nodes if n.op.name == "dot"]   # either package


def _flops(dots):
    return sum(2 * n.contract_dim * math.prod(n.shape) for n in dots)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    return arch, jimport_arch(arch), H.import_arch_program(arch,
                                                           device="cpu")


def test_dots_match_reference(pair):
    arch, ref, got = pair
    rd, gd = _dots(ref), _dots(got)
    assert len(gd) == len(rd)
    assert sorted(n.contract_dim for n in gd) == \
        sorted(n.contract_dim for n in rd)
    assert _flops(gd) == _flops(rd)
    apart = [(r.shape, g.shape) for r, g in zip(rd, gd) if r.shape != g.shape]
    assert apart == PERMUTED_DOTS[arch]
    for r, g in apart:
        assert sorted(r) == sorted(g)


def test_opcode_histogram_differences_are_the_listed_ones(pair):
    arch, ref, got = pair
    hr = collections.Counter(n.op.name for n in ref.nodes)
    hg = collections.Counter(n.op.name for n in got.nodes)
    diff = {k: hg[k] - hr[k] for k in sorted(set(hr) | set(hg))
            if hg[k] != hr[k]}
    assert diff == HIST_DIFF[arch]
    assert set(diff) <= set(WHY)
    assert got.num_nodes < H._MAX_NODES_PER_PROGRAM
    assert got.name == got.program == f"arch_{arch}"


def test_reference_figures_of_the_five_benchmark_archs():
    """The DOT counts and FLOPs of the benchmarks' five archs."""
    want = {"yi-9b": (10, 1.468e7), "mamba2-2.7b": (9, 4.882e6),
            "granite-moe-3b-a800m": (11, 5.177e6),
            "recurrentgemma-9b": (34, 1.337e7),
            "musicgen-large": (10, 1.258e7)}
    for arch, (n, flops) in want.items():
        d = _dots(H.import_arch_program(arch, device="cpu"))
        assert len(d) == n
        assert _flops(d) == pytest.approx(flops, rel=1e-3)


def test_mla_arch_raises():
    """deepseek-v3-671b (the MLA mixer) imports: per MLA layer its
    low-rank projections, the latent's up projections, the attention's
    two products and wo, then the dense and the MoE ffn and the head: 27
    DOTs, as in the reference's program."""
    g = H.import_arch_program("deepseek-v3-671b", device="cpu")
    assert len(_dots(g)) == 27 and g.num_nodes < H._MAX_NODES_PER_PROGRAM
    assert g.name == "arch_deepseek-v3-671b"


def test_programs_are_deterministic():
    a = H.import_arch_program("recurrentgemma-9b", device="cpu")
    b = H.import_arch_program("recurrentgemma-9b", device="cpu")
    assert kernel_hash(a) == kernel_hash(b)


# ------------------------------------------- tests/test_hlo_import.py
def test_import_simple_matmul_chain():
    def f(x, w1, w2):
        return torch.tanh(x @ w1) @ w2

    g = H.import_fn(f, torch.ones((8, 16)), torch.ones((16, 32)),
                    torch.ones((32, 4)), name="mm")
    ops = [n.op.name for n in g.nodes]
    assert ops.count("dot") == 2
    assert "tanh" in ops
    dots = _dots(g)
    assert dots[0].shape == (8, 32) and dots[0].contract_dim == 16
    assert dots[1].shape == (8, 4) and dots[1].contract_dim == 32
    assert g.nodes[-1].is_output


def test_import_inlines_loop_bodies_once():
    """A loop through `loop` records its first iteration; the carried
    value after it is the first iteration's node, as the reference binds
    a scan's outputs to its body's."""
    def f(x, w):
        h = x
        for _ in H.loop(3):
            h = torch.tanh(h @ w)
        return h * 2.0

    g = H.import_fn(f, torch.ones((4, 8)), torch.ones((8, 8)))
    ops = [n.op.name for n in g.nodes]
    assert ops == ["parameter", "parameter", "dot", "tanh", "multiply"]
    assert g.nodes[4].inputs == (3,) and g.nodes[4].is_output
    assert list(H.loop(3)) == [0, 1, 2]          # no recorder: a range


def test_nested_loops_bind_each_by_its_own_first_iteration():
    def f(x):
        for _ in H.loop(2):
            for _ in H.loop(3):
                x = x + 1.0
            x = torch.exp(x)
        return x

    g = H.import_fn(f, torch.zeros(4))
    assert [n.op.name for n in g.nodes] == ["parameter", "add",
                                            "exponential"]
    assert g.nodes[2].is_output


def test_scan_binds_slices_to_the_stacked_tensors():
    def f(x, ws):
        for w in H.scan(ws, 3):
            x = x @ w
        return x

    g = H.import_fn(f, torch.ones((2, 4)), torch.ones((3, 4, 4)))
    assert [n.op.name for n in g.nodes] == ["parameter", "parameter", "dot"]
    assert g.nodes[2].inputs == (0, 1)


def test_import_reduction_metadata():
    def f(x):
        return torch.sum(torch.exp(x), dim=1)

    g = H.import_fn(f, torch.ones((8, 64)))
    red = [n for n in g.nodes if n.op.name == "reduce-sum"]
    assert red and red[0].reduced_dims == (64,)


def test_three_operand_einsum_lowers_as_jnp_einsum():
    """Two dot_generals in opt_einsum's optimal order (the SSD's state
    einsum), with the reference's contract dims."""
    import jax.numpy as jnp
    from repro.core.hlo_import import import_jaxpr
    shapes = ((2, 3, 8, 5), (2, 3, 8, 4), (2, 3, 8, 4, 6))
    eq = "bcln,bclh,bclhp->bchnp"
    ref = import_jaxpr(lambda a, b, c: jnp.einsum(eq, a, b, c),
                       *(jnp.ones(s) for s in shapes))
    got = H.import_fn(lambda a, b, c: torch.einsum(eq, a, b, c),
                      *(torch.ones(s) for s in shapes))
    assert [(sorted(n.shape), n.contract_dim) for n in _dots(got)] == \
        [(sorted(n.shape), n.contract_dim) for n in _dots(ref)]


@pytest.mark.parametrize("arch", ["yi-9b", "granite-moe-3b-a800m",
                                  "mamba2-2.7b", "recurrentgemma-9b"])
def test_arch_programs_are_simulatable(arch):
    g = H.import_arch_program(arch, device="cpu")
    assert g.num_nodes > 100
    kernels = apply_fusion(g, default_fusion(g))
    assert len(kernels) > 5
    rt = TPUSimulator().measure_program(kernels)
    assert np.isfinite(rt) and rt > 0


def test_arch_programs_differ_across_archs():
    a = H.import_arch_program("yi-9b", device="cpu")
    b = H.import_arch_program("mamba2-2.7b", device="cpu")
    assert kernel_hash(a) != kernel_hash(b)


def test_import_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        H.import_arch_program("yi-9b")


# ------------------------------------------------ whole_model_graph
def test_whole_model_graph_takes_arch_blocks(monkeypatch):
    """Blocks of the imported programs in turn, bridged, deterministic,
    deepseek-v3-671b's too; an arch that does not import raises (the
    reference takes a synthetic block instead), shown with an importer
    that raises."""
    from repro_torch.data.synthetic import whole_model_graph
    archs = ("yi-9b", "mamba2-2.7b")
    g = whole_model_graph(1000, seed=0, arch_blocks=archs, device="cpu")
    again = whole_model_graph(1000, seed=0, arch_blocks=archs, device="cpu")
    assert g.num_nodes >= 1000
    assert kernel_hash(g) == kernel_hash(again)
    per = [len(_dots(H.import_arch_program(a, device="cpu"))) for a in archs]
    assert len(_dots(g)) >= sum(per)
    ds = whole_model_graph(500, seed=0, arch_blocks=("deepseek-v3-671b",),
                           device="cpu")
    assert ds.num_nodes >= 500 and len(_dots(ds)) >= 27

    def refuse(arch, **kw):
        raise NotImplementedError(f"{arch} does not import")
    monkeypatch.setattr(H, "import_arch_program", refuse)
    with pytest.raises(NotImplementedError, match="does not import"):
        whole_model_graph(500, arch_blocks=("yi-9b",), device="cpu")

"""The port's GraphSAGE aggregation kernels against the JAX package.

Each plain PyTorch version (what the wrappers run on CPU tensors) is held
against the Pallas kernel run in interpret mode, as tests/test_kernels.py
runs it, and against the kernel's `ref.py` oracle; `segment_aggregate`
with float32 and with int8 weights. The CUDA kernels
themselves run only on the card: tests/test_torch_cuda.py compares them
with the plain versions there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp

from repro.kernels.graph_aggregate.ops import graph_aggregate as jax_ga
from repro.kernels.graph_aggregate.ref import graph_aggregate_ref
from repro.kernels.segment_aggregate.ops import segment_aggregate as jax_sa
from repro.kernels.segment_aggregate.ref import segment_aggregate_ref
from repro_torch.kernels import graph_aggregate as ga
from repro_torch.kernels import segment_aggregate as sa

TOL = dict(rtol=1e-5, atol=1e-5)   # f32 sums taken in another order


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------- graph_aggregate
def _ga_inputs(B, N, D, F, seed):
    rng = np.random.default_rng(seed)
    adj = (rng.random((B, N, N)) < 0.15).astype(np.float32)
    x = rng.normal(0, 1, (B, N, D)).astype(np.float32)
    w = rng.normal(0, 1, (D, F)).astype(np.float32)
    return adj, x, w


GA_CASES = [(1, 8, 16, 32, "relu", True), (3, 16, 32, 64, "relu", False),
            (2, 48, 64, 160, "none", True), (1, 17, 48, 96, "none", False),
            (2, 64, 24, 72, "relu", True)]


@pytest.mark.parametrize("case", GA_CASES, ids=str)
def test_graph_aggregate_plain_matches_jax_kernel_and_ref(case):
    B, N, D, F, act, mean = case
    adj, x, w = _ga_inputs(B, N, D, F, seed=N + F)
    got = ga.graph_aggregate(_t(adj), _t(x), _t(w), act=act, mean=mean)
    assert got.shape == (B, N, F) and got.dtype == torch.float32
    jax_out = jax_ga(jnp.asarray(adj), jnp.asarray(x), jnp.asarray(w),
                     act=act, mean=mean, block_f=64, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_out), **TOL)
    ref = graph_aggregate_ref(adj, x, w, act=act, mean=mean)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_graph_aggregate_isolated_nodes_zero():
    _, x, w = _ga_inputs(2, 8, 8, 8, seed=1)
    adj = np.zeros((2, 8, 8), np.float32)
    for mean in (True, False):
        out = ga.graph_aggregate(_t(adj), _t(x), _t(w), mean=mean)
        assert float(out.abs().max()) == 0.0


def test_graph_aggregate_rejects_other_devices():
    adj, x, w = (torch.zeros(s, device="meta")
                 for s in ((1, 4, 4), (1, 4, 8), (8, 8)))
    with pytest.raises(ValueError, match="cuda or cpu"):
        ga.graph_aggregate(adj, x, w)
    with pytest.raises(ValueError, match="act"):
        ga.graph_aggregate(adj, x, w, act="gelu")


# -------------------------------------------------------- segment_aggregate
def _sa_inputs(M, D, F, E, *, seed, integer=False, unit_scale=True):
    rng = np.random.default_rng(seed)
    if integer:
        x = rng.integers(-3, 4, (M, D)).astype(np.float32)
        w = rng.integers(-5, 6, (D, F)).astype(np.float32)
    else:
        x = rng.normal(0, 1, (M, D)).astype(np.float32)
        w = rng.normal(0, 1, (D, F)).astype(np.float32)
    scale = (np.ones((1, F), np.float32) if unit_scale
             else rng.uniform(0.5, 2.0, (1, F)).astype(np.float32))
    gather = rng.integers(0, M, E).astype(np.int32)
    scatter = rng.integers(0, M, E).astype(np.int32)
    edge_mask = (rng.random(E) < 0.8).astype(np.float32)
    node_mask = (rng.random(M) < 0.9).astype(np.float32)
    return x, w, scale, gather, scatter, edge_mask, node_mask


def _port_sa(x, w, s, g, sc, em, nm, **kw):
    edges = sa.edge_csr(_t(g), _t(sc), _t(em), x.shape[0])
    return sa.segment_aggregate(_t(x), _t(w), _t(s), edges, _t(nm), **kw)


SA_CASES = [
    # (M, D, F, E, act, mean, unit_scale)
    (16, 12, 20, 33, "relu", True, True),
    (64, 192, 192, 256, "relu", True, True),
    (9, 7, 5, 3, "none", False, True),
    (32, 32, 128, 64, "relu", False, False),
    (24, 48, 64, 100, "relu", True, False),
    (8, 16, 16, 512, "none", True, True),           # E >> M fan-in
]


@pytest.mark.parametrize("case", SA_CASES, ids=str)
def test_segment_aggregate_plain_matches_jax_kernel_and_ref(case):
    M, D, F, E, act, mean, unit = case
    args = _sa_inputs(M, D, F, E, seed=M + E, unit_scale=unit)
    got = _port_sa(*args, act=act, mean=mean)
    assert got.shape == (M, F) and got.dtype == torch.float32
    jax_out = jax_sa(*(jnp.asarray(a) for a in args), act=act, mean=mean,
                     block_e=64, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_out), **TOL)
    ref = segment_aggregate_ref(*args, act=act, mean=mean)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("mean", [True, False], ids=["mean", "sum"])
def test_segment_aggregate_bitexact_on_integers(mean):
    """Integer-valued inputs make every f32 intermediate exact: the plain
    version, the JAX kernel and the edge-loop oracle agree bit for bit."""
    args = _sa_inputs(32, 16, 24, 96, seed=7, integer=True)
    got = _port_sa(*args, mean=mean).numpy()
    jax_out = jax_sa(*(jnp.asarray(a) for a in args), mean=mean,
                     interpret=True)
    assert np.array_equal(got, np.asarray(jax_out))
    assert np.array_equal(got, segment_aggregate_ref(*args, mean=mean))


def _int8_weights(D, F, seed, *, pow2_scale=False):
    """int8 weights with per-channel scales, as `quantize_params` makes
    them; power-of-two scales keep every product exact."""
    rng = np.random.default_rng(seed)
    w = rng.integers(-127, 128, (D, F)).astype(np.int8)
    if pow2_scale:
        scale = 2.0 ** rng.integers(-6, 1, (1, F))
    else:
        scale = rng.uniform(1e-3, 2e-2, (1, F))
    return w, scale.astype(np.float32)


SA_I8_CASES = [
    # (M, D, F, E, act, mean)
    (16, 12, 20, 33, "relu", True),
    (64, 192, 192, 256, "relu", True),
    (24, 48, 64, 100, "none", False),
    (32, 32, 128, 64, "relu", False),
]


@pytest.mark.parametrize("case", SA_I8_CASES, ids=str)
def test_segment_aggregate_int8_plain_matches_jax_kernel_and_ref(case):
    """int8 weights: the plain version dequantizes `w * w_scale` as the
    kernel does, and agrees with the JAX kernel's int8 instantiation and
    the edge-loop oracle."""
    M, D, F, E, act, mean = case
    x, _, _, g, sc, em, nm = _sa_inputs(M, D, F, E, seed=M + E + 1)
    w, scale = _int8_weights(D, F, seed=M + F)
    args = (x, w, scale, g, sc, em, nm)
    got = _port_sa(*args, act=act, mean=mean)
    assert got.shape == (M, F) and got.dtype == torch.float32
    jax_out = jax_sa(*(jnp.asarray(a) for a in args), act=act, mean=mean,
                     block_e=64, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_out), **TOL)
    ref = segment_aggregate_ref(*args, act=act, mean=mean)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("mean", [True, False], ids=["mean", "sum"])
def test_segment_aggregate_int8_bitexact_on_integers(mean):
    """Integer-valued x, int8 w and power-of-two scales: every product
    and sum is exact, so all three agree bit for bit."""
    x, _, _, g, sc, em, nm = _sa_inputs(32, 16, 24, 96, seed=8,
                                        integer=True)
    w, scale = _int8_weights(16, 24, seed=9, pow2_scale=True)
    args = (x, w, scale, g, sc, em, nm)
    got = _port_sa(*args, mean=mean).numpy()
    jax_out = jax_sa(*(jnp.asarray(a) for a in args), mean=mean,
                     interpret=True)
    assert np.array_equal(got, np.asarray(jax_out))
    assert np.array_equal(got, segment_aggregate_ref(*args, mean=mean))


def test_segment_aggregate_all_edges_masked_is_zero():
    x, w, s, g, sc, em, nm = _sa_inputs(16, 8, 16, 40, seed=5)
    out = _port_sa(x, w, s, g, sc, np.zeros_like(em), nm)
    assert float(out.abs().max()) == 0.0


def test_segment_aggregate_isolated_nodes_zero():
    """Destinations no edge points at aggregate to zero, mean or sum."""
    x, w, s, g, sc, em, nm = _sa_inputs(16, 8, 16, 40, seed=6)
    sc = sc % 8                                  # nodes 8..15 get no edges
    for mean in (True, False):
        out = _port_sa(x, w, s, g, sc, em, nm, mean=mean)
        assert float(out[8:].abs().max()) == 0.0


def test_check_one_device_names_the_devices():
    """The wrappers launch on their tensors' one device; tensors spread
    over several raise a ValueError that names each tensor's device."""
    from repro_torch.kernels import build
    a, b = torch.zeros(2), torch.zeros(2, device="meta")
    build.check_one_device("k", x=a, y=a.clone())
    with pytest.raises(ValueError, match="x on cpu, y on meta"):
        build.check_one_device("k", x=a, y=b)


def test_segment_aggregate_rejects_other_devices():
    x, w, s, g, sc, em, nm = _sa_inputs(8, 4, 4, 6, seed=2)
    edges = sa.edge_csr(_t(g), _t(sc), _t(em), 8)
    with pytest.raises(ValueError, match="cuda or cpu"):
        sa.segment_aggregate(torch.zeros((8, 4), device="meta"), _t(w),
                             _t(s), edges, _t(nm))


@pytest.mark.parametrize("M,E", [(1, 0), (8, 3), (16, 40), (64, 300)])
def test_edge_csr_matches_edge_loop(M, E):
    """rowptr/src/weight group the edges by destination, each group in
    the edges' original order — what a sequential edge loop visits —
    and leave out the masked edges, which add nothing."""
    rng = np.random.default_rng(M * 7 + E)
    g = rng.integers(0, M, E).astype(np.int32)
    sc = rng.integers(0, M, E).astype(np.int32)
    em = (rng.random(E) < 0.7).astype(np.float32)
    csr = sa.edge_csr(_t(g), _t(sc), _t(em), M)
    assert csr.rowptr.dtype == torch.int32 and csr.src.dtype == torch.int32
    want_src = [[] for _ in range(M)]
    want_w = [[] for _ in range(M)]
    for e in range(E):
        if em[e] != 0:
            want_src[sc[e]].append(g[e])
            want_w[sc[e]].append(em[e])
    rowptr = csr.rowptr.numpy()
    assert rowptr[0] == 0 and rowptr[-1] == int((em != 0).sum())
    assert csr.src.shape == csr.weight.shape == (E,)
    for d in range(M):
        lo, hi = rowptr[d], rowptr[d + 1]
        assert csr.src[lo:hi].tolist() == want_src[d]
        assert csr.weight[lo:hi].tolist() == want_w[d]


# ------------------------------------------ split-TF32 products, emulated
# The CUDA kernels take their products on the tensor cores in tf32
# (csrc/tf32_mma.cuh). These tests emulate that arithmetic on the CPU, so
# a change to it can be tried here before the card: cvt.rna.tf32.f32 as
# bit operations on f32 views, the tensor cores' tf32 products (exact in
# f32) summed in float64 and rounded once to f32 (the card sums in f32,
# ~2^-24 relative per add, far below the limit below). Each is held to
# chip_smoke.py's check: max|out - ref| <= 1e-5 · max(1, max|ref|), ref the
# plain version in f32.
LIMIT = 1e-5


def _tf32_rna(a):
    """cvt.rna.tf32.f32: round to 10 explicit mantissa bits, ties away
    from zero; the low 13 bits come out 0 (finite inputs)."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(a):
    hi = _tf32_rna(a)
    return hi, _tf32_rna(np.asarray(a, np.float32) - hi)


def _tf32_product(a, b, terms):
    """a @ b as the kernels issue it: 1 = one tf32 product, 2 = a_hi b_hi
    + a_hi b_lo (a exact in tf32), 3 = + a_lo b_hi."""
    (a_hi, a_lo), (b_hi, b_lo) = _split(a), _split(b)
    f64 = np.float64
    out = a_hi.astype(f64) @ b_hi.astype(f64)
    if terms >= 2:
        out += a_hi.astype(f64) @ b_lo.astype(f64)
    if terms >= 3:
        out += a_lo.astype(f64) @ b_hi.astype(f64)
    return out.astype(np.float32)


def _ratio(out, ref):
    """max|out - ref| over chip_smoke.py's limit."""
    return float(np.abs(out - ref).max()) / (
        LIMIT * max(1.0, float(np.abs(ref).max())))


def _sa_emulated(x, w, scale, g, sc, em, nm, terms, mean=True):
    msg = np.maximum(_tf32_product(x * nm[:, None], w * scale, terms), 0)
    out = np.zeros(msg.shape, np.float64)
    np.add.at(out, sc, msg[g].astype(np.float64) * em[:, None])
    if mean:
        deg = np.zeros(msg.shape[0], np.float64)
        np.add.at(deg, sc, em)
        out = out / np.maximum(deg, 1.0)[:, None]
    return out.astype(np.float32)


def _pack_inputs(seed=11):
    """The replay pack's shape: M=512, D=F=192, ~2 edges per node."""
    rng = np.random.default_rng(seed)
    M, D, F, E = 512, 192, 192, 1024
    x = rng.normal(0, 1, (M, D)).astype(np.float32)
    w = (rng.normal(0, 1, (D, F)) / np.sqrt(D)).astype(np.float32)
    g, sc = (rng.integers(0, M, E).astype(np.int32) for _ in range(2))
    em = (rng.random(E) < 0.8).astype(np.float32)
    nm = (rng.random(M) < 0.9).astype(np.float32)
    return x, w, np.ones((1, F), np.float32), g, sc, em, nm


def test_split_tf32_segment_aggregate_emulated_at_the_pack():
    """At the replay pack, one tf32 product fails the check and the
    three-term split stays well inside it."""
    args = _pack_inputs()
    ref = _port_sa(*args).numpy()
    single = _ratio(_sa_emulated(*args, terms=1), ref)
    split = _ratio(_sa_emulated(*args, terms=3), ref)
    print(f"segment_aggregate M=512: one tf32 product {single:.2f}x the "
          f"limit, split tf32 {split:.4f}x")
    assert single > 1.0
    assert split < 0.1


def test_split_tf32_graph_aggregate_emulated():
    """graph_aggregate at B=8, N=64, D=F=192: X·W in three terms, then
    the exact 0/1 adjacency times msg in two (A msg_hi + A msg_lo)."""
    rng = np.random.default_rng(12)
    B, N, D, F = 8, 64, 192, 192
    adj = (rng.random((B, N, N)) < 2.0 / N).astype(np.float32)
    x = rng.normal(0, 1, (B, N, D)).astype(np.float32)
    w = (rng.normal(0, 1, (D, F)) / np.sqrt(D)).astype(np.float32)
    assert not _split(adj)[1].any()                 # exact in tf32
    ref = ga.graph_aggregate(_t(adj), _t(x), _t(w)).numpy()
    deg = np.maximum(adj.sum(-1, keepdims=True), 1.0)

    def emulated(t1, t2):
        msg = np.maximum(_tf32_product(x, w, t1), 0)
        return np.stack([_tf32_product(adj[b], msg[b], t2)
                         for b in range(B)]) / deg
    single = _ratio(emulated(1, 1), ref)
    split = _ratio(emulated(3, 2), ref)
    print(f"graph_aggregate N=64: one tf32 product each {single:.2f}x the "
          f"limit, split tf32 (3 + 2 terms) {split:.4f}x")
    assert single > 1.0
    assert split < 0.1


@pytest.mark.parametrize("weights", ["f32", "int8"])
def test_split_tf32_integer_inputs_are_exact(weights):
    """The bit-exact checks' inputs (x in [-3, 3]; w in [-5, 5], or int8
    times 2^-6..2^0) have no lo half, and the split products equal the
    plain version bit for bit."""
    x, w, s, g, sc, em, nm = _sa_inputs(128, 64, 96, 300, seed=13,
                                        integer=True)
    if weights == "int8":
        wq, s = _int8_weights(64, 96, seed=14, pow2_scale=True)
        w = wq.astype(np.float32)
    for a in (x * nm[:, None], w * s):
        assert not _split(a)[1].any()
    plain_w = wq if weights == "int8" else w
    exact = (x * nm[:, None]).astype(np.float64) @ (w * s).astype(np.float64)
    assert np.array_equal(_tf32_product(x * nm[:, None], w * s, 3),
                          exact.astype(np.float32))
    for mean in (True, False):
        ref = _port_sa(x, plain_w, s, g, sc, em, nm, mean=mean).numpy()
        assert np.array_equal(
            _sa_emulated(x, w, s, g, sc, em, nm, terms=3, mean=mean), ref)

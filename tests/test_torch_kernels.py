"""The port's GraphSAGE aggregation kernels against the JAX package.

Each plain PyTorch version (what the wrappers run on CPU tensors) is held
against the Pallas kernel run in interpret mode, as tests/test_kernels.py
runs it, and against the kernel's `ref.py` oracle. The CUDA kernels
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

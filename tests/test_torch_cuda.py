"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: they skip without a CUDA device, and this file imports
nothing of jax so that it runs on a machine with the card and no jax:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels import graph_aggregate as ga
from repro_torch.kernels import segment_aggregate as sa


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a)).cuda()


def _ga_inputs(B, N, D, F, seed):
    rng = np.random.default_rng(seed)
    adj = (rng.random((B, N, N)) < 0.15).astype(np.float32)
    x = rng.normal(0, 1, (B, N, D)).astype(np.float32)
    w = (rng.normal(0, 1, (D, F)) / np.sqrt(D)).astype(np.float32)
    return adj, x, w


def _sa_inputs(M, D, F, E, seed):
    """Integer-valued operands: every f32 sum is exact."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 4, (M, D)).astype(np.float32)
    w = rng.integers(-5, 6, (D, F)).astype(np.float32)
    scale = np.ones((F,), np.float32)
    gather = rng.integers(0, M, E).astype(np.int32)
    scatter = rng.integers(0, M, E).astype(np.int32)
    edge_mask = (rng.random(E) < 0.8).astype(np.float32)
    node_mask = (rng.random(M) < 0.9).astype(np.float32)
    return x, w, scale, gather, scatter, edge_mask, node_mask


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")


@pytest.mark.cuda
@pytest.mark.parametrize("N,mean", [(17, True), (64, False), (100, True)])
def test_graph_aggregate_cuda_kernel_matches_plain(N, mean):
    _need_card()
    adj, x, w = (_t(a) for a in _ga_inputs(4, N, 192, 192, seed=N))
    before = ga.launches
    out = ga.graph_aggregate(adj, x, w, mean=mean)
    assert ga.launches == before + 1
    ref = ga.graph_aggregate_plain(adj, x, w, mean=mean)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("mean", [True, False], ids=["mean", "sum"])
def test_segment_aggregate_cuda_kernel_bitexact_on_integers(mean):
    _need_card()
    x, w, s, g, sc, em, nm = (_t(a) for a in _sa_inputs(
        128, 64, 96, 300, seed=3))
    edges = sa.edge_csr(g, sc, em, 128)
    out = sa.segment_aggregate(x, w, s, edges, nm, mean=mean)
    ref = sa.segment_aggregate_plain(x, w, s, g, sc, em, nm, mean=mean)
    assert torch.equal(out, ref)


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take():
    _need_card()
    adj, x, w = (_t(a) for a in _ga_inputs(2, 8, 16, 16, seed=0))
    with pytest.raises(ValueError, match="contiguous float32"):
        ga.graph_aggregate(adj, x.transpose(1, 2).contiguous()
                           .transpose(1, 2), w)
    with pytest.raises(ValueError, match="contiguous float32"):
        ga.graph_aggregate(adj, x, w.double())
    xs, ws, s, g, sc, em, nm = (_t(a) for a in _sa_inputs(16, 8, 8, 20, 1))
    edges = sa.edge_csr(g, sc, em, 16)
    with pytest.raises(ValueError, match="contiguous"):
        sa.segment_aggregate(xs, ws.half(), s, edges, nm)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_cost_model_on_card_kernels_match_plain(layout):
    """The whole forward on the card, with and without the kernels."""
    _need_card()
    from repro_torch.core import features as F
    from repro_torch.core.evaluate import make_predict_fn
    from repro_torch.core.model import CostModelConfig, cost_model_init
    from repro_torch.data.batching import encode_packed
    from repro_torch.data.synthetic import random_kernel

    graphs = [random_kernel(n, seed=i) for i, n in enumerate((5, 12, 20))]
    norm = F.fit_normalizer(graphs)
    batch = (F.encode_batch(graphs, 24, norm) if layout == "dense"
             else encode_packed(graphs, norm))
    preds = []
    for kernels in (True, False):
        cfg = CostModelConfig(hidden_dim=64, opcode_embed_dim=16,
                              max_nodes=24, dropout=0.0, adjacency=layout,
                              use_pallas_aggregate=kernels)
        model = cost_model_init(torch.Generator().manual_seed(0), cfg)
        preds.append(make_predict_fn(cfg)(model, batch))
    np.testing.assert_allclose(preds[0], preds[1], rtol=1e-5, atol=1e-5)

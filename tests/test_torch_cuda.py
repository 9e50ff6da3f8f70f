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


def _int8_weights(D, F, seed, *, pow2_scale):
    rng = np.random.default_rng(seed)
    w = rng.integers(-127, 128, (D, F)).astype(np.int8)
    scale = (2.0 ** rng.integers(-6, 1, (F,)) if pow2_scale
             else rng.uniform(1e-3, 2e-2, (F,)))
    return _t(w), _t(scale.astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("mean", [True, False], ids=["mean", "sum"])
def test_segment_aggregate_int8_cuda_kernel_bitexact_on_integers(mean):
    """The int8-weight entry point: integer x, int8 w and power-of-two
    scales make every sum exact, so kernel and plain agree bit for bit;
    only the int8 launch count moves."""
    _need_card()
    x, _, _, g, sc, em, nm = (_t(a) for a in _sa_inputs(
        128, 64, 96, 300, seed=4))
    w, s = _int8_weights(64, 96, seed=5, pow2_scale=True)
    edges = sa.edge_csr(g, sc, em, 128)
    before, before_i8 = sa.launches, sa.launches_i8
    out = sa.segment_aggregate(x, w, s, edges, nm, mean=mean)
    assert (sa.launches, sa.launches_i8) == (before, before_i8 + 1)
    ref = sa.segment_aggregate_plain(x, w, s, g, sc, em, nm, mean=mean)
    assert torch.equal(out, ref)


@pytest.mark.cuda
def test_segment_aggregate_int8_cuda_kernel_matches_plain():
    _need_card()
    rng = np.random.default_rng(6)
    M, D, F, E = 512, 192, 192, 1024
    x = _t(rng.normal(0, 1, (M, D)).astype(np.float32))
    g, sc = (_t(rng.integers(0, M, E).astype(np.int32)) for _ in range(2))
    em = _t((rng.random(E) < 0.6).astype(np.float32))
    nm = _t((rng.random(M) < 0.9).astype(np.float32))
    w, s = _int8_weights(D, F, seed=7, pow2_scale=False)
    out = sa.segment_aggregate(x, w, s, sa.edge_csr(g, sc, em, M), nm)
    ref = sa.segment_aggregate_plain(x, w, s, g, sc, em, nm)
    tol = 1e-5 * float(ref.abs().max())
    assert float((out - ref).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dense", "sparse", "segmented"])
def test_int8_cost_model_on_card_kernels_match_plain(layout):
    """The int8 forward on the card with and without the kernels; on the
    sparse and segmented layouts the int8 kernel variant runs."""
    _need_card()
    from repro_torch.core import features as F
    from repro_torch.core.evaluate import make_predict_fn
    from repro_torch.core.model import CostModelConfig, cost_model_init
    from repro_torch.data.batching import encode_packed, encode_segmented
    from repro_torch.data.synthetic import random_kernel, whole_model_graph
    from repro_torch.quant import QuantizedCostModel, quantize_params

    graphs = [random_kernel(n, seed=i) for i, n in enumerate((5, 12, 20))]
    norm = F.fit_normalizer(graphs)
    if layout == "dense":
        batch = F.encode_batch(graphs, 24, norm)
    elif layout == "sparse":
        batch = encode_packed(graphs, norm)
    else:
        batch = encode_segmented([whole_model_graph(1200, seed=0)] + graphs,
                                 256, norm)
    cfg = CostModelConfig(hidden_dim=64, opcode_embed_dim=16, max_nodes=24,
                          dropout=0.0, adjacency=layout,
                          reduction="column_wise",
                          use_pallas_aggregate=True)
    qm = quantize_params(cost_model_init(torch.Generator().manual_seed(0),
                                         cfg))
    preds = []
    before = sa.launches_i8
    for kernels in (True, False):
        q = QuantizedCostModel(qm.params, qm.act_scales,
                               dict(qm.config, use_pallas_aggregate=kernels))
        preds.append(make_predict_fn(q.serving_config())(q.model(), batch))
    assert (sa.launches_i8 > before) == (layout != "dense")
    np.testing.assert_allclose(preds[0], preds[1], rtol=1e-5, atol=1e-5)


# ------------------- split-TF32 tensor-core kernels at ragged shapes
def _within_limit(out, ref):
    """chip_smoke.py's check: max|out - ref| <= 1e-5 · max(1, max|ref|)."""
    err = float((out - ref).abs().max())
    assert err <= 1e-5 * max(1.0, float(ref.abs().max())), err


def _real_inputs(M, D, F, E, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (M, D)).astype(np.float32)
    w = (rng.normal(0, 1, (D, F)) / np.sqrt(D)).astype(np.float32)
    g, sc = (rng.integers(0, M, E).astype(np.int32) for _ in range(2))
    em = (rng.random(E) < 0.8).astype(np.float32)
    nm = (rng.random(M) < 0.9).astype(np.float32)
    return x, w, g, sc, em, nm


# M = 1 .. 512 take the fused launch (a cluster of row tiles), 1000 the
# two-launch plan; D, F = 100 are not multiples of 64 (F = 100 is also
# not a multiple of 16: the int8 tile travels as 4-byte copies)
SA_SHAPES = [(1, 192, 192), (63, 192, 192), (64, 192, 192),
             (65, 192, 192), (512, 192, 192), (300, 100, 100),
             (1000, 192, 192), (130, 100, 100)]


@pytest.mark.cuda
@pytest.mark.parametrize("weights", ["f32", "int8"])
@pytest.mark.parametrize("shape", SA_SHAPES, ids=str)
def test_segment_aggregate_split_tf32_matches_plain(shape, weights):
    _need_card()
    M, D, F = shape
    x, w, g, sc, em, nm = (_t(a) for a in _real_inputs(M, D, F, 2 * M,
                                                       seed=M + D))
    if weights == "int8":
        w, s = _int8_weights(D, F, seed=M, pow2_scale=False)
    else:
        s = torch.ones((F,), device="cuda")
    edges = sa.edge_csr(g, sc, em, M)
    for mean in (True, False):
        out = sa.segment_aggregate(x, w, s, edges, nm, mean=mean)
        ref = sa.segment_aggregate_plain(x, w, s, g, sc, em, nm, mean=mean)
        _within_limit(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [192, 1000])
def test_segment_aggregate_all_masked_row_tile(M):
    """Rows 64..127 masked: that row tile skips its product, and its
    messages (act(0) = 0) still reach the destinations that read them."""
    _need_card()
    x, w, g, sc, em, nm = _real_inputs(M, 192, 192, 3 * M, seed=M)
    nm[64:128] = 0.0
    x, w, g, sc, em, nm = (_t(a) for a in (x, w, g, sc, em, nm))
    s = torch.ones((192,), device="cuda")
    out = sa.segment_aggregate(x, w, s, sa.edge_csr(g, sc, em, M), nm)
    _within_limit(out, sa.segment_aggregate_plain(x, w, s, g, sc, em, nm))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [65, 1000])
def test_segment_aggregate_bitexact_on_integers_both_plans(M):
    """Integer inputs through the fused launch (M = 65) and the two-launch
    plan (M = 1000), f32 and int8 weights: bit-exact."""
    _need_card()
    x, w, _, g, sc, em, nm = (_t(a) for a in _sa_inputs(M, 192, 192, 2 * M,
                                                        seed=M))
    wq, sq = _int8_weights(192, 192, seed=M + 1, pow2_scale=True)
    edges = sa.edge_csr(g, sc, em, M)
    for ww, ss in ((w, torch.ones((192,), device="cuda")), (wq, sq)):
        for mean in (True, False):
            out = sa.segment_aggregate(x, ww, ss, edges, nm, mean=mean)
            ref = sa.segment_aggregate_plain(x, ww, ss, g, sc, em, nm,
                                             mean=mean)
            assert torch.equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 17, 64, 100])
@pytest.mark.parametrize("DF", [(192, 192), (100, 100)], ids=str)
def test_graph_aggregate_split_tf32_matches_plain(N, DF):
    _need_card()
    D, F = DF
    adj, x, w = (_t(a) for a in _ga_inputs(8, N, D, F, seed=N + D))
    for mean in (True, False):
        for act in ("relu", "none"):
            out = ga.graph_aggregate(adj, x, w, act=act, mean=mean)
            ref = ga.graph_aggregate_plain(adj, x, w, act=act, mean=mean)
            _within_limit(out, ref)


@pytest.mark.cuda
def test_graph_aggregate_weighted_adjacency_takes_three_terms():
    """A real-valued adjacency has a lo half: the kernel sees it and
    issues the third product term."""
    _need_card()
    adj, x, w = _ga_inputs(4, 64, 192, 192, seed=5)
    adj = adj * np.random.default_rng(6).uniform(0.1, 1.0, adj.shape)
    adj, x, w = (_t(a.astype(np.float32)) for a in (adj, x, w))
    out = ga.graph_aggregate(adj, x, w)
    _within_limit(out, ga.graph_aggregate_plain(adj, x, w))


# N > 192 (at D = 192) keeps the messages in a device scratch and walks
# A·msg in chunks of source nodes; B = 48 graphs make some blocks reuse
# their slice of it; N = 257 and D, F = 100 stage A and W by cp.async
GA_LARGE = [(2, 193, 192, 192), (48, 256, 192, 192), (2, 512, 192, 192),
            (2, 832, 192, 192), (2, 1000, 192, 192), (3, 257, 100, 100)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", GA_LARGE, ids=str)
def test_graph_aggregate_large_graphs_take_the_scratch(shape):
    _need_card()
    B, N, D, F = shape
    assert ga._kernel()[1](B, N, D, F) > 0      # the scratch plan
    adj, x, w = (_t(a) for a in _ga_inputs(B, N, D, F, seed=N))
    for mean in (True, False):
        for act in ("relu", "none"):
            out = ga.graph_aggregate(adj, x, w, act=act, mean=mean)
            ref = ga.graph_aggregate_plain(adj, x, w, act=act, mean=mean)
            _within_limit(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [64, 512])
def test_graph_aggregate_bitexact_on_integers_both_plans(N):
    """Integer inputs, messages in the SM (N = 64) and in the scratch
    (N = 512): every sum is exact, so bit-exact."""
    _need_card()
    rng = np.random.default_rng(N)
    adj = (rng.random((4, N, N)) < 0.15).astype(np.float32)
    x = rng.integers(-3, 4, (4, N, 192)).astype(np.float32)
    w = rng.integers(-5, 6, (192, 192)).astype(np.float32)
    adj, x, w = _t(adj), _t(x), _t(w)
    for mean in (True, False):
        out = ga.graph_aggregate(adj, x, w, mean=mean)
        assert torch.equal(out, ga.graph_aggregate_plain(adj, x, w,
                                                         mean=mean))


# ------------------------------------------------ LM zoo: flash, ssd_scan
# (B, Sq, Sk, H, KH, hd, causal, window, q_offset)
FLASH_CUDA_CASES = [
    (2, 200, 200, 8, 2, 120, True, 64, 0),     # the model's hd, ragged S
    (1, 128, 128, 4, 4, 128, True, None, 0),
    (2, 96, 96, 8, 2, 16, False, None, 0),
    (1, 70, 70, 4, 1, 48, False, 20, 0),       # non-causal window, MQA
    (1, 24, 300, 4, 2, 64, True, 100, 276),    # int q_offset, Sq < Sk
    (1, 1024, 1024, 4, 2, 120, True, 256, 0),  # key tiles skipped, edges
    (2, 190, 190, 4, 2, 64, False, 100, 0),    # Sq not a multiple of 128
]


def _flash_cuda_inputs(case, dtype, seed):
    B, Sq, Sk, H, KH, hd = case[:6]
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to("cuda", dtype)
            for shape in ((B, Sq, H, hd), (B, Sk, KH, hd), (B, Sk, KH, hd))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CUDA_CASES, ids=str)
def test_flash_attention_cuda_kernel_matches_plain(case, dtype):
    """f32 (csrc/flash_attention_tf32.cu): split-TF32 products with f32
    sums against cuBLAS's f32 (TF32 off), 2e-5; bf16 (the tensor-core kernel,
    csrc/flash_attention_sm90.cu): f32 sums with P split into bf16
    halves, rounded to bf16, so at most one ulp (<= 2^-7·|ref|) apart,
    held to 2^-6·|ref| + 1e-5 per element."""
    _need_card()
    from repro_torch.kernels import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    causal, window, q_offset = case[6:]
    q, k, v = _flash_cuda_inputs(case, getattr(torch, dtype), seed=case[5])
    before = fa.launches, fa.launches_tc, fa.launches_f32
    out = fa.flash_attention(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)
    bf16 = dtype == "bfloat16"
    assert (fa.launches, fa.launches_tc, fa.launches_f32) == (
        before[0] + 1, before[1] + bf16, before[2] + (not bf16))
    ref = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
    assert out.dtype == q.dtype
    rtol, atol = (2.0 ** -6, 1e-5) if dtype == "bfloat16" else (2e-5, 2e-5)
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("block", [(128, 128), (128, 64), (64, 128),
                                   (64, 64)], ids=str)
@pytest.mark.parametrize("case", FLASH_CUDA_CASES, ids=str)
def test_flash_attention_bf16_block_shapes_match_plain(case, block):
    """Each (block_q, block_k) instantiation of the bf16 kernel
    (csrc/flash_attention_sm90.cu) against the plain version, held as
    the default shape is (2^-6·|ref| + 1e-5 per element); one launch,
    counted under its block shape."""
    _need_card()
    from repro_torch.kernels import flash_attention as fa
    causal, window, q_offset = case[6:]
    q, k, v = _flash_cuda_inputs(case, torch.bfloat16, seed=case[5] + 3)
    before = fa.launches_tc, dict(fa.launches_sm90)
    out = fa.flash_attention(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, block_q=block[0],
                             block_k=block[1])
    want = dict(before[1])
    want[block] += 1
    assert fa.launches_tc == before[0] + 1 and fa.launches_sm90 == want
    ref = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
    worst = float(((out.float() - ref.float()).abs()
                   / (2.0 ** -6 * ref.float().abs() + 1e-5)).max())
    assert worst <= 1.0, worst


# the f32 kernel held element by element as chip_smoke.py holds it:
# |out - ref| <= 2e-5·|ref| + 5e-6 against the plain version in float64
# (`exact`: on the card the f32 plain version's own products land up to
# ~2x that limit from it at hd 256, q x 3); (B, Sq, Sk, H, KH, hd,
# causal, window, q_offset, q scale): hd 64 / 120 / 128, q_offset > 0
# with Sq < Sk, and q x 3 (larger scores, where exp turns a score's
# error into most of it)
FLASH_F32_CASES = [
    (1, 512, 512, 4, 1, hd, True, window, 0, 1.0)
    for hd in (64, 120, 128) for window in (None, 100)] + [
    (2, 96, 320, 8, 2, hd, True, 150, 224, 1.0) for hd in (64, 120, 128)] + [
    (1, 512, 512, 4, 1, 120, True, 256, 0, 3.0),
    (1, 1024, 1024, 4, 2, 128, True, None, 0, 3.0),
    (1, 96, 320, 4, 1, 64, True, 100, 224, 3.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_F32_CASES, ids=str)
def test_flash_attention_f32_split_tf32_within_flash_tol(case):
    _need_card()
    from repro_torch.kernels import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    causal, window, q_offset, qmul = case[6:]
    q, k, v = _flash_cuda_inputs(case, torch.float32, seed=case[5] + 7)
    q = q * qmul
    before = fa.launches_f32
    out = fa.flash_attention(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)
    assert fa.launches_f32 == before + 1
    ref = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, exact=True)
    worst = float(((out - ref).abs() / (2e-5 * ref.abs() + 5e-6)).max())
    assert worst <= 1.0, worst


@pytest.mark.cuda
def test_flash_attention_f32_counts_its_launches():
    """One f32 call is one launch of the f32 route (its key/value split
    pre-pass and the attention kernel count as one), none of the bf16."""
    _need_card()
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _flash_cuda_inputs((1, 64, 64, 4, 2, 64), torch.float32, 0)
    before = fa.launches, fa.launches_tc, fa.launches_f32
    for _ in range(3):
        fa.flash_attention(q, k, v, causal=True)
    assert (fa.launches, fa.launches_tc, fa.launches_f32) == (
        before[0] + 3, before[1], before[2] + 3)


# 128 < hd <= 256 (bf16: csrc/flash_attention_hd256.cu; f32:
# csrc/flash_attention_hd256_tf32.cu), held element by element as
# chip_smoke.py holds it: bf16 |out - ref| <= 2^-6·|ref| + 1e-5, f32
# 2e-5·|ref| + 5e-6 against the plain version in float64 (`exact`);
# (B, Sq, Sk, H, KH, hd, causal, window, q_offset[, scale of q, k and
# v[, scale of q alone]]): recurrentgemma-9b's MQA with a window,
# ragged rows, a q_offset with Sq < Sk, non-causal, hd 136 and 192 (the
# last column box partly past hd, the fourth never loaded); then for the
# bf16 kernel's blocks of 128 query rows (two warpgroups of 64): Sq = 129
# and 200 (the second warpgroup of the last block wholly or partly past
# Sq), windows whose lower edge makes the two warpgroups walk different
# key tiles, and late rows of an S = 4096 causal head with q, k, v ~
# N(0, 1.7^2) (a peaked softmax over large v, where the tensor cores'
# truncating accumulation shows: tests/test_torch_zoo_kernels.py); last,
# q x 3 at hd 256, where one f32 accumulator over all 256 columns of
# Q·K^T would fail the f32 limit (the f32 kernel sums 64 columns an
# accumulator)
FLASH_HD256_CASES = [
    (2, 300, 300, 4, 1, 256, True, 100, 0),
    (1, 256, 256, 2, 1, 256, True, None, 0),
    (1, 40, 300, 4, 2, 256, True, 120, 260),
    (1, 130, 130, 2, 2, 256, False, None, 0),
    (1, 200, 200, 4, 1, 136, True, 64, 0),
    (2, 96, 96, 2, 1, 192, False, 40, 0),
    (1, 129, 129, 2, 1, 256, True, None, 0),
    (2, 200, 200, 4, 1, 256, True, 150, 0),
    (1, 512, 512, 2, 1, 256, True, 64, 0),
    (1, 384, 384, 4, 2, 192, True, 70, 0),
    (1, 1024, 4096, 2, 1, 256, True, None, 3072, 1.7),
    (1, 256, 256, 2, 1, 256, True, None, 0, 1.0, 3.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_HD256_CASES, ids=str)
def test_flash_attention_hd256_matches_plain(case, dtype):
    _need_card()
    from repro_torch.kernels import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    causal, window, q_offset = case[6:9]
    scale = case[9] if len(case) > 9 else 1.0
    q, k, v = (t * scale for t in _flash_cuda_inputs(
        case, getattr(torch, dtype), seed=case[5]))
    if len(case) > 10:
        q = q * case[10]
    bf16 = dtype == "bfloat16"
    before = fa.launches, fa.launches_hd256, fa.launches_hd256_f32
    out = fa.flash_attention(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)
    assert (fa.launches, fa.launches_hd256, fa.launches_hd256_f32) == (
        before[0] + 1, before[1] + bf16, before[2] + (not bf16))
    ref = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, exact=not bf16)
    rtol, atol = (2.0 ** -6, 1e-5) if bf16 else (2e-5, 5e-6)
    worst = float(((out.float() - ref.float()).abs()
                   / (rtol * ref.float().abs() + atol)).max())
    assert worst <= 1.0, worst


@pytest.mark.cuda
def test_flash_attention_hd256_f32_counts_its_launches():
    """One f32 call at hd 256 runs two device kernels, the key/value split
    pre-pass and the attention kernel, and counts one launch of the
    hd256_f32 route, none of the others."""
    _need_card()
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import flash_attention as fa
    q, k, v = _flash_cuda_inputs((1, 100, 100, 4, 1, 256), torch.float32, 0)
    fa.flash_attention(q, k, v, causal=True)          # build and load
    torch.cuda.synchronize()
    before = (fa.launches, fa.launches_tc, fa.launches_f32,
              fa.launches_hd256, fa.launches_hd256_f32)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fa.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
    assert (fa.launches, fa.launches_tc, fa.launches_f32,
            fa.launches_hd256, fa.launches_hd256_f32) == (
        before[0] + 3, before[1], before[2], before[3], before[4] + 3)
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("split_kv" in n for n in names) == 3, names
    assert sum("flash_hd256_tf32" in n for n in names) == 3, names


def _every_kernel(dev):
    """One call of every kernel wrapper on `dev`, beside its plain
    version: [(label, out, ref, exact)]."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    res = []
    adj, x, w = (torch.from_numpy(a).to(dev)
                 for a in _ga_inputs(2, 64, 192, 192, seed=1))
    res.append(("graph_aggregate", ga.graph_aggregate(adj, x, w),
                ga.graph_aggregate_plain(adj, x, w), False))
    xs, ws, s, g, sc, em, nm = (torch.from_numpy(a).to(dev)
                                for a in _sa_inputs(128, 64, 96, 300, 2))
    edges = sa.edge_csr(g, sc, em, 128)
    res.append(("segment_aggregate", sa.segment_aggregate(
        xs, ws, s, edges, nm), sa.segment_aggregate_plain(
        xs, ws, s, g, sc, em, nm), True))
    wq, sq = (t.to(dev) for t in _int8_weights(64, 96, 3, pow2_scale=True))
    res.append(("segment_aggregate int8", sa.segment_aggregate(
        xs, wq, sq, edges, nm), sa.segment_aggregate_plain(
        xs, wq, sq, g, sc, em, nm), True))
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (t.to(dev) for t in _flash_cuda_inputs(
            (1, 200, 200, 8, 2, 120), dtype, seed=4))
        res.append((f"flash_attention {dtype}", fa.flash_attention(
            q, k, v, causal=True, window=64), fa.flash_attention_plain(
            q, k, v, causal=True, window=64), False))
    gen = torch.Generator().manual_seed(5)
    S = torch.randn((2, 5, 3, 16, 8), generator=gen).to(dev)
    d = torch.rand((2, 5, 3), generator=gen).to(dev)
    res.append(("ssd_scan", ss.ssd_scan(S, d)[1], ss.ssd_scan_plain(S, d)[1],
                True))
    return res


@pytest.mark.cuda
def test_every_kernel_launches_on_its_tensors_device():
    """Tensors on cuda:1 while the current device is cuda:0: each wrapper
    launches its kernel on cuda:1 (a launch on the current device would
    read another card's memory) and leaves the current device as it was.
    Skips below two cards."""
    _need_card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.cuda.device(0):
        results = _every_kernel(torch.device("cuda", 1))
        torch.cuda.synchronize(1)
        assert torch.cuda.current_device() == 0
    for label, out, ref, exact in results:
        assert out.device == torch.device("cuda", 1), label
        if exact:
            assert torch.equal(out, ref), label
        elif out.dtype == torch.bfloat16:
            torch.testing.assert_close(out.float(), ref.float(),
                                       rtol=2.0 ** -6, atol=1e-5)
        else:
            torch.testing.assert_close(out, ref, rtol=2e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [120, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_cuda_kernel_reads_strided_layouts(dtype, hd):
    """q, k, v as views into one packed [B, S, 3, H, hd] projection (in
    bf16 through the TMA tensor maps' strides), at the hd <= 128 and the
    hd-256 routes' head dims."""
    _need_card()
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator().manual_seed(1)
    qkv = torch.randn((2, 130, 3, 4, hd), generator=g).to(
        "cuda", getattr(torch, dtype))
    q, k, v = qkv[:, :, 0], qkv[:, :, 1, :2], qkv[:, :, 2, 2:]
    out = fa.flash_attention(q, k, v, causal=True, window=50)
    ref = fa.flash_attention_plain(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=True, window=50)
    rtol, atol = (2.0 ** -6, 1e-5) if dtype == "bfloat16" else (2e-5, 2e-5)
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [130, 256])
def test_flash_attention_hd256_f32_reads_q_without_16_byte_rows(hd):
    """The hd-256 f32 kernel copies q in 16-byte pieces only where q's
    base, strides and hd allow; here q starts 4 bytes into a row of hd + 1
    floats (and hd 130 is no multiple of 4): its 4-byte copies."""
    _need_card()
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator().manual_seed(2)
    buf = torch.randn((1, 150, 4, hd + 1), generator=g).cuda()
    q = buf[..., 1:]
    k, v = (torch.randn((1, 150, 2, hd), generator=g).cuda()
            for _ in range(2))
    before = fa.launches_hd256_f32
    out = fa.flash_attention(q, k, v, causal=True, window=70)
    assert fa.launches_hd256_f32 == before + 1
    ref = fa.flash_attention_plain(q, k, v, causal=True, window=70,
                                   exact=True)
    worst = float(((out - ref).abs() / (2e-5 * ref.abs() + 5e-6)).max())
    assert worst <= 1.0, worst


@pytest.mark.cuda
def test_flash_attention_cuda_wrapper_rejects_what_the_kernel_does_not_take():
    _need_card()
    from repro_torch.kernels import flash_attention as fa
    q = torch.zeros((1, 8, 2, 264), device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q)
    q = torch.zeros((1, 8, 2, 16), device="cuda")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="sees no key"):
        fa.flash_attention(q, q, q, window=4, q_offset=8)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros((1, 8, 16, 2), device="cuda").transpose(2, 3)
        fa.flash_attention(t, t, t)


@pytest.mark.cuda
def test_flash_attention_cuda_bf16_rejects_what_tma_cannot_take():
    """The bf16 kernel's tensor maps need 16-byte aligned pointers and
    strides, rows of hd * 2 bytes included; the wrapper says which rule
    a layout breaks, and launches nothing."""
    _need_card()
    from repro_torch.kernels import flash_attention as fa
    bf = torch.bfloat16
    before = fa.launches
    q = torch.zeros((1, 8, 2, 20), device="cuda", dtype=bf)
    with pytest.raises(ValueError, match="multiple of 8"):
        fa.flash_attention(q, q, q)
    buf = torch.zeros((1, 8, 2, 72), device="cuda", dtype=bf)
    with pytest.raises(ValueError, match="16-byte aligned"):
        t = buf[..., 1:65]
        fa.flash_attention(t, t, t)
    buf = torch.zeros((1, 8, 2, 68), device="cuda", dtype=bf)
    with pytest.raises(ValueError, match="strides"):
        t = buf[..., :64]
        fa.flash_attention(t, t, t)
    assert fa.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(1, 1, 1, 8, 8), (2, 5, 3, 16, 8),
                                  (2, 32, 80, 128, 64)], ids=str)
def test_ssd_scan_cuda_kernel_bitexact_with_plain(case):
    """The kernel rounds the multiply and the add apart, as the plain
    version's two ops do: bit for bit on any input."""
    _need_card()
    from repro_torch.kernels import ssd_scan as ss
    g = torch.Generator().manual_seed(case[1])
    S = torch.randn(case, generator=g).cuda()
    d = torch.rand(case[:3], generator=g).cuda()
    before = ss.launches
    hb, hf = ss.ssd_scan(S, d)
    assert ss.launches == before + 1
    rb, rf = ss.ssd_scan_plain(S, d)
    assert torch.equal(hb, rb) and torch.equal(hf, rf)
    assert float(hb[:, 0].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "qwen3-14b"])
def test_smoke_lm_on_card_flash_kernel_matches_chunked(arch):
    """The smoke LM (f32) on the card with the flash kernel on vs. off;
    one launch per attention layer per forward."""
    _need_card()
    import dataclasses

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import lm, registry
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = registry.get_smoke_config(arch)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cuda")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 80))).cuda()
    losses, logits = [], []
    for flag in (True, False):
        c = dataclasses.replace(cfg, use_pallas_attn=flag)
        before = fa.launches
        losses.append(float(lm.loss_fn(params, c, {"tokens": tokens})))
        assert fa.launches - before == (cfg.num_layers if flag else 0)
        logits.append(lm.logits_fn(params, c, lm.forward_trunk(
            params, c, lm._embed_inputs(params, c, {"tokens": tokens}))))
    assert abs(losses[0] - losses[1]) <= 1e-5
    torch.testing.assert_close(logits[0], logits[1], rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------- training
def _train_setup(layout, ckpt_dir=""):
    from repro_torch.core.model import CostModelConfig
    from repro_torch.core.simulator import TPUSimulator
    from repro_torch.data.sampler import TileBatchSampler
    from repro_torch.data.synthetic import generate_corpus
    from repro_torch.data.tile_dataset import build_tile_dataset, \
        fit_tile_normalizer
    from repro_torch.training.trainer import TrainerConfig

    recs = build_tile_dataset(generate_corpus(6, seed=0), TPUSimulator(),
                              max_configs_per_kernel=8).records
    norm = fit_tile_normalizer(recs)
    sampler = TileBatchSampler(recs, norm, kernels_per_batch=4,
                               configs_per_kernel=8, max_nodes=64,
                               adjacency=layout)
    cfg = CostModelConfig(adjacency=layout)
    tc = TrainerConfig(task="tile", ckpt_every=0, log_every=1,
                       ckpt_dir=ckpt_dir)
    return cfg, tc, sampler, recs, norm


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_training_on_the_card_lowers_the_loss(layout):
    """20 steps at the default width on the card: finite, falling loss,
    with no aggregation kernel launched (training runs them off)."""
    _need_card()
    from repro_torch.training.trainer import CostModelTrainer
    cfg, tc, sampler, _, _ = _train_setup(layout)
    tr = CostModelTrainer(cfg, tc, sampler)
    assert tr.device.type == "cuda"
    before = (ga.launches, sa.launches)
    first = tr.run(1, resume=False)["loss"]
    last = tr.run(20, resume=False)["loss"]
    assert np.isfinite(first) and np.isfinite(last)
    assert last < first
    assert (ga.launches, sa.launches) == before


@pytest.mark.cuda
def test_aggregation_wrappers_refuse_grad_on_the_card():
    _need_card()
    adj, x, w = (_t(a) for a in _ga_inputs(2, 17, 192, 192, seed=0))
    w.requires_grad_(True)
    with pytest.raises(RuntimeError, match="graph_aggregate has no backward"):
        ga.graph_aggregate(adj, x, w)
    xs, ws, scale, gather, scatter, em, nm = (
        _t(a) for a in _sa_inputs(64, 192, 192, 300, seed=0))
    edges = sa.edge_csr(gather, scatter, em, 64)
    xs.requires_grad_(True)
    with pytest.raises(RuntimeError,
                       match="segment_aggregate has no backward"):
        sa.segment_aggregate(xs, ws, scale, edges, nm)
    with torch.no_grad():
        ga.graph_aggregate(adj, x, w)
        sa.segment_aggregate(xs, ws, scale, edges, nm)


@pytest.mark.cuda
def test_trained_checkpoint_serves_with_the_kernels(tmp_path):
    """A checkpoint trained on the card serves through both aggregation
    kernels within 1e-4·max|pred| of the kernels off."""
    _need_card()
    import dataclasses
    from repro_torch.core.evaluate import make_predict_fn
    from repro_torch.core.params import load_jax_checkpoint
    from repro_torch.serving import CostModelService
    from repro_torch.training.trainer import CostModelTrainer
    d = str(tmp_path / "ck")
    cfg, tc, sampler, recs, norm = _train_setup("dense", ckpt_dir=d)
    CostModelTrainer(cfg, tc, sampler).run(20, resume=False)
    graphs = [r.kernel.with_tile(t) for r in recs[:6] for t in r.tiles]
    for layout, kernel in (("dense", ga), ("sparse", sa)):
        preds = {}
        for kernels in (True, False):
            scfg = dataclasses.replace(cfg, adjacency=layout,
                                       use_pallas_aggregate=kernels)
            model = load_jax_checkpoint(d, scfg)
            svc = CostModelService(model, scfg, norm,
                                   predict_fn=make_predict_fn(scfg))
            before = kernel.launches
            preds[kernels] = svc.predict_many(graphs)
            assert (kernel.launches > before) == kernels
        tol = 1e-4 * max(1.0, float(np.abs(preds[False]).max()))
        assert np.all(np.isfinite(preds[True]))
        assert float(np.abs(preds[True] - preds[False]).max()) <= tol


def _small_graphs():
    from repro_torch.core import features as F
    from repro_torch.data.synthetic import random_kernel
    graphs = [random_kernel(n, seed=i)
              for i, n in enumerate((5, 12, 20, 3, 17))]
    return graphs, F.fit_normalizer(graphs)


@pytest.mark.cuda
@pytest.mark.parametrize("gnn,reduction,layout,kernels", [
    ("gat", "column_wise", "sparse", False),
    ("gat", "lstm", "dense", False),
    ("graphsage", "lstm", "sparse", True),
    ("graphsage", "lstm", "dense", True)])
def test_gat_and_lstm_on_card_match_the_cpu(gnn, reduction, layout,
                                            kernels):
    """GAT and the LSTM reduction on the card against the same weights
    on the CPU, within 1e-4·max|pred| (the smoke's serving limit). Sparse
    GAT's segment sums are `index_add_` atomics on the card: two runs
    need not agree bit for bit, so the check is a tolerance, not
    equality."""
    _need_card()
    from repro_torch.core.evaluate import predict_kernels
    from repro_torch.core.model import CostModelConfig, cost_model_init
    graphs, norm = _small_graphs()
    cfg = CostModelConfig(gnn=gnn, reduction=reduction, hidden_dim=64,
                          opcode_embed_dim=16, max_nodes=24, dropout=0.0,
                          adjacency=layout, use_pallas_aggregate=kernels)
    preds = {}
    for dev in ("cuda", "cpu"):
        model = cost_model_init(torch.Generator().manual_seed(0), cfg,
                                device=dev)
        preds[dev] = predict_kernels(model, cfg, graphs, norm, max_nodes=24)
    tol = 1e-4 * max(1.0, float(np.abs(preds["cpu"]).max()))
    assert np.all(np.isfinite(preds["cuda"]))
    assert float(np.abs(preds["cuda"] - preds["cpu"]).max()) <= tol


@pytest.mark.cuda
def test_socket_server_round_trip_on_the_card():
    """The socket server scores on the card from its worker thread: the
    kernel launches there, and the answers are the in-process
    service's."""
    _need_card()
    from repro_torch.core.evaluate import make_predict_fn
    from repro_torch.core.model import CostModelConfig, cost_model_init
    from repro_torch.serving import CostModelService
    from repro_torch.serving.client import CostModelClient
    from repro_torch.serving.server import CostModelServer
    graphs, norm = _small_graphs()
    cfg = CostModelConfig(hidden_dim=64, opcode_embed_dim=16, max_nodes=24,
                          dropout=0.0, adjacency="sparse",
                          use_pallas_aggregate=True)
    model = cost_model_init(torch.Generator().manual_seed(0), cfg)
    want = CostModelService(model, cfg, norm,
                            predict_fn=make_predict_fn(cfg)).predict_many(
                                graphs)
    before = sa.launches
    with CostModelServer(CostModelService(
            model, cfg, norm, predict_fn=make_predict_fn(cfg))) as server:
        with CostModelClient(*server.address, retries=0) as c:
            got = c.predict_many(graphs, deadline_ms=60_000)
        assert server.stats.worker_failures == 0
    assert sa.launches > before
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------- input pipeline, flywheel
@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_prefetch_copies_on_a_side_stream_the_consumer_waits_for(
        layout, monkeypatch):
    """`Prefetcher(device=cuda)`: the worker pins each array and copies
    it on a stream of its own, records an event there; the consumer's
    stream waits on that event and every copied tensor is
    `record_stream`ed on it. The batches equal the synchronous ones."""
    _need_card()
    from repro_torch.core.model import batch_to_device
    from repro_torch.data.prefetch import Prefetcher
    _, _, sampler, _, _ = _train_setup(layout)
    seen = {"pinned": 0, "recorded_on": [], "waited": [], "held": []}
    pin, record = torch.Tensor.pin_memory, torch.cuda.Event.record
    wait, hold = torch.cuda.Stream.wait_event, torch.Tensor.record_stream

    def spy_pin(self, *a, **k):
        seen["pinned"] += 1
        return pin(self, *a, **k)

    def spy_record(self, stream=None):
        seen["recorded_on"].append(stream)
        return record(self, stream)

    def spy_wait(self, event):
        seen["waited"].append((self, event))
        return wait(self, event)

    def spy_hold(self, stream):
        seen["held"].append((self.data_ptr(), stream))
        return hold(self, stream)
    monkeypatch.setattr(torch.Tensor, "pin_memory", spy_pin)
    monkeypatch.setattr(torch.cuda.Event, "record", spy_record)
    monkeypatch.setattr(torch.cuda.Stream, "wait_event", spy_wait)
    monkeypatch.setattr(torch.Tensor, "record_stream", spy_hold)
    consumer = torch.cuda.current_stream()
    with Prefetcher(sampler, depth=2, device="cuda") as p:
        for step in range(4):
            got = p.batch(step).graphs
            want = batch_to_device(sampler.batch(step).graphs, "cuda")
            for f in want.__dataclass_fields__:
                a, b = getattr(got, f), getattr(want, f)
                assert a.device.type == "cuda"
                assert torch.equal(a, b), f
    sides = [s for s in seen["recorded_on"] if s is not None]
    assert sides and all(s != consumer for s in sides)
    assert len(seen["waited"]) == 4
    assert all(s == consumer for s, _ in seen["waited"])
    n_fields = len(want.__dataclass_fields__)
    assert seen["pinned"] >= 4 * n_fields
    assert len(seen["held"]) == 4 * n_fields
    assert all(s == consumer for _, s in seen["held"])


@pytest.mark.cuda
def test_trainer_prefetch_on_the_card_is_bit_identical():
    """20 steps with prefetch=2 and device copies equal prefetch=0 on
    the card, loss by loss and leaf by leaf."""
    _need_card()
    import dataclasses
    from repro_torch.training.optim import tree_leaves
    from repro_torch.training.trainer import CostModelTrainer
    cfg, tc, sampler, _, _ = _train_setup("dense")
    runs = []
    for depth in (0, 2):
        tr = CostModelTrainer(cfg, dataclasses.replace(
            tc, prefetch=depth, prefetch_device_put=depth > 0), sampler)
        runs.append((tr, [tr.run(s, resume=False)["loss"]
                          for s in range(1, 21)]))
    assert runs[0][1] == runs[1][1]
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(runs[0][0].params), tree_leaves(runs[1][0].params)))


@pytest.mark.cuda
@pytest.mark.parametrize("layout,kernel", [("dense", "graph_aggregate"),
                                           ("sparse", "segment_aggregate")])
def test_mc_acquisition_on_the_card_with_and_without_the_kernels(layout,
                                                                 kernel):
    """MC-dropout passes on the card through the aggregation kernel agree
    with the kernels off (the same masks: one device generator per
    sample) within 1e-4·max|pred|, and the kernel launches."""
    _need_card()
    from repro_torch.core.model import CostModelConfig, cost_model_init
    from repro_torch.search import AcquisitionEstimator
    graphs, norm = _small_graphs()
    kw = dict(gnn="graphsage", reduction="lstm", hidden_dim=64,
              opcode_embed_dim=16, max_nodes=24, dropout=0.1,
              adjacency=layout)
    model = cost_model_init(torch.Generator().manual_seed(0),
                            CostModelConfig(**kw))
    got = {}
    for on in (True, False):
        before = (ga.launches, sa.launches)
        acq = AcquisitionEstimator(
            model, CostModelConfig(**kw, use_pallas_aggregate=on), norm,
            samples=4, seed=3, max_nodes=24)
        got[on] = acq.estimate_with_variance(graphs)
        launched = (ga.launches - before[0], sa.launches - before[1])
        assert launched[kernel == "segment_aggregate"] > 0 if on \
            else launched == (0, 0)
    tol = 1e-4 * max(1.0, float(np.abs(got[False][0]).max()))
    for i in range(2):
        assert float(np.abs(got[True][i] - got[False][i]).max()) <= tol
    assert float(got[True][1].max()) > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_and_ssd_refuse_grad_on_the_card(dtype):
    """The kernels have no backward: on the card, as on the CPU, inputs
    that require grad are refused while grad mode is on, and the kernel
    launches under no_grad."""
    _need_card()
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(1, 128, 4, 64, device="cuda", generator=gen,
                    dtype=dtype).requires_grad_(True)
    kv = torch.randn(1, 128, 2, 64, device="cuda", generator=gen,
                     dtype=dtype)
    before = fa.launches
    with pytest.raises(RuntimeError, match="use_pallas_attn=False"):
        fa.flash_attention(q, kv, kv)
    assert fa.launches == before
    with torch.no_grad():
        assert fa.flash_attention(q, kv, kv).shape == q.shape
    assert fa.launches == before + 1
    S = torch.randn(1, 2, 1, 3, 4, device="cuda", generator=gen)
    d = torch.rand(1, 2, 1, device="cuda", generator=gen).requires_grad_()
    with pytest.raises(RuntimeError, match="ssd_scan has no backward"):
        ss.ssd_scan(S, d)
    with torch.no_grad():
        assert ss.ssd_scan(S, d)[1].shape == (1, 1, 3, 4)

"""The port's whole-program (segmented) layout against the JAX package's.

Segmentation and `encode_segmented` are copies: their arrays are
byte-identical to the reference's. The segmented forward over a
1200-node whole-model graph cut at a budget of 256 (the size
tests/test_segmentation.py keeps for CPU runs) agrees with JAX's within
1e-5, in f32 and int8, with the aggregation kernel on and off (JAX's in
interpret mode). Graphs within the budget take the identity path, which
is bit-identical to the sparse layout. Also the segmented backends of
`predict_kernels` and `CostModelService`.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax

from repro.core import features as JF
from repro.core.evaluate import predict_kernels as jax_predict_kernels
from repro.core.model import CostModelConfig as JaxConfig
from repro.core.model import cost_model_apply as jax_apply
from repro.core.model import cost_model_init as jax_init
from repro.data import batching as JB
from repro.data.segmentation import segment_graph as jax_segment_graph
from repro.data.synthetic import random_kernel as jax_random_kernel
from repro.data.synthetic import whole_model_graph as jax_whole_model
from repro.quant import quantize as JQ
from repro.serving import CostModelService as JaxService
from repro_torch.core import features as PF
from repro_torch.core.evaluate import make_predict_fn, predict_kernels
from repro_torch.core.model import CostModelConfig, cost_model_init
from repro_torch.core.params import from_jax_params, from_jax_quantized
from repro_torch.data import batching as PB
from repro_torch.data.segmentation import segment_graph
from repro_torch.data.synthetic import random_kernel, whole_model_graph
from repro_torch.serving import CostModelService

TOL = dict(rtol=1e-5, atol=1e-5)


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _configs(**kw):
    base = dict(hidden_dim=32, opcode_embed_dim=8, dropout=0.0,
                adjacency="segmented", reduction="column_wise",
                transformer_heads=4)
    base.update(kw)
    jcfg = JaxConfig(**base)
    return jcfg, CostModelConfig.from_dict(jcfg.to_dict())


@pytest.fixture(scope="module")
def whole():
    """(jax graphs, port graphs, jax normalizer, port normalizer): one
    1200-node whole-model graph and one small kernel."""
    jg = [jax_whole_model(1200, seed=0), jax_random_kernel(10, seed=3)]
    pg = [whole_model_graph(1200, seed=0), random_kernel(10, seed=3)]
    return (jg, pg, JF.fit_normalizer(jg[1:]), PF.fit_normalizer(pg[1:]))


# ------------------------------------------------- copied data path
@pytest.mark.parametrize("n,budget", [(40, 16), (120, 33), (1200, 256)])
def test_segment_graph_matches_reference(n, budget):
    jg = jax_whole_model(n, seed=1) if n > 200 else \
        jax_random_kernel(n, seed=n)
    pg = whole_model_graph(n, seed=1) if n > 200 else random_kernel(n, seed=n)
    js, ps = jax_segment_graph(jg, budget), segment_graph(pg, budget)
    assert ps.num_segments == js.num_segments > 1
    for a, b in zip(js.segments, ps.segments):
        assert (a.owned_local, a.owned_global, a.halo_global) == \
            (b.owned_local, b.owned_global, b.halo_global)
        assert a.graph.canonical_hash() == b.graph.canonical_hash()


@pytest.mark.parametrize("budget", [16, 64, 256])
def test_encode_segmented_byte_identical(budget, whole):
    jg = [jax_random_kernel(n, seed=n) for n in (40, 7, 90)] + whole[0][:1]
    pg = [random_kernel(n, seed=n) for n in (40, 7, 90)] + whole[1][:1]
    jb = JB.encode_segmented(jg, budget, whole[2])
    pb = PB.encode_segmented(pg, budget, whole[3])
    for name in jb.__dataclass_fields__:
        if name == "inner":
            continue
        a, b = getattr(jb, name), getattr(pb, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    for name in jb.inner.__dataclass_fields__:
        a, b = getattr(jb.inner, name), getattr(pb.inner, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


# ------------------------------------------------------- the forward
@pytest.mark.parametrize("reduction", ["per_node", "column_wise",
                                       "transformer"])
@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernel"])
def test_identity_path_bit_identical_to_sparse(reduction, kernels):
    """Graphs within the budget go through the segmented layout exactly as
    through the sparse one. Four graphs make the outer batch's shapes
    equal to the sparse bucket's: PyTorch's CPU matmul may round the same
    row differently in a product with another row count (the head runs
    over [graph slots, ·]), which is not the layout's doing."""
    graphs = [random_kernel(n, seed=n) for n in (20, 9, 15, 6)]
    norm = PF.fit_normalizer(graphs)
    cfg = CostModelConfig(hidden_dim=32, opcode_embed_dim=8,
                          transformer_heads=4, dropout=0.0,
                          adjacency="segmented", reduction=reduction,
                          use_pallas_aggregate=kernels)
    model = cost_model_init(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    sb = PB.encode_segmented(graphs, 64, norm)
    pb = PB.encode_packed(graphs, norm)
    assert (sb.num_nodes, sb.batch_size, sb.reduce_capacity) == \
        (pb.num_nodes, pb.batch_size, pb.reduce_capacity)
    predict = make_predict_fn(cfg)
    assert np.array_equal(predict(model, sb), predict(model, pb))


@pytest.mark.parametrize("precision", ["f32", "int8"])
@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "stacked"])
def test_segmented_whole_model_forward_matches_jax(precision, kernels, scan,
                                                   whole):
    jg, pg, jn, pn = whole
    jcfg, pcfg = _configs(use_pallas_aggregate=kernels, scan_layers=scan)
    params = jax_init(jax.random.key(1), jcfg)
    jb = JB.encode_segmented(jg, 256, jn)
    pb = PB.encode_segmented(pg, 256, pn)
    assert pb.inner.num_nodes > 1200 > 256          # really segmented
    if precision == "int8":
        jqm = JQ.quantize_params(params, jcfg)
        want = np.asarray(jax_apply(jqm.params, jqm.serving_config(), jb))
        pqm = from_jax_quantized(_numpy_tree(jqm.params), jqm.act_scales,
                                 jqm.config, device="cpu")
        pcfg, model = pqm.serving_config(), pqm.model()
    else:
        want = np.asarray(jax_apply(params, jcfg, jb))
        model = from_jax_params(_numpy_tree(params), pcfg, device="cpu")
    got = make_predict_fn(pcfg)(model, pb)
    assert got.shape == want.shape == (2,)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, **TOL)


# ----------------------------------------------- predict_kernels, service
def test_predict_kernels_segmented_matches_jax(whole):
    jg, pg, jn, pn = whole
    jg = jg + [jax_random_kernel(n, seed=n) for n in (30, 12)]
    pg = pg + [random_kernel(n, seed=n) for n in (30, 12)]
    jcfg, pcfg = _configs()
    params = jax_init(jax.random.key(2), jcfg)
    want = jax_predict_kernels(params, jcfg, jg, jn, node_budget=256,
                               chunk=3)
    model = from_jax_params(_numpy_tree(params), pcfg, device="cpu")
    got = predict_kernels(model, pcfg, pg, pn, node_budget=256, chunk=3)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_service_segmented_backend(precision, whole):
    """The segmented service scores like `predict_kernels(adjacency=
    "segmented")` and like JAX's segmented service; the small graphs also
    like the sparse service."""
    jg, pg, jn, pn = whole
    jcfg, pcfg = _configs(max_nodes=32, use_pallas_aggregate=True)
    params = jax_init(jax.random.key(4), jcfg)
    if precision == "int8":
        jqm = JQ.quantize_params(params, jcfg)
        jmodel = jqm
        model = from_jax_quantized(_numpy_tree(jqm.params), jqm.act_scales,
                                   jqm.config, device="cpu")
        pcfg = model.serving_config()
        direct_model = model.model()
    else:
        jmodel = params
        model = direct_model = from_jax_params(_numpy_tree(params), pcfg,
                                               device="cpu")
    requests = [pg[1:], pg[:1], pg]
    svc = CostModelService(model, pcfg, pn, node_budget=256)
    assert svc.adjacency == "segmented" and svc.precision == precision
    got = [svc.predict_many(r) for r in requests]
    jsvc = JaxService(jmodel, jcfg, jn, node_budget=256)
    want = [jsvc.predict_many(r) for r in
            [jg[1:], jg[:1], jg]]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **TOL)
    direct = predict_kernels(direct_model, pcfg, pg, pn, node_budget=256)
    np.testing.assert_allclose(got[2], direct, **TOL)
    st = svc.stats()
    assert st.buckets["segmented"].graphs == 1
    assert st.cache.hits == 2                 # the third request is cached
    sparse = CostModelService(model, pcfg, pn, node_budget=256,
                              adjacency="sparse")
    assert np.array_equal(sparse.predict_many(pg[1:]), got[0])

"""The port's cost-model forward against the JAX package.

The same parameters (a JAX `cost_model_init` tree carried across with
`from_jax_params`) and the same graphs go through JAX `cost_model_apply`
and the port's, on batches from each package's own encoders, over every
GraphSAGE combination the port supports: reduction × directed ×
kernel_feat_mode × GNN parameter layout × batch layout × aggregation
kernel. Also checks that the port's copied encoders produce byte-identical
batch arrays to `repro`'s.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax

from repro.core import features as JF
from repro.core.model import CostModelConfig as JaxConfig
from repro.core.model import cost_model_apply as jax_apply
from repro.core.model import cost_model_init as jax_init
from repro.data import batching as JB
from repro.data.synthetic import random_kernel as jax_random_kernel
from repro_torch.core import features as PF
from repro_torch.core.evaluate import make_predict_fn
from repro_torch.core.model import CostModelConfig, cost_model_init
from repro_torch.core.params import from_jax_params
from repro_torch.data import batching as PB
from repro_torch.data.synthetic import random_kernel

SIZES = [5, 12, 3, 20, 1, 17]
MAX_NODES = 24
TOL = dict(rtol=1e-5, atol=1e-5)


def _graphs(make):
    return [make(n, seed=i) for i, n in enumerate(SIZES)]


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _configs(**kw):
    base = dict(hidden_dim=16, opcode_embed_dim=8, transformer_heads=4,
                gnn_layers=2, max_nodes=MAX_NODES, dropout=0.0)
    base.update(kw)
    jcfg = JaxConfig(**base)
    return jcfg, CostModelConfig.from_dict(jcfg.to_dict())


def _batches(layout):
    jg, pg = _graphs(jax_random_kernel), _graphs(random_kernel)
    jn, pn = JF.fit_normalizer(jg), PF.fit_normalizer(pg)
    if layout == "dense":
        return (JF.encode_batch(jg, MAX_NODES, jn),
                PF.encode_batch(pg, MAX_NODES, pn))
    return JB.encode_packed(jg, jn), PB.encode_packed(pg, pn)


COMBOS = list(itertools.product(
    ["per_node", "column_wise", "transformer"],      # reduction
    [True, False],                                   # directed
    ["node", "kernel"],                              # kernel_feat_mode
    [False, True],                                   # scan_layers
    ["dense", "sparse"],                             # batch layout
    [False, True]))                                  # use_pallas_aggregate


def _id(c):
    red, directed, kfm, scan, layout, pallas = c
    return (f"{red}-{'dir' if directed else 'undir'}-{kfm}-"
            f"{'stacked' if scan else 'unrolled'}-{layout}-"
            f"{'kernel' if pallas else 'plain'}")


@pytest.mark.parametrize("combo", COMBOS, ids=[_id(c) for c in COMBOS])
def test_forward_matches_jax(combo):
    red, directed, kfm, scan, layout, pallas = combo
    jcfg, pcfg = _configs(reduction=red, directed=directed,
                          kernel_feat_mode=kfm, scan_layers=scan,
                          adjacency=layout, use_pallas_aggregate=pallas)
    params = jax_init(jax.random.key(sum(SIZES) + len(_id(combo))), jcfg)
    jb, pb = _batches(layout)
    want = np.asarray(jax_apply(params, jcfg, jb))
    model = from_jax_params(_numpy_tree(params), pcfg, device="cpu")
    got = make_predict_fn(pcfg)(model, pb)
    assert got.shape == want.shape == (jb.batch_size,)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("src_scan,dst_scan",
                         [(False, True), (True, False)])
def test_from_jax_params_converts_gnn_layout(src_scan, dst_scan):
    """A tree in one GNN layout loads into a model of the other layout
    and predicts the same."""
    jcfg, _ = _configs(reduction="column_wise", scan_layers=src_scan)
    _, pcfg = _configs(reduction="column_wise", scan_layers=dst_scan)
    params = jax_init(jax.random.key(3), jcfg)
    model = from_jax_params(_numpy_tree(params), pcfg, device="cpu")
    key = "gnn.stacked.f3.w" if dst_scan else "gnn.layers.1.f3.w"
    assert key in model.state_dict()
    jb, pb = _batches("sparse")
    np.testing.assert_allclose(make_predict_fn(pcfg)(model, pb),
                               np.asarray(jax_apply(params, jcfg, jb)),
                               **TOL)


def test_from_jax_params_zero_gnn_layers_stacked_config():
    jcfg, pcfg = _configs(reduction="column_wise", gnn_layers=0,
                          scan_layers=True)
    params = jax_init(jax.random.key(5), jcfg)
    model = from_jax_params(_numpy_tree(params), pcfg, device="cpu")
    jb, pb = _batches("sparse")
    np.testing.assert_allclose(make_predict_fn(pcfg)(model, pb),
                               np.asarray(jax_apply(params, jcfg, jb)),
                               **TOL)


def test_from_jax_params_rejects_mismatched_tree():
    jcfg, _ = _configs(hidden_dim=16)
    _, pcfg = _configs(hidden_dim=24)
    params = jax_init(jax.random.key(0), jcfg)
    with pytest.raises(ValueError, match="wrong shape"):
        from_jax_params(_numpy_tree(params), pcfg, device="cpu")


def test_state_dict_keys_mirror_jax_tree_paths():
    jcfg, pcfg = _configs()
    params = jax_init(jax.random.key(0), jcfg)
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    want = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path) for path, _ in flat}
    model = from_jax_params(_numpy_tree(params), pcfg, device="cpu")
    assert set(model.state_dict()) == want
    init = cost_model_init(torch.Generator().manual_seed(0), pcfg,
                           device="cpu")
    assert set(init.state_dict()) == want
    assert {k: tuple(v.shape) for k, v in init.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in model.state_dict().items()}


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_copied_encoders_are_byte_identical(layout):
    jb, pb = _batches(layout)
    assert type(jb).__name__ == type(pb).__name__
    for name in jb.__dataclass_fields__:
        a, b = getattr(jb, name), getattr(pb, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


def test_copied_bucketing_and_packing_agree():
    jg, pg = _graphs(jax_random_kernel), _graphs(random_kernel)
    for budget in (8, 20, 64):
        assert JB.pack_graphs(jg, budget, oversized="singleton") == \
            PB.pack_graphs(pg, budget, oversized="singleton")
    assert JB.bucket_for(jg) == JB.BucketSpec(
        **PB.bucket_for(pg).__dict__)
    assert [g.canonical_hash() for g in jg] == \
        [g.canonical_hash() for g in pg]


DOCTEST_MODULES = ["repro_torch.core.graph", "repro_torch.core.features",
                   "repro_torch.data.batching", "repro_torch.data.fusion",
                   "repro_torch.serving.cache",
                   "repro_torch.serving.coalescer",
                   "repro_torch.serving.service",
                   "repro_torch.data.segmentation",
                   "repro_torch.quant.scale", "repro_torch.quant.quantize"]


@pytest.mark.parametrize("module_name", DOCTEST_MODULES)
def test_copied_module_doctests(module_name):
    """The copied jax-free modules keep their docstring examples green."""
    import doctest
    import importlib
    result = doctest.testmod(importlib.import_module(module_name),
                             verbose=False)
    assert result.attempted > 0 and result.failed == 0

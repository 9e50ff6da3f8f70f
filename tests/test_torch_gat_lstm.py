"""GAT and the LSTM reduction in the port, against the JAX package.

On the CPU (`device="cpu"`), with inputs made by numpy from a seed and
parameters carried across from a JAX init: the GAT layers (dense
directed and undirected, sparse directed) against `repro.core.gnn`, the
LSTM cell and scan with right-padding masks against `repro.nn.lstm`,
`cost_model_apply` over gnn × reduction × layout against the JAX
forward, one `CostModelTrainer` step for GAT and for LSTM against the
JAX trainer, and GAT+LSTM checkpoints across the packages with the two
attention leaves `a_dst_in` / `a_dst_out` kept apart.

Tolerance rtol = atol = 1e-5 (as `tests/test_torch_model.py`) unless a
test says otherwise. On the card the sparse GAT's segment sums are
`index_add_` atomics, so sparse GAT is not bit-reproducible there
(`tests/test_torch_cuda.py` holds it card vs CPU within a tolerance).
"""
import itertools
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from repro.core import features as JF
from repro.core import gnn as JG
from repro.core.model import CostModelConfig as JaxConfig
from repro.core.model import cost_model_apply as jax_apply
from repro.core.model import cost_model_init as jax_init
from repro.data import batching as JB
from repro.data.synthetic import random_kernel as jax_random_kernel
from repro.nn import lstm as JL
from repro.training import checkpoint as JC
from repro.training.trainer import TrainerConfig as JaxTrainerConfig
from repro_torch.core import features as PF
from repro_torch.core import gnn as PG
from repro_torch.core.evaluate import make_predict_fn
from repro_torch.core.model import CostModelConfig, cost_model_init
from repro_torch.core.params import from_jax_params, load_jax_checkpoint
from repro_torch.data import batching as PB
from repro_torch.data.synthetic import random_kernel
from repro_torch.nn import lstm as PL
from repro_torch.training import optim as PO
from repro_torch.training.trainer import CostModelTrainer, TrainerConfig
from tests.test_torch_training import (  # noqa: F401  (fixtures)
    _grads_close,
    _jax_leaves,
    _metrics,
    _pair,
    _port_leaves,
    _samplers,
    fusion_records,
    tile_records,
)

SIZES = [5, 12, 3, 20, 1, 17]
MAX_NODES = 24
SEG_BUDGET = 8          # < the largest graph: segmented really segments
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _torch_tree(params):
    return jax.tree_util.tree_map(_t, params)


# ------------------------------------------------------------------ GAT
def _gat_inputs(directed: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    B, N, D, H = 3, 9, 16, 2
    eps = rng.standard_normal((B, N, D)).astype(np.float32)
    adj = (rng.random((B, N, N)) < 0.25).astype(np.float32)
    adj[:, 4, :] = 0.0                       # a node with no in-edges
    mask = np.ones((B, N), np.float32)
    mask[1, 6:] = 0.0                        # padding
    adj *= mask[:, :, None] * mask[:, None, :]
    params = JG.gat_init(jax.random.key(seed), D, 2, H, directed=directed)
    return eps, adj, mask, params, H


@pytest.mark.parametrize("directed", [True, False],
                         ids=["directed", "undirected"])
def test_gat_dense_matches_jax(directed):
    eps, adj, mask, params, H = _gat_inputs(directed)
    want = np.asarray(JG.gat_apply(params, jnp.asarray(eps),
                                   jnp.asarray(adj), jnp.asarray(mask),
                                   num_heads=H, directed=directed))
    got = PG.gat_apply(_torch_tree(params), _t(eps), _t(adj), _t(mask),
                       num_heads=H, directed=directed).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def _flat_edges(adj, mask):
    """The dense inputs as a flat node buffer and edge list, with a few
    masked padding edges at the end."""
    B, N, _ = adj.shape
    b, d, s = np.nonzero(adj)
    src = np.concatenate([b * N + s, [0, 3]]).astype(np.int32)
    dst = np.concatenate([b * N + d, [1, 2]]).astype(np.int32)
    emask = np.concatenate([np.ones(len(b)), [0, 0]]).astype(np.float32)
    return src, dst, emask, mask.reshape(-1)


def test_gat_sparse_matches_jax_and_dense():
    eps, adj, mask, params, H = _gat_inputs(True, seed=1)
    src, dst, emask, nmask = _flat_edges(adj, mask)
    x = eps.reshape(-1, eps.shape[-1])
    want = np.asarray(JG.gat_apply_sparse(
        params, jnp.asarray(x), jnp.asarray(src), jnp.asarray(dst),
        jnp.asarray(emask), jnp.asarray(nmask), num_heads=H))
    tp = _torch_tree(params)
    got = PG.gat_apply_sparse(tp, _t(x), _t(src), _t(dst), _t(emask),
                              _t(nmask), num_heads=H).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    dense = PG.gat_apply(tp, _t(eps), _t(adj), _t(mask), num_heads=H)
    np.testing.assert_allclose(got, dense.reshape(x.shape).numpy(), **TOL)


def test_gat_sparse_undirected_raises_like_the_reference():
    eps, adj, mask, params, H = _gat_inputs(False)
    src, dst, emask, nmask = _flat_edges(adj, mask)
    x = eps.reshape(-1, eps.shape[-1])
    with pytest.raises(NotImplementedError, match="dense-only"):
        JG.gat_apply_sparse(params, jnp.asarray(x), jnp.asarray(src),
                            jnp.asarray(dst), jnp.asarray(emask),
                            jnp.asarray(nmask), num_heads=H, directed=False)
    with pytest.raises(NotImplementedError, match="dense-only"):
        PG.gat_apply_sparse(_torch_tree(params), _t(x), _t(src), _t(dst),
                            _t(emask), _t(nmask), num_heads=H,
                            directed=False)


def test_gat_init_keeps_a_dst_out_apart():
    layer = PG.gat_layer_init(torch.Generator().manual_seed(0), 16, 2,
                              directed=True)
    assert torch.equal(layer["a_dst_in"], layer["a_dst_out"])
    assert layer["a_dst_in"].data_ptr() != layer["a_dst_out"].data_ptr()
    cfg = CostModelConfig(gnn="gat", hidden_dim=16, opcode_embed_dim=8,
                          gnn_layers=2)
    model = cost_model_init(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    names = dict(model.named_parameters())
    assert {"gnn.layers.0.a_dst_in", "gnn.layers.0.a_dst_out"} <= set(names)
    assert len(list(model.parameters())) == len(names)


# ----------------------------------------------------------------- LSTM
def _lstm_inputs(seed=0, B=4, T=7, D=6, Hd=5):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((B, T, D)).astype(np.float32)
    lengths = np.array([7, 3, 1, 0])[:B]
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    params = JL.lstm_init(jax.random.key(seed), D, Hd)
    return xs, mask, params


def test_lstm_cell_matches_jax():
    xs, _, params = _lstm_inputs()
    rng = np.random.default_rng(1)
    h = rng.standard_normal((4, 5)).astype(np.float32)
    c = rng.standard_normal((4, 5)).astype(np.float32)
    jh, jc = JL.lstm_cell(params, (jnp.asarray(h), jnp.asarray(c)),
                          jnp.asarray(xs[:, 0]))
    ph, pc = PL.lstm_cell(_torch_tree(params), (_t(h), _t(c)), _t(xs[:, 0]))
    np.testing.assert_allclose(ph.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), **TOL)


@pytest.mark.parametrize("masked", [True, False],
                         ids=["right-padding", "no-mask"])
def test_lstm_apply_matches_jax(masked):
    xs, mask, params = _lstm_inputs()
    m = mask if masked else None
    want = np.asarray(JL.lstm_apply(
        params, jnp.asarray(xs), None if m is None else jnp.asarray(m)))
    got = PL.lstm_apply(_torch_tree(params), _t(xs),
                        None if m is None else _t(m)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    if masked:
        # padded steps leave the state alone: the state after the last
        # valid element, and zeros for a sequence with none
        short = PL.lstm_apply(_torch_tree(params), _t(xs[1:2, :3])).numpy()
        np.testing.assert_allclose(got[1:2], short, **TOL)
        assert np.all(got[3] == 0.0)


def test_lstm_masked_blend_propagates_nan_like_the_reference():
    """m·new + (1 − m)·old, not a select: a NaN in a padded step's input
    reaches the state in both packages."""
    xs, mask, params = _lstm_inputs()
    xs[0, 5, 0] = np.nan
    mask[0, 5:] = 0.0
    want = np.asarray(JL.lstm_apply(params, jnp.asarray(xs),
                                    jnp.asarray(mask)))
    got = PL.lstm_apply(_torch_tree(params), _t(xs), _t(mask)).numpy()
    assert np.isnan(want[0]).all() and np.isnan(got[0]).all()
    np.testing.assert_allclose(got[1:], want[1:], **TOL)


# ------------------------------------------------------- the whole model
def _batches(layout):
    jg = [jax_random_kernel(n, seed=i) for i, n in enumerate(SIZES)]
    pg = [random_kernel(n, seed=i) for i, n in enumerate(SIZES)]
    jn, pn = JF.fit_normalizer(jg), PF.fit_normalizer(pg)
    if layout == "dense":
        return (JF.encode_batch(jg, MAX_NODES, jn),
                PF.encode_batch(pg, MAX_NODES, pn))
    if layout == "sparse":
        return JB.encode_packed(jg, jn), PB.encode_packed(pg, pn)
    return (JB.encode_segmented(jg, SEG_BUDGET, jn),
            PB.encode_segmented(pg, SEG_BUDGET, pn))


def _configs(**kw):
    base = dict(hidden_dim=16, opcode_embed_dim=8, transformer_heads=4,
                gnn_layers=2, max_nodes=MAX_NODES, dropout=0.0)
    base.update(kw)
    jcfg = JaxConfig(**base)
    return jcfg, CostModelConfig.from_dict(jcfg.to_dict())


COMBOS = list(itertools.product(
    ["graphsage", "gat", "none"],
    ["per_node", "column_wise", "lstm", "transformer"],
    ["dense", "sparse", "segmented"]))


@pytest.mark.parametrize("gnn,reduction,layout", COMBOS,
                         ids=["-".join(c) for c in COMBOS])
def test_cost_model_apply_matches_jax(gnn, reduction, layout):
    jcfg, pcfg = _configs(gnn=gnn, reduction=reduction, adjacency=layout)
    params = jax_init(jax.random.key(len(gnn) + 7 * len(reduction)), jcfg)
    jb, pb = _batches(layout)
    want = np.asarray(jax_apply(params, jcfg, jb))
    model = from_jax_params(_numpy_tree(params), pcfg, device="cpu")
    got = make_predict_fn(pcfg)(model, pb)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_lstm_model_with_kernels_matches_without(layout):
    """graphsage + lstm through the aggregation kernels' route (their
    plain versions on the CPU) equals the model without them."""
    _, off = _configs(reduction="lstm", adjacency=layout)
    _, on = _configs(reduction="lstm", adjacency=layout,
                     use_pallas_aggregate=True)
    model = cost_model_init(torch.Generator().manual_seed(3), off,
                            device="cpu")
    _, pb = _batches(layout)
    np.testing.assert_allclose(
        make_predict_fn(on)(model, pb), make_predict_fn(off)(model, pb),
        **TOL)


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "stacked"])
def test_undirected_gat_dense_model_matches_jax(scan):
    jcfg, pcfg = _configs(gnn="gat", reduction="lstm", directed=False,
                          scan_layers=scan)
    params = jax_init(jax.random.key(11), jcfg)
    jb, pb = _batches("dense")
    model = from_jax_params(_numpy_tree(params), pcfg, device="cpu")
    np.testing.assert_allclose(make_predict_fn(pcfg)(model, pb),
                               np.asarray(jax_apply(params, jcfg, jb)),
                               **TOL)


# ------------------------------------------------------------ training
@pytest.mark.parametrize("gnn,reduction,adjacency", [
    ("gat", "column_wise", "dense"), ("gat", "column_wise", "sparse"),
    ("graphsage", "lstm", "dense"), ("graphsage", "lstm", "sparse")])
def test_one_train_step_matches_jax(gnn, reduction, adjacency,
                                    tile_records, fusion_records, tmp_path):
    """As `test_torch_training.py`'s one-step test (the same tolerances,
    reasoned there): gradients within 1e-5 of the tree's largest, Adam's
    moments likewise, parameters where |g| > 1e-3 of the largest."""
    samplers = _samplers("tile", adjacency, tile_records, fusion_records)
    jt, pt = _pair("tile", adjacency, samplers, gnn=gnn, reduction=reduction,
                   jax_tc=JaxTrainerConfig(
                       task="tile", ckpt_every=0, log_every=1,
                       metrics_path=str(tmp_path / "jax.jsonl")),
                   port_tc=TrainerConfig(
                       task="tile", ckpt_every=0, log_every=1,
                       metrics_path=str(tmp_path / "port.jsonl")))
    js, ps = samplers
    b = js.batch(0)
    jloss, jgrads = jax.value_and_grad(jt._loss_fn)(
        jt.params, b.graphs, jnp.asarray(b.targets),
        jnp.asarray(b.group_ids), jnp.asarray(b.valid), jt._step_rng(0))
    ploss = pt.loss(ps.batch(0), generator=pt.step_generator(0),
                    training=True)
    pgrads = torch.autograd.grad(ploss, PO.tree_leaves(pt.params))
    np.testing.assert_allclose(ploss.item(), float(jloss), rtol=1e-5)
    jg = _jax_leaves(jgrads)
    _grads_close([g.numpy() for g in pgrads], jg)

    jt.run(1, resume=False)
    pt.run(1, resume=False)
    (jrec,), (prec,) = _metrics(tmp_path / "jax.jsonl"), \
        _metrics(tmp_path / "port.jsonl")
    np.testing.assert_allclose(prec["loss"], jrec["loss"], rtol=1e-5)
    for key in ("m", "v"):
        _grads_close(_port_leaves(pt.opt_state[key]),
                     _jax_leaves(jt.opt_state[key]))
    lr = jrec["lr"]
    gmax = max(float(np.abs(g).max()) for g in jg)
    for p, j, g in zip(_port_leaves(pt.params), _jax_leaves(jt.params), jg):
        big = np.abs(g) > 1e-3 * gmax
        np.testing.assert_allclose(p[big], j[big], rtol=1e-6, atol=1e-7)
        assert np.all(np.abs(p - j) <= 2 * lr * (1 + 1e-6))


def _manifest_leaves(ckpt_dir):
    step_dir = sorted(d for d in os.listdir(ckpt_dir)
                      if d.startswith("step_"))[-1]
    with open(os.path.join(ckpt_dir, step_dir, "manifest.json")) as f:
        man = json.load(f)
    return {leaf["key"]: np.load(os.path.join(ckpt_dir, step_dir,
                                              leaf["file"]))
            for leaf in man["leaves"]}


def test_a_dst_leaves_train_apart(tile_records, fusion_records, tmp_path):
    """One AdamW step moves `a_dst_in` and `a_dst_out` (equal at init)
    each by its own gradient, and the checkpoint writes both."""
    d = str(tmp_path / "ck")
    _, ps = _samplers("tile", "dense", tile_records, fusion_records)
    cfg = CostModelConfig(gnn="gat", reduction="lstm", hidden_dim=16,
                          opcode_embed_dim=8, gnn_layers=2,
                          node_final_layers=2, max_nodes=MAX_NODES,
                          dropout=0.0)
    pt = CostModelTrainer(cfg, TrainerConfig(task="tile", ckpt_every=0,
                                             log_every=1, ckpt_dir=d), ps,
                          device="cpu")
    layer = pt.params["gnn"]["layers"][0]
    assert torch.equal(layer["a_dst_in"], layer["a_dst_out"])
    assert layer["a_dst_in"].data_ptr() != layer["a_dst_out"].data_ptr()
    pt.run(1, resume=False)
    layer = pt.params["gnn"]["layers"][0]
    assert not torch.equal(layer["a_dst_in"], layer["a_dst_out"])
    leaves = _manifest_leaves(d)
    a_in = leaves["params/gnn/layers/0/a_dst_in"]
    a_out = leaves["params/gnn/layers/0/a_dst_out"]
    np.testing.assert_array_equal(a_in, layer["a_dst_in"].detach().numpy())
    np.testing.assert_array_equal(a_out,
                                  layer["a_dst_out"].detach().numpy())
    assert not np.array_equal(a_in, a_out)


@pytest.mark.parametrize("save_scan,load_scan", [(False, False),
                                                 (False, True),
                                                 (True, False)])
def test_gat_lstm_checkpoint_both_directions(save_scan, load_scan,
                                             tile_records, fusion_records,
                                             tmp_path):
    """A GAT+LSTM model trained two port steps restores in JAX bit for
    bit, and a JAX checkpoint of it loads in the port (in either GNN
    layout) and predicts as the JAX model does."""
    d = str(tmp_path / "ck")
    samplers = _samplers("tile", "dense", tile_records, fusion_records)
    jt, pt = _pair("tile", "dense", samplers, gnn="gat", reduction="lstm",
                   scan_layers=save_scan,
                   port_tc=TrainerConfig(task="tile", ckpt_every=0,
                                         log_every=1, ckpt_dir=d))
    pt.run(2, resume=False)
    state, step, _ = JC.restore_checkpoint(
        d, {"params": jt.params, "opt": jt.opt_state})
    assert step == 2
    for j, p in zip(_jax_leaves(state),
                    _port_leaves({"params": pt.params,
                                  "opt": pt.opt_state})):
        np.testing.assert_array_equal(j, p)

    j2 = str(tmp_path / "jax")
    JC.save_checkpoint(j2, 2, {"params": state["params"]})
    jcfg, pcfg = _configs(gnn="gat", reduction="lstm",
                          scan_layers=load_scan, node_final_layers=2)
    model = load_jax_checkpoint(j2, pcfg, device="cpu")
    key = "gnn.stacked.a_dst_out" if load_scan else \
        "gnn.layers.1.a_dst_out"
    assert key in model.state_dict()
    jb, pb = _batches("dense")
    want = np.asarray(jax_apply(state["params"], _with_scan(jcfg,
                                                             save_scan),
                                jb))
    np.testing.assert_allclose(make_predict_fn(pcfg)(model, pb), want,
                               **TOL)


def _with_scan(jcfg, scan):
    return JaxConfig.from_dict(dict(jcfg.to_dict(), scan_layers=scan))

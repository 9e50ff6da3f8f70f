"""The port's int8 quantization against the JAX package's.

Inputs are made with numpy from a seed and go through `repro.quant` and
`repro_torch.quant`: the int8 values and scales are bit-identical, the
same leaves are chosen for quantization, calibration agrees, a sidecar
written by either package loads in the other bit for bit, and int8
predictions agree with JAX's within rtol = atol = 1e-5 (the reference's
own tolerance for its int8 paths) over both batch layouts, both GNN
layouts and the aggregation kernel on and off (JAX's kernel in interpret
mode). Also the service, snapshot and CLI at int8.
"""
import itertools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from repro.core import features as JF
from repro.core.model import CostModelConfig as JaxConfig
from repro.core.model import cost_model_apply as jax_apply
from repro.core.model import cost_model_init as jax_init
from repro.data import batching as JB
from repro.data.synthetic import random_kernel as jax_random_kernel
from repro.quant import quantize as JQ
from repro.quant import scale as JS
from repro_torch.core import features as PF
from repro_torch.core.evaluate import make_predict_fn
from repro_torch.core.model import CostModelConfig
from repro_torch.core.params import from_jax_params, from_jax_quantized
from repro_torch.data import batching as PB
from repro_torch.data.synthetic import random_kernel
from repro_torch.quant import quantize as PQ
from repro_torch.quant import scale as PS

SIZES = [5, 12, 3, 20, 1, 17]
MAX_NODES = 24
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _configs(**kw):
    base = dict(hidden_dim=32, opcode_embed_dim=8, max_nodes=MAX_NODES,
                dropout=0.0, adjacency="sparse", reduction="per_node",
                transformer_heads=4, gnn_layers=2)
    base.update(kw)
    jcfg = JaxConfig(**base)
    return jcfg, CostModelConfig.from_dict(jcfg.to_dict())


def _graphs():
    return ([jax_random_kernel(n, seed=i) for i, n in enumerate(SIZES)],
            [random_kernel(n, seed=i) for i, n in enumerate(SIZES)])


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _jax_flat(tree):
    """{key path: leaf} of a JAX tree, `QuantizedLeaf`s as leaves."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JS.QuantizedLeaf))[0]
    return {JQ._key_str(p): leaf for p, leaf in flat}


def _port_flat(tree):
    return dict(PQ._flatten(tree))


def _assert_same_leaves(jtree, ptree):
    """Both trees hold the same keys, the same leaf kinds, and the same
    bytes in every array."""
    ja, pa = _jax_flat(jtree), _port_flat(ptree)
    assert set(ja) == set(pa)
    for k in ja:
        j, p = ja[k], pa[k]
        if isinstance(j, JS.QuantizedLeaf):
            assert isinstance(p, PS.QuantizedLeaf), k
            pairs = [(j.q, p.q), (j.scale, p.scale)]
        else:
            assert not isinstance(p, PS.QuantizedLeaf), k
            pairs = [(j, p)]
        for a, b in pairs:
            a, b = np.asarray(a), _np(b)
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert a.tobytes() == b.tobytes(), k


# ------------------------------------------------------------- scale math
def _tricky(rng, shape):
    """Random values plus, per output channel, values exactly halfway
    between two int8 steps (amax 127/16 makes the scale exactly 1/16)
    and one all-zero channel."""
    x = rng.normal(0, 2, shape).astype(np.float32)
    if shape[-1] < 2:
        return x
    x[..., 0] = 0.0                                   # all-zero channel
    half = (rng.integers(-126, 126, shape[:-1]) + 0.5) / 16.0
    x[..., 1] = half.astype(np.float32)
    x[(0,) * (len(shape) - 1) + (1,)] = 127.0 / 16.0  # channel 1 amax
    return x


@pytest.mark.parametrize("shape", [(16, 24), (3, 32, 40), (300,),
                                   (2, 5, 7, 9)], ids=str)
def test_scale_primitives_bit_identical(shape):
    rng = np.random.default_rng(len(shape) * 100 + shape[-1])
    x = _tricky(rng, shape) if len(shape) >= 2 else \
        rng.normal(0, 3, shape).astype(np.float32)
    for axis in range(-1, -len(shape) - 1, -1):
        js = JS.per_channel_scale(jnp.asarray(x), channel_axis=axis)
        ps = PS.per_channel_scale(_t(x), channel_axis=axis)
        assert np.asarray(js).tobytes() == _np(ps).tobytes()
        jq = JS.quantize_int8(jnp.asarray(x), js)
        pq = PS.quantize_int8(_t(x), ps)
        assert pq.dtype == torch.int8
        assert np.asarray(jq).tobytes() == _np(pq).tobytes()
        assert np.asarray(JS.dequantize_int8(jq, js)).tobytes() == \
            _np(PS.dequantize_int8(pq, ps)).tobytes()
    assert float(PS.amax_scale(torch.tensor(0.0))) == \
        float(JS.amax_scale(jnp.asarray(0.0)))


def test_halfway_values_round_half_to_even():
    x = np.array([[0.5, 1.5, 2.5, -0.5, -1.5, 127.0]], np.float32)
    s = np.ones((1, 6), np.float32)
    pq = PS.quantize_int8(_t(x), _t(s))
    assert pq.tolist() == [[0, 2, 2, 0, -2, 127]]
    assert _np(pq).tobytes() == np.asarray(
        JS.quantize_int8(jnp.asarray(x), jnp.asarray(s))).tobytes()


def _random_tree(rng, L, d):
    """A parameter-shaped tree: an unrolled GNN, a stacked one, and
    leaves too small or too thin to quantize."""
    layer = lambda: {"f2_in": {"w": _tricky(rng, (d, d))},    # noqa: E731
                     "f3": {"w": _tricky(rng, (3 * d, d))}}
    return {
        "opcode_embed": {"table": _tricky(rng, (40, 8))},
        "f1": {"w": _tricky(rng, (20, d))},
        "unrolled": {"gnn": {"layers": [layer() for _ in range(L)]}},
        "gnn": {"stacked": {"f2_in": {"w": _tricky(rng, (L, d, d))},
                            "f3": {"w": _tricky(rng, (L, 3 * d, d))}}},
        "head": {"w": _tricky(rng, (2 * d, 1)),
                 "b": rng.normal(0, 1, (1,)).astype(np.float32)},
        "tiny": {"w": _tricky(rng, (8, 8))},                  # < 256
        "vec": {"scale": rng.normal(0, 1, (512,)).astype(np.float32)},
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_params_bit_identical_on_random_trees(seed):
    rng = np.random.default_rng(seed)
    tree = _random_tree(rng, L=3, d=16 + 8 * seed)
    jqm = JQ.quantize_params(jax.tree_util.tree_map(jnp.asarray, tree))
    pqm = PQ.quantize_params(
        jax.tree_util.tree_map(_t, tree), min_size=PQ.DEFAULT_MIN_SIZE)
    _assert_same_leaves(jqm.params, pqm.params)
    assert pqm.num_quantized == jqm.num_quantized
    assert pqm.quantized_bytes() == jqm.quantized_bytes()
    stacked = pqm.params["gnn"]["stacked"]["f2_in"]["w"]
    assert tuple(stacked.scale.shape) == (3, 1, stacked.q.shape[-1])
    assert PS.tree_is_quantized(pqm.params)
    assert not PS.tree_is_quantized(PQ.dequantize_params(pqm))


@pytest.mark.parametrize("scan", [False, True],
                         ids=["unrolled", "stacked"])
def test_quantized_key_set_matches_reference(scan):
    jcfg, pcfg = _configs(scan_layers=scan, reduction="transformer",
                          hidden_dim=16)
    params = jax_init(jax.random.key(0), jcfg)
    jqm = JQ.quantize_params(params, jcfg)
    model = from_jax_params(_numpy_tree(params), pcfg, device="cpu")
    pqm = PQ.quantize_params(model)

    def qkeys(flat, cls):
        return {k for k, v in flat.items() if isinstance(v, cls)}
    want = qkeys(_jax_flat(jqm.params), JS.QuantizedLeaf)
    got = qkeys(_port_flat(pqm.params), PS.QuantizedLeaf)
    assert got == want
    assert ("gnn/stacked/f2_in/w" if scan else "gnn/layers/0/f3/w") in got
    _assert_same_leaves(jqm.params, pqm.params)
    assert pqm.config == jqm.config
    assert PQ.tree_bytes(model) == JQ.tree_bytes(params)


@pytest.mark.parametrize("scan", [False, True],
                         ids=["unrolled", "stacked"])
def test_calibrate_activations_matches_reference(scan):
    jcfg, pcfg = _configs(scan_layers=scan, kernel_feat_mode="node")
    jg, pg = _graphs()
    jn, pn = JF.fit_normalizer(jg), PF.fit_normalizer(pg)
    params = jax_init(jax.random.key(1), jcfg)
    want = JQ.calibrate_activations(params, jcfg, jg, jn)
    model = from_jax_params(_numpy_tree(params), pcfg, device="cpu")
    got = PQ.calibrate_activations(model, pcfg, pg, pn)
    assert set(got) == set(want) == {"f1", "gnn_0", "gnn_1"}
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6), k
    # the calibrated model carries the same scales either way
    jqm = JQ.quantize_params(params, jcfg, calib_graphs=jg, normalizer=jn)
    pqm = PQ.quantize_params(model, pcfg, calib_graphs=pg, normalizer=pn)
    for k in want:
        assert pqm.act_scales[k] == pytest.approx(jqm.act_scales[k],
                                                  rel=1e-6)


# --------------------------------------------------------------- sidecar
def _jax_qm(scan=True, seed=3):
    jcfg, _ = _configs(scan_layers=scan)
    jg, _ = _graphs()
    params = jax_init(jax.random.key(seed), jcfg)
    return JQ.quantize_params(params, jcfg, calib_graphs=jg,
                              normalizer=JF.fit_normalizer(jg))


@pytest.mark.parametrize("scan", [False, True],
                         ids=["unrolled", "stacked"])
def test_jax_sidecar_loads_in_port_bit_exact(tmp_path, scan):
    jqm = _jax_qm(scan)
    path = str(tmp_path / "model.int8.npz")
    JQ.save_quantized(path, jqm)
    pqm = PQ.load_quantized(path, device="cpu")
    _assert_same_leaves(jqm.params, pqm.params)
    assert pqm.config == jqm.config
    assert pqm.act_scales == {k: float(v) for k, v in
                              jqm.act_scales.items()}


@pytest.mark.parametrize("scan", [False, True],
                         ids=["unrolled", "stacked"])
def test_port_sidecar_loads_in_jax_bit_exact(tmp_path, scan):
    jqm = _jax_qm(scan, seed=4)
    pqm = from_jax_quantized(_numpy_tree(jqm.params), jqm.act_scales,
                             jqm.config, device="cpu")
    _assert_same_leaves(jqm.params, pqm.params)
    path = str(tmp_path / "port.int8.npz")
    assert PQ.save_quantized(path, pqm) == path
    back = JQ.load_quantized(path)
    _assert_same_leaves(back.params, pqm.params)
    assert back.config == pqm.config
    assert back.act_scales == pytest.approx(pqm.act_scales)
    # the two packages write the same arrays under the same names
    jpath = str(tmp_path / "jax.int8.npz")
    JQ.save_quantized(jpath, jqm)
    with np.load(path) as a, np.load(jpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            if k != "__meta__":
                assert a[k].tobytes() == b[k].tobytes(), k


def test_sidecar_checksum_mismatch_raises(tmp_path):
    _, pcfg = _configs()
    from repro_torch.core.model import cost_model_init
    pqm = PQ.quantize_params(cost_model_init(
        torch.Generator().manual_seed(0), pcfg, device="cpu"))
    path = str(tmp_path / "m.npz")
    PQ.save_quantized(path, pqm)
    with np.load(path) as z:
        arrays = {k: np.array(z[k]) for k in z.files}
    victim = next(k for k in arrays if k.endswith(".q"))
    arrays[victim].flat[0] ^= 1                        # flip one bit
    np.savez(path, **arrays)
    with pytest.raises(ValueError, match="checksum"):
        PQ.load_quantized(path, device="cpu")
    with pytest.raises(ValueError, match="checksum"):
        JQ.load_quantized(path)


def test_from_jax_quantized_rejects_mismatched_tree():
    jqm = _jax_qm()
    config = dict(jqm.config, hidden_dim=24)
    with pytest.raises(ValueError, match="wrong shape"):
        from_jax_quantized(_numpy_tree(jqm.params), jqm.act_scales, config,
                           device="cpu")


# ------------------------------------------------------- int8 predictions
def _batches(layout):
    jg, pg = _graphs()
    jn, pn = JF.fit_normalizer(jg), PF.fit_normalizer(pg)
    if layout == "dense":
        return (JF.encode_batch(jg, MAX_NODES, jn),
                PF.encode_batch(pg, MAX_NODES, pn))
    return JB.encode_packed(jg, jn), PB.encode_packed(pg, pn)


INT8_COMBOS = list(itertools.product(
    ["dense", "sparse"], [False, True], [False, True],
    ["per_node", "transformer"]))


def _int8_id(c):
    layout, scan, kernels, red = c
    return (f"{layout}-{'stacked' if scan else 'unrolled'}-"
            f"{'kernel' if kernels else 'plain'}-{red}")


@pytest.mark.parametrize("combo", INT8_COMBOS,
                         ids=[_int8_id(c) for c in INT8_COMBOS])
def test_int8_predictions_match_jax(combo):
    layout, scan, kernels, red = combo
    jcfg, _ = _configs(adjacency=layout, scan_layers=scan, reduction=red,
                       use_pallas_aggregate=kernels)
    params = jax_init(jax.random.key(7), jcfg)
    jqm = JQ.quantize_params(params, jcfg)
    jb, pb = _batches(layout)
    want = np.asarray(jax_apply(jqm.params, jqm.serving_config(), jb))
    pqm = from_jax_quantized(_numpy_tree(jqm.params), jqm.act_scales,
                             jqm.config, device="cpu")
    cfg = pqm.serving_config()
    assert cfg.precision == "int8" and cfg.use_pallas_aggregate == kernels
    got = make_predict_fn(cfg)(pqm.model(), pb)
    assert got.shape == want.shape == (jb.batch_size,)
    np.testing.assert_allclose(got, want, **TOL)


def test_int8_model_keeps_weights_as_int8_buffers():
    jqm = _jax_qm(scan=False)
    pqm = from_jax_quantized(_numpy_tree(jqm.params), jqm.act_scales,
                             jqm.config, device="cpu")
    model = pqm.model()
    sd = model.state_dict()
    assert sd["gnn.layers.0.f2_in.w.q"].dtype == torch.int8
    assert sd["gnn.layers.0.f2_in.w.scale"].dtype == torch.float32
    buffers = dict(model.named_buffers())
    assert "gnn.layers.0.f2_in.w.q" in buffers
    assert not any(p.dtype == torch.int8 for p in model.parameters())
    assert model.device == torch.device("cpu")
    assert set(sd) == {k.replace("/", ".") + suffix
                       for k, v in _jax_flat(jqm.params).items()
                       for suffix in ((".q", ".scale")
                                      if isinstance(v, JS.QuantizedLeaf)
                                      else ("",))}


def test_int8_kernel_path_feeds_int8_weights_to_the_kernel(monkeypatch):
    """With the kernels on, the sparse hop hands the f2 weights to
    `segment_aggregate` as int8 with their scales; f3 is dequantized."""
    from repro_torch.core import gnn as G
    seen = []
    real = G.segment_aggregate

    def spy(x, w, w_scale, edges, node_mask, **kw):
        seen.append((w.dtype, tuple(w_scale.shape)))
        return real(x, w, w_scale, edges, node_mask, **kw)
    monkeypatch.setattr(G, "segment_aggregate", spy)
    jqm = _jax_qm(scan=True)
    pqm = from_jax_quantized(_numpy_tree(jqm.params), jqm.act_scales,
                             dict(jqm.config, use_pallas_aggregate=True),
                             device="cpu")
    _, pb = _batches("sparse")
    make_predict_fn(pqm.serving_config())(pqm.model(), pb)
    assert seen and all(s == (torch.int8, (1, 32)) for s in seen)
    assert len(seen) == 2 * 2                  # 2 hops x 2 directions


# -------------------------------------------------- service and the CLI
def test_service_accepts_quantized_model():
    from repro_torch.serving import CostModelService
    jqm = _jax_qm(scan=False)
    pqm = from_jax_quantized(_numpy_tree(jqm.params), jqm.act_scales,
                             jqm.config, device="cpu")
    jg, pg = _graphs()
    pn = PF.fit_normalizer(pg)
    svc = CostModelService(pqm, None, pn)
    assert svc.precision == "int8"
    got = svc.predict_many(pg)
    jb = JB.encode_packed(jg, JF.fit_normalizer(jg))
    ref = np.asarray(jax_apply(jqm.params, jqm.serving_config(), jb))
    np.testing.assert_allclose(got, ref[:len(pg)], **TOL)


def test_service_snapshot_stamps_int8(tmp_path):
    from repro_torch.serving import CostModelService
    from repro_torch.serving.cache import SnapshotFormatError
    jqm = _jax_qm(scan=False)
    pqm = from_jax_quantized(_numpy_tree(jqm.params), jqm.act_scales,
                             jqm.config, device="cpu")
    _, pg = _graphs()
    pn = PF.fit_normalizer(pg)
    q_svc = CostModelService(pqm, None, pn)
    q_svc.predict_many(pg)
    path = str(tmp_path / "cache.npz")
    assert q_svc.snapshot_cache(path) > 0
    with np.load(path) as z:
        header = json.loads(bytes(z["entries"]).decode("utf-8"))
    assert header["meta"] == {"precision": "int8"}
    f32 = from_jax_params(_numpy_tree(JQ.dequantize_params(jqm)),
                          CostModelConfig.from_dict(
                              dict(jqm.config, precision="f32")),
                          device="cpu")
    f_svc = CostModelService(f32, f32.cfg, pn)
    with pytest.raises(SnapshotFormatError, match="precision"):
        f_svc.restore_cache(path)
    assert CostModelService(pqm, None, pn).restore_cache(path) > 0


def test_serve_cli_int8_on_cpu(capsys):
    from repro_torch.launch.serve_costmodel import main
    assert main(["--precision", "int8", "--device", "cpu", "--programs",
                 "2", "--rounds", "1"]) == 0
    out = capsys.readouterr().out
    assert "precision=int8" in out and "queries/s" in out

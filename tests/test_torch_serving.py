"""The port's serving path against the JAX package's.

The same 2-program tile-search replay goes through JAX's
`CostModelService` and the port's (on the CPU) with the same parameters:
predictions agree within 1e-5 and the cache and coalescer behave the same.
Also `predict_kernels` parity, and the jax-free JAX-checkpoint reader on a
checkpoint written by `repro.training.checkpoint`.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from repro.core.evaluate import make_predict_fn as jax_predict_fn
from repro.core.evaluate import predict_kernels as jax_predict_kernels
from repro.core.model import CostModelConfig as JaxConfig
from repro.core.model import cost_model_init as jax_init
from repro.serving import CostModelService as JaxService
from repro.serving.replay import build_tile_replay as jax_replay
from repro.serving.replay import run_replay
from repro.training.checkpoint import save_checkpoint
from repro_torch.core.evaluate import make_predict_fn, predict_kernels
from repro_torch.core.model import CostModelConfig
from repro_torch.core.params import from_jax_params, load_jax_checkpoint, \
    read_jax_checkpoint
from repro_torch.serving import CostModelService
from repro_torch.serving.replay import build_tile_replay

TOL = dict(rtol=1e-5, atol=1e-5)
REPLAY = dict(max_configs=8, rounds=3, subset=0.75, seed=0)


def _configs(layout, **kw):
    base = dict(gnn="graphsage", reduction="column_wise", hidden_dim=16,
                opcode_embed_dim=8, dropout=0.0, max_nodes=24,
                adjacency=layout)
    base.update(kw)
    jcfg = JaxConfig(**base)
    return jcfg, CostModelConfig.from_dict(jcfg.to_dict())


@pytest.fixture(scope="module")
def replays():
    return jax_replay(2, **REPLAY), build_tile_replay(2, **REPLAY)


@pytest.fixture(scope="module")
def jax_params():
    return jax_init(jax.random.key(0), _configs("sparse")[0])


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


_JAX_RUNS = {}


def _jax_run(layout, replays, params):
    if layout not in _JAX_RUNS:
        jcfg, _ = _configs(layout)
        svc = JaxService(params, jcfg, replays[0].normalizer,
                         predict_fn=jax_predict_fn(jcfg))
        preds, _ = run_replay(svc.predict_many, replays[0].requests)
        _JAX_RUNS[layout] = (preds, svc.stats())
    return _JAX_RUNS[layout]


def test_replay_streams_identical(replays):
    jr, pr = replays
    assert jr.num_kernels == pr.num_kernels
    assert [[g.canonical_hash() for g in r] for r in jr.requests] == \
        [[g.canonical_hash() for g in r] for r in pr.requests]


@pytest.mark.parametrize("layout", ["sparse", "dense"])
@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernel"])
def test_service_matches_jax_service(layout, kernels, replays, jax_params):
    want, jstats = _jax_run(layout, replays, jax_params)
    _, pcfg = _configs(layout, use_pallas_aggregate=kernels)
    model = from_jax_params(_numpy_tree(jax_params), pcfg, device="cpu")
    svc = CostModelService(model, pcfg, replays[1].normalizer,
                           predict_fn=make_predict_fn(pcfg))
    got, _ = run_replay(svc.predict_many, replays[1].requests)
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(want),
                               **TOL)
    st = svc.stats()
    assert st.hit_rate == jstats.hit_rate
    assert (st.cache.hits, st.cache.misses) == \
        (jstats.cache.hits, jstats.cache.misses)
    assert st.flushes == jstats.flushes
    assert st.flush_sizes == jstats.flush_sizes
    assert st.requests == jstats.requests and st.graphs == jstats.graphs


@pytest.mark.parametrize("layout", ["sparse", "dense"])
def test_predict_kernels_matches_jax(layout, replays, jax_params):
    graphs = [g for r in replays[0].requests[:4] for g in r]
    pgraphs = [g for r in replays[1].requests[:4] for g in r]
    jcfg, pcfg = _configs(layout, use_pallas_aggregate=False)
    want = jax_predict_kernels(jax_params, jcfg, graphs,
                               replays[0].normalizer, max_nodes=24, chunk=16)
    model = from_jax_params(_numpy_tree(jax_params), pcfg, device="cpu")
    got = predict_kernels(model, pcfg, pgraphs, replays[1].normalizer,
                          max_nodes=24, chunk=16)
    np.testing.assert_allclose(got, want, **TOL)


def test_service_cache_snapshot_round_trip(tmp_path, replays, jax_params):
    _, pcfg = _configs("sparse")
    model = from_jax_params(_numpy_tree(jax_params), pcfg, device="cpu")
    svc = CostModelService(model, pcfg, replays[1].normalizer)
    req = replays[1].requests[0]
    first = svc.predict_many(req)
    path = str(tmp_path / "warm.npz")
    assert svc.snapshot_cache(path) == len(set(
        g.canonical_hash() for g in req))
    warm = CostModelService(model, pcfg, replays[1].normalizer)
    warm.restore_cache(path)
    np.testing.assert_array_equal(warm.predict_many(req), first)
    assert warm.stats().cache.misses == 0


@pytest.mark.parametrize("saved_scan,load_scan",
                         [(False, False), (True, False), (False, True)])
def test_jax_checkpoint_round_trip(tmp_path, replays, saved_scan,
                                   load_scan):
    jcfg, _ = _configs("sparse", scan_layers=saved_scan)
    _, pcfg = _configs("sparse", scan_layers=load_scan)
    params = jax_init(jax.random.key(1), jcfg)
    state = {"params": params, "opt": {"count": jnp.zeros((), jnp.int32)}}
    save_checkpoint(str(tmp_path), 7, state, meta={"note": "x"})

    tree, step, meta = read_jax_checkpoint(str(tmp_path))
    assert step == 7 and meta == {"note": "x"}
    flat_saved = jax.tree_util.tree_leaves(_numpy_tree(params))
    flat_read = jax.tree_util.tree_leaves(tree["params"])
    assert len(flat_saved) == len(flat_read)
    for a, b in zip(flat_saved, flat_read):
        assert np.array_equal(a, b)

    model = load_jax_checkpoint(str(tmp_path), pcfg, device="cpu")
    graphs = [g for r in replays[1].requests[:3] for g in r]
    jgraphs = [g for r in replays[0].requests[:3] for g in r]
    got = predict_kernels(model, pcfg, graphs, replays[1].normalizer,
                          max_nodes=24)
    want = jax_predict_kernels(params, jcfg, jgraphs, replays[0].normalizer,
                               max_nodes=24)
    np.testing.assert_allclose(got, want, **TOL)


def test_read_jax_checkpoint_missing_dir(tmp_path):
    with pytest.raises(FileNotFoundError):
        read_jax_checkpoint(str(tmp_path / "none"))


def test_serve_cli_replays_on_cpu(capsys):
    from repro_torch.launch.serve_costmodel import main
    assert main(["--programs", "1", "--rounds", "2", "--max-configs", "4",
                 "--hidden-dim", "16", "--device", "cpu",
                 "--compare-direct"]) == 0
    out = capsys.readouterr().out
    assert "queries/s" in out and "max prediction delta" in out


@pytest.mark.parametrize("flags", [["--listen", "127.0.0.1:0"],
                                   ["--connect", "127.0.0.1:1"],
                                   ["--precision", "int8"]])
def test_serve_cli_refuses_unported_modes(flags, capsys):
    from repro_torch.launch.serve_costmodel import main
    with pytest.raises(SystemExit) as e:
        main(flags + ["--device", "cpu"])
    assert e.value.code == 2
    assert "not ported" in capsys.readouterr().err

"""The data flywheel in the port, against the JAX package.

On the CPU, with inputs made by numpy from a seed:

* the corpus store: the same records give the same `manifest_hash`,
  `append_delta` the same `chain_hash`, each package opens and chains
  the other's store, and tampering, a wrong base and a corrupt shard are
  caught whichever package wrote the store;
* `MeasurementLog` sweeps and `route_variance` plans equal to the
  reference's;
* the stochastic forward (graphsage + LSTM, dropout live) under the
  same numpy mask in both packages, and `AcquisitionEstimator`:
  deterministic per seed, masks reused across the chunks of one sample
  as in the reference, MC mean and std over 256 samples within a
  statistical tolerance of the reference's, the same refusals;
* `tile_val_loss` and `fine_tune` (dropout 0, from one checkpoint both
  read) and `run_flywheel` with the same deterministic acquisition in
  both packages, round for round;
* `chip_smoke.py`'s flywheel scenario (`benchmarks/bench_flywheel.py`'s
  constants) on the CPU: regret margin > 0, the delta chain equal to a
  rebuild;
* the CLIs: `train --from-store/--deltas` and its refusals,
  `build_corpus` (1 and 2 workers, the JAX builder's hash,
  `--import-archs` on the CPU), `launch.flywheel --device cpu` twice.
"""
import dataclasses
import doctest
import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

import repro.core.model as JM
import repro.flywheel.loop as JLoop
from repro.core import features as JF
from repro.core.simulator import TPUSimulator as JaxSimulator
from repro.data import batching as JB
from repro.data import store as JS
from repro.data.fusion_dataset import FusionKernelRecord as JaxFusionRecord
from repro.data.synthetic import generate_corpus as jax_corpus
from repro.data.synthetic import random_kernel as jax_random_kernel
from repro.data.sampler import TileBatchSampler as JaxTileSampler
from repro.data.tile_dataset import TileKernelRecord as JaxTileRecord
from repro.data.tile_dataset import build_tile_dataset as jax_tile_ds
from repro.data.tile_dataset import build_tile_records as jax_tile_records
from repro.data.tile_dataset import fit_tile_normalizer as jax_fit_tile
from repro.flywheel import FlywheelConfig as JaxFlywheelConfig
from repro.flywheel import MeasurementLog as JaxLog
from repro.flywheel import run_flywheel as jax_run_flywheel
from repro.flywheel.retrain import fine_tune as jax_fine_tune
from repro.flywheel.retrain import tile_val_loss as jax_val_loss
from repro.launch import build_corpus as JBC
from repro.search import HardwareEstimator as JaxHardware
from repro.search import acquisition as JA
from repro.training import checkpoint as JC
from repro.training import optim as JO
import repro_torch.core.model as PM
import repro_torch.flywheel.loop as PLoop
from repro_torch.core import features as PF
from repro_torch.core.params import from_jax_params
from repro_torch.core.simulator import TPUSimulator
from repro_torch.data import batching as PB
from repro_torch.data import store as PS
from repro_torch.data.fusion_dataset import FusionKernelRecord
from repro_torch.data.sampler import TileBatchSampler
from repro_torch.data.synthetic import generate_corpus, random_kernel
from repro_torch.data.tile_dataset import TileKernelRecord, \
    build_tile_dataset, build_tile_records, fit_tile_normalizer
from repro_torch.flywheel import FlywheelConfig, MeasurementLog, \
    run_flywheel
from repro_torch.flywheel.retrain import fine_tune, tile_val_loss
from repro_torch.launch import build_corpus as PBC
from repro_torch.search import AcquisitionEstimator, HardwareEstimator
from repro_torch.search import acquisition as PA

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TILES = [(8, 8), (16, 8), (4, 4), (8, 16)]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["OMP_NUM_THREADS"] = "1"
    return env


# ------------------------------------------------------------ records
def _records(pkg: str, kind: str, seeds) -> list:
    """Records of either package from the same seeds."""
    rk = jax_random_kernel if pkg == "jax" else random_kernel
    if kind == "fusion":
        rec = JaxFusionRecord if pkg == "jax" else FusionKernelRecord
        return [rec(rk(5 + s % 7, seed=s, program=f"p{s % 3}"),
                    1e-5 * (s + 1), program=f"p{s % 3}") for s in seeds]
    rec = JaxTileRecord if pkg == "jax" else TileKernelRecord
    out = []
    for s in seeds:
        tiles = TILES[:1 + s % len(TILES)]
        out.append(rec(kernel=rk(5 + s % 7, seed=s, program=f"p{s % 3}"),
                       tiles=list(tiles),
                       runtimes=np.linspace(1e-4, 2e-4 + 1e-6 * s,
                                            len(tiles)),
                       program=f"p{s % 3}"))
    return out


def _blobs(pkg_store, kind, corpus) -> list:
    return [json.dumps(pkg_store.pack_record(kind, r), sort_keys=True)
            for r in corpus]


def _files(d):
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d))}


@pytest.mark.parametrize("kind", ["tile", "fusion"])
@pytest.mark.parametrize("dedup", [True, False])
def test_same_records_same_manifest_hash(kind, dedup, tmp_path):
    seeds = list(range(9)) + [0, 3]          # two duplicates
    spec = {"test": kind}
    jm = JS.write_corpus(str(tmp_path / "j"), kind,
                         _records("jax", kind, seeds), spec=spec,
                         shard_records=4, dedup=dedup)
    pm = PS.write_corpus(str(tmp_path / "p"), kind,
                         _records("port", kind, seeds), spec=spec,
                         shard_records=4, dedup=dedup)
    assert pm["manifest_hash"] == jm["manifest_hash"]
    assert pm == jm
    assert _files(tmp_path / "p") == _files(tmp_path / "j")


def _store_with_deltas(pkg_store, pkg, d):
    """A tile base store and two deltas: new records, a duplicate of the
    base and a grown sweep of an earlier delta record."""
    pkg_store.write_corpus(d, "tile", _records(pkg, "tile", range(6)),
                           dedup=True)
    grown = _records(pkg, "tile", [13])[0]
    grown = dataclasses.replace(grown, tiles=TILES,
                                runtimes=np.linspace(3e-4, 4e-4, 4))
    deltas = [_records(pkg, "tile", [10, 11, 2]),
              [grown] + _records(pkg, "tile", [12, 0])]
    ms = [pkg_store.CorpusWriter.append_delta(d, recs, note=f"round {i}")
          for i, recs in enumerate(deltas)]
    return ms


def test_append_delta_same_chain_hash(tmp_path):
    jd, pd = str(tmp_path / "j"), str(tmp_path / "p")
    jms = _store_with_deltas(JS, "jax", jd)
    pms = _store_with_deltas(PS, "port", pd)
    assert [m["manifest_hash"] for m in pms] == \
        [m["manifest_hash"] for m in jms]
    jc = JS.StreamingCorpus.open(jd).with_deltas()
    pc = PS.StreamingCorpus.open(pd).with_deltas()
    assert pc.chain_hash == jc.chain_hash and pc.num_deltas == 2
    assert _blobs(PS, "tile", pc) == _blobs(JS, "tile", jc)
    assert _files(pd) == _files(jd)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_store(writer, tmp_path):
    d = str(tmp_path / "s")
    w_store, r_store = (JS, PS) if writer == "jax" else (PS, JS)
    _store_with_deltas(w_store, writer, d)
    theirs = r_store.StreamingCorpus.open(d, verify=True).with_deltas()
    ours = w_store.StreamingCorpus.open(d).with_deltas()
    theirs.verify()
    assert theirs.chain_hash == ours.chain_hash
    assert theirs.record_programs == ours.record_programs
    assert _blobs(r_store, "tile", theirs) == _blobs(w_store, "tile", ours)
    # and the reader's appends extend the writer's chain
    r_store.CorpusWriter.append_delta(
        d, _records("port" if writer == "jax" else "jax", "tile", [20]))
    assert w_store.StreamingCorpus.open(d).with_deltas().num_deltas == 3


def _tamper(d, _):
    path = os.path.join(d, "delta-00000.json")
    text = open(path).read().replace('"delta_seq": 0',
                                     '"delta_seq": 0, "evil": 1')
    with open(path, "w") as f:
        f.write(text)


def _wrong_base(d, tmp_path):
    other = str(tmp_path / "other")
    PS.write_corpus(other, "tile", _records("port", "tile", [40]),
                    dedup=True)
    for name in os.listdir(d):
        if name.startswith("delta-"):
            with open(os.path.join(d, name), "rb") as src, \
                    open(os.path.join(other, name), "wb") as dst:
                dst.write(src.read())
    return other


def _corrupt(d, _):
    shard = os.path.join(d, "delta-00000-00000.npz")
    blob = bytearray(open(shard, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    with open(shard, "wb") as f:
        f.write(bytes(blob))


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("fault", ["tamper", "wrong_base", "corrupt"])
def test_delta_faults_are_caught(fault, writer, tmp_path):
    d = str(tmp_path / "s")
    w_store = JS if writer == "jax" else PS
    w_store.write_corpus(d, "tile", _records(writer, "tile", range(3)),
                         dedup=True)
    w_store.CorpusWriter.append_delta(d, _records(writer, "tile", [30]))
    if fault == "tamper":
        _tamper(d, tmp_path)
        with pytest.raises(PS.CorpusFormatError,
                           match="manifest hash mismatch"):
            PS.load_delta_manifests(d)
    elif fault == "wrong_base":
        other = _wrong_base(d, tmp_path)
        with pytest.raises(PS.CorpusFormatError, match="base"):
            PS.load_delta_manifests(other)
    else:
        _corrupt(d, tmp_path)
        chained = PS.StreamingCorpus.open(d).with_deltas()
        with pytest.raises(PS.CorpusFormatError, match="checksum"):
            chained[3]                          # the first delta record


@pytest.mark.parametrize("module", ["repro_torch.data.store",
                                    "repro_torch.flywheel.log",
                                    "repro_torch.search.acquisition"])
def test_module_doctests(module):
    res = doctest.testmod(importlib.import_module(module), verbose=False)
    assert res.attempted > 0 and res.failed == 0


# ------------------------------------------------------ MeasurementLog
def _rec_key(r):
    if hasattr(r, "tiles"):
        return (r.program, r.kernel.structural_digest(order_sensitive=True),
                [tuple(t) for t in r.tiles], r.runtimes.tolist())
    return (r.program, r.kernel.canonical_hash(order_sensitive=True),
            r.runtime)


@pytest.mark.parametrize("kind,min_configs", [("tile", 1), ("tile", 2),
                                              ("fusion", 1)])
def test_measurement_log_sweeps_match_jax(kind, min_configs, tmp_path):
    """The same charged measurements, round by round: the same pending
    sweeps, duplicates and delta shards."""
    rng = np.random.default_rng(0)
    rounds = [[(int(rng.integers(0, 4)), TILES[int(rng.integers(0, 4))])
               for _ in range(5)] for _ in range(4)]
    logs = {"jax": JaxLog(kind), "port": MeasurementLog(kind)}
    hws = {"jax": JaxHardware(JaxSimulator(), log=logs["jax"]),
           "port": HardwareEstimator(TPUSimulator(), log=logs["port"])}
    rk = {"jax": jax_random_kernel, "port": random_kernel}
    stores = {"jax": JS, "port": PS}
    for pkg in logs:
        stores[pkg].write_corpus(str(tmp_path / pkg), kind,
                                 _records(pkg, kind, [99]), dedup=True)
    hashes = {"jax": [], "port": []}
    for r, batch in enumerate(rounds):
        pend = {}
        for pkg, hw in hws.items():
            hw.estimate([rk[pkg](6 + s, seed=s, program=f"k{s}").with_tile(t)
                         if kind == "tile" else
                         rk[pkg](6 + s, seed=s + 10 * r, program=f"k{s}")
                         for s, t in batch])
            if r % 2:
                m = logs[pkg].flush_to(str(tmp_path / pkg),
                                       min_configs=min_configs)
                hashes[pkg].append(m and m["manifest_hash"])
            else:
                pend[pkg] = [_rec_key(x) for x in logs[pkg].take_pending(
                    min_configs=min_configs)]
        if pend:
            assert pend["port"] == pend["jax"]
    assert hashes["port"] == hashes["jax"]
    for attr in ("total", "duplicates"):
        assert getattr(logs["port"], attr) == getattr(logs["jax"], attr)
    assert len(logs["port"]) == len(logs["jax"])
    assert [_rec_key(x) for x in logs["port"].records()] == \
        [_rec_key(x) for x in logs["jax"].records()]


# ------------------------------------------------------ route_variance
@pytest.mark.parametrize("spread", ["kernel", "global"])
@pytest.mark.parametrize("kappa", [None, 0.0, 1.0, 6.0])
@pytest.mark.parametrize("exclude", [False, True])
def test_route_variance_matches_jax(spread, kappa, exclude):
    rng = np.random.default_rng(hash((spread, kappa, exclude)) % 2 ** 32)
    for trial in range(6):
        sizes = rng.integers(1, 7, size=rng.integers(1, 6))
        stds = [rng.random(n).round(int(rng.integers(1, 4))) for n in sizes]
        means = [rng.normal(0, 1, n) for n in sizes]
        ex = {(gi, int(rng.integers(0, n))) for gi, n in enumerate(sizes)
              if exclude and rng.random() < 0.5}
        budget = int(rng.integers(0, sum(sizes) + 3))
        kw = dict(spread=spread, exclude=ex)
        if kappa is not None:
            kw.update(means=means, kappa=kappa)
        assert PA.route_variance(stds, budget, **kw) == \
            JA.route_variance(stds, budget, **kw)


# ------------------------------------------- stochastic forward, MC acq
MAX_NODES = 24
SIZES = [5, 12, 3, 20, 1, 17, 9, 14]


def _configs(**kw):
    base = dict(gnn="graphsage", reduction="lstm", hidden_dim=16,
                opcode_embed_dim=8, gnn_layers=2, max_nodes=MAX_NODES,
                dropout=0.3, kernel_feat_mode="kernel")
    base.update(kw)
    jcfg = JM.CostModelConfig(**base)
    return jcfg, PM.CostModelConfig.from_dict(jcfg.to_dict())


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _graphs():
    jg = [jax_random_kernel(n, seed=i) for i, n in enumerate(SIZES)]
    pg = [random_kernel(n, seed=i) for i, n in enumerate(SIZES)]
    return jg, pg, JF.fit_normalizer(jg), PF.fit_normalizer(pg)


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_stochastic_forward_matches_jax_under_the_same_masks(layout,
                                                             monkeypatch):
    """graphsage + LSTM with dropout live: both packages' dropout patched
    to apply the same numpy mask; the forwards agree within 1e-5 of
    max|pred|, and differ from the deterministic forward (the mask is
    applied where the reference applies it)."""
    jcfg, pcfg = _configs(adjacency=layout)
    params = JM.cost_model_init(jax.random.key(4), jcfg)
    model = from_jax_params(_numpy_tree(params), pcfg, device="cpu")
    jg, pg, jn, pn = _graphs()
    if layout == "dense":
        jb, pb = (JF.encode_batch(jg, MAX_NODES, jn),
                  PF.encode_batch(pg, MAX_NODES, pn))
    else:
        jb, pb = JB.encode_packed(jg, jn), PB.encode_packed(pg, pn)
    calls = {"jax": 0, "port": 0}

    def mask(pkg, shape, keep):
        i = calls[pkg]
        calls[pkg] += 1
        return np.random.default_rng(100 + i).random(shape) < keep

    def jax_dropout(rng, x, rate, deterministic):
        if deterministic or rate <= 0.0 or rng is None:
            return x
        keep = 1.0 - rate
        return jnp.where(mask("jax", x.shape, keep), x / keep, 0.0)

    def port_dropout(x, rate, *, generator, training):
        if not training or rate <= 0.0 or generator is None:
            return x
        keep = 1.0 - rate
        m = torch.from_numpy(mask("port", tuple(x.shape), keep))
        return torch.where(m, x / keep, torch.zeros_like(x))
    monkeypatch.setattr(JM, "dropout", jax_dropout)
    monkeypatch.setattr(PM, "dropout", port_dropout)
    want = np.asarray(JM.cost_model_apply(params, jcfg, jb,
                                          rng=jax.random.key(0),
                                          deterministic=False))
    with torch.inference_mode():
        tb = PM.batch_to_device(pb, torch.device("cpu"))
        got = PM.cost_model_apply(model.tree(), pcfg, tb,
                                  generator=torch.Generator(),
                                  training=True).numpy()
        det = PM.cost_model_apply(model.tree(), pcfg, tb).numpy()
    assert calls == {"jax": 1, "port": 1}
    tol = 1e-5 * float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= tol
    assert float(np.abs(det - want).max()) > 100 * tol


def _acq_pair(samples, seed=0, **kw):
    jcfg, pcfg = _configs(**kw)
    params = JM.cost_model_init(jax.random.key(5), jcfg)
    model = from_jax_params(_numpy_tree(params), pcfg, device="cpu")
    jg, pg, jn, pn = _graphs()
    akw = dict(samples=samples, seed=seed, max_nodes=MAX_NODES, chunk=8)
    return (JA.AcquisitionEstimator(params, jcfg, jn, **akw),
            AcquisitionEstimator.from_params(model, pcfg, pn, **akw), jg, pg)


def test_acquisition_is_deterministic_for_a_seed():
    _, acq, _, pg = _acq_pair(4)
    mean, std = acq.estimate_with_variance(pg)
    again = AcquisitionEstimator(acq.model, acq.model_cfg, acq.normalizer,
                                 samples=4, seed=0, max_nodes=MAX_NODES,
                                 chunk=8)
    m2, s2 = again.estimate_with_variance(pg)
    assert np.array_equal(mean, m2) and np.array_equal(std, s2)
    other = AcquisitionEstimator(acq.model, acq.model_cfg, acq.normalizer,
                                 samples=4, seed=1, max_nodes=MAX_NODES,
                                 chunk=8)
    assert not np.array_equal(other.estimate_with_variance(pg)[0], mean)
    assert np.all(std > 0)
    assert acq.queries == len(pg)
    np.testing.assert_allclose(acq.estimate(pg), mean, rtol=1e-6)


def test_acquisition_masks_repeat_across_chunks_as_in_the_reference():
    """One key (one generator seed) per sample, reused for every chunk:
    the same kernels in two chunks of the same shape get the same
    masks, in both packages."""
    jacq, pacq, jg, pg = _acq_pair(3)
    for acq, graphs in ((jacq, jg), (pacq, pg)):
        acq._kw["chunk"] = 4
        stack = acq._mc_stack(graphs[:4] + graphs[:4])
        assert np.array_equal(stack[:, :4], stack[:, 4:])
        assert not np.array_equal(stack[0], stack[1])


def test_acquisition_statistics_match_jax():
    """MC mean and std over 256 samples: the masks differ between the
    frameworks, so the two are compared as estimates of one
    distribution. Per kernel, the means within 5 standard errors
    (sqrt((s_j^2 + s_p^2) / n)), the stds within 25 % of each other
    (the relative standard error of a std estimate at n = 256 is about
    4.4 %, of the difference about 6.3 %: 4 of those)."""
    n = 256
    jacq, pacq, jg, pg = _acq_pair(n)
    jm, js = jacq.estimate_with_variance(jg)
    pm, ps = pacq.estimate_with_variance(pg)
    se = np.sqrt((js ** 2 + ps ** 2) / n)
    assert np.all(np.abs(pm - jm) <= 5 * se + 1e-6), (pm - jm) / se
    assert np.all(np.abs(ps - js) <= 0.25 * np.maximum(ps, js)), ps / js
    assert np.all(js > 0)


@pytest.mark.parametrize("cfg_kw,acq_kw", [({}, dict(samples=1)),
                                           (dict(dropout=0.0), {})])
def test_acquisition_refuses_as_the_reference(cfg_kw, acq_kw):
    jcfg, pcfg = _configs(**cfg_kw)
    params = JM.cost_model_init(jax.random.key(5), jcfg)
    model = from_jax_params(_numpy_tree(params), pcfg, device="cpu")
    with pytest.raises(ValueError) as want:
        JA.AcquisitionEstimator(params, jcfg, None, **acq_kw)
    with pytest.raises(ValueError) as got:
        AcquisitionEstimator.from_params(model, pcfg, None, **acq_kw)
    assert str(got.value) == str(want.value)


# ------------------------------------------- tile_val_loss, fine_tune
@pytest.fixture(scope="module")
def tile_world():
    kw = dict(max_configs_per_kernel=6, max_kernel_nodes=MAX_NODES)
    jrec = jax_tile_ds(jax_corpus(4, seed=0), JaxSimulator(), **kw).records
    prec = build_tile_dataset(generate_corpus(4, seed=0), TPUSimulator(),
                              **kw).records
    return jrec, prec, jax_fit_tile(jrec), fit_tile_normalizer(prec)


def _checkpoint(tmp_path, jcfg, seed=6):
    """A JAX-written checkpoint (params and AdamW state) both read."""
    params = JM.cost_model_init(jax.random.key(seed), jcfg)
    d = str(tmp_path / "warm")
    JC.save_checkpoint(d, 7, {"params": params,
                              "opt": JO.adamw_init(params)})
    return params, d


def test_tile_val_loss_matches_jax(tile_world, tmp_path):
    jrec, prec, jn, pn = tile_world
    jcfg, pcfg = _configs(dropout=0.0)
    params, _ = _checkpoint(tmp_path, jcfg)
    model = from_jax_params(_numpy_tree(params), pcfg, device="cpu")
    kw = dict(kernels_per_batch=2, configs_per_kernel=4, max_nodes=MAX_NODES,
              seed=9)
    want = jax_val_loss(params, jcfg, JaxTileSampler(jrec, jn, **kw),
                        batches=4)
    got = tile_val_loss(model, pcfg, TileBatchSampler(prec, pn, **kw),
                        batches=4)
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("kernels", [False, True])
def test_fine_tune_matches_jax(kernels, tile_world, tmp_path):
    """From one checkpoint at dropout 0: the same steps, the same final
    training loss and validation trajectory (1e-5). A kernels-on
    config trains through the plain route in the port."""
    jrec, prec, jn, pn = tile_world
    jcfg, pcfg = _configs(dropout=0.0)
    _, d = _checkpoint(tmp_path, jcfg)
    vkw = dict(kernels_per_batch=2, configs_per_kernel=4,
               max_nodes=MAX_NODES, seed=11)
    kw = dict(warm_start_dir=d, steps=6, lr=1e-3, warmup_steps=2, seed=3,
              kernels_per_batch=2, configs_per_kernel=4, eval_every=3,
              val_batches=3)
    jft = jax_fine_tune(jrec, jn, jcfg,
                        val_sampler=JaxTileSampler(jrec, jn, **vkw), **kw)
    pft = fine_tune(prec, pn, dataclasses.replace(
        pcfg, use_pallas_aggregate=kernels),
        val_sampler=TileBatchSampler(prec, pn, **vkw), device="cpu", **kw)
    assert (pft.steps, pft.from_step) == (jft.steps, jft.from_step) == (6, 7)
    np.testing.assert_allclose(pft.final_train_loss, jft.final_train_loss,
                               rtol=1e-5)
    assert [s for s, _ in pft.val_history] == [3, 6]
    np.testing.assert_allclose([v for _, v in pft.val_history],
                               [v for _, v in jft.val_history], rtol=1e-5)
    assert isinstance(pft.params, PM.CostModel)


# ------------------------------------------------------ run_flywheel
def _det(kernel, salt: str) -> float:
    """A deterministic number in [0, 1) from the kernel's content hash
    (the same in both packages' copies of the graph IR)."""
    h = kernel.canonical_hash()
    return int(h[:8] if salt == "mean" else h[8:16], 16) / 2 ** 32


def _fixed_acquisition(base):
    """`base` (either package's AcquisitionEstimator) with its MC head
    replaced by a deterministic (mean, std) per candidate."""
    class Fixed(base):
        def __init__(self, params, model_cfg, normalizer, *, samples=8,
                     seed=0, **kw):
            super(base, self).__init__()
            self.seed = seed

        def group_variance(self, groups):
            return ([np.array([_det(k, "mean") for k in g]) for g in groups],
                    [np.array([0.05 * (1 + self.seed) * _det(k, "std")
                               for k in g]) for g in groups])
    return Fixed


def test_run_flywheel_matches_jax_round_for_round(tmp_path, monkeypatch):
    """The same deterministic acquisition in both packages, training at
    dropout 0: the same evals, acquisitions and delta shards per round
    (equal manifest hashes), the same regrets (1e-5)."""
    monkeypatch.setattr(JLoop, "AcquisitionEstimator",
                        _fixed_acquisition(JA.AcquisitionEstimator))
    monkeypatch.setattr(PLoop, "AcquisitionEstimator",
                        _fixed_acquisition(AcquisitionEstimator))
    from repro.data.fusion import apply_fusion as japply, \
        default_fusion as jdefault
    from repro_torch.data.fusion import apply_fusion, default_fusion
    jk = [k for p in jax_corpus(4, seed=0) for k in japply(p, jdefault(p))]
    pk = [k for p in generate_corpus(4, seed=0)
          for k in apply_fusion(p, default_fusion(p))]
    kw = dict(max_configs_per_kernel=6, max_kernel_nodes=MAX_NODES, seed=0)
    jrec = jax_tile_records(jk, JaxSimulator(), **kw)
    prec = build_tile_records(pk, TPUSimulator(), **kw)
    js, ps = str(tmp_path / "js"), str(tmp_path / "ps")
    JS.write_corpus(js, "tile", jrec, dedup=True)
    PS.write_corpus(ps, "tile", prec, dedup=True)
    jn = jax_fit_tile(list(JS.StreamingCorpus.open(js)))
    pn = fit_tile_normalizer(list(PS.StreamingCorpus.open(ps)))
    jcfg, pcfg = _configs(dropout=0.0)
    params = JM.cost_model_init(jax.random.key(8), jcfg)
    model = from_jax_params(_numpy_tree(params), pcfg, device="cpu")
    fkw = dict(rounds=2, budget_evals=7, finetune_steps=4, warmup_steps=2,
               mc_samples=2, kernels_per_batch=2, configs_per_kernel=4,
               max_configs=8, seed=0)
    targets = {"jax": [jax_random_kernel(10, seed=500 + i, program=f"t{i}")
                       for i in range(3)],
               "port": [random_kernel(10, seed=500 + i, program=f"t{i}")
                        for i in range(3)]}
    jres = jax_run_flywheel(JaxSimulator(), js, targets["jax"], params,
                            jcfg, jn, JaxFlywheelConfig(**fkw),
                            ckpt_dir=str(tmp_path / "jck"))
    pres = run_flywheel(TPUSimulator(), ps, targets["port"], model, pcfg,
                        pn, FlywheelConfig(**fkw),
                        ckpt_dir=str(tmp_path / "pck"))
    assert pres.evals_charged == jres.evals_charged == 7
    assert pres.measured == jres.measured
    assert [[np.asarray(t).tolist() for t in pres.truth]] == \
        [[np.asarray(t).tolist() for t in jres.truth]]
    for pr, jr in zip(pres.rounds, jres.rounds, strict=True):
        assert (pr.round, pr.measured, pr.delta_records, pr.acquired) == \
            (jr.round, jr.measured, jr.delta_records, jr.acquired)
        assert abs(pr.regret - jr.regret) <= 1e-5
        np.testing.assert_allclose(pr.train_loss, jr.train_loss, rtol=1e-4)
    assert abs(pres.regret0 - jres.regret0) <= 1e-5
    assert [m["manifest_hash"] for m in PS.load_delta_manifests(ps)] == \
        [m["manifest_hash"] for m in JS.load_delta_manifests(js)]
    assert PS.StreamingCorpus.open(ps).with_deltas().chain_hash == \
        JS.StreamingCorpus.open(js).with_deltas().chain_hash


def test_flywheel_gates_at_the_bench_constants_on_the_cpu(tmp_path):
    """`chip_smoke.py`'s flywheel scenario (bench_flywheel.py's constants,
    nothing cut) on the CPU: the flywheel beats the static plan at equal
    budget, and the delta chain equals a from-scratch rebuild."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(ROOT)
    work = str(tmp_path)
    world = cs.flywheel_world(work)
    model = cs.flywheel_static(world, "cpu", os.path.join(work, "static"))
    cfg = cs.flywheel_model_cfg(True)
    hard = cs.flywheel_hard_set(world, model, cfg)
    loop = cs.flywheel_loop(world, model, cfg, hard, work)
    assert loop["res"].evals_charged == cs.FW_PER_KERNEL * cs.FW_TARGETS
    assert loop["parity"]
    assert loop["margin"] > 0


# ----------------------------------------------------------------- CLIs
def _train_cli(*argv):
    from repro_torch.launch.train import main
    main(["cost-model", "--device", "cpu", *argv])


@pytest.fixture
def delta_store(tmp_path):
    d = str(tmp_path / "store")
    _store_with_deltas(PS, "port", d)
    return d


def test_cli_trains_from_store_and_deltas_like_the_jax_cli(
        delta_store, tmp_path, capsys, monkeypatch):
    base, warm = str(tmp_path / "base"), str(tmp_path / "warm")
    _train_cli("--from-store", delta_store, "--steps", "2", "--ckpt-dir",
               base, "--hidden", "16")
    first = capsys.readouterr().out
    _train_cli("--from-store", delta_store, "--deltas", "--warm-start", base,
               "--steps", "2", "--ckpt-dir", warm, "--hidden", "16")
    port = capsys.readouterr().out
    chain = PS.StreamingCorpus.open(delta_store).with_deltas().chain_hash
    assert f"chained 2 delta shard set(s) (chain {chain[:12]}" in port
    assert "warm-started from" in port and "done: step=2" in port
    from repro.launch.train import main as jax_main
    monkeypatch.setattr(sys, "argv", [
        "train.py", "cost-model", "--from-store", delta_store, "--deltas",
        "--steps", "1", "--ckpt-dir", str(tmp_path / "jax"), "--hidden",
        "16"])
    jax_main()
    jax_out = capsys.readouterr().out
    for out in (first, port):
        assert "streaming" in out
    # the same stream: chain line and record counts as the JAX CLI's
    pick = [line for line in port.splitlines()
            if line.startswith(("chained", "streaming"))]
    assert pick == [line for line in jax_out.splitlines()
                    if line.startswith(("chained", "streaming"))]


@pytest.mark.parametrize("argv,match", [
    (["--deltas"], "--deltas only applies"),
    (["--task", "fusion", "--from-store", "STORE"], "needs 'fusion'"),
    (["--warm-start", "CK", "--ckpt-dir", "CK"], "DIFFERENT")])
def test_cli_refuses_as_the_reference(argv, match, delta_store, tmp_path):
    from repro_torch.training.checkpoint import save_checkpoint
    ck = str(tmp_path / "ck")
    save_checkpoint(ck, 3, {"params": {"w": np.zeros(2, np.float32)}})
    argv = [{"STORE": delta_store, "CK": ck}.get(a, a) for a in argv]
    with pytest.raises(SystemExit, match=match):
        _train_cli(*argv)


def test_build_corpus_hash_is_independent_of_workers_and_package(tmp_path):
    """1 worker, 2 spawned workers and the CLI (2 workers, forked in a
    fresh process) build the same stores as the JAX package's builder."""
    kw = dict(kinds=("tile", "fusion"), programs=4, seed=1,
              shard_records=16, quiet=True,
              tile_opts={"max_configs_per_kernel": 6},
              fusion_opts={"configs_per_program": 4})
    one = PBC.build_corpus(str(tmp_path / "w1"), workers=1, **kw)
    two = PBC.build_corpus(str(tmp_path / "w2"), workers=2,
                           mp_context="spawn", **kw)
    ref = JBC.build_corpus(str(tmp_path / "jax"), workers=1, **kw)
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.build_corpus", "--out",
         str(tmp_path / "cli"), "--programs", "4", "--seed", "1",
         "--shard-records", "16", "--tile-configs", "6", "--fusion-configs",
         "4", "--workers", "2"], env=_env(), capture_output=True,
        text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    for kind in ("tile", "fusion"):
        h = ref[kind]["manifest_hash"]
        assert one[kind]["manifest_hash"] == two[kind]["manifest_hash"] == h
        assert f"{kind}: " in res.stdout and f"manifest_hash={h}" in \
            res.stdout
    # an unchanged spec is a no-op
    again = PBC.build_corpus(str(tmp_path / "w1"), workers=1, **kw)
    assert again["tile"]["manifest_hash"] == one["tile"]["manifest_hash"]


def test_build_corpus_refuses_import_archs(tmp_path, capsys):
    """`--import-archs` works now (the importer is ported): the imported
    program's records join the synthetic ones, deterministically (the
    same manifest hash from a second build)."""
    argv = ["--programs", "1", "--import-archs", "yi-9b", "--device", "cpu",
            "--workers", "1", "--kind", "fusion", "--fusion-configs", "2"]
    PBC.main(["--out", str(tmp_path / "x")] + argv)
    PBC.main(["--out", str(tmp_path / "y")] + argv)
    one = PBC.load_manifest(str(tmp_path / "x" / "fusion"))
    two = PBC.load_manifest(str(tmp_path / "y" / "fusion"))
    assert one["spec"]["import_archs"] == ["yi-9b"]
    assert one["manifest_hash"] == two["manifest_hash"]
    programs = {r.program for r in PBC.StreamingCorpus.open(
        str(tmp_path / "x" / "fusion"))}
    assert "arch_yi-9b" in programs and len(programs) == 2


def test_pick_context_forks_only_before_cuda(monkeypatch):
    if "fork" not in __import__("multiprocessing").get_all_start_methods():
        pytest.skip("no fork on this platform")
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    assert PBC._pick_context("auto") == "fork"
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert PBC._pick_context("auto") == "spawn"
    assert PBC._pick_context("fork") == "fork"


def test_flywheel_cli_on_the_cpu_twice(tmp_path, capsys):
    """`launch.flywheel --device cpu` at a tiny size: the first run builds
    the store (the JAX package's records and hash) and appends deltas;
    the second, at another seed, appends more to the same chain."""
    from repro_torch.launch.flywheel import main
    store = str(tmp_path / "store")
    flags = ["--store", store, "--ckpt-dir", str(tmp_path / "ck"),
             "--rounds", "2", "--budget-evals", "6", "--programs", "3",
             "--targets", "2", "--max-configs", "8", "--static-steps",
             "6", "--finetune-steps", "3", "--mc-samples", "2", "--hidden",
             "16", "--device", "cpu"]
    main(flags)
    out1 = capsys.readouterr().out
    from repro.data.fusion import apply_fusion, default_fusion
    kernels = [k for p in jax_corpus(3, seed=0)
               for k in apply_fusion(p, default_fusion(p))]
    ref = JS.write_corpus(str(tmp_path / "jax"), "tile",
                          jax_tile_records(kernels, JaxSimulator(), seed=0))
    assert PS.load_manifest(store)["manifest_hash"] == ref["manifest_hash"]
    n1 = len(PS.load_delta_manifests(store))
    main(flags + ["--seed", "1", "--kernels"])
    out2 = capsys.readouterr().out
    assert "scoring kernels off" in out1 and "scoring kernels on" in out2
    assert "built store" in out1 and "built store" not in out2
    assert "round 1:" in out1 and "round 1:" in out2
    chained = PS.StreamingCorpus.open(store).with_deltas()
    assert 1 <= n1 < chained.num_deltas
    assert f"chain {chained.chain_hash}" in out2


def test_flywheel_cli_needs_the_card_by_default(tmp_path):
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.flywheel", "--store",
         str(tmp_path / "s"), "--ckpt-dir", str(tmp_path / "c")],
        env=_env(), capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert not os.path.exists(tmp_path / "s")

"""The port's copies of the training data modules against the reference.

`data/corpus.py`, `data/fusion_dataset.py`, `data/sampler.py` and the
dataset builders of `data/tile_dataset.py` are jax-free modules copied
into `repro_torch` with their imports rewritten: from the same seeds
they must build the same records, fit the same normalizer statistics
and draw byte-identical batches. `whole_model_records` (which needed
the fusion dataset) now runs and matches too.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.features import fit_normalizer as jax_fit_normalizer
from repro.core.simulator import TPUSimulator as JaxSimulator
from repro.data import corpus as JCorpus
from repro.data import fusion_dataset as JFD
from repro.data import sampler as JS
from repro.data import tile_dataset as JTD
from repro.data.synthetic import generate_corpus as jax_corpus
from repro.data.synthetic import whole_model_records as jax_whole
from repro_torch.core.features import fit_normalizer
from repro_torch.core.simulator import TPUSimulator
from repro_torch.data import corpus as PCorpus
from repro_torch.data import fusion_dataset as PFD
from repro_torch.data import sampler as PS
from repro_torch.data import tile_dataset as PTD
from repro_torch.data.synthetic import generate_corpus, whole_model_records


def _graph_key(g):
    return (g.name, g.program, g.tile_size,
            tuple((n.op.name, n.shape, n.dtype_bytes, n.inputs, n.is_output,
                   n.contract_dim, n.filter_size, n.reduced_dims)
                  for n in g.nodes))


@pytest.fixture(scope="module")
def programs():
    return jax_corpus(5, seed=2), generate_corpus(5, seed=2)


@pytest.fixture(scope="module")
def tile_datasets(programs):
    kw = dict(max_configs_per_kernel=8, max_kernel_nodes=40)
    return (JTD.build_tile_dataset(programs[0], JaxSimulator(), **kw),
            PTD.build_tile_dataset(programs[1], TPUSimulator(), **kw))


@pytest.fixture(scope="module")
def fusion_datasets(programs):
    kw = dict(configs_per_program=5, max_kernel_nodes=40)
    return (JFD.build_fusion_dataset(programs[0], JaxSimulator(), **kw),
            PFD.build_fusion_dataset(programs[1], TPUSimulator(), **kw))


def _same_tile_records(jr, pr):
    assert len(jr) == len(pr) > 0
    for a, b in zip(jr, pr):
        assert _graph_key(a.kernel) == _graph_key(b.kernel)
        assert a.tiles == b.tiles
        assert (a.program, a.kernel_id) == (b.program, b.kernel_id)
        np.testing.assert_array_equal(a.runtimes, b.runtimes)


def test_tile_dataset_matches(tile_datasets):
    jd, pd = tile_datasets
    _same_tile_records(jd.records, pd.records)
    assert jd.num_samples == pd.num_samples
    assert jd.programs() == pd.programs()
    assert {k: len(v) for k, v in jd.by_program().items()} == \
        {k: len(v) for k, v in pd.by_program().items()}


def test_tile_records_builder_matches(programs):
    from repro.data.fusion import apply_fusion as japply, \
        default_fusion as jdefault
    from repro_torch.data.fusion import apply_fusion, default_fusion
    jk = [k for p in programs[0] for k in japply(p, jdefault(p))]
    pk = [k for p in programs[1] for k in apply_fusion(p, default_fusion(p))]
    kw = dict(max_configs_per_kernel=6, max_kernel_nodes=40, seed=3)
    _same_tile_records(JTD.build_tile_records(jk, JaxSimulator(), **kw),
                       PTD.build_tile_records(pk, TPUSimulator(), **kw))


def test_fusion_dataset_matches(fusion_datasets):
    jd, pd = fusion_datasets
    assert len(jd.records) == len(pd.records) > 0
    for a, b in zip(jd.records, pd.records):
        assert _graph_key(a.kernel) == _graph_key(b.kernel)
        assert (a.runtime, a.program) == (b.runtime, b.program)
    assert jd.programs() == pd.programs()


def test_fusion_records_builder_matches(programs):
    for jp, pp in zip(programs[0][:2], programs[1][:2]):
        jr = JFD.build_fusion_records(jp, JaxSimulator(),
                                      configs_per_program=4, seed=5)
        pr = PFD.build_fusion_records(pp, TPUSimulator(),
                                      configs_per_program=4, seed=5)
        assert [(_graph_key(r.kernel), r.runtime) for r in jr] == \
            [(_graph_key(r.kernel), r.runtime) for r in pr]


def test_tile_normalizer_matches(tile_datasets):
    jn = JTD.fit_tile_normalizer(tile_datasets[0].records)
    pn = PTD.fit_tile_normalizer(tile_datasets[1].records)
    for f in dataclasses.fields(jn):
        np.testing.assert_array_equal(getattr(jn, f.name),
                                      getattr(pn, f.name))


def test_corpus_hashes_and_splits_match(tile_datasets, programs):
    for a, b in zip(tile_datasets[0].records, tile_datasets[1].records):
        assert JCorpus.kernel_hash(a.kernel) == PCorpus.kernel_hash(b.kernel)
    names = [p.program for p in programs[0]] + ["convdraw_0", "norm_1"]
    for method in ("random", "manual"):
        assert JCorpus.split_programs(names, method=method, seed=4) == \
            PCorpus.split_programs(names, method=method, seed=4)
    split = PCorpus.split_programs(names, seed=4)
    assert [r.program for r in PCorpus.filter_by_programs(
        tile_datasets[1].records, split["train"])] == \
        [r.program for r in JCorpus.filter_by_programs(
            tile_datasets[0].records, split["train"])]


def _assert_same_batch(a, b):
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(x):
            _assert_same_batch(x, y)
        else:
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape, f.name
            assert x.tobytes() == y.tobytes(), f.name


def _tile_samplers(tile_datasets, **kw):
    jr, pr = tile_datasets[0].records, tile_datasets[1].records
    return (JS.TileBatchSampler(jr, JTD.fit_tile_normalizer(jr), **kw),
            PS.TileBatchSampler(pr, PTD.fit_tile_normalizer(pr), **kw))


def _fusion_samplers(fusion_datasets, **kw):
    jr, pr = fusion_datasets[0].records, fusion_datasets[1].records
    return (JS.BalancedSampler(jr, jax_fit_normalizer(
                [r.kernel for r in jr]), **kw),
            PS.BalancedSampler(pr, fit_normalizer([r.kernel for r in pr]),
                               **kw))


@pytest.mark.parametrize("kind", ["tile", "fusion"])
@pytest.mark.parametrize("adjacency", ["dense", "sparse", "segmented"])
@pytest.mark.parametrize("hosts", [(0, 1), (1, 2)],
                         ids=["one-host", "host-1-of-2"])
def test_sampler_batches_are_byte_identical(kind, adjacency, hosts,
                                            tile_datasets, fusion_datasets):
    host_id, num_hosts = hosts
    kw = dict(max_nodes=32, adjacency=adjacency, seed=1, host_id=host_id,
              num_hosts=num_hosts)
    if kind == "tile":
        js, ps = _tile_samplers(tile_datasets, kernels_per_batch=3,
                                configs_per_kernel=4, **kw)
    else:
        js, ps = _fusion_samplers(fusion_datasets, batch_size=6, **kw)
    assert js.batch_size == ps.batch_size
    for step in (0, 1, 7):
        _assert_same_batch(js.batch(step), ps.batch(step))


@pytest.mark.parametrize("adjacency", ["dense", "sparse"])
def test_global_batch_sampler_matches(adjacency, tile_datasets):
    js, ps = _tile_samplers(tile_datasets, kernels_per_batch=2,
                            configs_per_kernel=3, max_nodes=32,
                            adjacency=adjacency)
    jg, pg = JS.GlobalBatchSampler.for_mesh(js, 2), \
        PS.GlobalBatchSampler.for_mesh(ps, 2)
    assert jg.num_shards == pg.num_shards == 2
    for step in (0, 3):
        _assert_same_batch(jg.batch(step), pg.batch(step))


def test_shard_planner_and_shards_match():
    for slow in (frozenset(), frozenset({1}), frozenset({0, 2})):
        assert JS.ShardPlanner(4).plan(5, slow) == \
            PS.ShardPlanner(4).plan(5, slow)
    recs = list(range(10))
    assert [PS.shard_records(recs, i, 3) for i in range(3)] == \
        [JS.shard_records(recs, i, 3) for i in range(3)]
    with pytest.raises(ValueError):
        PS.shard_records(recs, 3, 3)


def test_whole_model_records_run_and_match():
    jr = jax_whole(2, 400, seed=3)
    pr = whole_model_records(2, 400, seed=3)
    assert [type(r).__name__ for r in pr] == ["FusionKernelRecord"] * 2
    assert [(_graph_key(a.kernel), a.runtime, a.program) for a in jr] == \
        [(_graph_key(b.kernel), b.runtime, b.program) for b in pr]
    assert all(r.kernel.num_nodes >= 300 for r in pr)

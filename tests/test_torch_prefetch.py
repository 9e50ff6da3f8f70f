"""The port's input pipeline (`repro_torch.data.prefetch`), on the CPU.

The reference's guarantees, held on the port's `Prefetcher`: the stream
is byte-identical to synchronous `sampler.batch(step)` (and to the JAX
package's prefetcher over its own copy of the sampler), a seek restarts
the worker deterministically, `close()` is prompt and idempotent, a
worker error is raised at the consumer, and the trainer with `prefetch`
on runs the same steps as with it off. With `device="cpu"` the graph
arrays arrive as tensors. The card's side-stream copies are in
`tests/test_torch_cuda.py`.
"""
import dataclasses
import doctest
import gc
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core.simulator import TPUSimulator as JaxSimulator
from repro.data.prefetch import Prefetcher as JaxPrefetcher
from repro.data.sampler import TileBatchSampler as JaxTileSampler
from repro.data.synthetic import random_kernel as jax_random_kernel
from repro.data.tile_dataset import build_tile_dataset as jax_tile_ds
from repro.data.tile_dataset import fit_tile_normalizer as jax_fit_tile
from repro_torch.core.model import CostModelConfig
from repro_torch.core.simulator import TPUSimulator
from repro_torch.data import prefetch as P
from repro_torch.data.prefetch import Prefetcher
from repro_torch.data.sampler import BalancedSampler, TileBatchSampler
from repro_torch.data.synthetic import random_kernel
from repro_torch.data.tile_dataset import build_tile_dataset, \
    fit_tile_normalizer
from repro_torch.training.optim import tree_leaves
from repro_torch.training.trainer import CostModelTrainer, TrainerConfig

SIZES = (6, 11, 19, 27, 34)


@pytest.fixture(scope="module")
def tile_world():
    ds = build_tile_dataset([], TPUSimulator(),
                            extra_kernels=[random_kernel(n, seed=n)
                                           for n in SIZES],
                            max_configs_per_kernel=6)
    assert ds.records, "tile dataset empty"
    return ds.records, fit_tile_normalizer(ds.records)


class _ScriptedSampler:
    """Deterministic toy sampler; optionally raises at one step."""

    def __init__(self, fail_at=None):
        self.fail_at = fail_at
        self.calls = []

    def batch(self, step):
        self.calls.append(step)
        if step == self.fail_at:
            raise RuntimeError(f"boom at {step}")
        return {"step": step, "payload": np.full((3,), step)}


def _leaves(batch):
    return [np.asarray(x) for x in dataclasses.astuple(batch.graphs)]


def assert_batches_identical(a, b):
    assert type(a).__name__ == type(b).__name__
    assert np.array_equal(a.targets, b.targets)
    assert np.array_equal(a.valid, b.valid)
    if hasattr(a, "group_ids"):
        assert np.array_equal(a.group_ids, b.group_ids)
    for fa, fb in zip(_leaves(a), _leaves(b)):
        assert fa.dtype == fb.dtype and np.array_equal(fa, fb)


def test_module_doctests():
    res = doctest.testmod(P, verbose=False)
    assert res.attempted > 0 and res.failed == 0


def test_prefetcher_sequential_stream():
    with Prefetcher(_ScriptedSampler(), depth=2) as p:
        for s in range(5):
            assert p.batch(s)["step"] == s


@pytest.mark.parametrize("adjacency", ["dense", "sparse"])
def test_prefetcher_matches_sync_sampler(adjacency, tile_world):
    records, norm = tile_world
    kw = dict(max_nodes=40, seed=2, adjacency=adjacency)
    sync = TileBatchSampler(records, norm, **kw)
    with Prefetcher(TileBatchSampler(records, norm, **kw), depth=3) as pre:
        for s in range(4):
            assert_batches_identical(sync.batch(s), pre.batch(s))


def test_prefetcher_matches_sync_fusion_sampler(tile_world):
    records, norm = tile_world
    recs = [type("R", (), {"kernel": r.kernel, "runtime": float(i + 1),
                           "program": r.program})()
            for i, r in enumerate(records)]
    kw = dict(batch_size=6, max_nodes=40, seed=3)
    sync = BalancedSampler(recs, norm, **kw)
    with Prefetcher(BalancedSampler(recs, norm, **kw), depth=2) as pre:
        for s in range(3):
            assert_batches_identical(sync.batch(s), pre.batch(s))


def test_prefetcher_stream_equals_the_jax_prefetchers(tile_world):
    """The port's prefetcher over its sampler delivers the JAX package's
    prefetched stream byte for byte (the same records from each
    package's builder)."""
    records, norm = tile_world
    jds = jax_tile_ds([], JaxSimulator(),
                      extra_kernels=[jax_random_kernel(n, seed=n)
                                     for n in SIZES],
                      max_configs_per_kernel=6)
    with JaxPrefetcher(JaxTileSampler(jds.records, jax_fit_tile(jds.records),
                                      max_nodes=40, seed=5),
                       depth=2) as jp, \
            Prefetcher(TileBatchSampler(records, norm, max_nodes=40, seed=5),
                       depth=2) as pp:
        for s in range(4):
            assert_batches_identical(jp.batch(s), pp.batch(s))


def test_prefetcher_restart_and_seek(tile_world):
    records, norm = tile_world
    sync = TileBatchSampler(records, norm, max_nodes=40, seed=4)
    # simulated preempt-and-restart: a fresh prefetcher starting mid-stream
    with Prefetcher(TileBatchSampler(records, norm, max_nodes=40, seed=4),
                    depth=2, start_step=5) as pre:
        assert_batches_identical(sync.batch(5), pre.batch(5))
        assert_batches_identical(sync.batch(6), pre.batch(6))
        # seek backwards (non-sequential access) restarts deterministically
        assert_batches_identical(sync.batch(0), pre.batch(0))
        assert_batches_identical(sync.batch(1), pre.batch(1))


def test_prefetcher_raises_worker_errors_at_the_consumer():
    p = Prefetcher(_ScriptedSampler(fail_at=2), depth=2)
    assert p.batch(0)["step"] == 0
    assert p.batch(1)["step"] == 1
    with pytest.raises(RuntimeError, match="boom at 2"):
        p.batch(2)
    assert p._state["thread"] is None          # the worker is gone
    # recovers: the next request restarts a worker
    assert p.batch(0)["step"] == 0
    p.close()


def test_prefetcher_close_unblocks_full_queue_and_is_idempotent():
    p = Prefetcher(_ScriptedSampler(), depth=1)
    p.batch(0)
    deadline = time.time() + 5.0          # let the worker fill the queue
    while p._state["queue"] is not None and p._state["queue"].empty() \
            and time.time() < deadline:
        time.sleep(0.01)
    thread = p._state["thread"]
    p.close()
    p.close()                             # idempotent
    assert p._state["thread"] is None     # state fully torn down
    assert not thread.is_alive()


def test_prefetcher_runs_ahead_of_consumer():
    s = _ScriptedSampler()
    with Prefetcher(s, depth=3) as p:
        p.batch(0)
        deadline = time.time() + 5.0
        while len(s.calls) < 4 and time.time() < deadline:
            time.sleep(0.01)
    # after serving step 0, the worker had encoded ahead (steps 1..3+)
    assert len(s.calls) >= 4


def test_prefetcher_is_stopped_when_collected():
    p = Prefetcher(_ScriptedSampler(), depth=1)
    p.batch(0)
    thread = p._state["thread"]
    del p
    gc.collect()
    thread.join(timeout=5.0)
    assert not thread.is_alive()


def test_prefetcher_rejects_depth_below_one():
    with pytest.raises(ValueError, match="depth"):
        Prefetcher(_ScriptedSampler(), depth=0)


@pytest.mark.parametrize("adjacency", ["dense", "sparse"])
def test_prefetcher_device_cpu_delivers_tensors(adjacency, tile_world):
    """With `device=`, the graph arrays arrive as tensors on it (on the
    CPU: no copy), byte-equal to the arrays; targets stay numpy."""
    records, norm = tile_world
    kw = dict(max_nodes=40, seed=6, adjacency=adjacency)
    sync = TileBatchSampler(records, norm, **kw)
    with Prefetcher(TileBatchSampler(records, norm, **kw), depth=2,
                    device="cpu") as pre:
        for s in range(3):
            got, want = pre.batch(s), sync.batch(s)
            assert isinstance(got.targets, np.ndarray)
            for t, a in zip(dataclasses.astuple(got.graphs), _leaves(want)):
                assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
                assert np.array_equal(t.numpy(), a)
            assert_batches_identical(got, want)


TINY = dict(hidden_dim=16, opcode_embed_dim=8, gnn_layers=2,
            node_final_layers=2, max_nodes=40, dropout=0.1)


@pytest.mark.parametrize("adjacency,device_put", [
    ("dense", False), ("dense", True), ("sparse", True)])
def test_trainer_prefetch_equals_no_prefetch_step_for_step(
        adjacency, device_put, tile_world):
    """prefetch=2 runs the same steps as prefetch=0: every step's loss and
    the final parameters bit for bit (dropout on, one thread)."""
    records, norm = tile_world
    runs = []
    for depth in (0, 2):
        tr = CostModelTrainer(
            CostModelConfig(adjacency=adjacency, **TINY),
            TrainerConfig(task="tile", ckpt_every=0, log_every=1,
                          prefetch=depth,
                          prefetch_device_put=device_put and depth > 0),
            TileBatchSampler(records, norm, kernels_per_batch=2,
                             configs_per_kernel=4, max_nodes=40,
                             adjacency=adjacency), device="cpu")
        losses = [tr.run(s, resume=False)["loss"] for s in range(1, 6)]
        losses.append(tr.run(12, resume=False)["loss"])   # one long run
        runs.append((losses, tree_leaves(tr.params)))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_trainer_closes_its_prefetcher(tile_world, monkeypatch):
    records, norm = tile_world
    made = []

    class Spy(Prefetcher):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)
    tr = CostModelTrainer(
        CostModelConfig(**TINY),
        TrainerConfig(task="tile", ckpt_every=0, log_every=1, prefetch=2),
        TileBatchSampler(records, norm, kernels_per_batch=2,
                         configs_per_kernel=4, max_nodes=40), device="cpu")
    monkeypatch.setattr(P, "Prefetcher", Spy)
    tr.run(3, resume=False)
    assert len(made) == 1 and made[0]._state["thread"] is None

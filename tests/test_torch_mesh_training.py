"""The port's data-parallel cost-model training, against the JAX package.

`CostModelTrainer(dp >= 1)` runs one rank a process over torch.distributed
(gloo on the CPU here), against the reference's mesh step
(tests/test_mesh_training.py) on a 2-device host mesh, which runs in a
subprocess with XLA_FLAGS=--xla_force_host_platform_device_count=2 (the
device count of JAX is fixed at its import). The records, sampler and
model are that file's; parity runs at dropout 0 (`jax.random` and torch
draw different masks), the dp=1 vs dp=0 identity at the default dropout.
The port's ranks run through `repro_torch.sharding.spawn_ranks`, with the
rank functions of tests/_torch_dist_workers.py; the single-rank groups
of the dp=1 tests are made in this process over a `file://` store.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch.distributed as dist

from repro.core.model import CostModelConfig as JaxConfig
from repro.data.sampler import TileBatchSampler as JaxTileSampler
from repro.training.trainer import CostModelTrainer as JaxTrainer
from repro.training.trainer import TrainerConfig as JaxTrainerConfig
from repro_torch.core.model import CostModelConfig
from repro_torch.data.sampler import GlobalBatchSampler
from repro_torch.sharding import make_train_mesh, spawn_ranks
from repro_torch.training import checkpoint as PC
from repro_torch.training.optim import tree_leaves
from repro_torch.training.trainer import CostModelTrainer, TrainerConfig
from tests import _torch_dist_workers as W

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CASES = [("sparse", False), ("sparse", True), ("dense", False),
         ("dense", True)]
# after 3 steps the packages' params differ by f32 rounding carried
# through Adam: held to 1e-5 of the tree's largest |param| wherever the
# reference's first moment is above 1e-3 of the tree's largest; below it
# Adam's steps move an entry by ±lr for a gradient of rounding size, in
# either package's sign (the guard of tests/test_torch_training.py), so
# those entries are held to the bound 2·lr a step. With int8 compression
# a gradient that lands within rounding of a code boundary (k + 1/2 code
# steps) may round to either code in the two packages: the reduced
# gradient of that entry then moves by one code step (scale / n), which
# shows in its first moment far above rounding (> 1e-3 relative). Such
# entries are held to the same 2·lr-a-step bound, and must stay rare
# (at most 1e-3 of the entries; one in 3 steps here).
PARAM_RTOL = 1e-5
FLIP_SHARE = 1e-3
LR = 1e-3                       # AdamWConfig().lr, the schedule's ceiling

JAX_MESH = """
import json, os, sys
from repro.core.model import CostModelConfig
from repro.core.simulator import TPUSimulator
from repro.data.sampler import TileBatchSampler
from repro.data.synthetic import random_kernel
from repro.data.tile_dataset import build_tile_records, fit_tile_normalizer
from repro.training.trainer import CostModelTrainer, TrainerConfig

out = sys.argv[1]
kernels = [random_kernel(n, seed=i)
           for i, n in enumerate((10, 14, 18, 12, 16, 20))]
recs = build_tile_records(kernels, TPUSimulator(), max_configs_per_kernel=8)
norm = fit_tile_normalizer(recs)
losses = {}
for adjacency, compress in CASES:
    tag = f"{adjacency}-{int(compress)}"
    mcfg = CostModelConfig(hidden_dim=16, gnn_layers=1,
                           transformer_layers=1, dropout=0.0,
                           adjacency=adjacency)
    tc = TrainerConfig(task="tile", steps=3, log_every=100, seed=0, dp=2,
                       ckpt_every=0, compress_grads=compress,
                       ckpt_dir=os.path.join(out, tag, "init"))
    t = CostModelTrainer(mcfg, tc, TileBatchSampler(
        recs, norm, seed=3, adjacency=adjacency, kernels_per_batch=2,
        configs_per_kernel=4))
    t.save()
    t.cfg.ckpt_dir = os.path.join(out, tag, "final")
    losses[tag] = t.run(resume=False)["loss"]
with open(os.path.join(out, "losses.json"), "w") as f:
    json.dump(losses, f)
"""


def _tag(adjacency, compress):
    return f"{adjacency}-{int(compress)}"


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The reference's dp=2 mesh runs (3 steps) of every case: the
    initial and final checkpoints and the final losses."""
    out = str(tmp_path_factory.mktemp("jax_mesh"))
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    code = f"CASES = {CASES!r}\n" + textwrap.dedent(JAX_MESH)
    res = subprocess.run([sys.executable, "-c", code, out], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    with open(os.path.join(out, "losses.json")) as f:
        return out, json.load(f)


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory, jax_runs):
    """The port's 2-rank runs of every case, from the reference's
    initial params."""
    jout, _ = jax_runs
    runs = {}
    for adjacency, compress in CASES:
        tag = _tag(adjacency, compress)
        out = str(tmp_path_factory.mktemp(f"port_{tag}"))
        spawn_ranks(W.mesh_train, (out, adjacency, 2, 1, compress,
                                   os.path.join(jout, tag, "init")),
                    2, device="cpu")
        runs[tag] = out
    return runs


def _rank_params(out, rank):
    with np.load(os.path.join(out, f"rank{rank}.npz")) as z:
        return [z[f"arr_{i}"] for i in range(len(z.files))]


def _result(out, rank=0):
    with open(os.path.join(out, f"result{rank}.json")) as f:
        return json.load(f)


@pytest.fixture
def single_rank_group(tmp_path):
    """A process group of this process alone (gloo, a file store)."""
    dist.init_process_group("gloo", init_method="file://"
                            + str(tmp_path / "store"), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _leaves(tr):
    return [x.detach().numpy().copy() for x in tree_leaves(tr.params)]


# ------------------------------------------------------------- dp=1
@pytest.mark.timeout(120)
@pytest.mark.parametrize("adjacency,compress,dropout", [
    ("sparse", False, 0.1), ("dense", True, 0.1), ("dense", False, 0.0)])
def test_dp1_bit_identical_to_dp0(adjacency, compress, dropout,
                                  single_rank_group):
    """The reference's gate: dp=1 reproduces the single-device step
    exactly (same loss float, same bytes in every param and moment); at
    dropout 0.1 too, since rank 0 of dp=1 draws the step's generator."""
    runs = []
    for dp in (0, 1):
        tr = W.mesh_trainer(adjacency, dp, compress_grads=compress,
                            model_kw=dict(dropout=dropout))
        res = tr.run(resume=False)
        runs.append((res["loss"], _leaves(tr),
                     [x.numpy().copy() for x in tree_leaves(tr.opt_state)]))
    (l0, p0, o0), (l1, p1, o1) = runs
    assert l0 == l1
    for a, b in zip(p0 + o0, p1 + o1):
        assert a.tobytes() == b.tobytes()


# ------------------------------------------------------------- dp=2
@pytest.mark.timeout(600)
@pytest.mark.parametrize("adjacency,compress", CASES)
def test_dp2_matches_the_jax_mesh_step(adjacency, compress, jax_runs,
                                       port_runs):
    jout, jlosses = jax_runs
    tag = _tag(adjacency, compress)
    port = _rank_params(port_runs[tag], 0)
    # the port reads the JAX package's checkpoints (one format)
    tree, step, _ = PC.read_checkpoint(os.path.join(jout, tag, "final"))
    assert step == 3
    ref = tree_leaves(tree["params"])
    m = tree_leaves(tree["opt"]["m"])
    port_m = tree_leaves(PC.read_checkpoint(
        os.path.join(port_runs[tag], "ckpt"))[0]["opt"]["m"])
    np.testing.assert_allclose(_result(port_runs[tag])["loss"], jlosses[tag],
                               rtol=1e-5)
    mmax = max(float(np.abs(x).max()) for x in m)
    tol = PARAM_RTOL * max(float(np.abs(x).max()) for x in ref)
    flipped = total = 0
    for p, j, mm, pm in zip(port, ref, m, port_m):
        held = np.abs(mm) > 1e-3 * mmax
        if compress:
            flip = np.abs(pm - mm) > 1e-3 * np.abs(mm)
            flipped += int(np.sum(flip & held))
            held &= ~flip
        total += p.size
        assert float(np.abs(p - j)[held].max(initial=0.0)) <= tol
        assert np.all(np.abs(p - j) <= 3 * 2 * LR * (1 + 1e-6))
    assert flipped <= FLIP_SHARE * total


@pytest.mark.timeout(600)
@pytest.mark.parametrize("adjacency,compress", CASES)
def test_dp2_ranks_stay_bit_equal(adjacency, compress, port_runs):
    out = port_runs[_tag(adjacency, compress)]
    for a, b in zip(_rank_params(out, 0), _rank_params(out, 1)):
        assert a.tobytes() == b.tobytes()
    assert [_result(out, r)["data_rank"] for r in (0, 1)] == [0, 1]


@pytest.mark.timeout(600)
def test_dp2_checkpoint_holds_stacked_residuals(port_runs):
    tree, step, _ = PC.read_checkpoint(
        os.path.join(port_runs["sparse-1"], "ckpt"))
    assert step == 3
    ef = tree_leaves(tree["opt"]["ef"])
    params = tree_leaves(tree["params"])
    assert [e.shape for e in ef] == [(2,) + p.shape for p in params]
    assert any(np.any(e[0] != e[1]) for e in ef)    # per-rank residuals
    assert "ef" not in PC.read_checkpoint(
        os.path.join(port_runs["sparse-0"], "ckpt"))[0]["opt"]


@pytest.mark.timeout(600)
def test_ckpt_dp2_restores_dp1_bit_exact(port_runs, single_rank_group,
                                         tmp_path):
    import shutil
    ck = str(tmp_path / "ck")
    shutil.copytree(os.path.join(port_runs["sparse-0"], "ckpt"), ck)
    t1 = W.mesh_trainer("sparse", 1, ckpt_dir=ck)
    assert t1.maybe_resume() and t1.step == 3
    for a, b in zip(_leaves(t1), _rank_params(port_runs["sparse-0"], 0)):
        assert a.tobytes() == b.tobytes()
    assert t1.run(4, resume=True)["step"] == 4       # and it trains on


@pytest.mark.timeout(600)
def test_ckpt_dp2_compress_restore_reinits_ef(port_runs, single_rank_group,
                                              tmp_path):
    import shutil
    ck = str(tmp_path / "ck")
    shutil.copytree(os.path.join(port_runs["sparse-1"], "ckpt"), ck)
    t1 = W.mesh_trainer("sparse", 1, compress_grads=True, ckpt_dir=ck)
    assert t1.maybe_resume() and t1.step == 3
    for a, b in zip(_leaves(t1), _rank_params(port_runs["sparse-1"], 0)):
        assert a.tobytes() == b.tobytes()
    ef = tree_leaves(t1.opt_state["ef"])
    assert [e.shape for e in ef] == [p.shape for p in tree_leaves(t1.params)]
    assert not any(e.any() for e in ef)


@pytest.mark.timeout(600)
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_ckpt_dp2_across_packages(direction, jax_runs, port_runs,
                                  single_rank_group, tmp_path):
    """A dp=2 checkpoint of either package restores bit-exactly in the
    other's trainer (the reference's at dp=0, a single device here; the
    port's at dp=1)."""
    import shutil
    import jax
    jout, _ = jax_runs
    ck = str(tmp_path / "ck")
    if direction == "port_to_jax":
        src = os.path.join(port_runs["dense-1"], "ckpt")
        want = _rank_params(port_runs["dense-1"], 0)
        shutil.copytree(src, ck)
        recs, norm = _jax_tile_data()
        jt = JaxTrainer(
            JaxConfig(adjacency="dense", **W.MESH_MODEL),
            JaxTrainerConfig(task="tile", steps=3, ckpt_every=0, ckpt_dir=ck),
            JaxTileSampler(recs, norm, seed=3, adjacency="dense",
                           kernels_per_batch=2, configs_per_kernel=4))
        assert jt.maybe_resume() and jt.step == 3
        got = [np.asarray(x) for x in jax.tree_util.tree_leaves(jt.params)]
    else:
        src = os.path.join(jout, "dense-1", "final")
        want = tree_leaves(PC.read_checkpoint(src)[0]["params"])
        shutil.copytree(src, ck)
        t1 = W.mesh_trainer("dense", 1, compress_grads=True, ckpt_dir=ck)
        assert t1.maybe_resume() and t1.step == 3
        got = _leaves(t1)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.tobytes() == b.tobytes()


def _jax_tile_data():
    from repro.core.simulator import TPUSimulator
    from repro.data.synthetic import random_kernel
    from repro.data.tile_dataset import build_tile_records, \
        fit_tile_normalizer
    kernels = [random_kernel(n, seed=i)
               for i, n in enumerate((10, 14, 18, 12, 16, 20))]
    recs = build_tile_records(kernels, TPUSimulator(),
                              max_configs_per_kernel=8)
    return recs, fit_tile_normalizer(recs)


# ----------------------------------------------------- dp=2 x mp=2
@pytest.mark.timeout(600)
def test_dp2_mp2_equals_dp2_mp1(port_runs, jax_runs, tmp_path):
    """Four ranks, params replicated over the model axis: every rank ends
    with the bytes of the dp=2 x mp=1 run."""
    jout, _ = jax_runs
    out = str(tmp_path)
    spawn_ranks(W.mesh_train, (out, "sparse", 2, 2, False,
                               os.path.join(jout, "sparse-0", "init")),
                4, device="cpu")
    want = _rank_params(port_runs["sparse-0"], 0)
    places = []
    for r in range(4):
        for a, b in zip(_rank_params(out, r), want):
            assert a.tobytes() == b.tobytes()
        res = _result(out, r)
        places.append((res["data_rank"], res["model_rank"]))
    assert places == [(0, 0), (0, 1), (1, 0), (1, 1)]


# --------------------------------------------------------- stopping
@pytest.mark.timeout(120)
def test_a_stop_on_one_rank_stops_every_rank_after_the_same_step(tmp_path):
    out = str(tmp_path)
    spawn_ranks(W.mesh_train, (out, "dense", 2, 1, False, "", 10, 1, 2), 2,
                device="cpu")
    for r in (0, 1):
        res = _result(out, r)
        assert res["step"] == 3 and res["interrupted"]
    assert PC.list_steps(os.path.join(out, "ckpt")) == [3]


# --------------------------------------------------------- sampler
@pytest.mark.parametrize("adjacency", ["dense", "sparse"])
def test_global_batch_shard_is_the_global_batch_slice(adjacency):
    import dataclasses
    recs, norm = W.tile_data()
    g = GlobalBatchSampler.for_mesh(W.tile_sampler(recs, norm, adjacency),
                                    2)
    for step in (0, 5):
        full = g.batch(step)
        for d in range(2):
            part = g.shard(step, d)
            for f in dataclasses.fields(full):
                a, b = getattr(part, f.name), getattr(full, f.name)
                if dataclasses.is_dataclass(a):
                    for gf in dataclasses.fields(a):
                        x = np.asarray(getattr(a, gf.name))
                        y = np.asarray(getattr(b, gf.name))[d]
                        assert x.dtype == y.dtype
                        np.testing.assert_array_equal(x, y)
                else:
                    np.testing.assert_array_equal(np.asarray(a),
                                                  np.asarray(b)[d])


# -------------------------------------------------------- refusals
REFUSED = [
    (dict(adjacency="segmented"), dict(dp=1), "segmented"),
    ({}, dict(dp=1, data_axis="batch"), "data_axis"),
    (dict(use_pallas_aggregate=True), dict(dp=1), "no backward"),
    (dict(adjacency="sparse"), dict(dp=0, compress_grads=True),
     "compress_grads"),
    ({}, dict(dp=1, mp=0), "mp >= 1"),
]


@pytest.mark.parametrize("model_kw,tc_kw,match", REFUSED)
def test_trainer_refuses(model_kw, tc_kw, match):
    recs, norm = W.tile_data()
    adjacency = model_kw.get("adjacency", "dense")
    mcfg = CostModelConfig(**dict(W.MESH_MODEL, **model_kw))
    sampler = W.tile_sampler(recs, norm, "dense" if adjacency ==
                             "segmented" else adjacency)
    with pytest.raises(ValueError, match=match):
        CostModelTrainer(mcfg, TrainerConfig(task="tile", **tc_kw), sampler,
                         device="cpu")


def test_compress_sparse_error_names_both_flags():
    recs, norm = W.tile_data()
    with pytest.raises(ValueError) as e:
        CostModelTrainer(CostModelConfig(adjacency="sparse",
                                         **W.MESH_MODEL),
                         TrainerConfig(task="tile", compress_grads=True),
                         W.tile_sampler(recs, norm, "sparse"), device="cpu")
    assert "compress_grads" in str(e.value) and "dp" in str(e.value)


def test_trainer_refuses_a_global_sampler_of_another_dp():
    recs, norm = W.tile_data()
    g = GlobalBatchSampler.for_mesh(W.tile_sampler(recs, norm, "sparse"), 2)
    with pytest.raises(ValueError, match="shards"):
        CostModelTrainer(CostModelConfig(adjacency="sparse", **W.MESH_MODEL),
                         TrainerConfig(task="tile", dp=1), g, device="cpu")


def test_make_train_mesh_errors_name_the_fix(single_rank_group):
    with pytest.raises(ValueError, match=">= 1"):
        make_train_mesh(0, device="cpu")
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        make_train_mesh(2, device="cpu")
    mesh = make_train_mesh(1, device="cpu")
    assert (mesh.data_rank, mesh.model_rank, mesh.shape) == (
        0, 0, {"data": 1, "model": 1})


def test_make_train_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="none is initialised"):
        make_train_mesh(1, device="cpu")


# --------------------------------------------------------------- CLI
@pytest.mark.timeout(300)
def test_cli_trains_data_parallel_with_compressed_grads(tmp_path):
    d = str(tmp_path / "ck")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "cost-model",
         "--dp", "2", "--compress-grads", "--steps", "4", "--device", "cpu",
         "--programs", "6", "--ckpt-dir", d, "--log-every", "2",
         "--metrics-path", str(tmp_path / "m.jsonl")],
        env=dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=280)
    assert res.returncode == 0, res.stderr[-4000:]
    lines = res.stdout.splitlines()
    assert lines[0].startswith("data-parallel: dp=2 mp=1, 2 ranks")
    assert "backend gloo" in lines[0] and "devices cpu, cpu" in lines[0]
    assert sum(line.startswith("done: step=4") for line in lines) == 1
    tree, step, _ = PC.read_checkpoint(d)
    assert step == 4
    assert all(e.shape[0] == 2 for e in tree_leaves(tree["opt"]["ef"]))
    with open(tmp_path / "m.jsonl") as f:
        assert [json.loads(x)["step"] for x in f] == [2, 4]


@pytest.mark.timeout(300)
def test_cli_joins_the_ranks_that_torchrun_starts(tmp_path):
    """Under `torchrun` each process joins as its rank (RANK/WORLD_SIZE
    from the environment) instead of spawning; `--standalone` lets the
    OS pick the rendezvous port."""
    d = str(tmp_path / "ck")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "cost-model", "--dp", "2", "--steps", "3", "--device", "cpu",
         "--programs", "6", "--ckpt-dir", d, "--log-every", "3"],
        env=dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=280)
    assert res.returncode == 0, res.stderr[-4000:]
    lines = res.stdout.splitlines()
    assert lines[0] == ("data-parallel: dp=2 mp=1, 2 ranks (torchrun), "
                        "backend gloo, rank 0 on cpu")
    assert sum(line.startswith("done: step=3") for line in lines) == 1
    assert PC.list_steps(d) == [3]

"""Training the cost model in the port, against the JAX package.

On the CPU (`device="cpu"`), with inputs made by numpy from a seed:
the losses and AdamW against `repro`'s, value and gradient; one full
train step of `CostModelTrainer` from the same parameters and batch
(dense, sparse, segmented; tile and fusion task) against the JAX
trainer's; 20-step loss trajectories on byte-identical batch streams;
checkpoints across the two packages in both directions; and the
trainer's own behaviour (resume, warm start, metrics, SIGTERM, rejected
configurations), dropout, the kernels' grad guard and the CLI.

Parity runs at dropout 0: `jax.random` and torch draw different masks.
"""
import json
import os
import shutil
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from repro.core import losses as JL
from repro.core.features import fit_normalizer as jax_fit_normalizer
from repro.core.model import CostModelConfig as JaxConfig
from repro.core.simulator import TPUSimulator as JaxSimulator
from repro.data.fusion_dataset import build_fusion_dataset as jax_fusion_ds
from repro.data.sampler import BalancedSampler as JaxBalanced
from repro.data.sampler import TileBatchSampler as JaxTileSampler
from repro.data.synthetic import generate_corpus as jax_corpus
from repro.data.synthetic import whole_model_records as jax_whole
from repro.data.tile_dataset import build_tile_dataset as jax_tile_ds
from repro.data.tile_dataset import fit_tile_normalizer as jax_fit_tile
from repro.training import checkpoint as JC
from repro.training import optim as JO
from repro.training.trainer import CostModelTrainer as JaxTrainer
from repro.training.trainer import TrainerConfig as JaxTrainerConfig
from repro_torch.core import losses as PL
from repro_torch.core.features import fit_normalizer
from repro_torch.core.model import CostModelConfig, batch_to_device, \
    cost_model_apply, cost_model_init
from repro_torch.core.simulator import TPUSimulator
from repro_torch.data.fusion_dataset import build_fusion_dataset
from repro_torch.data.sampler import BalancedSampler, TileBatchSampler
from repro_torch.data.synthetic import generate_corpus, whole_model_records
from repro_torch.data.tile_dataset import build_tile_dataset, \
    fit_tile_normalizer
from repro_torch.kernels import graph_aggregate as ga
from repro_torch.kernels import segment_aggregate as sa
from repro_torch.nn.core import dropout
from repro_torch.training import checkpoint as PC
from repro_torch.training import optim as PO
from repro_torch.training.trainer import CostModelTrainer, TrainerConfig

MAX_NODES = 24
TINY = dict(hidden_dim=16, opcode_embed_dim=8, gnn_layers=2,
            node_final_layers=2, max_nodes=MAX_NODES, dropout=0.0)
# one step of f32 forward + backward through ~20 ops: the two packages
# round differently, measured at <= 3.4e-6 of the leaf's largest
# gradient; every leaf is held to 1e-5 of the tree's largest gradient
# (a leaf whose true gradient is ~0, e.g. the final layernorm's bias
# under a sum readout, is rounding noise in both)
GRAD_TOL = 1e-5


# ----------------------------------------------------------------- data
@pytest.fixture(scope="module")
def tile_records():
    kw = dict(max_configs_per_kernel=6, max_kernel_nodes=MAX_NODES)
    return (jax_tile_ds(jax_corpus(4, seed=0), JaxSimulator(), **kw).records,
            build_tile_dataset(generate_corpus(4, seed=0), TPUSimulator(),
                               **kw).records)


@pytest.fixture(scope="module")
def fusion_records():
    kw = dict(configs_per_program=4, max_kernel_nodes=MAX_NODES)
    return (jax_fusion_ds(jax_corpus(3, seed=1), JaxSimulator(),
                          **kw).records,
            build_fusion_dataset(generate_corpus(3, seed=1), TPUSimulator(),
                                 **kw).records)


def _samplers(task, adjacency, tile_records, fusion_records):
    if task.startswith("tile"):
        jrec, prec = tile_records
        kw = dict(kernels_per_batch=2, configs_per_kernel=4,
                  max_nodes=MAX_NODES, adjacency=adjacency)
        return (JaxTileSampler(jrec, jax_fit_tile(jrec), **kw),
                TileBatchSampler(prec, fit_tile_normalizer(prec), **kw))
    jrec, prec = fusion_records
    kw = dict(batch_size=8, max_nodes=MAX_NODES, adjacency=adjacency)
    return (JaxBalanced(jrec, jax_fit_normalizer([r.kernel for r in jrec]),
                        **kw),
            BalancedSampler(prec, fit_normalizer([r.kernel for r in prec]),
                            **kw))


def _to_torch_tree(tree):
    return jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)), tree)


def _pair(task, adjacency, samplers, *, jax_tc=None, port_tc=None,
          **cfg_kw):
    """A JAX trainer and a port trainer holding the same parameters."""
    js, ps = samplers
    cfg = dict(TINY, adjacency=adjacency, **cfg_kw)
    jt = JaxTrainer(JaxConfig(**cfg), jax_tc or JaxTrainerConfig(
        task=task, ckpt_every=0, log_every=1), js)
    pt = CostModelTrainer(CostModelConfig(**cfg), port_tc or TrainerConfig(
        task=task, ckpt_every=0, log_every=1), ps, device="cpu")
    pt._load_params(_to_torch_tree(jt.params))
    return jt, pt


def _jax_leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _port_leaves(tree):
    return [x.detach().numpy() for x in PO.tree_leaves(tree)]


def _metrics(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


# --------------------------------------------------------------- losses
RANK_CASES = [("hinge", False, False), ("hinge", True, True),
              ("logistic", False, False), ("logistic", True, False),
              ("logistic", True, True)]


@pytest.mark.parametrize("phi,groups,valid", RANK_CASES)
def test_pairwise_rank_loss_matches_jax(phi, groups, valid):
    rng = np.random.default_rng(7)
    n = 12
    preds = rng.normal(size=n).astype(np.float32)
    targets = rng.random(n).astype(np.float32)
    gids = rng.integers(0, 3, n).astype(np.int32) if groups else None
    val = (rng.random(n) < 0.75).astype(np.float32) if valid else None

    def jloss(p):
        return JL.pairwise_rank_loss(
            p, jnp.asarray(targets), None if gids is None else
            jnp.asarray(gids), None if val is None else jnp.asarray(val),
            phi=phi)
    jl, jg = jax.value_and_grad(jloss)(jnp.asarray(preds))
    tp = torch.tensor(preds, requires_grad=True)
    pl = PL.pairwise_rank_loss(
        tp, torch.from_numpy(targets),
        None if gids is None else torch.from_numpy(gids),
        None if val is None else torch.from_numpy(val), phi=phi)
    pl.backward()
    # the same f32 sums of the same terms: within a few ulps
    np.testing.assert_allclose(pl.item(), float(jl), rtol=1e-6)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-9)


@pytest.mark.parametrize("kind,masked", [("log_mse", False),
                                         ("log_mse", True), ("mse", False),
                                         ("mse", True)])
def test_regression_losses_match_jax(kind, masked):
    rng = np.random.default_rng(3)
    preds = rng.normal(-10, 2, 16).astype(np.float32)
    targets = (10.0 ** rng.uniform(-7, -2, 16)).astype(np.float32)
    val = (rng.random(16) < 0.6).astype(np.float32) if masked else None
    jfn, pfn = ((JL.log_mse_loss, PL.log_mse_loss) if kind == "log_mse"
                else (JL.mse_loss, PL.mse_loss))
    jl, jg = jax.value_and_grad(lambda p: jfn(
        p, jnp.asarray(targets), None if val is None else jnp.asarray(val)))(
        jnp.asarray(preds))
    tp = torch.tensor(preds, requires_grad=True)
    pl = pfn(tp, torch.from_numpy(targets),
             None if val is None else torch.from_numpy(val))
    pl.backward()
    np.testing.assert_allclose(pl.item(), float(jl), rtol=1e-6)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-9)


def test_rank_loss_rejects_unknown_phi():
    with pytest.raises(ValueError, match="unknown rank loss"):
        PL.pairwise_rank_loss(torch.zeros(3), torch.zeros(3), phi="square")


# ---------------------------------------------------------------- AdamW
def _random_tree(rng, scale=1.0):
    return {"b": [rng.normal(0, scale, (4,)).astype(np.float32),
                  rng.normal(0, scale, (2, 3)).astype(np.float32)],
            "a": {"w": rng.normal(0, scale, (5, 3)).astype(np.float32)}}


@pytest.mark.parametrize("schedule", ["constant", "exponential", "cosine"])
@pytest.mark.parametrize("clip", [0.05, 100.0, None],
                         ids=["clip-binds", "clip-idle", "no-clip"])
def test_adamw_updates_match_jax(schedule, clip):
    rng = np.random.default_rng(11)
    kw = dict(lr=0.05, weight_decay=0.01, grad_clip_norm=clip,
              schedule=schedule, lr_decay=0.5, decay_every=2,
              warmup_steps=3, total_steps=6)
    jcfg, pcfg = JO.AdamWConfig(**kw), PO.AdamWConfig(**kw)
    params = _random_tree(rng)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    pp = PO.tree_map(torch.from_numpy, params)
    js, ps = JO.adamw_init(jp), PO.adamw_init(pp)
    for _ in range(5):
        grads = _random_tree(rng, scale=0.5)
        jp, js, jstats = JO.adamw_update(
            jp, jax.tree_util.tree_map(jnp.asarray, grads), js, jcfg)
        pp, ps, pstats = PO.adamw_update(
            pp, PO.tree_map(torch.from_numpy, grads), ps, pcfg)
        # the reference's f32 arithmetic in the same order: the sums of
        # squares in the norm differ by an ulp, which the clip passes on;
        # an entry whose moment terms nearly cancel keeps the rounding of
        # the larger ones, so each leaf is held to 1e-6 of its largest
        for name in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(pstats[name]),
                                       float(jstats[name]), rtol=1e-6)
        assert ps["step"].dtype == torch.int32
        assert int(ps["step"]) == int(js["step"])
        for key in ("m", "v"):
            for a, b in zip(_port_leaves(ps[key]), _jax_leaves(js[key])):
                assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max()
        for a, b in zip(_port_leaves(pp), _jax_leaves(jp)):
            assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max()


def test_adamw_state_mirrors_the_tree():
    params = {"x": torch.ones(2), "y": [torch.ones(3, 1)]}
    st = PO.adamw_init(params)
    assert st["step"].shape == () and st["step"].dtype == torch.int32
    assert st["m"]["y"][0].shape == (3, 1)
    assert PO.tree_leaves({"b": 1, "a": [2, 3]}) == [2, 3, 1]


# ---------------------------------------------------- one train step
def _grads_close(port_grads, jax_grads):
    gmax = max(float(np.abs(g).max()) for g in jax_grads)
    for p, j in zip(port_grads, jax_grads):
        assert p.shape == j.shape
        assert float(np.abs(p - j).max()) <= GRAD_TOL * gmax


@pytest.mark.parametrize("task,adjacency", [
    ("tile", "dense"), ("tile", "sparse"), ("fusion", "dense"),
    ("fusion", "sparse")])
def test_one_train_step_matches_jax(task, adjacency, tile_records,
                                    fusion_records, tmp_path):
    samplers = _samplers(task, adjacency, tile_records, fusion_records)
    jt, pt = _pair(task, adjacency, samplers,
                   jax_tc=JaxTrainerConfig(
                       task=task, ckpt_every=0, log_every=1,
                       metrics_path=str(tmp_path / "jax.jsonl")),
                   port_tc=TrainerConfig(
                       task=task, ckpt_every=0, log_every=1,
                       metrics_path=str(tmp_path / "port.jsonl")))
    js, ps = samplers
    b = js.batch(0)
    gids = getattr(b, "group_ids", np.zeros_like(b.targets, np.int32))
    jloss, jgrads = jax.value_and_grad(jt._loss_fn)(
        jt.params, b.graphs, jnp.asarray(b.targets), jnp.asarray(gids),
        jnp.asarray(b.valid), jt._step_rng(0))
    ploss = pt.loss(ps.batch(0), generator=pt.step_generator(0),
                    training=True)
    pgrads = torch.autograd.grad(ploss, PO.tree_leaves(pt.params))
    np.testing.assert_allclose(ploss.item(), float(jloss), rtol=1e-5)
    jg = _jax_leaves(jgrads)
    _grads_close([g.numpy() for g in pgrads], jg)

    # the full step: AdamW's state and stats, then the parameters
    jt.run(1, resume=False)
    pt.run(1, resume=False)
    (jrec,), (prec,) = _metrics(tmp_path / "jax.jsonl"), \
        _metrics(tmp_path / "port.jsonl")
    np.testing.assert_allclose(prec["loss"], jrec["loss"], rtol=1e-5)
    np.testing.assert_allclose(prec["grad_norm"], jrec["grad_norm"],
                               rtol=1e-5)
    assert prec["lr"] == pytest.approx(jrec["lr"], rel=1e-7)
    assert int(pt.opt_state["step"]) == 1
    for key in ("m", "v"):
        _grads_close(_port_leaves(pt.opt_state[key]),
                     _jax_leaves(jt.opt_state[key]))
    # Adam's first step moves each parameter by lr·g/(|g| + eps): a
    # gradient of rounding size may take either sign (or be 0) in the two
    # packages, so entries with |g| <= 1e-3 of the tree's largest
    # gradient are held only to the step's bound 2·lr (whole leaves are
    # such noise: the final layernorm's bias shifts every node of a
    # kernel alike, and the rank loss compares kernels of one size); the
    # others agree to f32 rounding
    lr = jrec["lr"]
    gmax = max(float(np.abs(g).max()) for g in jg)
    for p, j, g in zip(_port_leaves(pt.params), _jax_leaves(jt.params), jg):
        big = np.abs(g) > 1e-3 * gmax
        np.testing.assert_allclose(p[big], j[big], rtol=1e-6, atol=1e-7)
        assert np.all(np.abs(p - j) <= 2 * lr * (1 + 1e-6))


@pytest.mark.parametrize("task,adjacency,sampler", [
    ("tile", "dense", "TileBatchSampler"),
    ("fusion", "sparse", "BalancedSampler")])
def test_twenty_steps_track_jax(task, adjacency, sampler, tile_records,
                                fusion_records, tmp_path):
    samplers = _samplers(task, adjacency, tile_records, fusion_records)
    assert type(samplers[1]).__name__ == sampler
    jt, pt = _pair(task, adjacency, samplers,
                   jax_tc=JaxTrainerConfig(
                       task=task, ckpt_every=0, log_every=1,
                       metrics_path=str(tmp_path / "jax.jsonl")),
                   port_tc=TrainerConfig(
                       task=task, ckpt_every=0, log_every=1,
                       metrics_path=str(tmp_path / "port.jsonl")))
    jt.run(20, resume=False)
    pt.run(20, resume=False)
    jl = [r["loss"] for r in _metrics(tmp_path / "jax.jsonl")]
    pl = [r["loss"] for r in _metrics(tmp_path / "port.jsonl")]
    assert len(jl) == len(pl) == 20
    # the same batch stream: rounding only (measured at most 3.4e-6)
    np.testing.assert_allclose(pl, jl, rtol=1e-3)


@pytest.mark.parametrize("reduction", ["transformer", "column_wise"])
def test_one_segmented_step_matches_jax(reduction):
    jrec, prec = jax_whole(1, 300, seed=0), whole_model_records(1, 300,
                                                                 seed=0)
    kw = dict(batch_size=2, max_nodes=64, adjacency="segmented")
    js = JaxBalanced(jrec, jax_fit_normalizer([r.kernel for r in jrec]), **kw)
    ps = BalancedSampler(prec, fit_normalizer([r.kernel for r in prec]),
                         **kw)
    jt, pt = _pair("fusion", "segmented", (js, ps), reduction=reduction)
    b = js.batch(0)
    jloss, jgrads = jax.value_and_grad(jt._loss_fn)(
        jt.params, b.graphs, jnp.asarray(b.targets),
        jnp.zeros_like(jnp.asarray(b.targets), jnp.int32),
        jnp.asarray(b.valid), jt._step_rng(0))
    ploss = pt.loss(ps.batch(0), training=True)
    pgrads = torch.autograd.grad(ploss, PO.tree_leaves(pt.params))
    np.testing.assert_allclose(ploss.item(), float(jloss), rtol=1e-5)
    _grads_close([g.numpy() for g in pgrads], _jax_leaves(jgrads))
    res = pt.run(1, resume=False)
    assert np.isfinite(res["loss"])


# ------------------------------------------------ checkpoints, across
def test_jax_checkpoint_resumes_in_the_port(tile_records, fusion_records,
                                            tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    samplers = _samplers("tile", "dense", tile_records, fusion_records)
    jt, pt = _pair("tile", "dense", samplers,
                   jax_tc=JaxTrainerConfig(task="tile", ckpt_every=3,
                                           log_every=1, ckpt_dir=a),
                   port_tc=TrainerConfig(task="tile", ckpt_every=0,
                                         log_every=1, ckpt_dir=b))
    pt._load_params(_to_torch_tree(
        jax.tree_util.tree_map(jnp.zeros_like, jt.params)))
    jt.run(3, resume=False)
    shutil.copytree(a, b)
    assert pt.maybe_resume() and pt.step == 3
    assert int(pt.opt_state["step"]) == 3
    for p, j in zip(_port_leaves(pt.params), _jax_leaves(jt.params)):
        np.testing.assert_array_equal(p, j)
    for key in ("m", "v"):
        for p, j in zip(_port_leaves(pt.opt_state[key]),
                        _jax_leaves(jt.opt_state[key])):
            np.testing.assert_array_equal(p, j)
    # the next step agrees with the JAX trainer's next step
    jt.run(4, resume=False)
    pt.run(4, resume=False)
    lr = float(JO.schedule_lr(jt.cfg.optim, jnp.asarray(4)))
    ms = _jax_leaves(jt.opt_state["m"])
    mmax = max(float(np.abs(m).max()) for m in ms)
    for p, j, m in zip(_port_leaves(pt.params), _jax_leaves(jt.params), ms):
        # as in the one-step test: moments of rounding size (<= 1e-3 of
        # the tree's largest) may differ in sign, and an Adam step moves
        # a parameter by at most ~lr; the rest agree to f32 rounding
        big = np.abs(m) > 1e-3 * mmax
        np.testing.assert_allclose(p[big], j[big], rtol=1e-6, atol=1e-6)
        assert np.all(np.abs(p - j) <= 2 * lr)


def test_port_checkpoint_restores_in_jax_bit_exactly(tile_records,
                                                     fusion_records,
                                                     tmp_path):
    d = str(tmp_path / "ck")
    samplers = _samplers("tile", "sparse", tile_records, fusion_records)
    jt, pt = _pair("tile", "sparse", samplers,
                   port_tc=TrainerConfig(task="tile", ckpt_every=0,
                                         log_every=1, ckpt_dir=d))
    pt.run(2, resume=False)
    like = {"params": jt.params, "opt": jt.opt_state}
    state, step, meta = JC.restore_checkpoint(d, like)
    assert step == 2 and meta["task"] == "tile"
    assert JaxConfig.from_dict(meta["model_cfg"]) == jt.model_cfg
    assert state["opt"]["step"].dtype == jnp.int32
    assert state["opt"]["step"].shape == () and int(state["opt"]["step"]) == 2
    port = {"params": pt.params, "opt": pt.opt_state}
    for j, p in zip(_jax_leaves(state), _port_leaves(port)):
        assert j.dtype == p.dtype
        np.testing.assert_array_equal(j, p)
    # and the JAX trainer resumes from it
    jt2 = JaxTrainer(jt.model_cfg, JaxTrainerConfig(task="tile",
                                                    ckpt_dir=d), samplers[0])
    assert jt2.maybe_resume() and jt2.step == 2


@pytest.mark.parametrize("save_scan", [False, True],
                         ids=["unrolled-to-stacked", "stacked-to-unrolled"])
def test_checkpoint_converts_gnn_layouts(save_scan, tile_records,
                                         fusion_records, tmp_path):
    d = str(tmp_path / "ck")
    _, ps = _samplers("tile", "dense", tile_records, fusion_records)
    cfg = dict(TINY, scan_layers=save_scan)
    src = CostModelTrainer(CostModelConfig(**cfg), TrainerConfig(
        ckpt_dir=d, ckpt_every=0), ps, device="cpu")
    src.run(2, resume=False)
    dst = CostModelTrainer(CostModelConfig(**dict(cfg,
                                                  scan_layers=not save_scan)),
                           TrainerConfig(ckpt_dir=d), ps, device="cpu")
    assert dst.maybe_resume()
    from repro_torch.core import gnn as G
    for tree in (lambda t: t.params["gnn"],
                 lambda t: t.opt_state["m"]["gnn"]):
        a = PO.tree_leaves(G.unstack_params(tree(src)))
        b = PO.tree_leaves(G.unstack_params(tree(dst)))
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_checkpoint_files_match_the_jax_writer(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"z": [rng.random((2, 3)).astype(np.float32), {
        "b": np.int32(4), "a": rng.random(5).astype(np.float32)}],
        "layers": [rng.random(1).astype(np.float32)] * 11}
    JC.save_checkpoint(str(tmp_path / "j"), 7, jax.tree_util.tree_map(
        jnp.asarray, tree), meta={"k": 1})
    PC.save_checkpoint(str(tmp_path / "p"), 7, PO.tree_map(
        lambda a: torch.from_numpy(np.asarray(a)), tree), meta={"k": 1})
    mj, mp = (json.load(open(tmp_path / s / "step_00000007" /
                             "manifest.json")) for s in ("j", "p"))
    assert mj == mp
    for e in mj["leaves"]:
        a = np.load(tmp_path / "j" / "step_00000007" / e["file"])
        b = np.load(tmp_path / "p" / "step_00000007" / e["file"])
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ------------------------------------------- checkpoints, the port alone
def _t(*shape, fill=1.0):
    return torch.full(shape, fill)


def test_checkpoint_roundtrip_and_retention(tmp_path):
    d = str(tmp_path / "ck")
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3)},
             "step": torch.tensor(3, dtype=torch.int32)}
    for s in (1, 2, 3, 4):
        PC.save_checkpoint(d, s, state, keep=2)
    assert PC.list_steps(d) == [3, 4]
    restored, step, meta = PC.restore_checkpoint(d, state)
    assert step == 4 and meta == {}
    assert torch.equal(restored["params"]["w"], state["params"]["w"])
    assert restored["step"].dtype == torch.int32


def test_checkpoint_atomicity_ignores_partial(tmp_path):
    d = str(tmp_path / "ck")
    state = {"w": _t(2)}
    PC.save_checkpoint(d, 1, state)
    os.makedirs(os.path.join(d, "step_00000002"))   # a crashed writer
    assert PC.latest_step(d) == 1
    _, step, _ = PC.restore_checkpoint(d, state)
    assert step == 1


def test_checkpoint_shape_mismatch_raises(tmp_path):
    d = str(tmp_path / "ck")
    PC.save_checkpoint(d, 1, {"w": _t(2)})
    with pytest.raises(ValueError, match=r"'w'.*\(2,\).*\(3,\)"):
        PC.restore_checkpoint(d, {"w": _t(3)})


def test_checkpoint_keep_gc(tmp_path):
    d = str(tmp_path / "ck")
    state = {"w": _t(2)}
    for s in (1, 2, 3, 4, 5):
        PC.save_checkpoint(d, s, state, keep=2)
    assert PC.list_steps(d) == [4, 5]
    assert sorted(n for n in os.listdir(d) if n.startswith("step_")) == \
        ["step_00000004", "step_00000005"]
    PC.save_checkpoint(d, 6, state, keep=10)
    assert PC.list_steps(d) == [4, 5, 6]
    PC.save_checkpoint(d, 7, state, keep=1)
    assert PC.list_steps(d) == [7]


def test_checkpoint_keep_ignores_partial_dirs(tmp_path):
    d = str(tmp_path / "ck")
    state = {"w": _t(2)}
    PC.save_checkpoint(d, 1, state, keep=2)
    os.makedirs(os.path.join(d, "step_00000002"))
    PC.save_checkpoint(d, 3, state, keep=2)
    assert PC.list_steps(d) == [1, 3]


def test_checkpoint_restore_missing_leaf_raises_keyerror(tmp_path):
    d = str(tmp_path / "ck")
    PC.save_checkpoint(d, 1, {"params": {"w": _t(2)}})
    with pytest.raises(KeyError, match="extra"):
        PC.restore_checkpoint(d, {"params": {"w": _t(2), "extra": _t(3)}})


def test_checkpoint_restore_empty_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        PC.restore_checkpoint(str(tmp_path / "nothing"), {"w": _t(2)})


def test_checkpoint_restore_explicit_step(tmp_path):
    d = str(tmp_path / "ck")
    for s in (1, 2, 3):
        PC.save_checkpoint(d, s, {"w": _t(2, fill=float(s))}, keep=5)
    restored, step, _ = PC.restore_checkpoint(d, {"w": _t(2, fill=0.0)},
                                              step=2)
    assert step == 2
    assert restored["w"].tolist() == [2.0, 2.0]


# ---------------------------------------------------- trainer behaviour
def _tiny_trainer(tmp_path, tile_records, fusion_records, *, steps=12,
                  dropout_rate=0.1, adjacency="dense", **tc_kw):
    _, ps = _samplers("tile", adjacency, tile_records, fusion_records)
    mc = CostModelConfig(**dict(TINY, dropout=dropout_rate,
                                adjacency=adjacency))
    tc = TrainerConfig(**{**dict(task="tile", steps=steps, ckpt_every=5,
                                 log_every=5,
                                 ckpt_dir=str(tmp_path / "ck"),
                                 optim=PO.AdamWConfig(lr=3e-3)), **tc_kw})
    return mc, tc, ps


def test_trainer_loss_decreases(tmp_path, tile_records, fusion_records):
    mc, tc, ps = _tiny_trainer(tmp_path, tile_records, fusion_records,
                               ckpt_dir="")
    tr = CostModelTrainer(mc, tc, ps, device="cpu")
    losses = [tr.run((k + 1) * 10, resume=False)["loss"] for k in range(4)]
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("adjacency", ["dense", "sparse"])
def test_trainer_resume_is_bit_exact(adjacency, tmp_path, tile_records,
                                     fusion_records):
    """12 straight steps == 6 + restart + 6, with dropout on: the batch
    and the dropout generator are functions of the step."""
    mc, tc, ps = _tiny_trainer(tmp_path, tile_records, fusion_records,
                               adjacency=adjacency)
    tr1 = CostModelTrainer(mc, tc, ps, device="cpu")
    tr1.run(12, resume=False)
    tc2 = TrainerConfig(**{**tc.__dict__, "ckpt_dir": str(tmp_path / "ck2")})
    CostModelTrainer(mc, tc2, ps, device="cpu").run(6, resume=False)
    tr3 = CostModelTrainer(mc, tc2, ps, device="cpu")   # a fresh process
    assert tr3.maybe_resume() and tr3.step == 6
    tr3.run(12, resume=False)
    for a, b in zip(PO.tree_leaves({"p": tr1.params, "o": tr1.opt_state}),
                    PO.tree_leaves({"p": tr3.params, "o": tr3.opt_state})):
        assert torch.equal(a, b)


def test_dropout_changes_the_run(tmp_path, tile_records, fusion_records):
    runs = []
    for rate in (0.0, 0.1):
        mc, tc, ps = _tiny_trainer(tmp_path, tile_records, fusion_records,
                                   dropout_rate=rate, ckpt_dir="")
        tr = CostModelTrainer(mc, tc, ps, device="cpu")
        tr.run(3, resume=False)
        runs.append(PO.tree_leaves(tr.params)[0].clone())
    assert not torch.equal(runs[0], runs[1])


@pytest.mark.parametrize("reset_opt_step", [True, False])
def test_warm_start(reset_opt_step, tmp_path, tile_records, fusion_records):
    mc, tc, ps = _tiny_trainer(tmp_path, tile_records, fusion_records)
    src = CostModelTrainer(mc, tc, ps, device="cpu")
    src.run(5, resume=False)
    tc2 = TrainerConfig(**{**tc.__dict__, "ckpt_dir": str(tmp_path / "ft"),
                           "seed": 9})
    dst = CostModelTrainer(mc, tc2, ps, device="cpu")
    assert dst.warm_start(tc.ckpt_dir, reset_opt_step=reset_opt_step) == 5
    assert dst.step == 0
    assert int(dst.opt_state["step"]) == (0 if reset_opt_step else 5)
    for a, b in zip(PO.tree_leaves({"p": src.params, "m": src.opt_state["m"]}),
                    PO.tree_leaves({"p": dst.params,
                                    "m": dst.opt_state["m"]})):
        assert torch.equal(a, b)
    assert dst.run(3, resume=False)["step"] == 3
    assert int(dst.opt_state["step"]) == (3 if reset_opt_step else 8)
    with pytest.raises(FileNotFoundError):
        dst.warm_start(str(tmp_path / "none"))


def test_warm_start_params_only(tmp_path, tile_records, fusion_records):
    mc, tc, ps = _tiny_trainer(tmp_path, tile_records, fusion_records)
    CostModelTrainer(mc, tc, ps, device="cpu").run(5, resume=False)
    dst = CostModelTrainer(mc, TrainerConfig(ckpt_dir=""), ps, device="cpu")
    dst.warm_start(tc.ckpt_dir, restore_opt=False)
    assert int(dst.opt_state["step"]) == 0
    assert all(float(m.abs().max()) == 0.0
               for m in PO.tree_leaves(dst.opt_state["m"]))


def test_metrics_jsonl_keys(tmp_path, tile_records, fusion_records):
    path = str(tmp_path / "m" / "metrics.jsonl")
    mc, tc, ps = _tiny_trainer(tmp_path, tile_records, fusion_records,
                               metrics_path=path, log_every=2)
    tr = CostModelTrainer(mc, tc, ps, device="cpu")
    seen = []

    def eval_fn(model, step):
        seen.append(step)
        assert model is tr.model
        return {"score": float(step)}
    res = tr.run(4, resume=False, eval_fn=eval_fn, eval_every=2)
    assert res["step"] == 4 and not res["interrupted"]
    recs = _metrics(path)
    train = [r for r in recs if "loss" in r]
    evals = [r for r in recs if "eval/score" in r]
    assert [r["step"] for r in train] == [2, 4]
    assert all(set(r) == {"step", "loss", "lr", "grad_norm", "wall"}
               for r in train)
    assert [(r["step"], r["eval/score"]) for r in evals] == [(2, 2.0),
                                                             (4, 4.0)]
    assert seen == [2, 4]


class _SigtermAt:
    """A sampler that sends this process SIGTERM when step `at` is drawn."""

    def __init__(self, sampler, at):
        self.sampler, self.at = sampler, at

    def batch(self, step):
        if step == self.at:
            os.kill(os.getpid(), signal.SIGTERM)
        return self.sampler.batch(step)


def test_sigterm_writes_a_final_checkpoint(tmp_path, tile_records,
                                           fusion_records):
    mc, tc, ps = _tiny_trainer(tmp_path, tile_records, fusion_records,
                               ckpt_every=0)
    before = signal.getsignal(signal.SIGTERM)
    tr = CostModelTrainer(mc, tc, _SigtermAt(ps, 3), device="cpu")
    res = tr.run(50, resume=False)
    assert res["interrupted"] and res["step"] == 4
    assert PC.list_steps(tc.ckpt_dir) == [4]
    assert signal.getsignal(signal.SIGTERM) is before   # handler restored


REJECTED = [
    (dict(precision="int8"), {}, ValueError, "training runs in f32"),
    (dict(use_pallas_aggregate=True), {}, ValueError, "no backward"),
    (dict(use_pallas_aggregate=True, adjacency="sparse"), {}, ValueError,
     "no backward"),
    (dict(use_pallas_aggregate=True, adjacency="segmented"), {}, ValueError,
     "no backward"),
    # the mesh step needs a process group of dp·mp ranks
    ({}, dict(dp=1), ValueError, "none is initialised"),
    # int8 compression at dp=0 shards a leading batch dim: dense only
    (dict(adjacency="sparse"), dict(compress_grads=True), ValueError,
     "compress_grads=True needs a leading batch dim"),
    ({}, dict(dp=2), ValueError, "needs a process group of 2 ranks"),
    ({}, dict(dp=-1), ValueError, "dp must be"),
]


@pytest.mark.parametrize("model_kw,trainer_kw,exc,match", REJECTED)
def test_trainer_rejects(model_kw, trainer_kw, exc, match, tile_records,
                         fusion_records):
    _, ps = _samplers("tile", "dense", tile_records, fusion_records)
    with pytest.raises(exc, match=match):
        CostModelTrainer(CostModelConfig(**dict(TINY, **model_kw)),
                         TrainerConfig(**trainer_kw), ps, device="cpu")


def test_trainer_needs_the_card_by_default(tile_records, fusion_records):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, ps = _samplers("tile", "dense", tile_records, fusion_records)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CostModelTrainer(CostModelConfig(**TINY), TrainerConfig(), ps)


# --------------------------------------------------------------- dropout
def test_dropout_keep_rate_and_scale():
    n, rate = 1_000_000, 0.1
    g = torch.Generator().manual_seed(0)
    y = dropout(torch.ones(n), rate, generator=g, training=True)
    kept = int((y != 0).sum())
    keep = 1 - rate
    assert abs(kept - n * keep) <= 5 * np.sqrt(n * keep * rate)
    assert torch.allclose(y[y != 0], torch.tensor(1 / keep))


def test_dropout_identity_cases():
    x = torch.randn(100)
    g = torch.Generator().manual_seed(0)
    assert dropout(x, 0.5, generator=g, training=False) is x
    assert dropout(x, 0.0, generator=g, training=True) is x
    assert dropout(x, 0.5, generator=None, training=True) is x


def test_dropout_mask_is_a_function_of_seed_and_step(tile_records,
                                                     fusion_records):
    _, ps = _samplers("tile", "dense", tile_records, fusion_records)
    tr = CostModelTrainer(CostModelConfig(**TINY), TrainerConfig(seed=3),
                          ps, device="cpu")
    x = torch.ones(4096)

    def mask(trainer, step):
        return dropout(x, 0.3, generator=trainer.step_generator(step),
                       training=True) != 0
    assert torch.equal(mask(tr, 5), mask(tr, 5))
    assert not torch.equal(mask(tr, 5), mask(tr, 6))
    other = CostModelTrainer(CostModelConfig(**TINY), TrainerConfig(seed=4),
                             ps, device="cpu")
    assert not torch.equal(mask(tr, 5), mask(other, 5))


@pytest.mark.parametrize("adjacency", ["dense", "sparse"])
def test_training_false_is_the_inference_forward(adjacency, tile_records,
                                                 fusion_records):
    _, ps = _samplers("tile", adjacency, tile_records, fusion_records)
    cfg = CostModelConfig(**dict(TINY, dropout=0.5, adjacency=adjacency))
    model = cost_model_init(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    batch = batch_to_device(ps.batch(0).graphs, torch.device("cpu"))
    with torch.inference_mode():
        ref = cost_model_apply(model.tree(), cfg, batch)
    g = torch.Generator().manual_seed(1)
    with torch.inference_mode():
        off = cost_model_apply(model.tree(), cfg, batch, generator=g,
                               training=False)
        on = cost_model_apply(model.tree(), cfg, batch, generator=g,
                              training=True)
    assert torch.equal(off, ref)
    assert not torch.equal(on, ref)


# ------------------------------------------------------------ grad guard
def _ga_args():
    rng = np.random.default_rng(0)
    return {"adj": torch.from_numpy((rng.random((2, 5, 5)) < 0.4).astype(
                np.float32)),
            "x": torch.from_numpy(rng.normal(size=(2, 5, 4)).astype(
                np.float32)),
            "w": torch.from_numpy(rng.normal(size=(4, 3)).astype(
                np.float32))}


def _sa_args():
    rng = np.random.default_rng(1)
    M, E = 6, 10
    edges = sa.edge_csr(torch.from_numpy(rng.integers(0, M, E)),
                        torch.from_numpy(rng.integers(0, M, E)),
                        torch.ones(E), M)
    return {"x": torch.from_numpy(rng.normal(size=(M, 4)).astype(
                np.float32)),
            "w": torch.from_numpy(rng.normal(size=(4, 3)).astype(
                np.float32)),
            "w_scale": torch.ones(3), "edges": edges,
            "node_mask": torch.ones(M)}


GUARD_CASES = [("graph_aggregate", k) for k in ("adj", "x", "w")] + \
    [("segment_aggregate", k) for k in ("x", "w", "w_scale", "node_mask")]


@pytest.mark.parametrize("kernel,arg", GUARD_CASES)
def test_aggregation_wrappers_refuse_grad(kernel, arg):
    fn, args = ((ga.graph_aggregate, _ga_args()) if kernel ==
                "graph_aggregate" else (sa.segment_aggregate, _sa_args()))
    args[arg].requires_grad_(True)
    with pytest.raises(RuntimeError, match=f"{kernel} has no backward"):
        fn(**args)
    with torch.no_grad():
        fn(**args)                      # inference is unaffected


def test_kernel_forward_refuses_trainable_params(tile_records,
                                                 fusion_records):
    _, ps = _samplers("tile", "dense", tile_records, fusion_records)
    cfg = CostModelConfig(**dict(TINY, use_pallas_aggregate=True))
    model = cost_model_init(torch.Generator().manual_seed(0), cfg,
                            device="cpu").requires_grad_(True)
    batch = batch_to_device(ps.batch(0).graphs, torch.device("cpu"))
    with pytest.raises(RuntimeError, match="no backward"):
        cost_model_apply(model.tree(), cfg, batch)
    with torch.inference_mode():
        assert cost_model_apply(model.tree(), cfg, batch).shape == (8,)


# ------------------------------------------------------------------- CLI
def test_cli_trains_and_writes_a_checkpoint(tmp_path, capsys):
    import subprocess
    import sys
    from repro_torch.launch.train import main
    d = str(tmp_path / "ck")
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "cost-model",
         "--steps", "4", "--device", "cpu", "--programs", "6",
         "--ckpt-dir", d, "--log-every", "2"],
        env=dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "done: step=4" in res.stdout
    assert PC.list_steps(d) == [4]
    tree, step, meta = PC.read_checkpoint(d)
    assert meta["task"] == "tile" and meta["model_cfg"]["hidden_dim"] == 64
    assert int(tree["opt"]["step"]) == 4
    # warm start from it into a new directory
    main(["cost-model", "--steps", "2", "--device", "cpu", "--programs",
          "6", "--ckpt-dir", str(tmp_path / "ft"), "--warm-start", d,
          "--warmup-steps", "1"])
    assert "warm-started from" in capsys.readouterr().out
    assert PC.list_steps(str(tmp_path / "ft")) == [2]


@pytest.mark.parametrize("argv,exc,match", [
    (["cost-model", "--dp", "-1"], SystemExit, "--dp must be >= 0"),
    (["cost-model", "--dp", "2", "--mp", "0"], SystemExit, "--mp >= 1")])
def test_cli_refuses_unported(argv, exc, match):
    from repro_torch.launch.train import main
    with pytest.raises(exc, match=match):
        main(argv + ["--device", "cpu"])


def test_cli_trains_deepseek_on_the_cpu(capsys):
    """`train lm` takes deepseek-v3-671b (MLA, then the sigmoid-routed
    MoE) at its smoke config."""
    from repro_torch.launch.train import main
    main(["lm", "--arch", "deepseek-v3-671b", "--smoke", "--steps", "2",
          "--seq", "32", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=deepseek-v3-671b-smoke params=")
    assert [line.split(":")[0] for line in out[1:]] == ["step 0", "step 1"]
    assert all(np.isfinite(float(line.split("loss=")[1].split()[0]))
               for line in out[1:])

"""The port's evaluation, search engine and autotuners against the JAX
package, on the CPU.

The copied jax-free modules (`core.metrics`, `core.analytical`,
`search`, `autotuner`) give outputs identical to the reference's on the
same inputs; the learned paths (`core.evaluate`'s Table-2 tasks,
`LearnedEstimator`, `model_scorer`, `model_cost_fn`) score a model
carried across from a JAX init and agree with the JAX package's: the
metrics within rtol = atol = 1e-5, the top-k picks, regret and annealed
fusion decisions exactly, on `examples/autotune_tilesize.py` Part A and
`examples/fusion_search.py`'s programs at `max_configs=24`.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax

from repro import autotuner as JA
from repro import search as JS
from repro.core import analytical as JAn
from repro.core import evaluate as JE
from repro.core import metrics as JM
from repro.core.features import fit_normalizer as jax_fit_normalizer
from repro.core.model import CostModelConfig as JaxConfig
from repro.core.model import cost_model_init as jax_init
from repro.core.simulator import TPUSimulator as JaxSimulator
from repro.data.fusion import apply_fusion as jax_apply_fusion
from repro.data.fusion import default_fusion as jax_default_fusion
from repro.data.fusion_dataset import build_fusion_dataset as jax_fusion_ds
from repro.data.synthetic import generate_corpus as jax_corpus
from repro.data.synthetic import generate_program as jax_program
from repro.data.tile_dataset import build_tile_dataset as jax_tile_ds
from repro.data.tile_dataset import enumerate_tiles as jax_tiles
from repro_torch import autotuner as PA
from repro_torch import search as PS
from repro_torch.core import analytical as PAn
from repro_torch.core import evaluate as PE
from repro_torch.core import metrics as PM
from repro_torch.core.features import fit_normalizer
from repro_torch.core.model import CostModelConfig
from repro_torch.core.params import from_jax_params
from repro_torch.core.simulator import TPUSimulator
from repro_torch.data.fusion import apply_fusion, default_fusion
from repro_torch.data.fusion_dataset import build_fusion_dataset
from repro_torch.data.synthetic import generate_corpus, generate_program
from repro_torch.data.tile_dataset import build_tile_dataset, \
    enumerate_tiles

TOL = dict(rtol=1e-5, atol=1e-5)
MAX_CONFIGS = 24
FUSION_PROGRAMS = [("attention", 1), ("rnn", 2), ("norm", 0)]


def _part_a():
    """`examples/autotune_tilesize.py` Part A in both packages."""
    jp, pp = jax_program("attention", 0, seed=42), \
        generate_program("attention", 0, seed=42)
    return (jax_apply_fusion(jp, jax_default_fusion(jp)),
            apply_fusion(pp, default_fusion(pp)))


def _learned(layout, seed=0, **kw):
    """A JAX-initialized model and the port's copy of it."""
    base = dict(hidden_dim=16, opcode_embed_dim=8, gnn_layers=2,
                transformer_heads=4, dropout=0.0, max_nodes=64,
                adjacency=layout, reduction="column_wise")
    base.update(kw)
    jcfg = JaxConfig(**base)
    jparams = jax_init(jax.random.key(seed), jcfg)
    cfg = CostModelConfig.from_dict(jcfg.to_dict())
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                            cfg, device="cpu")
    return jparams, jcfg, model, cfg


# -------------------------------------------------------------- metrics
def test_metrics_identical():
    rng = np.random.default_rng(0)
    for n in (2, 5, 17):
        p, t = rng.random(n), rng.random(n)
        t[1] = t[0]                                 # a tie
        assert PM.kendall_tau(p, t) == JM.kendall_tau(p, t)
        assert PM.mape(p, t) == JM.mape(p, t)
    per_kernel = [{"true": rng.random(k), "pred": rng.random(k)}
                  for k in (3, 8, 1, 5)]
    assert PM.tile_size_ape(per_kernel) == JM.tile_size_ape(per_kernel)
    assert PM.program_kendall(per_kernel) == JM.program_kendall(per_kernel)
    xs = rng.random(7) + 0.1
    assert PM.geometric_mean(xs) == JM.geometric_mean(xs)


@pytest.mark.parametrize("fam,idx", FUSION_PROGRAMS + [("attention", 0)])
def test_analytical_identical(fam, idx):
    jp, pp = jax_program(fam, idx, seed=3), generate_program(fam, idx,
                                                             seed=3)
    jks = jax_apply_fusion(jp, jax_default_fusion(jp))
    pks = apply_fusion(pp, default_fusion(pp))
    jm, pm = JAn.AnalyticalModel(), PAn.AnalyticalModel()
    jsim, psim = JaxSimulator(), TPUSimulator()
    for jk, pk in zip(jks, pks):
        assert PAn.kernel_type(pk) == JAn.kernel_type(jk)
        assert pm.predict(pk) == jm.predict(jk)
        jt = jax_tiles(jk, 8, jsim.hw)
        pt = enumerate_tiles(pk, 8, psim.hw)
        assert jt == pt
        assert [pm.predict(pk, t) for t in pt] == \
            [jm.predict(jk, t) for t in jt]
        if pt:
            assert pm.best_tile(pk, pt) == jm.best_tile(jk, jt)
    measured = [psim.measure(k) for k in pks]
    coeffs = PAn.fit_type_coefficients(pm, pks, measured)
    assert coeffs == JAn.fit_type_coefficients(jm, jks, measured)
    assert [PAn.predict_scaled(pm, coeffs, k) for k in pks] == \
        [JAn.predict_scaled(jm, coeffs, k) for k in jks]


# -------------------------------------------------------- search engine
def test_budget_meter_identical():
    for budget, each in ((5.0, 2.0), (7.0, 0.5), (float("inf"), 2.0)):
        j, p = JS.BudgetMeter(budget, each), PS.BudgetMeter(budget, each)
        for n in (1, 3, 2, 4, 1):
            assert p.affordable(n) == j.affordable(n)
            outcomes = []
            for m in (j, p):
                try:
                    m.charge(n)
                    outcomes.append("ok")
                except (JS.BudgetExhausted, PS.BudgetExhausted):
                    outcomes.append("exhausted")
            assert outcomes[0] == outcomes[1]
            assert (p.evals, p.spent_s, p.remaining_s, p.exhausted) == \
                (j.evals, j.spent_s, j.remaining_s, j.exhausted)
    with pytest.raises(ValueError):
        PS.BudgetMeter(1.0, 0.0)


def test_topk_rerank_identical():
    rng = np.random.default_rng(1)
    jks, pks = _part_a()
    groups_j = [jks[:3], jks[3:5], jks[5:]]
    groups_p = [pks[:3], pks[3:5], pks[5:]]
    scores = [rng.random(len(g)) for g in groups_p]
    for top_k, budget in ((1, float("inf")), (2, float("inf")), (3, 8.0)):
        jm, pm = JS.BudgetMeter(budget, 2.0), PS.BudgetMeter(budget, 2.0)
        jc = JS.topk_rerank(groups_j, scores=scores,
                            measure=JaxSimulator().measure, top_k=top_k,
                            meter=jm)
        pc = PS.topk_rerank(groups_p, scores=scores,
                            measure=TPUSimulator().measure, top_k=top_k,
                            meter=pm)
        assert [(c.chosen, c.measured, c.hardware_evals) for c in pc] == \
            [(c.chosen, c.measured, c.hardware_evals) for c in jc]
        assert np.array_equal([c.chosen_runtime for c in pc],
                              [c.chosen_runtime for c in jc],
                              equal_nan=True)
        assert pm.evals == jm.evals


@pytest.mark.parametrize("population", [1, 4])
@pytest.mark.parametrize("fam,idx", FUSION_PROGRAMS)
def test_anneal_identical(fam, idx, population):
    """The annealer under the analytical model, sequential and with a
    population scored in one batched call."""
    jp, pp = jax_program(fam, idx, seed=0), generate_program(fam, idx,
                                                             seed=0)
    kw = dict(hardware_budget_s=6, model_steps=120, eval_seconds=2.0,
              seed=0, population=population)
    jr = JA.simulated_annealing_fusion(
        jp, JaxSimulator(), estimator=JS.AnalyticalEstimator(), **kw)
    pr = PA.simulated_annealing_fusion(
        pp, TPUSimulator(), estimator=PS.AnalyticalEstimator(), **kw)
    assert pr.best_decision.fuse == jr.best_decision.fuse
    assert (pr.best_runtime, pr.default_runtime, pr.hardware_evals,
            pr.model_evals, pr.hardware_seconds_used) == \
        (jr.best_runtime, jr.default_runtime, jr.hardware_evals,
         jr.model_evals, jr.hardware_seconds_used)
    assert pr.trace == jr.trace


class _Oracle:
    """Noise-free simulator times as a refine stage, one per package."""

    @staticmethod
    def make(base, sim):
        class Oracle(base):
            name = "oracle"

            def _estimate(self, kernels):
                return np.array([sim.ideal_time(k) for k in kernels])
        return Oracle()


def test_cascade_identical():
    jks, pks = _part_a()
    jsim, psim = JaxSimulator(), TPUSimulator()
    jgroups = [[k.with_tile(t) for t in jax_tiles(k, MAX_CONFIGS, jsim.hw)]
               for k in jks]
    pgroups = [[k.with_tile(t) for t in enumerate_tiles(k, MAX_CONFIGS,
                                                         psim.hw)]
               for k in pks]
    jc = JS.CascadeEstimator([JS.AnalyticalEstimator(),
                              _Oracle.make(JS.CostEstimator, jsim)],
                             keep=0.5)
    pc = PS.CascadeEstimator([PS.AnalyticalEstimator(),
                              _Oracle.make(PS.CostEstimator, psim)],
                             keep=0.5)
    js, ps = jc.estimate_groups(jgroups), pc.estimate_groups(pgroups)
    for a, b in zip(ps, js):
        np.testing.assert_array_equal(a, b)
    assert [s.queries for s in pc.stages] == [s.queries for s in jc.stages]
    with pytest.raises(TypeError):
        pc.runtimes(pks)


# ------------------------------------------------------- tile autotuner
def test_tile_autotuner_part_a_analytical_identical():
    jks, pks = _part_a()
    jsc = JE.analytical_tile_scorer(JAn.AnalyticalModel())
    psc = PE.analytical_tile_scorer(PAn.AnalyticalModel())
    for scorer_j, scorer_p, top_k in ((None, None, 10), (jsc, psc, 10),
                                      (jsc, psc, 1)):
        jr = JA.autotune_program_tiles(jks, JaxSimulator(), scorer=scorer_j,
                                       top_k=top_k, max_configs=MAX_CONFIGS)
        pr = PA.autotune_program_tiles(pks, TPUSimulator(), scorer=scorer_p,
                                       top_k=top_k, max_configs=MAX_CONFIGS)
        assert [(r.chosen_tile, r.chosen_runtime, r.best_runtime,
                 r.hardware_evals, r.regret) for r in pr.results] == \
            [(r.chosen_tile, r.chosen_runtime, r.best_runtime,
              r.hardware_evals, r.regret) for r in jr.results]
        assert pr.total_runtime == jr.total_runtime


@pytest.mark.parametrize("layout", ["sparse", "dense"])
@pytest.mark.parametrize("top_k", [1, 10])
def test_tile_autotuner_part_a_learned_same_picks(layout, top_k):
    """A carried-over learned model through the service, as
    `model_scorer` and as an estimator: the same picks and regret as the
    JAX package's. The kernel features (the tile among them) join at the
    readout (`kernel_feat_mode="kernel"`): at random weights the node
    mode's scores barely tell a kernel's tiles apart, and the picks among
    equal scores would be arbitrary."""
    jks, pks = _part_a()
    jparams, jcfg, model, cfg = _learned(layout, seed=5,
                                         kernel_feat_mode="kernel")
    jnorm = jax_fit_normalizer(jks)
    pnorm = fit_normalizer(pks)
    jr = JA.autotune_program_tiles(
        jks, JaxSimulator(), top_k=top_k, max_configs=MAX_CONFIGS,
        scorer=JA.model_scorer(jparams, jcfg, jnorm))
    pr = PA.autotune_program_tiles(
        pks, TPUSimulator(), top_k=top_k, max_configs=MAX_CONFIGS,
        scorer=PA.model_scorer(model, cfg, pnorm))
    est = PS.LearnedEstimator.from_params(model, cfg, pnorm)
    pe = PA.autotune_program_tiles(pks, TPUSimulator(), top_k=top_k,
                                   max_configs=MAX_CONFIGS, estimator=est)
    want = [(r.chosen_tile, r.chosen_runtime, r.hardware_evals, r.regret)
            for r in jr.results]
    for res in (pr, pe):
        assert [(r.chosen_tile, r.chosen_runtime, r.hardware_evals,
                 r.regret) for r in res.results] == want


def test_learned_estimator_routes_agree_on_the_models_device():
    """`cache_capacity=0` scores through `predict_kernels` directly, on
    the model's device, as the service route does."""
    _, pks = _part_a()
    _, _, model, cfg = _learned("sparse", seed=2)
    norm = fit_normalizer(pks)
    via_service = PS.LearnedEstimator.from_params(model, cfg, norm)
    direct = PS.LearnedEstimator.from_params(model, cfg, norm,
                                             cache_capacity=0)
    assert via_service.service.model.device == model.device
    assert direct.service is None and direct.adjacency == "sparse"
    np.testing.assert_allclose(direct.estimate(pks),
                               via_service.estimate(pks), **TOL)
    dense = PS.LearnedEstimator.from_params(
        model, CostModelConfig.from_dict(dict(cfg.to_dict(),
                                              adjacency="dense")), norm,
        cache_capacity=0)
    assert dense._default_drop() == 64 and via_service._default_drop() is None


# ----------------------------------------------------- fusion autotuner
@pytest.mark.parametrize("fam,idx", FUSION_PROGRAMS)
def test_fusion_search_example_analytical_identical(fam, idx):
    """`examples/fusion_search.py`: HW-only at 60 s and model + HW at 6 s
    under the analytical cost."""
    jp, pp = jax_program(fam, idx, seed=0), generate_program(fam, idx,
                                                             seed=0)
    jam, pam = JAn.AnalyticalModel(), PAn.AnalyticalModel()
    for budget, jcost, pcost in (
            (60, None, None),
            (6, lambda ks: sum(jam.predict(k) for k in ks),
             lambda ks: sum(pam.predict(k) for k in ks))):
        kw = dict(hardware_budget_s=budget, model_steps=300,
                  eval_seconds=2.0, seed=0)
        jr = JA.simulated_annealing_fusion(jp, JaxSimulator(),
                                           model_cost=jcost, **kw)
        pr = PA.simulated_annealing_fusion(pp, TPUSimulator(),
                                           model_cost=pcost, **kw)
        assert pr.best_decision.fuse == jr.best_decision.fuse
        assert (pr.speedup, pr.hardware_evals, pr.model_evals) == \
            (jr.speedup, jr.hardware_evals, jr.model_evals)


@pytest.mark.parametrize("layout", ["sparse", "dense"])
@pytest.mark.parametrize("fam,idx", FUSION_PROGRAMS)
def test_fusion_search_learned_same_decisions(fam, idx, layout):
    """`model_cost_fn` of a carried-over model through the service: the
    same annealed decision, runtime and evaluation counts as the JAX
    package's."""
    jp, pp = jax_program(fam, idx, seed=0), generate_program(fam, idx,
                                                             seed=0)
    jparams, jcfg, model, cfg = _learned(layout, seed=1)
    jks = jax_apply_fusion(jp, jax_default_fusion(jp))
    pks = apply_fusion(pp, default_fusion(pp))
    jnorm, pnorm = jax_fit_normalizer(jks), fit_normalizer(pks)
    kw = dict(hardware_budget_s=6, model_steps=150, eval_seconds=2.0,
              seed=0)
    jr = JA.simulated_annealing_fusion(
        jp, JaxSimulator(), model_cost=JA.model_cost_fn(jparams, jcfg, jnorm),
        **kw)
    pr = PA.simulated_annealing_fusion(
        pp, TPUSimulator(), model_cost=PA.model_cost_fn(model, cfg, pnorm),
        **kw)
    assert pr.best_decision.fuse == jr.best_decision.fuse
    assert (pr.best_runtime, pr.hardware_evals, pr.model_evals) == \
        (jr.best_runtime, jr.hardware_evals, jr.model_evals)


# --------------------------------------------------- Table-2 evaluation
@pytest.fixture(scope="module")
def datasets():
    kw = dict(max_kernel_nodes=64)
    return {
        "tile": (jax_tile_ds(jax_corpus(3, seed=4), JaxSimulator(),
                             max_configs_per_kernel=8, **kw),
                 build_tile_dataset(generate_corpus(3, seed=4),
                                    TPUSimulator(),
                                    max_configs_per_kernel=8, **kw)),
        "fusion": (jax_fusion_ds(jax_corpus(3, seed=5), JaxSimulator(),
                                 configs_per_program=3, **kw),
                   build_fusion_dataset(generate_corpus(3, seed=5),
                                        TPUSimulator(),
                                        configs_per_program=3, **kw))}


def _close_metrics(got: dict, want: dict):
    for key in ("median_ape", "mean_ape", "median_mape", "mean_mape",
                "median_kendall", "mean_kendall"):
        if key in want:
            np.testing.assert_allclose(got[key], want[key], **TOL)
    assert set(got["per_program"]) == set(want["per_program"])


@pytest.mark.parametrize("layout", ["sparse", "dense", "segmented"])
def test_eval_tile_task_learned_matches_jax(datasets, layout):
    jds, pds = datasets["tile"]
    jparams, jcfg, model, cfg = _learned(layout, seed=3)
    jnorm = jax_fit_normalizer([r.kernel for r in jds.records])
    pnorm = fit_normalizer([r.kernel for r in pds.records])
    want = JE.eval_tile_task(jds, JE.learned_tile_scorer(jparams, jcfg,
                                                         jnorm))
    got = PE.eval_tile_task(pds, PE.learned_tile_scorer(model, cfg, pnorm))
    _close_metrics(got, want)


def test_eval_tile_task_analytical_identical(datasets):
    jds, pds = datasets["tile"]
    want = JE.eval_tile_task(jds, JE.analytical_tile_scorer(
        JAn.AnalyticalModel()))
    got = PE.eval_tile_task(pds, PE.analytical_tile_scorer(
        PAn.AnalyticalModel()))
    assert got == want


@pytest.mark.parametrize("layout", ["sparse", "dense"])
def test_eval_fusion_task_learned_matches_jax(datasets, layout):
    jds, pds = datasets["fusion"]
    jparams, jcfg, model, cfg = _learned(layout, seed=4)
    jnorm = jax_fit_normalizer([r.kernel for r in jds.records])
    pnorm = fit_normalizer([r.kernel for r in pds.records])
    for min_rt in (0.0, 5e-6):
        want = JE.eval_fusion_task(jds, JE.learned_runtime_predictor(
            jparams, jcfg, jnorm), min_runtime=min_rt)
        got = PE.eval_fusion_task(pds, PE.learned_runtime_predictor(
            model, cfg, pnorm), min_runtime=min_rt)
        _close_metrics(got, want)


def test_eval_fusion_task_analytical_identical(datasets):
    jds, pds = datasets["fusion"]
    jm, pm = JAn.AnalyticalModel(), PAn.AnalyticalModel()
    recs = pds.records
    coeffs = PAn.fit_type_coefficients(pm, [r.kernel for r in recs],
                                       [r.runtime for r in recs])
    want = JE.eval_fusion_task(jds, JE.analytical_runtime_predictor(
        jm, coeffs))
    got = PE.eval_fusion_task(pds, PE.analytical_runtime_predictor(
        pm, coeffs))
    assert got == want


DOCTEST_MODULES = ["repro_torch.search.estimator",
                   "repro_torch.autotuner.tile_autotuner",
                   "repro_torch.serving.server",
                   "repro_torch.serving.client"]


@pytest.mark.parametrize("module_name", DOCTEST_MODULES)
def test_copied_module_doctests(module_name):
    import doctest
    result = doctest.testmod(importlib.import_module(module_name),
                             verbose=False)
    assert result.attempted > 0 and result.failed == 0

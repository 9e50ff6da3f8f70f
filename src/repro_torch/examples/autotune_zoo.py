"""Joint tile + fusion autotuning across the LM-architecture zoo under
one fixed hardware budget (the paper's §7 scenario at zoo scale;
DESIGN.md §10).

Counterpart of examples/autotune_zoo.py on the port, with its flags,
defaults and prints. For each imported architecture graph (traced by
`core.hlo_import` on `--device`), one `BudgetMeter` spans the whole
scenario:

  1. fusion search — population-batched simulated annealing against the
     learned model (one coalesced service flush per temperature step),
     then hardware re-ranking of the best configs within the budget;
  2. tile search  — the fused kernels' tile candidates scored by a
     `CascadeEstimator` (analytical prune → learned refine, half the
     learned-model queries), top-k verified on whatever budget remains.

The final chosen configuration is measured once at the end ("deploy and
observe") — that measurement is reporting, not tuning, and is not
charged against the budget. The learned model trains on the plain route;
`main(..., use_kernels=True)` scores with it under
`use_pallas_aggregate` (sparse: the `segment_aggregate` kernel).

  PYTHONPATH=src python -m repro_torch.examples.autotune_zoo [--device cpu]
  PYTHONPATH=src python -m repro_torch.examples.autotune_zoo \\
      --archs yi-9b musicgen-large --budget-s 120 --population 16
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.autotuner import autotune_program_tiles, \
    simulated_annealing_fusion
from repro_torch.core.device import resolve_device
from repro_torch.core.evaluate import make_predict_fn
from repro_torch.core.hlo_import import import_arch_program
from repro_torch.core.model import CostModelConfig
from repro_torch.core.simulator import TPUSimulator
from repro_torch.data.fusion import apply_fusion
from repro_torch.data.sampler import TileBatchSampler
from repro_torch.data.synthetic import generate_corpus
from repro_torch.data.tile_dataset import build_tile_dataset, \
    fit_tile_normalizer
from repro_torch.search import AnalyticalEstimator, BudgetMeter, \
    CascadeEstimator, LearnedEstimator
from repro_torch.training.optim import AdamWConfig
from repro_torch.training.trainer import CostModelTrainer, TrainerConfig

MAX_NODES = 48


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--archs", nargs="+",
                    default=["musicgen-large", "yi-9b",
                             "granite-moe-3b-a800m"])
    ap.add_argument("--budget-s", type=float, default=90.0,
                    help="hardware budget per architecture (simulated s)")
    ap.add_argument("--eval-seconds", type=float, default=2.0)
    ap.add_argument("--train-steps", type=int, default=250,
                    help="cost-model training steps (synthetic corpus)")
    ap.add_argument("--population", type=int, default=8)
    ap.add_argument("--model-steps", type=int, default=160,
                    help="annealing proposals (split across the population)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def model_config(**overrides) -> CostModelConfig:
    return dataclasses.replace(
        CostModelConfig(gnn="graphsage", reduction="column_wise",
                        hidden_dim=48, opcode_embed_dim=16, dropout=0.0,
                        max_nodes=MAX_NODES, adjacency="sparse"),
        **overrides)


def build_data(sim: TPUSimulator):
    """The synthetic corpus's tile dataset and its normalizer."""
    tds = build_tile_dataset(generate_corpus(12, seed=0), sim,
                             max_configs_per_kernel=12)
    return tds, fit_tile_normalizer(tds.records)


def make_trainer(tds, norm, cfg: CostModelConfig, args) -> CostModelTrainer:
    sampler = TileBatchSampler(tds.records, norm, kernels_per_batch=3,
                               configs_per_kernel=8, max_nodes=MAX_NODES)
    return CostModelTrainer(
        cfg, TrainerConfig(task="tile", steps=args.train_steps,
                           ckpt_every=0, log_every=100,
                           optim=AdamWConfig(lr=2e-3, schedule="constant")),
        sampler, device=args.device)


def learned_estimator(model, cfg: CostModelConfig, norm, predict_fn):
    return LearnedEstimator.from_params(model, cfg, norm,
                                        max_nodes=MAX_NODES,
                                        node_budget=1024,
                                        predict_fn=predict_fn)


def tune_arch(prog, model, cfg: CostModelConfig, norm, args,
              sim: TPUSimulator) -> dict:
    """Fusion then tile search on one program under one meter, scored by
    the learned model under `cfg`, then deploy and observe."""
    predict_fn = make_predict_fn(cfg)
    meter = BudgetMeter(budget_s=args.budget_s,
                        eval_seconds=args.eval_seconds)
    learned = learned_estimator(model, cfg, norm, predict_fn)

    # 1) fusion: population-batched anneal + hardware re-rank capped so
    # the shared budget keeps room for the tile phase
    r_fus = simulated_annealing_fusion(
        prog, sim, estimator=learned, meter=meter,
        population=args.population,
        model_steps=max(args.model_steps // args.population, 1),
        rerank_top=max(int(args.budget_s / args.eval_seconds) // 3, 1),
        seed=0)
    kernels = apply_fusion(prog, r_fus.best_decision)

    # 2) tiles: cascade scoring, top-k verified on the remaining budget —
    # most expensive kernels first (free analytical ordering, one batched
    # call), so the leftover hardware time goes where the runtime is
    order = np.argsort(-AnalyticalEstimator().estimate(kernels))
    kernels = [kernels[int(i)] for i in order]
    refine = learned_estimator(model, cfg, norm, predict_fn)
    cascade = CascadeEstimator([AnalyticalEstimator(), refine], keep=0.5)
    r_tile = autotune_program_tiles(kernels, sim, scorer=None,
                                    estimator=cascade, top_k=4,
                                    max_configs=12, meter=meter,
                                    exhaustive_truth=False)

    # deploy-and-observe: a verified tile replaces the compiler default
    # only if its (already budget-charged) measurement beats it — the
    # default is always available as a fallback, like the fusion search
    tuned = improved = 0.0
    for k, r in zip(kernels, r_tile.results):
        base = sim.measure(k)
        best = min(base, r.chosen_runtime) if r.hardware_evals else base
        improved += base - best
        tuned += best
    return {"prog": prog, "meter": meter, "fusion": r_fus,
            "kernels": kernels, "tiles": r_tile, "refine": refine,
            "cascade": cascade, "tuned": tuned, "improved": improved,
            "verified": sum(1 for r in r_tile.results if r.hardware_evals),
            "candidates": sum(r.candidates for r in r_tile.results)}


def report_arch(t: dict, args) -> None:
    prog, r_fus, meter = t["prog"], t["fusion"], t["meter"]
    print(f"\n{prog.name}: {prog.num_nodes} nodes -> "
          f"{len(t['kernels'])} fused kernels")
    print(f"  default fusion: {r_fus.default_runtime:.3e}s; "
          f"fusion search {r_fus.speedup:.3f}x "
          f"({r_fus.model_evals} model evals, "
          f"{r_fus.hardware_evals} hw evals)")
    print(f"  tile cascade: {t['verified']}/{len(t['kernels'])} kernels "
          f"verified, {t['refine'].queries}/{t['candidates']} learned "
          f"queries ({t['cascade'].stages[0].queries} analytical)")
    print(f"  tuned runtime: {t['tuned']:.3e}s "
          f"({r_fus.default_runtime / max(t['tuned'], 1e-30):.3f}x vs "
          f"default); budget {meter.spent_s:.0f}/{args.budget_s:.0f}s "
          f"({meter.evals} hw evals)")


def main(argv=None, *, use_kernels: bool = False) -> dict:
    args = parse_args(argv)
    resolve_device(args.device)
    sim = TPUSimulator()

    # --- a small learned model, trained on the synthetic corpus ---------
    print(f"training cost model ({args.train_steps} steps on synthetic "
          f"corpus)")
    tds, norm = build_data(sim)
    cfg = model_config()
    trainer = make_trainer(tds, norm, cfg, args)
    trainer.run(args.train_steps, resume=False)
    serve_cfg = dataclasses.replace(cfg, use_pallas_aggregate=use_kernels)

    runs = {}
    for arch in args.archs:
        prog = import_arch_program(arch, device=args.device)
        t = tune_arch(prog, trainer.model, serve_cfg, norm, args, sim)
        report_arch(t, args)
        assert t["meter"].spent_s <= args.budget_s + 1e-9
        runs[arch] = t
    return {"trainer": trainer, "norm": norm, "model_cfg": cfg,
            "serve_cfg": serve_cfg, "runs": runs, "args": args, "sim": sim}


if __name__ == "__main__":
    main()

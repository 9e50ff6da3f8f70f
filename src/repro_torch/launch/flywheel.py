"""Flywheel launcher: k measure→append→fine-tune→search rounds.

Counterpart of `repro.launch.flywheel`, on one device (the card by
default). Builds (or reuses) a tile corpus store, trains the static
round-0 model on it, then runs `repro_torch.flywheel.run_flywheel`
against a held-out set of target kernels — printing round-over-round
deploy-and-observe regret next to the static model's regret at the same
total hardware budget.

  PYTHONPATH=src python -m repro_torch.launch.flywheel \\
      --store experiments/flywheel/store --ckpt-dir experiments/flywheel \\
      --rounds 3 --budget-evals 48 --static-steps 300 --finetune-steps 120

The store directory accumulates one chain-verified delta shard set per
round (`delta-0000N.json` + npz shards); rerunning the command appends
further deltas to the same chain. The store and the checkpoints are in
the JAX package's formats, so either package's CLI may continue the
other's run. Scoring (the MC-dropout passes and the learned estimator)
runs through the aggregation kernels unless `--no-kernels`, which is
the default on the CPU; training always takes the plain route (the
kernels have no backward).
"""
from __future__ import annotations

import argparse
import os


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--store", required=True,
                    help="tile corpus store directory (created if absent)")
    ap.add_argument("--ckpt-dir", required=True,
                    help="checkpoint root: static model under static/, "
                         "flywheel rounds under rounds/round-NN")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--budget-evals", type=int, default=48,
                    help="TOTAL hardware evals across all rounds (the "
                         "shared BudgetMeter)")
    ap.add_argument("--programs", type=int, default=10,
                    help="training programs when building a fresh store")
    ap.add_argument("--targets", type=int, default=6,
                    help="held-out kernels to tune")
    ap.add_argument("--max-configs", type=int, default=24,
                    help="candidate tiles enumerated per target kernel")
    ap.add_argument("--static-steps", type=int, default=300,
                    help="round-0 (static) model training steps")
    ap.add_argument("--finetune-steps", type=int, default=120)
    ap.add_argument("--warmup-steps", type=int, default=20)
    ap.add_argument("--mc-samples", type=int, default=8)
    ap.add_argument("--spread", default="kernel",
                    choices=["kernel", "global"])
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--max-nodes", type=int, default=48)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' runs "
                         "the CPU path)")
    ap.add_argument("--kernels", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="score through the graph_aggregate kernel "
                         "(use_pallas_aggregate); default: on a CUDA "
                         "device, off on the CPU")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.core.device import resolve_device
    from repro_torch.core.model import CostModelConfig, cost_model_init
    from repro_torch.core.params import load_jax_checkpoint
    from repro_torch.core.simulator import TPUSimulator
    from repro_torch.data.store import StreamingCorpus, load_manifest, \
        write_corpus
    from repro_torch.data.synthetic import random_kernel
    from repro_torch.data.tile_dataset import build_tile_records, \
        enumerate_tiles, fit_tile_normalizer
    from repro_torch.flywheel import FlywheelConfig, run_flywheel
    from repro_torch.flywheel.loop import deploy_regret, static_plan
    from repro_torch.flywheel.retrain import fine_tune
    from repro_torch.search import LearnedEstimator
    from repro_torch.training import checkpoint as ckpt_lib
    from repro_torch.training.optim import adamw_init

    dev = resolve_device(args.device)     # no card: fail before any work
    kernels = dev.type == "cuda" if args.kernels is None else args.kernels
    sim = TPUSimulator()
    if load_manifest(args.store) is None:
        from repro_torch.data.fusion import apply_fusion, default_fusion
        from repro_torch.data.synthetic import generate_corpus
        programs = generate_corpus(args.programs, seed=args.seed)
        kernel_graphs = [k for p in programs
                         for k in apply_fusion(p, default_fusion(p))]
        recs = build_tile_records(kernel_graphs, sim, seed=args.seed)
        write_corpus(args.store, "tile", recs)
        print(f"built store: {len(recs)} records -> {args.store}")
    corpus = StreamingCorpus.open(args.store)
    norm = fit_tile_normalizer(list(corpus))
    model_cfg = CostModelConfig(gnn="graphsage", reduction="lstm",
                                hidden_dim=args.hidden,
                                opcode_embed_dim=16,
                                max_nodes=args.max_nodes, dropout=0.1,
                                use_pallas_aggregate=kernels)

    static_dir = os.path.join(args.ckpt_dir, "static")
    if ckpt_lib.latest_step(static_dir) is None:
        # from-scratch round-0 model: fine_tune's trainer plumbing with a
        # fresh-params "warm start" (zero-step checkpoint of random init)
        tree0 = cost_model_init(torch.Generator().manual_seed(args.seed),
                                model_cfg, device=dev).tree()
        seed_dir = os.path.join(args.ckpt_dir, "init")
        ckpt_lib.save_checkpoint(seed_dir, 0, {"params": tree0,
                                               "opt": adamw_init(tree0)})
        ft = fine_tune(corpus, norm, model_cfg, warm_start_dir=seed_dir,
                       steps=args.static_steps, ckpt_dir=static_dir,
                       lr=args.lr, warmup_steps=args.warmup_steps,
                       seed=args.seed, device=dev)
        print(f"trained static model: {ft.steps} steps, "
              f"loss {ft.final_train_loss:.4f}")
    model = load_jax_checkpoint(static_dir, model_cfg, device=dev)
    print(f"static model: {static_dir} @ step "
          f"{ckpt_lib.latest_step(static_dir)} on {dev} "
          f"(scoring kernels {'on' if kernels else 'off'})")

    targets = [random_kernel(12, seed=10_000 + args.seed + i)
               for i in range(args.targets)]
    fc = FlywheelConfig(rounds=args.rounds, budget_evals=args.budget_evals,
                        finetune_steps=args.finetune_steps,
                        warmup_steps=args.warmup_steps, lr=args.lr,
                        mc_samples=args.mc_samples, spread=args.spread,
                        seed=args.seed, max_configs=args.max_configs)
    res = run_flywheel(sim, args.store, targets, model, model_cfg, norm,
                       fc, ckpt_dir=os.path.join(args.ckpt_dir, "rounds"))

    static_est = LearnedEstimator.from_params(
        model, model_cfg, norm, max_nodes=model_cfg.max_nodes,
        cache_capacity=0)
    groups = [[k.with_tile(t)
               for t in enumerate_tiles(k, max_configs=args.max_configs)]
              for k in targets]
    scores0 = static_est.estimate_groups(groups)
    static_regret = deploy_regret(
        res.truth, scores0, static_plan(scores0, args.budget_evals))

    print(f"\nstatic model @ {args.budget_evals} evals: "
          f"regret {static_regret:.4f}")
    for r in res.rounds:
        print(f"round {r.round}: +{r.measured} evals "
              f"(+{r.delta_records} delta records) -> "
              f"regret {r.regret:.4f}")
    print(f"flywheel total evals charged: {res.evals_charged}")
    chained = StreamingCorpus.open(args.store).with_deltas()
    print(f"store: {len(chained)} records, {chained.num_deltas} delta "
          f"shard set(s), chain {chained.chain_hash}")


if __name__ == "__main__":
    main()

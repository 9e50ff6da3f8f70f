"""End-to-end production driver: train the fusion-task cost model for a few
hundred steps with the full substrate — corpus incl. programs imported from
the assigned architectures, train/val/test splits, checkpointing + resume,
JSONL metrics, periodic eval — then hand the model to the fusion
autotuner.

Counterpart of examples/train_cost_model.py on the port, with its flags,
defaults and prints, on `--device` (the card by default):

  PYTHONPATH=src python -m repro_torch.examples.train_cost_model [--steps 600]
      [--adjacency dense|sparse] [--prefetch 2] [--store DIR] [--dp N]
      [--num-hosts H --host-id h] [--device cpu]

--adjacency selects the batched-graph representation end to end (sampler,
trainer, evaluation, autotuner). --prefetch encodes that many batches
ahead on a background thread (the same batch stream; 0 = synchronous).
--store DIR makes the corpus a durable artifact: the first run builds it
with `launch.build_corpus` (worker processes, the architectures traced
on the device) and every later run streams the records shard by shard
from disk (rebuilding an unchanged spec is a manifest-hash no-op).
--dp N trains data-parallel over N ranks spawned on this host (one card
each where there are enough, else sharing it over gloo; rank 0 reports).
Checkpoints are the JAX package's format: rerun with the same
--ckpt-dir to resume.

`main(..., use_kernels=True)` evaluates and autotunes with the trained
model under `use_pallas_aggregate` (dense: `graph_aggregate`, sparse:
`segment_aggregate`); training stays on the plain route (the kernels
have no backward).
"""
from __future__ import annotations

import argparse
import dataclasses
import os

from repro_torch.autotuner import model_cost_fn, simulated_annealing_fusion
from repro_torch.core.device import resolve_device
from repro_torch.core.evaluate import eval_fusion_task, \
    learned_runtime_predictor, make_predict_fn
from repro_torch.core.features import fit_normalizer
from repro_torch.core.hlo_import import import_arch_program
from repro_torch.core.model import CostModelConfig
from repro_torch.core.simulator import TPUSimulator
from repro_torch.data.corpus import filter_by_programs, split_programs
from repro_torch.data.fusion_dataset import FusionDataset, \
    build_fusion_dataset
from repro_torch.data.sampler import BalancedSampler
from repro_torch.data.synthetic import generate_corpus, generate_program
from repro_torch.training.optim import AdamWConfig
from repro_torch.training.trainer import CostModelTrainer, TrainerConfig

MAX_NODES = 48
ARCHS = ("yi-9b", "mamba2-2.7b", "granite-moe-3b-a800m")
STORE_WORKERS = os.cpu_count() or 1     # build_corpus's worker processes


def _rebuild_program(name: str, device="cuda"):
    """Regenerate one pre-fusion program graph by its corpus name —
    `arch_<zoo-name>` imports that architecture (traced on `device`),
    `<family>_<idx>` re-runs the deterministic synthetic generator."""
    if name.startswith("arch_"):
        return import_arch_program(name[len("arch_"):], device=device)
    family, idx = name.rsplit("_", 1)
    return generate_program(family, int(idx), seed=0)


def build_data(sim: TPUSimulator, store: str, device) -> dict:
    """Synthetic families + imported architectures, split by program:
    built in memory, or from the store under `store` (built on the first
    run, streamed after)."""
    programs = None
    if store:
        from repro_torch.data.store import StreamingCorpus
        from repro_torch.launch.build_corpus import build_corpus
        build_corpus(store, kinds=("fusion",), programs=24, seed=0,
                     import_archs=ARCHS, workers=STORE_WORKERS,
                     fusion_opts={"configs_per_program": 10},
                     device=str(device))
        corpus = StreamingCorpus.open(os.path.join(store, "fusion"))
        names = corpus.programs()
        split = split_programs(names, method="random")
        train_recs = corpus.select_programs(split["train"])
        test_recs = list(corpus.select_programs(split["test"]))
        num_samples = len(corpus)
    else:
        programs = generate_corpus(24, seed=0)
        for arch in ARCHS:
            programs.append(import_arch_program(arch, device=device))
        ds = build_fusion_dataset(programs, sim, configs_per_program=10)
        names = [p.program for p in programs]
        split = split_programs(names, method="random")
        train_recs = filter_by_programs(ds.records, split["train"])
        test_recs = filter_by_programs(ds.records, split["test"])
        num_samples = ds.num_samples
    return {"names": names, "split": split, "train_recs": train_recs,
            "test_recs": test_recs, "num_samples": num_samples,
            "programs": programs,
            "norm": fit_normalizer([r.kernel for r in train_recs])}


def model_config(adjacency: str, **overrides) -> CostModelConfig:
    return dataclasses.replace(
        CostModelConfig(gnn="graphsage", reduction="transformer",
                        hidden_dim=64, opcode_embed_dim=16,
                        max_nodes=MAX_NODES, adjacency=adjacency),
        **overrides)


def make_trainer(mc: CostModelConfig, data: dict, args) -> CostModelTrainer:
    """The checkpointed trainer (rerun to resume)."""
    sampler = BalancedSampler(data["train_recs"], data["norm"],
                              batch_size=24, max_nodes=MAX_NODES,
                              adjacency=mc.adjacency, host_id=args.host_id,
                              num_hosts=args.num_hosts)
    return CostModelTrainer(
        mc,
        TrainerConfig(task="fusion", steps=args.steps, ckpt_every=200,
                      log_every=100, ckpt_dir=args.ckpt_dir,
                      metrics_path=os.path.join(args.ckpt_dir,
                                                "metrics.jsonl"),
                      prefetch=args.prefetch, dp=args.dp,
                      optim=AdamWConfig(lr=2e-3)),
        sampler, device=args.device)


def make_eval_fn(serve_cfg: CostModelConfig, data: dict):
    """`eval_fn(model, step)`: MAPE and Kendall tau on the held-out
    programs, scored under `serve_cfg`."""
    def eval_fn(model, step):
        pred = learned_runtime_predictor(model, serve_cfg, data["norm"],
                                         max_nodes=MAX_NODES, chunk=32)
        res = eval_fusion_task(FusionDataset(data["test_recs"]), pred)
        return {"test_mape": res["mean_mape"],
                "test_kendall": res["mean_kendall"]}
    return eval_fn


def tune_held_out(model, serve_cfg: CostModelConfig, data: dict, target,
                  sim: TPUSimulator):
    """The fusion autotuner on a held-out program, the model pre-screening
    (representation follows the adjacency: sparse scores every candidate
    kernel; dense drops kernels above MAX_NODES)."""
    model_cost = model_cost_fn(model, serve_cfg, data["norm"],
                               max_nodes=MAX_NODES, chunk=32,
                               predict_fn=make_predict_fn(serve_cfg))
    return simulated_annealing_fusion(target, sim, model_cost=model_cost,
                                      hardware_budget_s=10, model_steps=200,
                                      seed=0)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--ckpt-dir", default="ckpts/fusion_model")
    ap.add_argument("--adjacency", choices=("dense", "sparse"),
                    default="dense")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="batches encoded ahead by a background thread "
                         "(0 = synchronous)")
    ap.add_argument("--store", default="",
                    help="corpus store root: built on the first run, "
                         "streamed from disk on every later run")
    ap.add_argument("--dp", type=int, default=0,
                    help="data-parallel ranks (0 = one process, no "
                         "process group; >= 1 spawns dp ranks)")
    ap.add_argument("--num-hosts", type=int, default=1,
                    help="total training hosts (the sampler draws from "
                         "this host's disjoint record shard)")
    ap.add_argument("--host-id", type=int, default=0,
                    help="this host's index in [0, --num-hosts)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.num_hosts < 1 or not 0 <= args.host_id < args.num_hosts:
        ap.error(f"--host-id must be in [0, --num-hosts={args.num_hosts}), "
                 f"got {args.host_id}")
    if args.dp < 0:
        ap.error(f"--dp must be >= 0, got {args.dp}")
    return args


def run(args, use_kernels: bool = False) -> dict | None:
    """The whole run in this process, or this rank's part of it when a
    process group is up (rank 0 alone evaluates, tunes and prints).
    Returns what it built (None on the other ranks)."""
    import torch.distributed as dist
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    say = print if rank0 else (lambda *a, **k: None)
    resolve_device(args.device)

    sim = TPUSimulator()
    data = build_data(sim, args.store, args.device)
    say(f"{len(data['names'])} programs -> {data['num_samples']} kernels "
        f"({len(data['train_recs'])} train / {len(data['test_recs'])} "
        f"test)")

    mc = model_config(args.adjacency)
    serve_cfg = dataclasses.replace(mc, use_pallas_aggregate=use_kernels)
    eval_fn = make_eval_fn(serve_cfg, data)
    trainer = make_trainer(mc, data, args)
    res = trainer.run(eval_fn=eval_fn, eval_every=200)
    say(f"training done at step {res['step']}: loss={res['loss']:.4f}")
    if not rank0:
        return None

    ev = eval_fn(trainer.model, res["step"])
    print(f"held-out programs: MAPE {ev['test_mape']:.1f}%  "
          f"Kendall {ev['test_kendall']:.3f}")

    if args.store:
        # rebuild just the one target program (generation is
        # deterministic and cheap; only this name is re-imported)
        target = _rebuild_program(data["split"]["test"][0], args.device)
    else:
        by_name = {p.program: p for p in data["programs"]}
        target = by_name[data["split"]["test"][0]]
    r = tune_held_out(trainer.model, serve_cfg, data, target, sim)
    print(f"fusion autotuner on held-out {target.name}: "
          f"{r.speedup:.3f}x speedup over compiler default with only "
          f"{r.hardware_evals} hardware evals")
    return {"data": data, "trainer": trainer, "result": res, "eval": ev,
            "fusion": r, "serve_cfg": serve_cfg}


def main(argv=None, *, use_kernels: bool = False) -> dict | None:
    args = parse_args(argv)
    if args.dp < 1:
        return run(args, use_kernels)
    from repro_torch.sharding.mesh import pick_backend, rank_device, \
        spawn_ranks
    devices = ", ".join(str(rank_device(args.device, r))
                        for r in range(args.dp))
    print(f"data-parallel: dp={args.dp}, {args.dp} ranks spawned, backend "
          f"{pick_backend(args.device, args.dp)}, devices {devices}",
          flush=True)
    spawn_ranks(run, (args, use_kernels), args.dp, device=args.device)
    return None


if __name__ == "__main__":
    main()

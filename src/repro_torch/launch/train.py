"""Training launcher (counterpart of `repro.launch.train`).

  cost-model — train the paper's learned performance model on a generated
    corpus, on the card by default: deterministic sampling, atomic
    checkpoints in the JAX package's format, resume, and --warm-start
    from another run's checkpoint (either package's):

      PYTHONPATH=src python -m repro_torch.launch.train cost-model \
          --task tile --steps 2000 --ckpt-dir ckpts/tile

    With --from-store the corpus is streamed shard by shard from an
    on-disk store built by `python -m repro_torch.launch.build_corpus`
    (or the JAX package's builder: the format is the same), with no
    generation or oracle measurement at train time; --deltas trains on
    the store's base+delta chained view (the flywheel's appended
    measurement shards, chain-verified), and with --warm-start it is
    the flywheel's incremental retrain:

      PYTHONPATH=src python -m repro_torch.launch.train cost-model \
          --task tile --from-store experiments/corpora/v1/tile --deltas \
          --warm-start ckpts/tile --ckpt-dir ckpts/tile_ft \
          --steps 200 --warmup-steps 20

    --dp N (--mp M) trains data-parallel over N·M ranks
    (`CostModelTrainer`'s mesh step), --compress-grads with the int8
    error-feedback all-reduce. The launcher starts the ranks itself
    (start method `spawn`, a `file://` store in a temporary directory),
    or, under `torchrun --nproc-per-node N·M`, each process joins as its
    rank. The first line says the backend and the devices: NCCL when each
    rank has a card of its own, gloo with the tensors left on the card
    when ranks outnumber cards (two ranks on one card), gloo on the CPU.
    Rank 0 alone prints, writes the checkpoints and the metrics:

      PYTHONPATH=src python -m repro_torch.launch.train cost-model \
          --dp 2 --compress-grads --steps 300 --ckpt-dir ckpts/tile_dp2

  lm — the LM zoo's train step (`models.lm.train_step_fn`, AdamW or
    Adafactor as the config says, microbatched) on random weights from
    --seed and `make_batch`'s inputs (tokens, musicgen's frame
    embeddings and labels, llava's tokens and patch prefix, which --seq
    counts), printing the parameter count and each step's loss and
    seconds; every arch of the zoo (h2o-danube-3-4b, yi-9b, yi-34b,
    qwen3-14b, granite-moe-3b-a800m, deepseek-v3-671b, musicgen-large,
    llava-next-34b, mamba2-2.7b, recurrentgemma-9b), at its full size or
    with --smoke its smoke config:

      PYTHONPATH=src python -m repro_torch.launch.train lm \
          --arch h2o-danube-3-4b --smoke --steps 5 --device cpu
"""
from __future__ import annotations

import argparse
import os
import time


def _check_cost_model_args(args) -> None:
    from repro_torch.core.device import resolve_device
    resolve_device(args.device)      # no card: fail before building data
    if args.num_hosts < 1:
        raise SystemExit(f"--num-hosts must be >= 1, got {args.num_hosts}")
    if not 0 <= args.host_id < args.num_hosts:
        raise SystemExit(f"--host-id must be in [0, {args.num_hosts}), "
                         f"got {args.host_id}")
    if args.dp < 0 or args.mp < 1:
        raise SystemExit(f"--dp must be >= 0 and --mp >= 1, "
                         f"got dp={args.dp} mp={args.mp}")
    if args.deltas and not args.from_store:
        raise SystemExit("--deltas only applies to a stored corpus; "
                         "pass --from-store DIR")
    if args.warm_start:
        from repro_torch.training.checkpoint import latest_step
        if latest_step(args.warm_start) is None:
            raise SystemExit(f"--warm-start: no checkpoint found in "
                             f"{args.warm_start!r}")
        if args.warm_start == args.ckpt_dir:
            raise SystemExit(
                "--warm-start must point at a DIFFERENT run's checkpoint "
                "directory — resuming the same --ckpt-dir is the default "
                "behaviour (drop --warm-start), and fine-tuning in place "
                "would overwrite the checkpoint being fine-tuned from")


def train_cost_model(args) -> None:
    _check_cost_model_args(args)
    if args.dp < 1:
        _train_cost_model(args)
        return
    import torch.distributed as dist
    from repro_torch.sharding.mesh import init_distributed, pick_backend, \
        rank_device, spawn_ranks
    world = args.dp * args.mp
    if "RANK" in os.environ:                 # under torchrun
        backend = init_distributed(args.device)
        try:
            if dist.get_rank() == 0:
                print(f"data-parallel: dp={args.dp} mp={args.mp}, {world} "
                      f"ranks (torchrun), backend {backend}, rank 0 on "
                      f"{rank_device(args.device, 0)}", flush=True)
            _train_cost_model(args)
        finally:
            dist.destroy_process_group()
        return
    devices = ", ".join(str(rank_device(args.device, r))
                        for r in range(world))
    print(f"data-parallel: dp={args.dp} mp={args.mp}, {world} ranks "
          f"spawned, backend {pick_backend(args.device, world)}, devices "
          f"{devices}", flush=True)
    spawn_ranks(_train_cost_model, (args,), world, device=args.device)


def _train_cost_model(args) -> None:
    """Build the data and train: the whole run on one device, or this
    rank's part of it (the process group is up)."""
    from repro_torch.core.features import fit_normalizer
    from repro_torch.core.model import CostModelConfig
    from repro_torch.core.simulator import TPUSimulator
    from repro_torch.data.corpus import filter_by_programs, split_programs
    from repro_torch.data.fusion_dataset import build_fusion_dataset
    from repro_torch.data.sampler import BalancedSampler, TileBatchSampler
    from repro_torch.data.synthetic import generate_corpus
    from repro_torch.data.tile_dataset import build_tile_dataset
    from repro_torch.training.optim import AdamWConfig
    from repro_torch.training.trainer import CostModelTrainer, TrainerConfig

    rank0 = True
    if args.dp >= 1:
        import torch.distributed as dist
        rank0 = dist.get_rank() == 0
    say = print if rank0 else (lambda *a, **k: None)

    want_kind = "tile" if args.task.startswith("tile") else "fusion"
    if args.from_store:
        from repro_torch.data.store import StreamingCorpus
        corpus = StreamingCorpus.open(args.from_store)
        if corpus.kind != want_kind:
            raise SystemExit(f"--from-store points at a {corpus.kind!r} "
                             f"corpus but --task {args.task} needs "
                             f"{want_kind!r}")
        if args.deltas:
            corpus = corpus.with_deltas()
            say(f"chained {corpus.num_deltas} delta shard set(s) "
                f"(chain {corpus.chain_hash[:12]}…)")
        split = split_programs(corpus.programs(), method=args.split,
                               seed=args.seed)
        recs = corpus.select_programs(split["train"])
        ident = (corpus.chain_hash if args.deltas
                 else corpus.manifest_hash)
        say(f"streaming {len(recs)}/{len(corpus)} records from "
            f"{args.from_store} (manifest {ident[:12]}…)")
    else:
        sim = TPUSimulator()
        programs = generate_corpus(args.programs, seed=args.seed)
        split = split_programs([p.program for p in programs],
                               method=args.split, seed=args.seed)
        if want_kind == "tile":
            ds = build_tile_dataset(programs, sim, max_configs_per_kernel=24)
        else:
            ds = build_fusion_dataset(programs, sim, configs_per_program=12)
        recs = filter_by_programs(ds.records, split["train"])
    mc = CostModelConfig(gnn=args.gnn, reduction=args.reduction,
                         hidden_dim=args.hidden, opcode_embed_dim=32,
                         max_nodes=args.max_nodes)
    if want_kind == "tile":
        from repro_torch.data.tile_dataset import fit_tile_normalizer
        norm = fit_tile_normalizer(recs)
        sampler = TileBatchSampler(recs, norm, kernels_per_batch=4,
                                   configs_per_kernel=8,
                                   max_nodes=args.max_nodes,
                                   host_id=args.host_id,
                                   num_hosts=args.num_hosts)
    else:
        norm = fit_normalizer([r.kernel for r in recs])
        sampler = BalancedSampler(recs, norm, batch_size=32,
                                  max_nodes=args.max_nodes,
                                  host_id=args.host_id,
                                  num_hosts=args.num_hosts)
    tc = TrainerConfig(task=args.task, steps=args.steps,
                       ckpt_every=args.ckpt_every, log_every=args.log_every,
                       ckpt_dir=args.ckpt_dir,
                       metrics_path=args.metrics_path,
                       compress_grads=args.compress_grads,
                       dp=args.dp, mp=args.mp,
                       optim=AdamWConfig(lr=args.lr,
                                         warmup_steps=args.warmup_steps))
    trainer = CostModelTrainer(mc, tc, sampler, device=args.device)
    if args.warm_start:
        from_step = trainer.warm_start(args.warm_start,
                                       reset_opt_step=not args.keep_opt_step)
        say(f"warm-started from {args.warm_start} step {from_step} "
            f"(LR warmup {'continues' if args.keep_opt_step else 'restarts'}"
            f", {args.warmup_steps} warmup steps)")
    res = trainer.run(resume=not args.no_resume)
    say(f"done: step={res['step']} loss={res['loss']:.5f} "
        f"wall={res['wall']:.1f}s interrupted={res['interrupted']} "
        f"device={trainer.device}", flush=True)


def train_lm(args) -> None:
    import torch
    from repro_torch.core.device import resolve_device
    from repro_torch.models import lm, registry
    from repro_torch.models.config import ShapeSpec
    from repro_torch.models.inputs import make_batch

    dev = resolve_device(args.device)
    cfg = registry.get_smoke_config(args.arch) if args.smoke \
        else registry.get_config(args.arch)
    shape = ShapeSpec("cli", args.seq, args.batch, "train")
    params = lm.init_params(torch.Generator(dev).manual_seed(args.seed), cfg,
                            device=dev)
    opt_init, _ = lm.make_optimizer(cfg)
    opt = opt_init(params)
    step = lm.train_step_fn(cfg)
    print(f"arch={cfg.name} params={lm.param_count(params):,} "
          f"device={dev}")
    for i in range(args.steps):
        batch = make_batch(cfg, shape, seed=args.seed + i, device=dev)
        t0 = time.time()
        params, opt, stats = step(params, opt, batch)
        loss = float(stats["loss"])           # waits for the step
        print(f"step {i}: loss={loss:.4f} ({time.time() - t0:.2f}s)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)

    cm = sub.add_parser("cost-model")
    cm.add_argument("--task", default="tile",
                    choices=["tile", "fusion", "tile_mse", "fusion_mse"])
    cm.add_argument("--steps", type=int, default=2000)
    cm.add_argument("--programs", type=int, default=48)
    cm.add_argument("--from-store", default="",
                    help="stream records from an on-disk corpus store "
                         "(one kind's directory, e.g. corpora/v1/tile) "
                         "instead of regenerating + re-measuring")
    cm.add_argument("--deltas", action="store_true",
                    help="with --from-store: train on the base+delta "
                         "chained view (StreamingCorpus.with_deltas) — "
                         "the flywheel's appended measurement shards "
                         "included, chain-verified")
    cm.add_argument("--warm-start", default="",
                    help="checkpoint directory of ANOTHER run (either "
                         "package's) to fine-tune from: params + AdamW "
                         "moments are restored, this run still starts at "
                         "step 0")
    cm.add_argument("--warmup-steps", type=int, default=0,
                    help="LR warmup steps (AdamWConfig.warmup_steps); "
                         "pair with --warm-start for the short re-warmup "
                         "that protects a fine-tuned checkpoint")
    cm.add_argument("--keep-opt-step", action="store_true",
                    help="with --warm-start: keep the optimizer's step "
                         "counter (LR schedule continues) instead of "
                         "resetting it (warmup restarts)")
    cm.add_argument("--split", default="random",
                    choices=["random", "manual"])
    cm.add_argument("--gnn", default="graphsage")
    cm.add_argument("--reduction", default="transformer")
    cm.add_argument("--hidden", type=int, default=64)
    cm.add_argument("--max-nodes", type=int, default=48)
    cm.add_argument("--lr", type=float, default=2e-3)
    cm.add_argument("--seed", type=int, default=0)
    cm.add_argument("--ckpt-dir", default="ckpts/cost_model")
    cm.add_argument("--ckpt-every", type=int, default=500)
    cm.add_argument("--log-every", type=int, default=100)
    cm.add_argument("--metrics-path", default="")
    cm.add_argument("--compress-grads", action="store_true",
                    help="int8 error-feedback all-reduce of the gradients "
                         "(dense batches at --dp 0)")
    cm.add_argument("--no-resume", action="store_true")
    cm.add_argument("--dp", type=int, default=0,
                    help="data-parallel mesh size: 0 trains on one device "
                         "with no process group; >= 1 trains over "
                         "dp * mp ranks")
    cm.add_argument("--mp", type=int, default=1,
                    help="model mesh axis size (params replicated)")
    cm.add_argument("--num-hosts", type=int, default=1,
                    help="total training hosts; this host's sampler draws "
                         "from its disjoint record shard")
    cm.add_argument("--host-id", type=int, default=0,
                    help="this host's index in [0, --num-hosts)")
    cm.add_argument("--device", default="cuda",
                    help="torch device to train on (default: the card; "
                         "'cpu' runs the CPU path)")

    lm_p = sub.add_parser("lm")
    lm_p.add_argument("--arch", required=True)
    lm_p.add_argument("--smoke", action="store_true")
    lm_p.add_argument("--steps", type=int, default=5)
    lm_p.add_argument("--seq", type=int, default=64)
    lm_p.add_argument("--batch", type=int, default=4)
    lm_p.add_argument("--seed", type=int, default=0)
    lm_p.add_argument("--device", default="cuda",
                      help="torch device (default: the card; 'cpu' runs "
                           "the CPU path)")

    args = ap.parse_args(argv)
    if args.cmd == "cost-model":
        train_cost_model(args)
    else:
        train_lm(args)


if __name__ == "__main__":
    main()

"""Cost-model prediction-service replay on the card: throughput / hit rate.

Counterpart of `repro.launch.serve_costmodel`'s local replay mode.
Replays the deterministic tile-search query stream
(`repro_torch.serving.replay`) through the port's `CostModelService`
and prints queries/sec, cache hit rate, coalescing and flush behavior,
per-bucket occupancy, per-call latency percentiles and how many times
each aggregation kernel launched. With `--compare-direct` it also times
the uncached per-request path (`core.evaluate.predict_kernels`) on the
same stream and reports the speedup and the max prediction delta.

  PYTHONPATH=src python -m repro_torch.launch.serve_costmodel \\
      --programs 8 --rounds 4 --compare-direct

Flags (as in the reference, plus --device):
  --programs N        synthetic programs in the corpus        (default 8)
  --max-configs N     tile candidates per kernel              (default 16)
  --rounds N          search passes over each kernel          (default 4)
  --subset F          candidate fraction sampled per round    (default 0.75)
  --adjacency A       sparse | dense batching representation  (default sparse)
  --cache-capacity N  LRU prediction-cache entries            (default 65536)
  --node-budget N     sparse pack budget / coalescer flush    (default 8*max_nodes)
  --chunk N           dense chunk width                       (default 128)
  --hidden-dim N      model width (untrained params)          (default 48)
  --seed N            corpus/model seed                       (default 0)
  --compare-direct    also time uncached per-request scoring
  --device D          cuda | cpu                              (default cuda)

The GraphSAGE aggregation runs through the hand-written CUDA kernels
(their plain PyTorch versions on cpu).

Not ported yet, and refused with an error: --precision int8, --listen,
--connect (and their --max-queue, --deadline-ms, --snapshot).
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Replay a tile-search query stream through the "
                    "cost-model prediction service on the card.")
    ap.add_argument("--programs", type=int, default=8)
    ap.add_argument("--max-configs", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--subset", type=float, default=0.75)
    ap.add_argument("--adjacency", choices=("sparse", "dense"),
                    default="sparse")
    ap.add_argument("--cache-capacity", type=int, default=65536)
    ap.add_argument("--node-budget", type=int, default=None)
    ap.add_argument("--chunk", type=int, default=128)
    ap.add_argument("--hidden-dim", type=int, default=48)
    ap.add_argument("--precision", choices=("f32", "int8"), default="f32")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compare-direct", action="store_true")
    ap.add_argument("--device", default="cuda")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--listen", metavar="HOST:PORT")
    mode.add_argument("--connect", metavar="HOST:PORT")
    ap.add_argument("--max-queue", type=int, default=64)
    ap.add_argument("--deadline-ms", type=float, default=None)
    ap.add_argument("--snapshot", default=None)
    args = ap.parse_args(argv)

    if args.listen or args.connect:
        ap.error("--listen/--connect (the socket server and client) are "
                 "not ported to repro_torch yet; use repro.launch."
                 "serve_costmodel")
    if args.precision != "f32":
        ap.error("--precision int8 is not ported to repro_torch yet")

    from repro_torch.core.device import resolve_device
    from repro_torch.core.evaluate import make_predict_fn, predict_kernels
    from repro_torch.core.model import CostModelConfig, cost_model_init
    from repro_torch.kernels import graph_aggregate, segment_aggregate
    from repro_torch.serving import CostModelService
    from repro_torch.serving.replay import build_tile_replay, run_replay

    device = resolve_device(args.device)
    replay = build_tile_replay(args.programs, max_configs=args.max_configs,
                               rounds=args.rounds, subset=args.subset,
                               seed=args.seed)
    max_nodes = max(g.num_nodes for r in replay.requests for g in r)
    cfg = CostModelConfig(gnn="graphsage", reduction="column_wise",
                          hidden_dim=args.hidden_dim, opcode_embed_dim=16,
                          dropout=0.0, max_nodes=max_nodes,
                          adjacency=args.adjacency,
                          use_pallas_aggregate=True)
    model = cost_model_init(torch.Generator().manual_seed(args.seed), cfg,
                            device=device)
    predict_fn = make_predict_fn(cfg)
    print(f"replay: {replay.num_kernels} kernels, "
          f"{len(replay.requests)} requests, {replay.num_queries} queries "
          f"({replay.num_unique} unique graphs), adjacency={args.adjacency}, "
          f"device={device}")

    def make_service() -> CostModelService:
        return CostModelService(model, cfg, replay.normalizer,
                                cache_capacity=args.cache_capacity,
                                node_budget=args.node_budget,
                                chunk=args.chunk, predict_fn=predict_fn)

    # warm-up pass on a throwaway service: builds the kernels and brings
    # every bucket shape through once before the timed pass
    run_replay(make_service().predict_many, replay.requests)
    _sync(device)

    service = make_service()
    graph_aggregate.launches = segment_aggregate.launches = 0
    t0 = time.perf_counter()
    preds, _ = run_replay(service.predict_many, replay.requests)
    _sync(device)
    dt = time.perf_counter() - t0
    print(f"service: {replay.num_queries / dt:.0f} queries/s "
          f"({dt:.2f}s total)")
    print(service.stats().summary())
    print(f"kernel launches: graph_aggregate={graph_aggregate.launches} "
          f"segment_aggregate={segment_aggregate.launches}")

    if args.compare_direct:
        def direct(graphs):
            return predict_kernels(model, cfg, graphs, replay.normalizer,
                                   max_nodes=max_nodes, chunk=args.chunk,
                                   predict_fn=predict_fn,
                                   node_budget=args.node_budget)
        run_replay(direct, replay.requests)
        _sync(device)
        t0 = time.perf_counter()
        dpreds, _ = run_replay(direct, replay.requests)
        _sync(device)
        ddt = time.perf_counter() - t0
        err = max(float(np.max(np.abs(a - b)))
                  for a, b in zip(preds, dpreds))
        print(f"direct (uncached per-request): "
              f"{replay.num_queries / ddt:.0f} queries/s ({ddt:.2f}s)")
        print(f"speedup {ddt / dt:.2f}x, max prediction delta {err:.2e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

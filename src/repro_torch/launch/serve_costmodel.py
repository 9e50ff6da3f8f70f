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

Two more modes put the same service behind a socket
(`repro_torch.serving.server`, the reference's wire protocol, so either
package's client talks to either package's server):

  # serve: build the model on the card once, answer predict requests
  # until SIGINT
  PYTHONPATH=src python -m repro_torch.launch.serve_costmodel \\
      --listen 127.0.0.1:7450 --snapshot warm.npz

  # connect: replay the query stream against a running server
  PYTHONPATH=src python -m repro_torch.launch.serve_costmodel \\
      --connect 127.0.0.1:7450

`--connect` needs no card and never imports torch: the graphs travel as
JSON and scoring happens server-side.

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
  --precision P       f32 | int8 serving weights (int8 runs   (default f32)
                      `repro_torch.quant.quantize_params` on
                      the init params, calibrated on the
                      stream's first 4 requests)
  --seed N            corpus/model seed                       (default 0)
  --compare-direct    also time uncached per-request scoring
  --device D          cuda | cpu (local replay and --listen)  (default cuda)
  --listen H:P        serve over a socket instead of replaying locally
  --connect H:P       replay against a running --listen server
  --max-queue N       --listen: admission queue bound         (default 64)
  --deadline-ms F     --listen: default per-request deadline  (default none)
  --snapshot PATH     --listen: warm-cache npz (restored at start,
                      written at shutdown)

The GraphSAGE aggregation runs through the hand-written CUDA kernels
(their plain PyTorch versions on cpu); with --precision int8 the sparse
hop takes the kernel's int8-weight variant.
"""
from __future__ import annotations

import argparse
import sys
import threading
import time


def _host_port(spec: str) -> tuple[str, int]:
    host, _, port = spec.rpartition(":")
    if not host or not port.isdigit():
        raise argparse.ArgumentTypeError(
            f"expected HOST:PORT, got {spec!r}")
    return host, int(port)


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _maybe_quantize(model, cfg, replay, args):
    """--precision int8: quantize the weights per channel, calibrating on
    the stream's first 4 requests; returns the (model, cfg) to serve."""
    if args.precision != "int8":
        return model, cfg
    from repro_torch.quant import quantize_params

    calib = [g for req in replay.requests[:4] for g in req]
    qm = quantize_params(model, cfg, calib_graphs=calib,
                         normalizer=replay.normalizer)
    cfg = qm.serving_config()
    return qm.model(cfg), cfg


def _serve(args, service) -> int:
    """--listen: put `service` behind a socket server until SIGINT."""
    from repro_torch.serving.server import CostModelServer

    host, port = args.listen
    server = CostModelServer(service, host=host, port=port,
                             max_queue=args.max_queue,
                             default_deadline_ms=args.deadline_ms,
                             snapshot_path=args.snapshot)
    server.start()
    bound = server.address
    print(f"serving cost model on {bound[0]}:{bound[1]} "
          f"(max_queue={args.max_queue}, "
          f"restored {server.stats.restored_entries} warm entries); "
          f"SIGINT stops", flush=True)
    try:
        threading.Event().wait()       # serve until interrupted
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
        print(f"stopped; served {server.stats.completed} requests "
              f"({server.stats.shed_overloaded} shed)", flush=True)
    return 0


def _connect(args) -> int:
    """--connect: replay the query stream through a running server.
    Needs no card and no torch: graphs go out as JSON."""
    from repro_torch.serving.client import CostModelClient
    from repro_torch.serving.replay import build_tile_replay, run_replay

    replay = build_tile_replay(args.programs, max_configs=args.max_configs,
                               rounds=args.rounds, subset=args.subset,
                               seed=args.seed)
    host, port = args.connect
    with CostModelClient(host, port) as client:
        client.ping()
        _, dt = run_replay(
            lambda gs: client.predict_many(gs, deadline_ms=args.deadline_ms),
            replay.requests)
        stats = client.stats()
    print(f"replayed {replay.num_queries} queries "
          f"({len(replay.requests)} requests) in {dt:.2f}s -> "
          f"{replay.num_queries / dt:.0f} queries/s")
    svc = stats["service"]
    print(f"server: hit_rate={svc['hit_rate']:.1%} "
          f"flushes={svc['flushes']} "
          f"completed={stats['server']['completed']} "
          f"shed={stats['server']['shed_overloaded']}")
    return 0


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
    mode.add_argument("--listen", type=_host_port, metavar="HOST:PORT")
    mode.add_argument("--connect", type=_host_port, metavar="HOST:PORT")
    ap.add_argument("--max-queue", type=int, default=64)
    ap.add_argument("--deadline-ms", type=float, default=None)
    ap.add_argument("--snapshot", default=None)
    args = ap.parse_args(argv)

    if args.connect:
        return _connect(args)

    import numpy as np
    import torch

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
    model, cfg = _maybe_quantize(model, cfg, replay, args)
    predict_fn = make_predict_fn(cfg)
    print(f"replay: {replay.num_kernels} kernels, "
          f"{len(replay.requests)} requests, {replay.num_queries} queries "
          f"({replay.num_unique} unique graphs), adjacency={args.adjacency}, "
          f"precision={cfg.precision}, device={device}")

    def make_service() -> CostModelService:
        return CostModelService(model, cfg, replay.normalizer,
                                cache_capacity=args.cache_capacity,
                                node_budget=args.node_budget,
                                chunk=args.chunk, predict_fn=predict_fn)

    if args.listen:
        return _serve(args, make_service())

    # warm-up pass on a throwaway service: builds the kernels and brings
    # every bucket shape through once before the timed pass
    run_replay(make_service().predict_many, replay.requests)
    _sync(device)

    service = make_service()
    graph_aggregate.launches = segment_aggregate.launches = 0
    segment_aggregate.launches_i8 = 0
    t0 = time.perf_counter()
    preds, _ = run_replay(service.predict_many, replay.requests)
    _sync(device)
    dt = time.perf_counter() - t0
    print(f"service: {replay.num_queries / dt:.0f} queries/s "
          f"({dt:.2f}s total)")
    print(service.stats().summary())
    print(f"kernel launches: graph_aggregate={graph_aggregate.launches} "
          f"segment_aggregate={segment_aggregate.launches} "
          f"segment_aggregate_i8={segment_aggregate.launches_i8}")

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

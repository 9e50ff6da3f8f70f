#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each reported on its own lines; any failure exits non-zero:

1. device  — the card's name and power limit (nvidia-smi), the torch and
             CUDA versions; TF32 is switched off for matmuls and cuDNN.
2. build   — compiles every hand-written kernel from `src/repro_torch/
             kernels/csrc` with nvcc (one process per source, in parallel).
3. kernels — holds each kernel against its plain PyTorch version on the
             card at the serving path's shapes, with the stated tolerance,
             and times both with CUDA events beside the kernel's bound.
4. serve   — replays the tile-search query stream through the port's
             `CostModelService` at the full width of the default
             `CostModelConfig` with the kernels on, once per layout
             (sparse → segment_aggregate, dense → graph_aggregate), counts
             the kernel launches of each run, and checks the predictions
             against the same service with the kernels off.

The line before the last is a JSON object with one entry per kernel; the
last line is `{"ok": true, "device": {...}}`. Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no
result. It imports nothing of the JAX package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
FEATURES = 192            # CostModelConfig().hidden_dim
DENSE_BATCH = 128         # CostModelService chunk
WARMUP, ITERS = 5, 50


def log(*parts) -> None:
    print(*parts, flush=True)


def time_ms(fn) -> float:
    """Mean device time of `fn()` over ITERS launches, after WARMUP."""
    import torch
    for _ in range(WARMUP):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def device_profile(fn) -> tuple[dict, float]:
    """Run `fn()` once under torch.profiler. Returns ({kernel name:
    (launches, device µs)} over the CUDA kernels it ran, wall seconds)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return ({e.key: (e.count, e.self_device_time_total)
             for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA}, wall)


def _short(kernel_name: str) -> str:
    name = kernel_name.replace("(anonymous namespace)::", "")
    return name.removeprefix("void ").split("(")[0].split("<")[0][:32]


def device_ms(fn) -> tuple[float, str]:
    """Device time of one `fn()` call: the CUDA kernel time of ITERS calls
    under the profiler, divided by ITERS (nan when the profiler sees no
    device activity), and its split by kernel."""
    def many():
        for _ in range(ITERS):
            fn()
    kernels, _ = device_profile(many)
    total = sum(us for _, us in kernels.values())
    split = " + ".join(f"{_short(name)} {us / ITERS / 1e3:.4f}"
                       for name, (_, us) in sorted(kernels.items()))
    return (total / ITERS / 1e3 if kernels else float("nan")), split


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------- 1
def phase_device() -> str:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {torch.cuda.get_device_name(0)} "
        f"count={torch.cuda.device_count()} torch={torch.__version__} "
        f"cuda={torch.version.cuda} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return card


# --------------------------------------------------------------------- 2
def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    reports = build.build()
    seconds = time.perf_counter() - t0
    log(f"[build] {len(build.SOURCES)} kernel sources with "
        f"{os.path.basename(build.nvcc())} in {seconds:.2f} s "
        f"(compiled: {sorted(reports) or 'none, up to date'})")
    for name, report in sorted(reports.items()):
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


# --------------------------------------------------------------------- 3
def _replay():
    from repro_torch.serving.replay import build_tile_replay
    return build_tile_replay(8, max_configs=16, rounds=4, subset=0.75,
                             seed=0)


def _packed_edges(replay, node_budget: int):
    """The first pack of the stream's distinct graphs at `node_budget`,
    encoded as the service encodes it: real indices and masks."""
    from repro_torch.data.batching import bucket_for, encode_packed, \
        pack_graphs
    seen, graphs = set(), []
    for req in replay.requests:
        for g in req:
            key = g.canonical_hash()
            if key not in seen:
                seen.add(key)
                graphs.append(g)
    pack = pack_graphs(graphs, node_budget, oversized="singleton")[0]
    part = [graphs[i] for i in pack]
    return encode_packed(part, replay.normalizer, spec=bucket_for(part))


def check_graph_aggregate(gen) -> dict:
    import torch
    from repro_torch.kernels import graph_aggregate as ga
    dev = torch.device("cuda")
    B, D, F = DENSE_BATCH, FEATURES, FEATURES
    w = (torch.randn((D, F), generator=gen) / D ** 0.5).to(dev)
    row = None
    for N in (17, 64):
        # kernel-graph density: about two in-edges per node
        adj = (torch.rand((B, N, N), generator=gen) < 2.0 / N).float()
        adj, x = adj.to(dev), torch.randn((B, N, D), generator=gen).to(dev)
        for mean in (True, False):
            out = ga.graph_aggregate(adj, x, w, act="relu", mean=mean)
            ref = ga.graph_aggregate_plain(adj, x, w, act="relu", mean=mean)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            tol = 1e-5 * max(1.0, float(ref.abs().max()))
            def run():
                return ga.graph_aggregate(adj, x, w, mean=mean)

            def plain():
                return ga.graph_aggregate_plain(adj, x, w, mean=mean)
            ms, plain_ms = time_ms(run), time_ms(plain)
            (dev_ms, split), (dev_plain_ms, _) = device_ms(run), \
                device_ms(plain)
            nbytes = 4 * (B * N * N + B * N * D + D * F + B * N * F)
            flops = 2 * B * N * D * F + 2 * B * N * N * F
            b_ms, b_by = bound(nbytes, flops)
            log(f"[kernels] graph_aggregate B={B} N={N} D={D} F={F} "
                f"{'mean' if mean else 'sum'}: max_abs_err={err:.3e} "
                f"(tol {tol:.3e}) kernel {ms:.4f} ms (device {dev_ms:.4f}), "
                f"plain {plain_ms:.4f} ms (device {dev_plain_ms:.4f}), "
                f"bound {b_ms:.4f} ms ({b_by}); kernel device split: {split}")
            if not err <= tol:
                raise AssertionError(
                    f"graph_aggregate N={N} mean={mean}: {err} > {tol}")
            if N == 64 and mean:
                row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": b_ms, "bound_by": b_by}
    return row


def check_segment_aggregate(gen, replay) -> dict:
    import torch
    from repro_torch.kernels import segment_aggregate as sa
    dev = torch.device("cuda")
    D, F = FEATURES, FEATURES
    w = (torch.randn((D, F), generator=gen) / D ** 0.5).to(dev)
    scale = torch.ones((F,), device=dev)
    row = None
    for budget in (64, 512):
        b = _packed_edges(replay, budget)
        M, E = b.num_nodes, b.num_edges
        nm = torch.from_numpy(b.node_mask).to(dev)
        edges = sa.edge_csr(torch.from_numpy(b.edge_src).to(dev),
                            torch.from_numpy(b.edge_dst).to(dev),
                            torch.from_numpy(b.edge_mask).to(dev), M)
        x = torch.randn((M, D), generator=gen).to(dev)
        m_real, e_real = float(b.node_mask.sum()), float(b.edge_mask.sum())
        for mean in (True, False):
            def run():
                return sa.segment_aggregate(x, w, scale, edges, nm,
                                            mean=mean)

            def plain():
                return sa.segment_aggregate_plain(
                    x, w, scale, edges.gather, edges.scatter,
                    edges.edge_mask, nm, mean=mean)
            out, ref = run(), plain()
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            tol = 1e-5 * max(1.0, float(ref.abs().max()))
            ms, plain_ms = time_ms(run), time_ms(plain)
            (dev_ms, split), (dev_plain_ms, _) = device_ms(run), \
                device_ms(plain)
            nbytes = 4 * (M * D + D * F + F + M + (M + 1) + 2 * E + M * F)
            flops = 2 * m_real * D * F + 2 * e_real * F
            b_ms, b_by = bound(nbytes, flops)
            log(f"[kernels] segment_aggregate M={M} E={E} (real "
                f"{int(m_real)} nodes, {int(e_real)} edges) D={D} F={F} "
                f"{'mean' if mean else 'sum'}: max_abs_err={err:.3e} "
                f"(tol {tol:.3e}) kernel {ms:.4f} ms (device {dev_ms:.4f}), "
                f"plain {plain_ms:.4f} ms (device {dev_plain_ms:.4f}), "
                f"bound {b_ms:.4f} ms ({b_by}); kernel device split: {split}")
            if not err <= tol:
                raise AssertionError(
                    f"segment_aggregate M={M} mean={mean}: {err} > {tol}")
            if budget == 512 and mean:
                row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": b_ms, "bound_by": b_by}
        # integer-valued inputs: every sum is exact, so bit-exact
        xi = torch.randint(-3, 4, (M, D), generator=gen).float().to(dev)
        wi = torch.randint(-5, 6, (D, F), generator=gen).float().to(dev)
        for mean in (True, False):
            out = sa.segment_aggregate(xi, wi, scale, edges, nm, mean=mean)
            ref = sa.segment_aggregate_plain(xi, wi, scale, edges.gather,
                                             edges.scatter, edges.edge_mask,
                                             nm, mean=mean)
            if not torch.equal(out, ref):
                raise AssertionError(
                    f"segment_aggregate M={M} mean={mean}: integer inputs "
                    f"not bit-exact (max diff "
                    f"{float((out - ref).abs().max())})")
        log(f"[kernels] segment_aggregate M={M} integer inputs: bit-exact "
            f"(mean and sum)")
    return row


# --------------------------------------------------------------------- 4
def serve(replay, layout: str) -> dict:
    import numpy as np
    import torch
    from repro_torch.core.evaluate import make_predict_fn
    from repro_torch.core.model import CostModelConfig, cost_model_init
    from repro_torch.kernels import graph_aggregate as ga
    from repro_torch.kernels import segment_aggregate as sa
    from repro_torch.serving import CostModelService
    from repro_torch.serving.replay import run_replay

    def service(use_kernels: bool) -> tuple[CostModelService, object]:
        cfg = CostModelConfig(use_pallas_aggregate=use_kernels, dropout=0.0,
                              adjacency=layout)
        model = cost_model_init(torch.Generator().manual_seed(0), cfg,
                                device="cuda")
        return (CostModelService(model, cfg, replay.normalizer,
                                 predict_fn=make_predict_fn(cfg)), cfg)

    warm, cfg = service(True)
    run_replay(warm.predict_many, replay.requests)      # warm-up pass
    torch.cuda.synchronize()
    svc, _ = service(True)
    ga.launches = sa.launches = 0
    t0 = time.perf_counter()
    preds, _ = run_replay(svc.predict_many, replay.requests)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"graph_aggregate": ga.launches,
                "segment_aggregate": sa.launches}
    st = svc.stats()
    # where the time goes: one more pass on a fresh service, profiled
    prof_svc, _ = service(True)
    kernels, wall = device_profile(
        lambda: run_replay(prof_svc.predict_many, replay.requests))
    busy = sum(us for _, us in kernels.values()) / 1e6
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:6]
    log(f"[serve] {layout} profiled pass: wall {wall:.3f} s, device busy "
        f"{busy:.4f} s ({busy / wall:.1%}), {sum(c for c, _ in kernels.values())}"
        f" kernel launches")
    for name, (count, us) in top:
        log(f"[serve]   {us / 1e3:9.3f} ms {count:6d}x  {_short(name)}")
    plain_svc, _ = service(False)
    ref, _ = run_replay(plain_svc.predict_many, replay.requests)
    got, want = np.concatenate(preds), np.concatenate(ref)
    err = float(np.max(np.abs(got - want)))
    tol = 1e-4 * max(1.0, float(np.max(np.abs(want))))
    log(f"[serve] {layout}: {replay.num_queries / dt:.1f} queries/s "
        f"({replay.num_queries} queries, {dt:.3f} s) "
        f"hit_rate={st.hit_rate:.4f} flushes={st.flushes} "
        f"p50={st.latency_p50_ms:.3f} ms p99={st.latency_p99_ms:.3f} ms "
        f"launches={launches} hidden={cfg.hidden_dim} "
        f"reduction={cfg.reduction} max_abs_err vs kernels off="
        f"{err:.3e} (tol {tol:.3e})")
    if got.shape != (replay.num_queries,) or not np.all(np.isfinite(got)):
        raise AssertionError(f"{layout}: predictions not finite or of "
                             f"shape ({replay.num_queries},)")
    if not err <= tol:
        raise AssertionError(f"{layout}: kernels on vs off {err} > {tol}")
    kernel = "segment_aggregate" if layout == "sparse" else \
        "graph_aggregate"
    if launches[kernel] == 0:
        raise AssertionError(f"{layout}: {kernel} never launched")
    return {"launches": launches[kernel], "preds": got}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)

    phase_device()
    phase_build()
    replay = _replay()
    log(f"[serve] replay: {replay.num_kernels} kernels, "
        f"{len(replay.requests)} requests, {replay.num_queries} queries, "
        f"{replay.num_unique} unique graphs")
    gen = torch.Generator().manual_seed(0)
    rows = {"graph_aggregate": check_graph_aggregate(gen),
            "segment_aggregate": check_segment_aggregate(gen, replay)}
    sparse = serve(replay, "sparse")
    dense = serve(replay, "dense")
    import numpy as np
    err = float(np.max(np.abs(sparse["preds"] - dense["preds"])))
    tol = 1e-4 * max(1.0, float(np.max(np.abs(dense["preds"]))))
    log(f"[serve] sparse vs dense layout: max_abs_err={err:.3e} "
        f"(tol {tol:.3e})")
    if not err <= tol:
        raise AssertionError(f"sparse vs dense layouts: {err} > {tol}")

    rows["graph_aggregate"].update(launches=dense["launches"])
    rows["segment_aggregate"].update(launches=sparse["launches"])
    kernels = []
    for name, replaces in (
            ("graph_aggregate",
             "src/repro/kernels/graph_aggregate/kernel.py:45"),
            ("segment_aggregate",
             "src/repro/kernels/segment_aggregate/kernel.py:89")):
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": r["launches"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

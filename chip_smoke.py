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
             and times both with CUDA events and the profiler beside the
             kernel's bound (split tf32 for the aggregation kernels, the
             fp32 bound beside it), its issued tf32 rate and its device
             time by launch: `graph_aggregate` at N = 17, 64, 100 and
             512 (the last keeps its messages in a device scratch),
             `segment_aggregate` with f32 weights at the replay's packs
             (64, 512, a ragged pack) and one node, fused launch vs. two
             launches, and with int8 weights at the 512 pack and at the
             inner batch of one 10k-node whole program segmented at a
             budget of 512 (f32 too); integer inputs bit-exact; planted
             faults (an adjacency entry flipped, an edge left out of the
             CSR) must fail the check.
4. serve   — replays the tile-search query stream through the port's
             `CostModelService` at the full width of the default
             `CostModelConfig` with the kernels on, once per layout
             (sparse → segment_aggregate, dense → graph_aggregate), counts
             the kernel launches of each run, and checks the predictions
             against the same service with the kernels off.
5. int8    — the same stream through a `QuantizedCostModel` of that model
             (calibrated on the stream's first 4 requests, as the CLI
             does), sparse (→ segment_aggregate's int8 variant) and dense
             (→ graph_aggregate on dequantized weights), each against the
             int8 service with the kernels off.
6. segmented — whole programs: the stream plus 4 requests of one
             10k-node `whole_model_graph` each, through the segmented
             backend (column-wise reduction, budget 512), in f32 and int8,
             each against the kernels off; graphs within the budget score
             as through the sparse service.
7. train   — the cost model trained on the card (`CostModelTrainer`, the
             default `CostModelConfig()` width, dropout 0.1, kernels
             off: they have no backward) on the tile dataset of
             `generate_corpus(48)` (`train cost-model`'s corpus, split by
             program): 300 steps dense and 300 sparse (4 kernels x 8
             tiles a step), and 20 steps of the fusion task on two
             10k-node `whole_model_records`, segmented at a budget of
             512 (two a step). Each run prints ms per step (CUDA events
             over 50 steps; 10 for the segmented run), steps/s, the loss
             of step 1 and of the last step, device busy and kernel
             launches per step (a profiled window of 20 steps; 9), and
             peak memory; fails on a non-finite loss, and (dense,
             sparse) unless the final model's held-out loss (a fixed
             batch of the test programs, dropout off) is below the
             step-0 model's. Resume: a trainer checkpointed at step 150
             and a fresh one resumed from it to 300 match the
             uninterrupted dense run within 1e-6 of each leaf's largest
             value. The final checkpoint, read back with
             `load_jax_checkpoint`, scores the held-out tile records
             through `CostModelService` with the kernels on (dense →
             graph_aggregate, sparse → segment_aggregate) against the
             kernels off, as in 4.
8. zoo-kernels — the LM zoo's kernels against their plain versions:
             `flash_attention` at h2o-danube-3-4b's layer shape (B=2,
             S=8192, H=32, KH=8, hd=120, causal, window 4096) in bf16
             (the tensor-core kernel) and in f32 (the split-TF32 kernel),
             at hd=128 and non-causal (bf16) and at S=1024 in f32 (hd 120
             and 64, q x 1 and x 3), at the full-causal bf16 layers of
             granite-moe-3b-a800m (H=24, KH=8, hd=64), musicgen-large
             (32, 32, 64) and llava-next-34b (56, 8, 128), and the hd-256
             routes (bf16 by wgmma, f32 by split-TF32 wgmma) at
             recurrentgemma-9b's local attention (H=16, KH=1, hd=256,
             window 2048; f32 also at S=1024, q x 3), timed beside
             PyTorch's scaled_dot_product_attention on the same inputs
             (the yardstick only), each held element by element (f32
             against the plain version in float64); at h2o's and
             recurrentgemma's layer shapes, in both dtypes, planted faults
             (window off by one, 64 keys left out) must fail that check;
             `ssd_scan` at
             Mamba2-2.7b's full shapes (B=2, nc=32, H=80, N=128, P=64),
             bit-exact; `decode_attention` (bf16) at musicgen-large's
             decode step (B=64, 32/32 heads, hd 64: the self cache of 504
             slots at position 250, the cross cache of 64 text keys), at
             granite-moe-3b-a800m's batch-4 decode (24/8 heads, a
             4096-slot cache at position 2047, split over blocks), at the
             serve loop's shapes of 10 and 20 (batch 4, 576 slots,
             position 544: h2o-danube-3-4b's 32/8 heads at hd 120 and
             window 4096, recurrentgemma-9b's 16/1 at hd 256 and window
             2048) and at recurrentgemma's ring of 2048 past its wrap,
             held within one bf16 ulp of the output's largest element and
             timed beside its bytes' bound, the plain version and
             PyTorch's scaled_dot_product_attention over the same slots.
9. lm-forward — the full h2o-danube-3-4b (24 layers, bf16, random
             weights from seed 0) scores 2 x 8192 tokens through
             `loss_fn` with the flash kernel (24 launches, all of the
             tensor-core kernel) and with
             `chunked_attention`; loss and last-position logits agree
             within the stated bf16 tolerance; layer 0's attention on
             the model's own inputs is held against the plain version
             and `chunked_attention`, and planted faults (output zeroed,
             window 64 keys short) must fail the latter; what the
             end-to-end limits make of those faults is printed.
10. lm-serve — the port's serve loop (`repro_torch.launch.serve`) on the
             same model: batch 4, prompt 512, 64 greedy decode steps;
             prefill on 511 tokens + decode of token 512 agrees with the
             forward's last-position logits; the loop's own
             `decode_attention` call at position 544 is held against the
             plain version on its inputs, as in every serve loop below.
11. lm-forward-f32 — the same model in f32 (its seed-0 weights cast, the
             bf16 ones released): `loss_fn` over the same 2 x 8192 tokens
             with the flash kernel (24 launches of the split-TF32 kernel)
             and with `chunked_attention`, held as in 9 to f32 limits.
12. autotune — what consumes the scores, on the models 7 trained: the
             Table-2 tile task (`eval_tile_task`) over the 42 held-out
             tile records through the trained sparse service
             (segment_aggregate) and dense one (graph_aggregate), each
             against the kernels off (scores within 1e-4·max|pred|,
             metrics moved only by ties within it), and analytical; the
             tile autotuner (`autotune_program_tiles`, max_configs 24 as
             bench_fig4.py) on the held-out programs' default-fused
             kernels: learned top-1 and top-10 through both layouts (picks
             equal to the kernels off but for ties), analytical top-10 and
             exhaustive (no total below the exhaustive one); the fusion
             annealer on examples/fusion_search.py's three programs (6 s
             budget, 300 model steps) scored by `model_cost_fn` of the
             trained segmented fusion model (speedup >= 1, hardware evals
             within the budget, every scored decision re-scored with the
             kernels off); a `CostModelServer` on 127.0.0.1:0 over the
             trained sparse service with 4 client threads replaying the
             stream (answers as in process, no error frames), a planted
             drop (the client's clean error), snapshot -> restart ->
             replay (100 % hits), and one round with the model in int8
             (segment_aggregate_i8).
13. gat-lstm — the stream through GAT (dense, sparse) and graphsage +
             LSTM (dense with graph_aggregate, sparse with
             segment_aggregate) at the default width, seed-0 weights:
             layouts agree, kernels on vs off agree, card vs CPU of the
             same weights agree; one segmented graphsage + LSTM pass over
             a 10k-node program, timed; 50 dense training steps each of
             GAT and of LSTM (finite losses, the held-out loss falls).
14. flywheel — benchmarks/bench_flywheel.py's scenario at its own
             constants, on the port (`paper_tile_model()`: graphsage +
             LSTM, hidden 64, dropout 0.1, dense): the base store built
             by `python -m repro_torch.launch.build_corpus --workers 2`
             (manifest hash equal to an in-process `write_corpus`), the
             static model trained 120 steps on the card, the hard set
             of 6 of 20 pool kernels, then `run_flywheel` (3 rounds,
             MC-dropout acquisition and scoring through graph_aggregate,
             120 fine-tune steps a round). Gates: regret margin over the
             static plan > 0, the delta chain byte-identical to a
             rebuild, warm start within 0.5 of scratch's steps; MC mean
             and std with the kernels on vs off within 1e-4·max|pred|,
             dense and sparse (segment_aggregate); a 40-step fine-tune
             with the input pipeline on (depth 2, device copies on a side
             stream) bit-identical to it off, step for step, then timed
             and profiled both ways; `train cost-model --from-store
             --deltas --warm-start` and, beside it, `launch.flywheel`
             twice (the second appends to the delta chain), each in its
             own process, all beside the warm-start gate.
15. ddp    — data-parallel training of the cost model on [train]'s
             corpus and width (dense, dropout 0.1, 50 steps a run):
             dp=0 against dp=1 (an NCCL group of one rank), bit-identical
             loss, params and AdamW state; dp=2 as two spawned ranks on
             the one card over gloo, plain and with the int8
             error-feedback all-reduce (`--compress-grads`): params
             bit-equal across the ranks, held-out loss falling; ms per
             step by CUDA events and the share of it in the step's
             reduction, per run; each dp=2 checkpoint restored under
             dp=1 bit-exactly (the int8 one with its residuals at zero),
             and the plain one served through graph_aggregate (dense)
             and segment_aggregate (sparse) against the kernels off.
             Scaling over cards is not measured: one card.
16. lm-train — the LM train step (`models.lm.train_step_fn`) at
             h2o-danube-3-4b's full width and depth (24 layers, bf16,
             remat full; the depth is cut only if it does not fit, and
             the cut printed), 4 x 2048 tokens in microbatches of 2 (the
             config's 16 overridden), one repeated batch from seed 0: 3
             steps with AdamW (then one profiled step) and 3 with
             Adafactor (lr 1e-2; its first step `grad_of_scan`), each
             from the seed-0 params: finite losses that fall, the two
             accumulation modes' step-1 losses equal within 1e-6; s per
             step, tokens/s, model TFLOP/s (6·N·tokens/s) and peak memory.
17. lm-moe — granite-moe-3b-a800m at its full config (32 layers, d 1536,
             24 heads over 8 kv heads at hd 64, 40 experts top-8, bf16,
             seed-0 weights): the pairs each MoE layer drops at capacity
             over 2 x 8192 tokens; `loss_fn` with the flash kernel (32
             launches of the tensor-core kernel at hd 64) and with
             `chunked_attention`, held as in 9 (planted faults for a
             full-causal layer: output zeroed, causal mask off, 64 future
             keys seen); `prefill_step_fn` over the same tokens with
             the flag (32 launches of the tensor-core kernel, the route
             of the benchmark's granite cells) and without (none): last
             logits within the same limit, layer 0's caches bit for bit;
             layer 0's `moe_apply` in f32 on the card against
             the CPU (routing and capacity alike but for top-k
             near-ties, which are counted); the serve loop as in 10,
             whose decode check first asserts that no token was dropped.
18. lm-frontends — musicgen-large at its full config (48 layers, hd 64,
             32 heads, bf16): `loss_fn` over `make_batch`'s 2 x 8192 frame
             embeddings and labels, flash (48 launches) vs chunked; prefill
             on 511 frame embeddings + decode of a token against the
             forward over the same frames and that token's embedding, then
             greedy steps. llava-next-34b at full width (d 7168, 56 heads
             over 8 at hd 128) and 30 of its 60 layers (45 fit beside the
             forward; the script's time limit cuts the rest, as printed):
             `loss_fn` over 1152 patch
             positions + 7040 tokens a sequence, flash vs chunked; prefill
             with the patches + decode of the last token against the
             chunked forward's last position.
19. lm-ssd — mamba2-2.7b at its full config (64 SSD layers, d 2560,
             state 128, chunk 256, bf16): `loss_fn` over 2 x 8192 tokens,
             timed and profiled, no flash and no ssd_scan launch (the
             mixer runs the reference's chunked algorithm); prefill on
             8191 tokens (padded to the chunk) + decode of the last
             against the forward; the serve loop as in 10.
20. lm-rglru — recurrentgemma-9b at full width (d 4096, RG-LRU width
             4096, 16 heads over 1 kv head at hd 256, window 2048, bf16,
             seed-0 weights) and its full 38 layers, or the deepest cut of
             (lru, lru, attn) blocks that fits (printed): `loss_fn` over
             2 x 8192 tokens with the flash kernel (12 launches of the
             hd-256 bf16 route) and with `chunked_attention`, held as in 9;
             layer 0's RG-LRU mixer in f32, card vs CPU; the serve loop as
             in 10. Then its first (lru, lru, attn) block in f32 through
             the same checks on the hd-256 f32 route.
21. import — the program importer (`core/hlo_import`) on the card: the
             smoke `loss_fn` of benchmarks/common.py's five archs (yi-9b,
             mamba2-2.7b, granite-moe-3b-a800m, recurrentgemma-9b,
             musicgen-large) traced into programs (nodes, DOTs, DOT FLOPs,
             seconds; each equal to the CPU's trace by kernel_hash), then
             a 10k-node `whole_model_graph` of their blocks scored through
             the segmented service (budget 512, segment_aggregate) in f32
             and int8, kernels on vs off within 1e-4·max|pred|.
22. lm-mla — deepseek-v3-671b (MLA, absorbed decode) at full width,
             its depth cut (see `phase_lm_mla`).
23. roofline — the dry-run lowering (`launch.lowering`, meta tensors,
             no card; both processes start after 16 and run beside
             17-22) checked against the card: 16's AdamW train cell
             (its depth, 4 x 2048 tokens, microbatch 2) lowered on a 1x1
             mesh in a process of its own: counted FLOPs, model FLOPs
             and their ratio, the H100 compute and memory terms, the
             predicted argument bytes and the peak estimate beside 16's
             measured s a step and peak memory (fails if the compute
             term exceeds the step or the arguments exceed the peak);
             beside it, in a second process, `python -m
             repro_torch.launch.dryrun --arch deepseek-v3-671b --shape
             train_4k --mesh single --workers 4` on a fake 256-rank
             16x16 mesh (its cost and peak from the probes, lowered in
             four processes): per-device params and
             optimizer bytes, whether they and the peak estimate fit
             80 GB and the card's own memory, the ops the lowering ran
             replicated and their share of the collective bytes, and
             the H100 terms, the collective one split into sharded and
             replicated-op bytes.
24. examples — the six example twins (`repro_torch.examples`, the
             reference scripts of examples/) through their `main()` at
             the reference's defaults (one cut, printed:
             train_cost_model's --steps): fusion_search;
             autotune_tilesize, whose Part B ranks the bf16 flash kernel's
             four (block_q, block_k) instantiations and times each on the
             card at S=4096, hd=128 (their launches on the kernels line);
             quickstart, whose serving runs once more with the kernels on
             (dense: graph_aggregate), every record's tile scores held
             against the kernels off (scores within 1e-4·max|pred|, picks
             equal, near-ties counted); serve_lm; train_cost_model dense
             and sparse, evaluating and autotuning with the kernels on
             (graph_aggregate, segment_aggregate), then dense again
             resumed from its checkpoint (the same held-out and autotuner
             lines); autotune_zoo with its estimators on the kernels
             (segment_aggregate), each arch searched again with them off
             (the same fusion decision, tile picks and budget; the learned
             scores of every fused kernel's candidate tiles held as
             above). Then every flash instantiation against the plain
             version at [zoo-kernels]' bf16 layers (h2o-danube-3-4b,
             granite-moe-3b-a800m, musicgen-large, llava-next-34b), each
             timed beside its bound, the plain version and SDPA.

The line before the last is a JSON object with one entry per kernel; the
last line is `{"ok": true, "device": {...}}`. Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no
result. It imports nothing of the JAX package.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12
PEAK_TF32_FLOP_PER_S = 495e12
FEATURES = 192            # CostModelConfig().hidden_dim
DENSE_BATCH = 128         # CostModelService chunk
SEGMENT_BUDGET = 512      # 8 * CostModelConfig().max_nodes
WHOLE_NODES = 10_000      # TpuGraphs-scale programs (bench_giant_graphs)
WHOLE_PROGRAMS = 4
WARMUP, ITERS = 5, 50
DEVICE = "cuda"


def log(*parts) -> None:
    """One line to stdout in one write: lines logged from two threads
    do not interleave."""
    sys.stdout.write(" ".join(map(str, parts)) + "\n")
    sys.stdout.flush()


def time_ms(fn, warmup: int = WARMUP, iters: int = ITERS) -> float:
    """Mean device time of `fn()` over `iters` launches, after `warmup`."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn) -> tuple[dict, float]:
    """Run `fn()` once under torch.profiler. Returns ({kernel name:
    (launches, device µs)} over the CUDA kernels it ran, wall seconds).
    It records the device alone: with the host's ops beside, the
    post-processing of a pass of ~15k launches took ten seconds or more
    (and a step of ~40k, tens)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return ({e.key: (e.count, e.self_device_time_total)
             for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA}, wall)


def _short(kernel_name: str) -> str:
    name = kernel_name.replace("(anonymous namespace)::", "")
    return name.removeprefix("void ").split("(")[0].split("<")[0][:32]


def device_ms(fn, iters: int = ITERS) -> tuple[float, str]:
    """Device time of one `fn()` call: the CUDA kernel time of `iters`
    calls under the profiler, divided by `iters` (nan when the profiler
    sees no device activity), and its split by kernel with the number of
    kernel records each. The calls are profiled as the active step after
    a warm-up step of as many calls (a profile without one missed its
    first kernel records). The profiler still drops a record now and
    then; a kernel whose records are not a multiple of `iters` is marked
    "records lost", and its time then reads low."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    def many():
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = {}

    def collect(prof):              # the step's own span is no kernel
        kernels.update({e.key: (e.count, e.self_device_time_total)
                        for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA
                        and not e.key.startswith("ProfilerStep")})
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=collect) as prof:
        for _ in range(2):
            many()
            prof.step()
    total = sum(us for _, us in kernels.values())
    split = " + ".join(
        f"{_short(name)} {us / iters / 1e3:.4f} ({n}x"
        f"{'' if n % iters == 0 else ', records lost'})"
        for name, (n, us) in sorted(kernels.items()))
    return (total / iters / 1e3 if kernels else float("nan")), split


def bound(nbytes: float, flops: float,
          peak_flops: float = PEAK_FP32_FLOP_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
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


def _pack_graphs(replay, node_budget: int, ragged: bool = False):
    """The graphs of the first pack of the stream's distinct graphs at
    `node_budget` (ragged: the first whose node count is not a multiple
    of 64)."""
    from repro_torch.data.batching import pack_graphs
    seen, graphs = set(), []
    for req in replay.requests:
        for g in req:
            key = g.canonical_hash()
            if key not in seen:
                seen.add(key)
                graphs.append(g)
    packs = [[graphs[i] for i in p]
             for p in pack_graphs(graphs, node_budget, oversized="singleton")]
    return next(p for p in packs
                if not ragged or sum(g.num_nodes for g in p) % 64)


def _packed_edges(replay, node_budget: int):
    """That pack encoded as the service encodes it: real indices and
    masks, bucketed capacities."""
    from repro_torch.data.batching import bucket_for, encode_packed
    part = _pack_graphs(replay, node_budget)
    return encode_packed(part, replay.normalizer, spec=bucket_for(part))


def _tf32_split_bound(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time for f32-accurate products on the tensor cores: the
    split-TF32 route issues three tf32 products per f32 product, so
    `flops` run at PEAK_TF32 / 3 = 165 TFLOP/s (above the fp32 CUDA
    cores' 67)."""
    return bound(nbytes, 3 * flops, PEAK_TF32_FLOP_PER_S)


def _issued_depth(D: int) -> int:
    """Depth the kernels' products issue: D padded to 32 (their depth
    chunks cover exactly that at D = 192, the model's width)."""
    return -(-max(D, 1) // 32) * 32


def _kernel_line(label, err, tol, ms, dev_ms, plain_ms, dev_plain,
                 b_ms, b_by, fp32_ms, issued, split) -> str:
    """One [kernels] line; dev_plain is device_ms() of the plain version."""
    lost = ", records lost" if "records lost" in dev_plain[1] else ""
    return (f"{label}: max_abs_err={err:.3e} (tol {tol:.3e}) kernel "
            f"{ms:.4f} ms (device {dev_ms:.4f}), plain {plain_ms:.4f} ms "
            f"(device {dev_plain[0]:.4f}{lost}), bound {b_ms:.5f} ms ({b_by}, "
            f"split tf32; fp32 bound {fp32_ms:.5f}), bound / call "
            f"{b_ms / ms:.1%}, issued tf32 {issued / dev_ms / 1e9:.1f} "
            f"TFLOP/s on the device; kernel device split: {split}")


def _fault(kind, label, out, ref, tol) -> None:
    """A planted fault must fail the 1e-5·max|ref| check."""
    ratio = float((out - ref).abs().max()) / tol
    log(f"[kernels] planted fault, {kind} {label}: {ratio:.1f} x the "
        f"limit: {'caught' if ratio > 1 else 'MISSED'}")
    if not ratio > 1:
        raise AssertionError(f"{kind}: the check misses {label}")


def check_graph_aggregate(gen) -> dict:
    import torch
    from repro_torch.kernels import graph_aggregate as ga
    dev = torch.device(DEVICE)
    B, D, F = DENSE_BATCH, FEATURES, FEATURES
    w = (torch.randn((D, F), generator=gen) / D ** 0.5).to(dev)
    row = None
    for N in (17, 64, 100, 512):     # 512: the messages go through L2
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
            (dev_ms, split), dev_plain = device_ms(run), device_ms(plain)
            nbytes = 4 * (B * N * N + B * N * D + D * F + B * N * F)
            flops = 2 * B * N * D * F + 2 * B * N * N * F
            b_ms, b_by = _tf32_split_bound(nbytes, flops)
            fp32_ms, _ = bound(nbytes, flops)
            # issued: X·W and A·msg in 3 terms each over padded rows,
            # depth and 64-channel tiles
            np_, fp = -(-N // 64) * 64, -(-F // 64) * 64
            issued = 2 * B * fp * np_ * 3 * (_issued_depth(D) + np_)
            log("[kernels] " + _kernel_line(
                f"graph_aggregate B={B} N={N} D={D} F={F} "
                f"{'mean' if mean else 'sum'}", err, tol, ms, dev_ms,
                plain_ms, dev_plain, b_ms, b_by, fp32_ms, issued, split))
            if not err <= tol:
                raise AssertionError(
                    f"graph_aggregate N={N} mean={mean}: {err} > {tol}")
            if N == 64 and mean:
                row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": b_ms, "bound_by": b_by}
                # one adjacency entry flipped at a node of degree 1
                deg = adj.sum(-1)
                b, i = (int(v) for v in (deg == 1).nonzero()[0])
                j = int((adj[b, i] == 0).nonzero()[0])
                bad = adj.clone()
                bad[b, i, j] = 1.0
                _fault("graph_aggregate", f"adj[{b},{i},{j}] flipped 0 -> 1 "
                       f"(node of degree 1)",
                       ga.graph_aggregate(bad, x, w, mean=mean), ref, tol)
    return row


def _sa_cases(replay):
    """(label, SparseGraphBatch-like) of the segment_aggregate checks: the
    replay's first packs at budgets 64 and 512 (bucketed capacities), a
    pack at budget 512 encoded at its real node count (ragged: not a
    multiple of 64), and one node with one self-edge."""
    import dataclasses
    import types

    import numpy as np
    from repro_torch.data.batching import bucket_for, encode_packed
    yield "pack", _packed_edges(replay, 64)
    yield "pack", _packed_edges(replay, 512)
    graphs = _pack_graphs(replay, 512, ragged=True)
    spec = bucket_for(graphs)
    n = sum(g.num_nodes for g in graphs)
    yield "ragged pack", encode_packed(
        graphs, replay.normalizer,
        spec=dataclasses.replace(spec, node_capacity=n))
    one = np.zeros(1, np.int32)
    yield "one node", types.SimpleNamespace(
        num_nodes=1, num_edges=1, node_mask=np.ones(1, np.float32),
        edge_src=one, edge_dst=one, edge_mask=np.ones(1, np.float32))


def _sa_edges(b, dev):
    import torch
    from repro_torch.kernels import segment_aggregate as sa
    return sa.edge_csr(torch.from_numpy(b.edge_src).to(dev),
                       torch.from_numpy(b.edge_dst).to(dev),
                       torch.from_numpy(b.edge_mask).to(dev), b.num_nodes)


def _sa_issued(nm, D, F) -> float:
    """Tensor-core FLOPs the segment kernel issues: 3 tf32 products per
    f32 product over every row tile with a real row, 64-channel tiles."""
    import numpy as np
    tiles = -(-len(nm) // 64)
    active = sum(bool(np.any(nm[64 * t:64 * t + 64])) for t in range(tiles))
    return 2 * 3 * active * 64 * (-(-F // 64) * 64) * _issued_depth(D)


def check_segment_aggregate(gen, replay) -> dict:
    import torch
    from repro_torch.kernels import segment_aggregate as sa
    dev = torch.device(DEVICE)
    D, F = FEATURES, FEATURES
    w = (torch.randn((D, F), generator=gen) / D ** 0.5).to(dev)
    scale = torch.ones((F,), device=dev)
    row = None
    for label, b in _sa_cases(replay):
        M, E = b.num_nodes, b.num_edges
        nm = torch.from_numpy(b.node_mask).to(dev)
        edges = _sa_edges(b, dev)
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
            (dev_ms, split), dev_plain = device_ms(run), device_ms(plain)
            (b_ms, b_by), fp32_ms = _sa_bound(M, D, F, E, m_real, e_real, 4)
            log("[kernels] " + _kernel_line(
                f"segment_aggregate {label} M={M} E={E} (real "
                f"{int(m_real)} nodes, {int(e_real)} edges) D={D} F={F} "
                f"{'mean' if mean else 'sum'}", err, tol, ms, dev_ms,
                plain_ms, dev_plain, b_ms, b_by, fp32_ms,
                _sa_issued(b.node_mask, D, F), split))
            if not err <= tol:
                raise AssertionError(
                    f"segment_aggregate M={M} mean={mean}: {err} > {tol}")
            if label == "pack" and M == 512 and mean:
                row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": b_ms, "bound_by": b_by}
            if mean and M <= 512:
                # the plan not taken: two launches with a message scratch
                def run_two():
                    return sa._launch(x, w, scale, edges, nm, "relu", mean,
                                      two_launch=True)
                two = run_two()
                two_ms, (two_dev, two_split) = time_ms(run_two), \
                    device_ms(run_two)
                log(f"[kernels] segment_aggregate {label} M={M} mean, "
                    f"fused launch {ms:.4f} ms (device {dev_ms:.4f}) vs "
                    f"two launches {two_ms:.4f} ms (device {two_dev:.4f}: "
                    f"{two_split}); two-launch max_abs_err "
                    f"{float((two - ref).abs().max()):.3e}")
        # one real edge (from a real node) left out of the CSR
        src_real = b.node_mask[b.edge_src] != 0
        e = int(((b.edge_mask != 0) & src_real).nonzero()[0][0])
        cut = b.edge_mask.copy()
        cut[e] = 0
        cut_edges = sa.edge_csr(edges.gather, edges.scatter,
                                torch.from_numpy(cut).to(dev), M)
        ref = sa.segment_aggregate_plain(x, w, scale, edges.gather,
                                         edges.scatter, edges.edge_mask, nm)
        tol = 1e-5 * max(1.0, float(ref.abs().max()))
        _fault("segment_aggregate", f"{label} M={M}: edge {e} left out of "
               f"the CSR", sa.segment_aggregate(x, w, scale, cut_edges, nm),
               ref, tol)
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
        log(f"[kernels] segment_aggregate {label} M={M} integer inputs: "
            f"bit-exact (mean and sum)")
    return row


def _whole_programs():
    from repro_torch.data.synthetic import whole_model_graph
    return [whole_model_graph(WHOLE_NODES, seed=i)
            for i in range(WHOLE_PROGRAMS)]


def _sa_bound(M, D, F, E, m_real, e_real, w_bytes):
    """((bound ms, what bounds it), fp32 bound ms): each input read once,
    the output written once; the f32-accurate products of the real rows
    (split tf32 on the tensor cores; the activations are f32, so the int8
    variant's products are f32 too) and the edge sums."""
    nbytes = (4 * M * D + w_bytes * D * F + 4 * F + 4 * M + 4 * (M + 1)
              + 8 * E + 4 * M * F)
    flops = 2 * m_real * D * F + 2 * e_real * F
    return _tf32_split_bound(nbytes, flops), bound(nbytes, flops)[0]


def check_segment_aggregate_i8(gen, replay, whole) -> dict:
    """The int8-weight variant at the replay's M = 512 pack and at the
    inner batch of one whole program segmented at SEGMENT_BUDGET; the f32
    variant is timed at that inner batch too."""
    import torch
    from repro_torch.data.batching import encode_segmented
    from repro_torch.kernels import segment_aggregate as sa
    from repro_torch.quant.scale import QuantizedLeaf
    dev = torch.device(DEVICE)
    D, F = FEATURES, FEATURES
    leaf = QuantizedLeaf.quantize(torch.randn((D, F), generator=gen)
                                  / D ** 0.5)
    w, scale = leaf.q.to(dev), leaf.scale.reshape(-1).to(dev)
    w_f32 = leaf.dequantize().to(dev)
    one = torch.ones((F,), device=dev)
    seg = encode_segmented(whole[:1], SEGMENT_BUDGET, replay.normalizer)
    row = None
    for label, b in (("pack", _packed_edges(replay, 512)),
                     ("segmented", seg.inner)):
        M, E = b.num_nodes, b.num_edges
        nm = torch.from_numpy(b.node_mask).to(dev)
        edges = _sa_edges(b, dev)
        x = torch.randn((M, D), generator=gen).to(dev)
        m_real, e_real = float(b.node_mask.sum()), float(b.edge_mask.sum())
        for variant, ww, ss, w_bytes in (("int8", w, scale, 1),
                                         ("f32", w_f32, one, 4)):
            def run():
                return sa.segment_aggregate(x, ww, ss, edges, nm)

            def plain():
                return sa.segment_aggregate_plain(
                    x, ww, ss, edges.gather, edges.scatter,
                    edges.edge_mask, nm)
            if variant == "f32" and label == "pack":
                continue            # measured by check_segment_aggregate
            out, ref = run(), plain()
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            tol = 1e-5 * max(1.0, float(ref.abs().max()))
            ms, plain_ms = time_ms(run), time_ms(plain)
            (dev_ms, split), dev_plain = device_ms(run), device_ms(plain)
            (b_ms, b_by), fp32_ms = _sa_bound(M, D, F, E, m_real, e_real,
                                              w_bytes)
            log("[kernels] " + _kernel_line(
                f"segment_aggregate {variant} {label} M={M} E={E} (real "
                f"{int(m_real)} nodes, {int(e_real)} edges) D={D} F={F} "
                f"mean", err, tol, ms, dev_ms, plain_ms, dev_plain, b_ms,
                b_by, fp32_ms, _sa_issued(b.node_mask, D, F), split))
            if not err <= tol:
                raise AssertionError(f"segment_aggregate {variant} {label}"
                                     f" M={M}: {err} > {tol}")
            if variant == "int8" and label == "pack":
                row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": b_ms, "bound_by": b_by}
        # integer-valued x, int8 w, power-of-two scales: bit-exact
        xi = torch.randint(-3, 4, (M, D), generator=gen).float().to(dev)
        wi = torch.randint(-127, 128, (D, F), generator=gen,
                           dtype=torch.int8).to(dev)
        si = (2.0 ** torch.randint(-6, 1, (F,), generator=gen)).to(dev)
        for mean in (True, False):
            out = sa.segment_aggregate(xi, wi, si, edges, nm, mean=mean)
            ref = sa.segment_aggregate_plain(xi, wi, si, edges.gather,
                                             edges.scatter, edges.edge_mask,
                                             nm, mean=mean)
            if not torch.equal(out, ref):
                raise AssertionError(
                    f"segment_aggregate int8 {label} M={M} mean={mean}: "
                    f"integer inputs not bit-exact (max diff "
                    f"{float((out - ref).abs().max())})")
        log(f"[kernels] segment_aggregate int8 {label} M={M} integer "
            f"inputs, power-of-two scales: bit-exact (mean and sum)")
    return row


# --------------------------------------------------------------------- 4
def _reset_launches() -> None:
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import graph_aggregate as ga
    from repro_torch.kernels import segment_aggregate as sa
    from repro_torch.kernels import ssd_scan as ss
    ga.launches = sa.launches = sa.launches_i8 = dec.launches = 0
    fa.launches = fa.launches_tc = fa.launches_f32 = ss.launches = 0
    fa.launches_hd256 = fa.launches_hd256_f32 = 0
    for shape in fa.launches_sm90:
        fa.launches_sm90[shape] = 0


def _launches() -> dict:
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import graph_aggregate as ga
    from repro_torch.kernels import segment_aggregate as sa
    from repro_torch.kernels import ssd_scan as ss
    return {"graph_aggregate": ga.launches,
            "segment_aggregate": sa.launches,
            "segment_aggregate_i8": sa.launches_i8,
            "flash_attention": fa.launches,
            "flash_attention_tc": fa.launches_tc,
            "flash_attention_f32": fa.launches_f32,
            "flash_attention_hd256": fa.launches_hd256,
            "flash_attention_hd256_f32": fa.launches_hd256_f32,
            "ssd_scan": ss.launches,
            "decode_attention": dec.launches}


# the _launches() key of each flash route (kernels.flash_attention.ROUTES)
FLASH_ROUTE_KEY = {"sm90": "flash_attention_tc", "tf32": "flash_attention_f32",
                   "hd256": "flash_attention_hd256",
                   "hd256_f32": "flash_attention_hd256_f32"}


def serve(label, make_service, requests, kernels, tag="serve",
          profiled=True) -> dict:
    """One path: warm-up pass, the timed pass with every launch count set
    to 0 just before and read just after, a profiled pass (unless not
    `profiled`), and the same stream with the kernels off.
    `make_service(use_kernels)` builds a fresh service; each kernel in
    `kernels` must have launched. Lines start with `[tag]`."""
    import numpy as np
    import torch
    from repro_torch.serving.replay import run_replay

    n_queries = sum(len(r) for r in requests)
    warm = make_service(True)
    run_replay(warm.predict_many, requests)             # warm-up pass
    torch.cuda.synchronize()
    svc = make_service(True)
    _reset_launches()
    t0 = time.perf_counter()
    preds, _ = run_replay(svc.predict_many, requests)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _launches()
    st = svc.stats()
    if profiled:    # where the time goes: one more pass, profiled
        prof_svc = make_service(True)
        prof, wall = device_profile(
            lambda: run_replay(prof_svc.predict_many, requests))
        busy = sum(us for _, us in prof.values()) / 1e6
        top = sorted(prof.items(), key=lambda kv: -kv[1][1])[:6]
        log(f"[{tag}] {label} profiled pass: wall {wall:.3f} s, device busy "
            f"{busy:.4f} s ({busy / wall:.1%}), "
            f"{sum(c for c, _ in prof.values())} kernel launches")
        for name, (count, us) in top:
            log(f"[{tag}]   {us / 1e3:9.3f} ms {count:6d}x  {_short(name)}")
    ref, _ = run_replay(make_service(False).predict_many, requests)
    got, want = np.concatenate(preds), np.concatenate(ref)
    err = float(np.max(np.abs(got - want)))
    tol = 1e-4 * max(1.0, float(np.max(np.abs(want))))
    cfg = svc.model_cfg
    log(f"[{tag}] {label}: {n_queries / dt:.1f} queries/s "
        f"({n_queries} queries, {dt:.3f} s) "
        f"hit_rate={st.hit_rate:.4f} flushes={st.flushes} "
        f"p50={st.latency_p50_ms:.3f} ms p99={st.latency_p99_ms:.3f} ms "
        f"launches={launches} hidden={cfg.hidden_dim} "
        f"reduction={cfg.reduction} precision={cfg.precision} "
        f"max_abs_err vs kernels off={err:.3e} (tol {tol:.3e})")
    if got.shape != (n_queries,) or not np.all(np.isfinite(got)):
        raise AssertionError(f"{label}: predictions not finite or of "
                             f"shape ({n_queries},)")
    if not err <= tol:
        raise AssertionError(f"{label}: kernels on vs off {err} > {tol}")
    for kernel in kernels:
        if launches[kernel] == 0:
            raise AssertionError(f"{label}: {kernel} never launched")
    return {"launches": launches, "preds": got}


def f32_services(replay, layout: str, **cfg_kw):
    """`make_service` for an f32 model of the default width, random
    weights from seed 0."""
    import torch
    from repro_torch.core.evaluate import make_predict_fn
    from repro_torch.core.model import CostModelConfig, cost_model_init
    from repro_torch.serving import CostModelService

    def make(use_kernels: bool):
        cfg = CostModelConfig(use_pallas_aggregate=use_kernels, dropout=0.0,
                              adjacency=layout, **cfg_kw)
        model = cost_model_init(torch.Generator().manual_seed(0), cfg,
                                device=DEVICE)
        return CostModelService(model, cfg, replay.normalizer,
                                predict_fn=make_predict_fn(cfg))
    return make


def quantize_like_the_cli(replay, **cfg_kw):
    """The seed-0 model of `f32_services`, quantized per channel and
    calibrated on the stream's first 4 requests (the CLI's
    --precision int8). Returns (QuantizedCostModel, f32 model)."""
    import torch
    from repro_torch.core.model import CostModelConfig, cost_model_init
    from repro_torch.quant import quantize_params
    cfg = CostModelConfig(use_pallas_aggregate=True, dropout=0.0, **cfg_kw)
    model = cost_model_init(torch.Generator().manual_seed(0), cfg,
                            device=DEVICE)
    calib = [g for req in replay.requests[:4] for g in req]
    return quantize_params(model, cfg, calib_graphs=calib,
                           normalizer=replay.normalizer), model


def int8_services(replay, qm, layout: str):
    from repro_torch.core.evaluate import make_predict_fn
    from repro_torch.quant import QuantizedCostModel
    from repro_torch.serving import CostModelService

    def make(use_kernels: bool):
        q = QuantizedCostModel(qm.params, qm.act_scales,
                               dict(qm.config, adjacency=layout,
                                    use_pallas_aggregate=use_kernels))
        return CostModelService(q, None, replay.normalizer,
                                predict_fn=make_predict_fn(
                                    q.serving_config()))
    return make


def _agree(label, got, want, tag="serve") -> None:
    import numpy as np
    err = float(np.max(np.abs(got - want)))
    tol = 1e-4 * max(1.0, float(np.max(np.abs(want))))
    log(f"[{tag}] {label}: max_abs_err={err:.3e} (tol {tol:.3e})")
    if not err <= tol:
        raise AssertionError(f"{label}: {err} > {tol}")


# --------------------------------------------------------------------- 7
TRAIN_PROGRAMS = 48       # `train cost-model --programs` default
TRAIN_STEPS, RESUME_AT = 300, 150
WHOLE_TRAIN_PROGRAMS, WHOLE_TRAIN_STEPS = 2, 20
TIMED_STEPS, PROFILED_STEPS = 50, 20
WHOLE_TIMED_STEPS = 10    # of the segmented run's 20: 1 + 10 timed + 9
# a resumed run redoes the uninterrupted one's arithmetic: each leaf
# within 1e-6 of its largest value (bit-exact on the CPU)
RESUME_RTOL = 1e-6


def _train_data() -> dict:
    """What `train cost-model` builds: the tile and fusion datasets of
    `generate_corpus(TRAIN_PROGRAMS)` labelled by the port's
    `TPUSimulator`, split by program, the tile normalizer fitted on the
    train split; and two ~10k-node whole-model fusion records."""
    from repro_torch.core.features import fit_normalizer
    from repro_torch.core.simulator import TPUSimulator
    from repro_torch.data.corpus import filter_by_programs, split_programs
    from repro_torch.data.fusion_dataset import build_fusion_dataset
    from repro_torch.data.synthetic import generate_corpus, \
        whole_model_records
    from repro_torch.data.tile_dataset import build_tile_dataset, \
        fit_tile_normalizer
    t0 = time.perf_counter()
    sim = TPUSimulator()
    programs = generate_corpus(TRAIN_PROGRAMS, seed=0)
    split = split_programs([p.program for p in programs], seed=0)
    tiles = build_tile_dataset(programs, sim, max_configs_per_kernel=24)
    fusion = build_fusion_dataset(programs, sim, configs_per_program=12)
    whole = whole_model_records(WHOLE_TRAIN_PROGRAMS, WHOLE_NODES, seed=0,
                                simulator=sim)
    d = {"tile_train": filter_by_programs(tiles.records, split["train"]),
         "tile_test": filter_by_programs(tiles.records, split["test"]),
         "fusion_test": filter_by_programs(fusion.records, split["test"]),
         "whole": whole,
         "test_programs": [p for p in programs
                           if p.program in set(split["test"])]}
    d["tile_norm"] = fit_tile_normalizer(d["tile_train"])
    d["whole_norm"] = fit_normalizer([r.kernel for r in whole])
    log(f"[train] data: {TRAIN_PROGRAMS} programs (the CLI's default, not "
        f"cut; {len(split['train'])} "
        f"train, {len(split['test'])} test), tile records "
        f"{len(d['tile_train'])} train / {len(d['tile_test'])} test "
        f"({tiles.num_samples} samples), fusion records "
        f"{len(fusion.records)} ({len(d['fusion_test'])} test), whole "
        f"programs {[r.kernel.num_nodes for r in whole]} nodes; built in "
        f"{time.perf_counter() - t0:.2f} s of host time")
    return d


def _tile_sampler(records, norm, layout):
    from repro_torch.data.sampler import TileBatchSampler
    return TileBatchSampler(records, norm, kernels_per_batch=4,
                            configs_per_kernel=8, max_nodes=64,
                            adjacency=layout)


def _trainer(cfg, sampler, task, device=None, **tc_kw):
    from repro_torch.training.trainer import CostModelTrainer, \
        TrainerConfig
    from repro_torch.training.optim import AdamWConfig
    tc = TrainerConfig(**{**dict(task=task, ckpt_every=0,
                                 log_every=TRAIN_STEPS,
                                 optim=AdamWConfig(lr=2e-3)), **tc_kw})
    return CostModelTrainer(cfg, tc, sampler, device=device or DEVICE)


def _held_loss(trainer, batch) -> float:
    import torch
    with torch.no_grad():
        return float(trainer.loss(batch))


def train_run(label, trainer, steps, held, *, timed, profiled,
              gate_held=True, tag="train") -> dict:
    """Drive `trainer` from step 0 to `steps`: step 1 alone (its loss), a
    window of `timed` steps between CUDA events ended by a synchronize,
    a profiled window of `profiled` steps, then on to the end. Fails on a
    non-finite loss, and with `gate_held` unless the held-out loss of the
    final model is below the step-0 model's. Lines start with `[tag]`."""
    import numpy as np
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held0 = _held_loss(trainer, held)
    first = trainer.run(1, resume=False)["loss"]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    trainer.run(trainer.step + timed, resume=False)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / timed
    out = {}
    prof, wall = device_profile(lambda: out.update(
        trainer.run(trainer.step + profiled, resume=False)))
    busy = sum(us for _, us in prof.values()) / 1e6
    launches = sum(c for c, _ in prof.values()) / profiled
    if trainer.step < steps:
        out = trainer.run(steps, resume=False)
    last = out["loss"]
    held1 = _held_loss(trainer, held)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    cfg = trainer.model_cfg
    log(f"[{tag}] {label}: {ms:.3f} ms/step ({1e3 / ms:.1f} steps/s, "
        f"CUDA events over {timed} steps), loss step 1 {first:.6f} -> step "
        f"{trainer.step} {last:.6f}, held-out loss {held0:.6f} -> "
        f"{held1:.6f}, device busy {busy:.4f} s of {wall:.3f} s "
        f"({busy / wall:.1%}) and {launches:.1f} kernel launches per step "
        f"over {profiled} profiled steps, peak memory {peak:.3f} GiB "
        f"(hidden={cfg.hidden_dim} adjacency={cfg.adjacency} "
        f"reduction={cfg.reduction} dropout={cfg.dropout} "
        f"task={trainer.cfg.task})")
    top = sorted(prof.items(), key=lambda kv: -kv[1][1])[:5]
    for name, (count, us) in top:
        log(f"[{tag}]   {us / 1e3:9.3f} ms {count:6d}x  {_short(name)}")
    if not (np.isfinite(first) and np.isfinite(last)
            and np.isfinite(held0) and np.isfinite(held1)):
        raise AssertionError(f"{label}: non-finite loss")
    if gate_held and not held1 < held0:
        raise AssertionError(f"{label}: held-out loss {held1} not below "
                             f"the step-0 model's {held0}")
    return {"ms": ms, "first": first, "last": last}


def check_resume(cfg, data, reference, ckpt_dir) -> None:
    """A trainer checkpointed at RESUME_AT and a fresh one resumed from
    it to TRAIN_STEPS against the uninterrupted run `reference`."""
    import torch
    from repro_torch.training.optim import tree_leaves

    def make():
        return _trainer(cfg, _tile_sampler(data["tile_train"],
                                           data["tile_norm"], "dense"),
                        "tile", ckpt_dir=ckpt_dir, ckpt_every=RESUME_AT)
    make().run(RESUME_AT, resume=False)
    resumed = make()
    resumed.run(TRAIN_STEPS)                 # resumes at RESUME_AT
    worst, exact = 0.0, True
    with torch.no_grad():
        for a, b in zip(tree_leaves(resumed.params),
                        tree_leaves(reference.params)):
            exact = exact and torch.equal(a, b)
            worst = max(worst, float((a - b).abs().max())
                        / max(float(b.abs().max()), 1e-30))
    log(f"[train] resume: checkpoint at step {RESUME_AT}, a fresh trainer "
        f"resumed to {resumed.step}: largest |Δ| / max|leaf| vs the "
        f"uninterrupted run {worst:.3e} (limit {RESUME_RTOL:g}; "
        f"bit-exact: {exact})")
    if resumed.step != TRAIN_STEPS or not worst <= RESUME_RTOL:
        raise AssertionError(f"resume: {worst} > {RESUME_RTOL}")


def trained_services(data, ckpt_dir, cfg, layout: str):
    """`make_service` for the checkpoint in `ckpt_dir`, read back with
    `load_jax_checkpoint` (the reader of either package's checkpoints)."""
    import dataclasses
    from repro_torch.core.evaluate import make_predict_fn
    from repro_torch.core.params import load_jax_checkpoint
    from repro_torch.serving import CostModelService

    def make(use_kernels: bool):
        scfg = dataclasses.replace(cfg, adjacency=layout,
                                   use_pallas_aggregate=use_kernels)
        return CostModelService(load_jax_checkpoint(ckpt_dir, scfg,
                                                    device=DEVICE),
                                scfg, data["tile_norm"],
                                predict_fn=make_predict_fn(scfg))
    return make


def phase_train(card: str, ckpt_root: str) -> dict:
    """Returns the trained models ({"dense", "sparse", "segmented"}: the
    trainers) and the data, for phases 12 and 13."""
    from repro_torch.core.model import CostModelConfig
    from repro_torch.data.sampler import BalancedSampler
    log(f"[train] on {card}")
    data = _train_data()
    _reset_launches()
    runs = {}
    for layout in ("dense", "sparse"):
        cfg = CostModelConfig(adjacency=layout)
        held = _tile_sampler(data["tile_test"], data["tile_norm"],
                             layout).batch(0)
        tr = _trainer(cfg, _tile_sampler(data["tile_train"],
                                         data["tile_norm"], layout), "tile")
        train_run(f"tile {layout}", tr, TRAIN_STEPS, held,
                  timed=TIMED_STEPS, profiled=PROFILED_STEPS)
        runs[layout] = tr
    seg_cfg = CostModelConfig(adjacency="segmented", reduction="column_wise")
    seg_held = BalancedSampler(data["fusion_test"], data["whole_norm"],
                               batch_size=32, max_nodes=SEGMENT_BUDGET,
                               adjacency="segmented").batch(0)
    seg = _trainer(seg_cfg, BalancedSampler(
        data["whole"], data["whole_norm"], batch_size=WHOLE_TRAIN_PROGRAMS,
        max_nodes=SEGMENT_BUDGET, adjacency="segmented"), "fusion")
    # the held-out loss (small fusion kernels of the test programs) is
    # printed, not gated
    train_run(f"fusion segmented ({WHOLE_TRAIN_PROGRAMS} whole programs "
              f"of ~{WHOLE_NODES} nodes a step)", seg, WHOLE_TRAIN_STEPS,
              seg_held, timed=WHOLE_TIMED_STEPS,
              profiled=WHOLE_TRAIN_STEPS - 1 - WHOLE_TIMED_STEPS,
              gate_held=False)
    launches = {k: _launches()[k]
                for k in ("graph_aggregate", "segment_aggregate")}
    log(f"[train] aggregation kernel launches while training: {launches}")
    if any(launches.values()):
        raise AssertionError("training launched an aggregation kernel")

    ckpt_dir = os.path.join(ckpt_root, "tile_dense")
    dense_cfg = runs["dense"].model_cfg
    check_resume(dense_cfg, data, runs["dense"], ckpt_dir)
    requests = [[r.kernel.with_tile(t) for t in r.tiles]
                for r in data["tile_test"]]
    served = {}
    for layout, kernel in (("dense", "graph_aggregate"),
                           ("sparse", "segment_aggregate")):
        served[layout] = serve(
            f"trained checkpoint {layout}",
            trained_services(data, ckpt_dir, dense_cfg, layout), requests,
            [kernel], tag="train")
    _agree("trained checkpoint, sparse vs dense layout",
           served["sparse"]["preds"], served["dense"]["preds"], tag="train")
    return {"data": data, "dense": runs["dense"], "sparse": runs["sparse"],
            "segmented": seg}


# --------------------------------------------------------------------- 8
ARCH = "h2o-danube-3-4b"
LM_BATCH, LM_SEQ = 2, 8192          # 2 x 8192 tokens: past the 4096 window
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 4, 512, 64
# Kernel vs. chunked attention in bf16: the two differ where q·scale is
# rounded (f32 after the cast vs. bf16 before it) and in the order of the
# f32 sums, so an attention output now and then lands one bf16 ulp
# (2^-8..2^-7 relative) apart; 24 layers carry that into the logits.
# Tolerances, set from the card's readings (|Δloss| 1.55e-4, max|Δlogits|
# 0.074 forward and 0.086 decode at max|logits| 5.6): |Δloss| <= 1e-3
# and max|Δlogits| <= 0.025 · max|logits| (about 4.5 bf16 ulps at the
# largest logit). With random weights attention moves the logits little,
# so the layer check (LAYER_RMS_RTOL) is the one that catches a wrong
# kernel; the planted faults show what these two catch.
LM_LOSS_TOL, LM_LOGIT_RTOL = 1e-3, 0.025
# llava-next-34b's logits move more than h2o-danube-3-4b's where bf16
# rounds elsewhere: two plain versions of the same attention, the
# kernel's arithmetic (flash_attention_plain) and chunked_attention, gave
# max|Δlogits| 0.203 (2.7 % of max|logits|) at 24 of its layers and
# 0.266 (3.3 %) at 45 (an H100 80GB HBM3 at 700 W): past LM_LOGIT_RTOL,
# with the kernel held within its element-wise limit at the layer's
# shape and on layer 0's inputs. Its limit,
# 0.06·max|logits|, lies 1.8x above the plain versions' 45-layer
# reading, as LM_LOGIT_RTOL lies 1.9x above h2o-danube-3-4b's; the
# layer check holds the kernel.
LM_LOGIT_RTOL_ARCH = {"llava-next-34b": 0.06}
# The same in f32 ([lm-forward-f32]): both paths run the same f32 ops but
# attention, whose outputs agree within 2e-5·|ref| + 5e-6 per element
# (FLASH_TOL; f32 sums in another order, ~1e-7 relative, plus the split
# TF32's dropped terms, ~1e-6); 24 residual layers that add such a
# difference without amplifying it stay below 24 · 2e-5 ≈ 5e-4 of the
# logits: max|Δlogits| <= 5e-4 · max|logits|. The loss is a mean over
# 16383 tokens of log-softmax terms, each moved at most 2 max|Δlogits|;
# its own f32 rounding is ~1e-6 of ~11, so |Δloss| <= 1e-4 leaves two
# orders of magnitude for the attention's share.
LM_F32_LOSS_TOL, LM_F32_LOGIT_RTOL = 1e-4, 5e-4
# flash_attention checks: (label, B, S, H, KH, hd, causal, window, dtype,
# timed calls); the first is h2o-danube-3-4b's layer, the table's row
FLASH_CASES = (
    ("layer", LM_BATCH, LM_SEQ, 32, 8, 120, True, 4096, "bfloat16", 5),
    ("hd128", 2, 2048, 32, 8, 128, True, None, "bfloat16", 10),
    ("non-causal", 2, 1024, 32, 8, 120, False, None, "bfloat16", 10),
    ("f32", 1, 1024, 32, 8, 120, True, 256, "float32", 10),
    ("f32-layer", 2, 8192, 32, 8, 120, True, 4096, "float32", 3),
    ("f32-hd64", 1, 1024, 32, 8, 64, True, 256, "float32", 10),
    ("f32-q3", 1, 1024, 32, 8, 120, True, 256, "float32", 10),
    # the layers of granite-moe-3b-a800m, musicgen-large, llava-next-34b
    ("granite-layer", LM_BATCH, LM_SEQ, 24, 8, 64, True, None, "bfloat16", 5),
    # granite's layer at the shapes its two benchmark prefill cells give
    # the kernel (4 x 4096 and 32 x 512 tokens)
    ("granite-4k", 4, 4096, 24, 8, 64, True, None, "bfloat16", 5),
    ("granite-512", 32, 512, 24, 8, 64, True, None, "bfloat16", 10),
    ("musicgen-layer", LM_BATCH, LM_SEQ, 32, 32, 64, True, None, "bfloat16",
     5),
    ("llava-layer", LM_BATCH, LM_SEQ, 56, 8, 128, True, None, "bfloat16", 5),
    # recurrentgemma-9b's local attention (MQA, hd 256, window 2048): the
    # hd-256 routes, bf16 (wgmma) and f32 (split-TF32 wgmma)
    ("rg-layer", LM_BATCH, LM_SEQ, 16, 1, 256, True, 2048, "bfloat16", 3),
    ("rg-layer-f32", LM_BATCH, LM_SEQ, 16, 1, 256, True, 2048, "float32", 2),
    ("rg-f32-q3", 1, 1024, 16, 1, 256, True, 256, "float32", 10))
# q is drawn N(0, 1) times this (1 elsewhere): q x 3 makes the scores
# larger, and exp turns a score's error into most of the output's
FLASH_Q_SCALE = {"f32-q3": 3.0, "rg-f32-q3": 3.0}
# the cases whose planted faults are checked: the model's layer, bf16 and
# f32, and recurrentgemma-9b's on the hd-256 routes
FLASH_FAULT_CASES = ("layer", "f32-layer", "rg-layer", "rg-layer-f32")
# the kernels-line row of each route, at its layer shape
FLASH_ROW_CASES = {"layer": "flash_attention", "f32-layer":
                   "flash_attention_f32", "rg-layer": "flash_attention_hd256",
                   "rg-layer-f32": "flash_attention_hd256_f32"}
SSD_SHAPE = (2, 32, 80, 128, 64)    # B, nc, H, N, P: Mamba2-2.7b, 8192 tokens
# decode_attention checks (bf16): (label, B, H, KH, hd, C, pos, window);
# pos None is a cross cache (no k_pos, every slot seen). The serve loop's
# caches (`lm_serve`) hold SERVE_PROMPT + SERVE_STEPS slots (a window's
# ring no longer than that); its decode reads them at SERVE_DECODE_POS.
# rg-ring is recurrentgemma's ring of 2048 past its wrap.
SERVE_DECODE_POS = SERVE_PROMPT + SERVE_STEPS // 2
_SERVE_C = SERVE_PROMPT + SERVE_STEPS
DECODE_CASES = (
    ("musicgen-self", 64, 32, 32, 64, 504, 250, None),
    ("musicgen-cross", 64, 32, 32, 64, 64, None, None),
    ("granite-b4", 4, 24, 8, 64, 4096, 2047, None),
    ("h2o-serve", SERVE_BATCH, 32, 8, 120, _SERVE_C, SERVE_DECODE_POS, 4096),
    ("rg-serve", SERVE_BATCH, 16, 1, 256, _SERVE_C, SERVE_DECODE_POS, 2048),
    ("rg-ring", SERVE_BATCH, 16, 1, 256, 2048, 3000, 2048))
DECODE_ITERS = 50
# flash_attention vs. its plain version, element by element:
# |out - ref| <= rtol·|ref| + atol. Both take the same f32 arithmetic and
# differ only in the order of the f32 sums (~1e-7 relative); in bf16 both
# round that to bf16, so an element lands at most one bf16 ulp apart,
# and one ulp is at most 2^-7·|ref|: the limit 2^-6·|ref| is twice that.
# atol covers elements near 0. In f32, rtol is the reference's own test
# tolerance and atol 5.6x the largest error seen on the card (8.9e-7);
# there the reference is the plain version in float64 after q·scale
# (`exact`): at hd 256 and q x 3 the f32 plain version itself lies up to
# 1.95x the limit from it on the card (kernels/flash_time.py --route
# hd256_f32), the split-TF32 kernel 0.40x (PERF.md).
FLASH_TOL = {"bfloat16": (2.0 ** -6, 1e-5), "float32": (2e-5, 5e-6)}
# keys left out by the planted faults (and query rows held apart): half
# of the hd <= 128 bf16 kernel's 128-key tile, one key tile of the
# hd-256 bf16 kernel and of the hd <= 128 f32 kernel, two of the hd-256
# f32 kernel's 32-key tiles
FAULT_TILE = 64
# One layer's attention output at the full shape, kernel vs.
# chunked_attention (the model's path with the flag off), as
# rms(Δ) / rms(ref): their bf16 rounding of q·scale differs (see above),
# which gave 0.0031 on random inputs of the layer's scale (my CPU run);
# a window one key tile short moves it by ~0.09.
LAYER_RMS_RTOL = 2.0 ** -6
# In f32 the two differ only in the order of f32 sums and the split
# TF32's dropped terms (~1e-6 relative); 2^-16 (1.5e-5) still lies four
# orders of magnitude below what a window one key tile short moves.
LAYER_RMS_RTOL_F32 = 2.0 ** -16


def _attn_pairs(Sq, Sk, causal, window, q_offset=0) -> int:
    """Unmasked (query, key) pairs of one (batch, head)."""
    import numpy as np
    q_pos = q_offset + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(q_pos, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(0, q_pos - window + 1) if window else np.zeros(Sq)
    return int(np.maximum(0, hi - lo + 1).sum())


def _sdpa_inputs(q, k, v, causal, window):
    """SDPA's layout: [B, H, S, hd] with the kv heads repeated, and the
    causal window as a boolean mask (True = attend)."""
    import torch
    rep = q.shape[2] // k.shape[2]
    S = q.shape[1]
    pos = torch.arange(S, device=q.device)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window:
        mask &= pos[:, None] - pos[None, :] < window
    return (q.transpose(1, 2).contiguous(),
            k.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous(),
            v.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous(),
            mask)


def _within(out, ref, rtol, atol) -> tuple[bool, float, float]:
    """(every |out - ref| <= rtol·|ref| + atol, max_abs_err, the largest
    |out - ref| / (rtol·|ref| + atol))."""
    out, ref = out.float(), ref.float()
    diff = (out - ref).abs()
    worst = float((diff / (rtol * ref.abs() + atol)).max())
    return worst <= 1.0, float(diff.max()), worst


def _attention_rows(q, k, v, keep):
    """The plain version's arithmetic for the query rows `q` over the
    keys where `keep` [rows, Sk] is True (f32: in float64 after q·scale,
    as the plain version's `exact`)."""
    import math

    import torch
    rep = q.shape[2] // k.shape[2]
    acc = torch.float64 if q.dtype == torch.float32 else torch.float32
    qf = (q.float() * (1.0 / math.sqrt(q.shape[-1]))).to(acc).transpose(1, 2)
    kf = k.to(acc).repeat_interleave(rep, dim=2).transpose(1, 2)
    vf = v.to(acc).repeat_interleave(rep, dim=2).transpose(1, 2)
    s = (qf @ kf.transpose(-1, -2)).masked_fill(~keep, -1e30)
    return (torch.softmax(s, dim=-1) @ vf).transpose(1, 2).to(q.dtype)


def _flash_faults(label, q, k, v, out, ref, window, rtol, atol) -> None:
    """Shows that the element-wise check fails a wrong kernel at this
    shape: the kernel with its window one key off either way, and the
    last query tile with one key tile inside the window left out."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    caught = []
    for w in (window - 1, window + 1):
        ok, err, worst = _within(fa.flash_attention(
            q, k, v, causal=True, window=w), ref, rtol, atol)
        caught.append((f"window {w}", ok, err, worst))
    S = q.shape[1]
    q_pos = torch.arange(S - FAULT_TILE, S, device=q.device)[:, None]
    k_pos = torch.arange(S, device=q.device)[None, :]
    keep = (k_pos <= q_pos) & (q_pos - k_pos < window)
    rows = (q[:, -FAULT_TILE:], k, v)
    ok, err, worst = _within(out[:, -FAULT_TILE:],
                             _attention_rows(*rows, keep), rtol, atol)
    log(f"[zoo-kernels] flash_attention {label}, last query tile vs. the "
        f"same rows computed apart: max_abs_err={err:.3e} (worst "
        f"{worst:.3f} of the limit)")
    if not ok:
        raise AssertionError("flash_attention: last query tile apart")
    drop = S - window // 2                     # inside every last row's window
    drop -= drop % FAULT_TILE
    keep[:, drop:drop + FAULT_TILE] = False
    ok, err, worst = _within(out[:, -FAULT_TILE:],
                             _attention_rows(*rows, keep), rtol, atol)
    caught.append((f"key tile {drop}..{drop + FAULT_TILE - 1} left out",
                   ok, err, worst))
    for fault, ok, err, worst in caught:
        log(f"[zoo-kernels] planted fault at {label}, {fault}: "
            f"max_abs_err={err:.3e} ({worst:.1f} x the limit): "
            f"{'MISSED' if ok else 'caught'}")
        if ok:
            raise AssertionError(f"flash_attention {label} check misses: "
                                 f"{fault}")


def check_flash_attention() -> dict:
    """Each FLASH_CASES case: kernel vs plain, element by element, timed
    beside the plain version and SDPA. Returns the kernels-line rows of
    the routes at their layer shapes (FLASH_ROW_CASES)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    rows = {}
    for label, B, S, H, KH, hd, causal, window, dt, iters in FLASH_CASES:
        rtol, atol = FLASH_TOL[dt]
        dt = getattr(torch, dt)
        q = (torch.randn((B, S, H, hd), generator=gen, device=DEVICE)
             * FLASH_Q_SCALE.get(label, 1.0)).to(dt)
        k = torch.randn((B, S, KH, hd), generator=gen, device=DEVICE).to(dt)
        v = torch.randn((B, S, KH, hd), generator=gen, device=DEVICE).to(dt)

        def run():
            return fa.flash_attention(q, k, v, causal=causal, window=window)

        def plain():
            return fa.flash_attention_plain(q, k, v, causal=causal,
                                            window=window)
        out, ref = run(), plain()
        plain_note = ""
        if dt == torch.float32:
            # f32 is held against the exact attention (FLASH_TOL), the f32
            # plain version's own distance from it printed beside
            exact = fa.flash_attention_plain(q, k, v, causal=causal,
                                             window=window, exact=True)
            plain_note = (f"; plain f32 vs exact: worst "
                          f"{_within(ref, exact, rtol, atol)[2]:.3f} of the "
                          f"limit")
            ref = exact
        torch.cuda.synchronize()
        ok, err, worst = _within(out, ref, rtol, atol)
        sq, sk, sv, mask = _sdpa_inputs(q, k, v, causal, window)

        def library():
            return F.scaled_dot_product_attention(sq, sk, sv, attn_mask=mask)
        # SDPA under the same element-wise limit: how far an independent
        # implementation in the same dtype lands from the plain version
        _, lib_err, lib_worst = _within(library().transpose(1, 2), ref,
                                        rtol, atol)
        ms = time_ms(run, warmup=1, iters=iters)
        plain_ms = time_ms(plain, warmup=1, iters=max(1, iters // 5))
        lib_ms = time_ms(library, warmup=1, iters=iters)
        (dev_ms, split), (dev_plain_ms, _), (dev_lib_ms, lib_split) = (
            device_ms(run, iters), device_ms(plain, max(1, iters // 5)),
            device_ms(library, iters))
        del sq, sk, sv, mask
        pairs = _attn_pairs(S, S, causal, window)
        flops = 4 * hd * pairs * B * H
        nbytes = q.element_size() * 2 * hd * (B * S * H + B * S * KH)
        bf16 = dt == torch.bfloat16
        route_name = fa.route_for(dt, hd)
        # the f32 routes: split TF32 (three tf32 products per f32
        # product), the fp32 CUDA cores' bound printed beside it
        b_ms, b_by = (bound(nbytes, flops, PEAK_BF16_FLOP_PER_S) if bf16
                      else _tf32_split_bound(nbytes, flops))
        fp32_ms, _ = bound(nbytes, flops)
        split_note = ("" if bf16
                      else f", split tf32; fp32 bound {fp32_ms:.4f}")
        route = {"sm90": "flash_attention_sm90.cu, tensor cores",
                 "tf32": "flash_attention_tf32.cu, split-TF32 tensor cores",
                 "hd256": "flash_attention_hd256.cu, wgmma tensor cores",
                 "hd256_f32": "flash_attention_hd256_tf32.cu, split-TF32 "
                              "tensor cores"}[
            route_name]
        log(f"[zoo-kernels] flash_attention {label} B={B} S={S} H={H} "
            f"KH={KH} hd={hd} causal={causal} window={window} "
            f"{str(dt).removeprefix('torch.')}, q x "
            f"{FLASH_Q_SCALE.get(label, 1.0):g} ({route}): kernel {ms:.4f} "
            f"ms call, {flops / ms / 1e9:.1f} TFLOP/s, bound / call "
            f"{b_ms / ms:.1%}, bound / device {b_ms / dev_ms:.1%}; "
            f"max_abs_err={err:.3e} "
            f"(|out - ref| <= {rtol:.3e}·|ref| + {atol:.0e}: worst "
            f"{worst:.3f} of the limit{plain_note}; max|ref| "
            f"{float(ref.float().abs().max()):.3f}, median |ref| "
            f"{float(ref.float().abs().median()):.4f}) kernel device "
            f"{dev_ms:.4f} ms [{split}], plain {plain_ms:.4f} ms (device "
            f"{dev_plain_ms:.4f}), sdpa {lib_ms:.4f} ms (device "
            f"{dev_lib_ms:.4f}, max_abs_err vs plain {lib_err:.3e}, worst "
            f"{lib_worst:.3f} of the limit; "
            f"{lib_split[:100]}), bound {b_ms:.4f} ms ({b_by}"
            f"{split_note}"
            f"; {pairs} pairs per head, {flops:.4e} FLOP, {nbytes} bytes)")
        if not ok:
            raise AssertionError(f"flash_attention {label}: worst "
                                 f"{worst} of the limit")
        if label in FLASH_FAULT_CASES:
            _flash_faults(label, q, k, v, out, ref, window, rtol, atol)
        if label in FLASH_ROW_CASES:
            rows[FLASH_ROW_CASES[label]] = {"max_abs_err": err, "ms": ms,
                           "plain_ms": plain_ms, "bound_ms": b_ms,
                           "bound_by": b_by, "library_ms": lib_ms}
        del q, k, v, out, ref
    return rows


def check_ssd_scan() -> dict:
    import torch
    from repro_torch.kernels import ssd_scan as ss
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    B, nc, H, N, P = SSD_SHAPE
    S = torch.randn((B, nc, H, N, P), generator=gen, device=DEVICE)
    d = torch.rand((B, nc, H), generator=gen, device=DEVICE)

    def run():
        return ss.ssd_scan(S, d)

    def plain():
        return ss.ssd_scan_plain(S, d)
    (hb, hf), (rb, rf) = run(), plain()
    torch.cuda.synchronize()
    err = max(float((hb - rb).abs().max()), float((hf - rf).abs().max()))
    tol = 1e-5 * max(float(rb.abs().max()), float(rf.abs().max()))
    ms, plain_ms = time_ms(run), time_ms(plain, warmup=1, iters=10)
    (dev_ms, split), (dev_plain_ms, _) = device_ms(run), device_ms(plain,
                                                                   10)
    nbytes = 4 * (2 * S.numel() + d.numel() + hf.numel())
    b_ms, b_by = bound(nbytes, 2 * S.numel())
    log(f"[zoo-kernels] ssd_scan B={B} nc={nc} H={H} N={N} P={P}: "
        f"max_abs_err={err:.3e} (tol {tol:.3e}) kernel {ms:.4f} ms (device "
        f"{dev_ms:.4f} [{split}], {nbytes / ms / 1e6:.0f} GB/s at the call "
        f"time), plain "
        f"{plain_ms:.4f} ms (device {dev_plain_ms:.4f}), bound {b_ms:.4f} ms "
        f"({b_by}; {nbytes} bytes)")
    if not err <= tol:
        raise AssertionError(f"ssd_scan: {err} > {tol}")
    # integer-valued S and d = 0.5: every step exact, so bit-exact
    Si = torch.randint(-8, 9, (B, nc, H, N, P), generator=gen,
                       device=DEVICE).float()
    di = torch.full((B, nc, H), 0.5, device=DEVICE)
    (hb, hf), (rb, rf) = ss.ssd_scan(Si, di), ss.ssd_scan_plain(Si, di)
    if not (torch.equal(hb, rb) and torch.equal(hf, rf)
            and float(hb[:, 0].abs().max()) == 0.0):
        raise AssertionError("ssd_scan: integer inputs not bit-exact")
    log("[zoo-kernels] ssd_scan integer S, d = 0.5: bit-exact, state "
        "before chunk 0 exactly 0")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def _decode_tol(ref) -> float:
    """decode_attention's limit against its plain version: one bf16 ulp
    of max|ref| in bf16 (both compute in f32 and round once; their sums
    differ in order alone), 1e-5 of it in f32."""
    import math

    import torch
    scale = float(ref.float().abs().max())
    if ref.dtype == torch.bfloat16:
        return 2.0 ** (math.floor(math.log2(scale)) - 7)
    return 1e-5 * scale


def _ring_k_pos(B, C, pos, device):
    """k_pos [B, C] of a cache that has seen positions 0..pos: slot s
    holds the last position p <= pos with p % C == s (-1 where p < 0),
    as a full cache (pos < C) and a ring write them."""
    import torch
    slots = torch.arange(C, device=device, dtype=torch.int32)
    p = pos - torch.remainder(pos - slots, C)
    return torch.where(p >= 0, p, -1)[None].expand(B, C).contiguous()


def check_decode_attention() -> dict:
    """Each DECODE_CASES case: kernel vs plain over the same cache, in
    bf16, within `_decode_tol`, timed beside the bytes' bound (the n
    slots read of K and V, k_pos, q and the output) and beside PyTorch's
    scaled_dot_product_attention over the same n slots with the same
    mask (the yardstick only; its mask is built outside the timing).
    Returns the kernels-line rows by case label."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dec
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    rows = {}
    for label, B, H, KH, hd, C, pos, window in DECODE_CASES:
        q, k, v = (torch.randn(shape, generator=gen, device=DEVICE)
                   .to(torch.bfloat16) for shape in
                   ((B, 1, H, hd), (B, C, KH, hd), (B, C, KH, hd)))
        k_pos = (None if pos is None
                 else _ring_k_pos(B, C, pos, DEVICE))
        at = pos or 0
        n = dec.read_slots(C, k_pos, at)
        mask = None
        if k_pos is not None:
            kp = k_pos[:, :n]
            mask = (kp >= 0) & (kp <= at)
            if window is not None:
                mask = mask & (at - kp < window)
            mask = mask[:, None, None, :]
        qt, kt, vt = (q.transpose(1, 2), k[:, :n].transpose(1, 2),
                      v[:, :n].transpose(1, 2))

        def run():
            return dec.decode_attention(q, k, v, k_pos, at, window=window)

        def plain():
            return dec.decode_attention_plain(q, k, v, k_pos, at,
                                              window=window)

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=mask,
                                                  enable_gqa=True)
        out, ref = run(), plain()
        lib_err = float((library().transpose(1, 2).float()
                         - ref.float()).abs().max())
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        tol = _decode_tol(ref)
        splits, _ = dec.plan(B * KH, n, dec.tile_slots(hd, 2),
                             dec._sm_count(0))
        before = dec.launches
        ms = time_ms(run, iters=DECODE_ITERS)
        launched = (dec.launches - before) / (WARMUP + DECODE_ITERS)
        plain_ms = time_ms(plain, warmup=1, iters=10)
        library_ms = time_ms(library, iters=DECODE_ITERS)
        (dev_ms, split), (dev_plain_ms, _) = (device_ms(run, DECODE_ITERS),
                                              device_ms(plain, 10))
        nbytes = (2 * B * n * KH * hd * 2 + 2 * B * H * hd * 2
                  + (0 if k_pos is None else 4 * B * n))
        flops = 4 * B * H * n * hd
        b_ms, b_by = bound(nbytes, flops, PEAK_BF16_FLOP_PER_S)
        log(f"[zoo-kernels] decode_attention {label} B={B} H={H} KH={KH} "
            f"hd={hd} C={C} pos={pos} window={window} bfloat16 "
            f"(decode_attention.cu, {splits} split(s), {launched:g} "
            f"launches a call): kernel {ms:.4f} ms call, "
            f"{nbytes / ms / 1e6:.0f} GB/s, bound / call {b_ms / ms:.1%}, "
            f"bound / device {b_ms / dev_ms:.1%}; max_abs_err={err:.3e} "
            f"(limit one bf16 ulp of max|ref| "
            f"{float(ref.float().abs().max()):.4f}: {tol:.3e}) "
            f"kernel device {dev_ms:.4f} ms [{split}], plain "
            f"{plain_ms:.4f} ms (device {dev_plain_ms:.4f}), SDPA "
            f"{library_ms:.4f} ms (max|Δ| to plain {lib_err:.3e}), bound "
            f"{b_ms:.4f} ms ({b_by}; {n} slots read, {nbytes} bytes, "
            f"{flops:.4e} FLOP)")
        if not (err <= tol and bool(torch.isfinite(out).all())):
            raise AssertionError(f"decode_attention {label}: max_abs_err "
                                 f"{err} > {tol}")
        if launched != 1 + (splits > 1):
            raise AssertionError(f"decode_attention {label}: {launched} "
                                 f"launches a call, {splits} splits")
        rows[label] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": b_ms, "bound_by": b_by,
                       "library_ms": library_ms}
        del q, k, v, k_pos, out, ref, mask, qt, kt, vt
    return rows


# --------------------------------------------------------------------- 9
def _cut(full, depth):
    """`full` with its stacks cut to `depth`: an int for a config of one
    stack, else one repeat count a stack (a stack cut to 0 is left
    out)."""
    import dataclasses

    from repro_torch.models.config import Stack
    depths = (depth,) if isinstance(depth, int) else tuple(depth)
    if len(depths) != len(full.stacks):
        raise ValueError(f"{full.name}: {len(full.stacks)} stacks, depth "
                         f"{depth}")
    stacks = tuple(Stack(s.pattern, n) for s, n in zip(full.stacks, depths)
                   if n)
    return full if stacks == full.stacks else dataclasses.replace(
        full, stacks=stacks)


def _lm_model(arch=ARCH, tag="lm-forward", depth=None):
    """`arch`'s full config (cut to `depth` if given: a layer count for a
    config of one stack, else one count a stack) and its seed-0 params on
    the card."""
    import torch
    from repro_torch.models import lm, registry
    cfg = full = registry.get_config(arch)
    if depth is not None:
        cfg = _cut(full, depth)
    t0 = time.perf_counter()
    params = lm.init_params(torch.Generator(device=DEVICE).manual_seed(0),
                            cfg, device=DEVICE)
    torch.cuda.synchronize()
    mixer = (f"mla {cfg.mla}, {cfg.num_heads} heads" if cfg.mla else
             f"{cfg.num_heads} heads ({cfg.num_kv_heads} kv), head_dim "
             f"{cfg.resolved_head_dim}, window "
             f"{cfg.sliding_window if cfg.has_mixer('swa') else None}"
             if cfg.num_heads else f"ssm {cfg.ssm}")
    ffn = ", ".join(
        [f"d_ff {cfg.d_ff}"] * any(e.endswith("+mlp") for s in cfg.stacks
                                   for e in s.pattern)
        + [f"moe {cfg.moe}"] * bool(cfg.moe))
    log(f"[{tag}] {arch} full config: {cfg.num_layers} layers"
        f"{'' if cfg is full else f' (cut from {full.num_layers})'}, "
        f"d_model {cfg.d_model}, {mixer}, {ffn}, vocab {cfg.vocab_size}, "
        f"{cfg.dtype}; {lm.param_count(params)} params initialized on the "
        f"card in {time.perf_counter() - t0:.2f} s")
    return cfg, params


@contextlib.contextmanager
def _flash_in_model(fn):
    """Has the model's layers call `fn(q, k, v, **kw)` where they call
    the flash kernel."""
    from repro_torch.models import layers
    kernel = layers.flash_attention
    layers.flash_attention = fn
    try:
        yield
    finally:
        layers.flash_attention = kernel


def _model_faults(window):
    """Wrong kernels planted to show what the LM checks catch: attention
    output zeroed; with a window, the window one key tile short; without
    one, the causal mask off and each row seeing one key tile of its
    future."""
    import torch
    from repro_torch.kernels import flash_attention as fa

    def zeroed(q, k, v, **kw):
        return torch.zeros_like(q)

    def short(q, k, v, *, window, **kw):
        return fa.flash_attention(q, k, v, window=window - FAULT_TILE, **kw)

    def acausal(q, k, v, **kw):
        return fa.flash_attention(q, k, v, **{**kw, "causal": False})

    def future(q, k, v, *, q_offset=0, **kw):
        return fa.flash_attention(q, k, v, q_offset=q_offset + FAULT_TILE,
                                  **kw)
    if window:
        return (("attention output zeroed", zeroed),
                (f"window {FAULT_TILE} keys short", short))
    return (("attention output zeroed", zeroed),
            ("causal mask off", acausal),
            (f"each row sees {FAULT_TILE} future keys", future))


def _rel_rms(out, ref) -> float:
    out, ref = out.float(), ref.float()
    return float((out - ref).pow(2).mean().sqrt() / ref.pow(2).mean().sqrt())


def _lm_limits(cfg) -> tuple[float, float, float]:
    """(|Δloss| limit, max|Δlogits| limit / max|logits|, layer-0 rms
    limit) of kernel vs. chunked_attention in the model's dtype."""
    if cfg.dtype == "float32":
        return LM_F32_LOSS_TOL, LM_F32_LOGIT_RTOL, LAYER_RMS_RTOL_F32
    return (LM_LOSS_TOL, LM_LOGIT_RTOL_ARCH.get(cfg.name, LM_LOGIT_RTOL),
            LAYER_RMS_RTOL)


def _layer_hold(cfg, seen, tag="lm-forward") -> None:
    """Layer 0's attention at the full shape, on the inputs the model gave
    the kernel: kernel vs. its plain version element by element, and vs.
    chunked_attention (the flag off) as a relative rms error, which each
    planted fault must exceed."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.layers import chunked_attention
    rms_tol = _lm_limits(cfg)[2]
    q, k, v, kw = seen["q"], seen["k"], seen["v"], seen["kw"]
    out = fa.flash_attention(q, k, v, **kw)
    ok, err, worst = _within(out, fa.flash_attention_plain(
        q, k, v, exact=cfg.dtype == "float32", **kw), *FLASH_TOL[cfg.dtype])
    ref = chunked_attention(q, k, v, **kw)
    rel = _rel_rms(out, ref)
    log(f"[{tag}] layer 0 attention {tuple(q.shape)} {q.dtype} {kw}: "
        f"kernel vs plain max_abs_err={err:.3e} (worst {worst:.3f} of the "
        f"limit); kernel vs chunked_attention rms(Δ)/rms(ref) {rel:.4e} "
        f"(limit {rms_tol:.4e})")
    if not (ok and rel <= rms_tol):
        raise AssertionError(f"{tag}: layer 0 attention out of tolerance")
    for label, fault in _model_faults(kw.get("window")):
        frel = _rel_rms(fault(q, k, v, **kw), ref)
        log(f"[{tag}] planted fault, {label}: layer 0 rms(Δ)/rms(ref) "
            f"{frel:.4e}: {'caught' if frel > rms_tol else 'MISSED'}")
        if not frel > rms_tol:
            raise AssertionError(f"{tag}: layer check misses {label}")


def _forward(params, cfg, batch):
    """(loss, last-position logits in f32) of one scoring pass."""
    from repro_torch.models import lm
    loss = float(lm.loss_fn(params, cfg, batch))
    x = lm._embed_inputs(params, cfg, batch)
    last = lm.logits_fn(params, cfg, lm.forward_trunk(params, cfg, x)
                        [:, -1:]).float()
    return loss, last


def _lm_tokens(cfg) -> dict:
    """LM_BATCH x LM_SEQ tokens from numpy's seed 0."""
    import numpy as np
    import torch
    return {"tokens": torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_SEQ))).to(DEVICE)}


def lm_forward(cfg, params, tag="lm-forward", batch=None) -> dict:
    """`loss_fn` over `batch` (LM_BATCH x LM_SEQ tokens by default) with
    the flash kernel and with chunked_attention, in the model's dtype:
    one launch per attention layer of the route of that dtype and head
    dim (`fa.route_for`), agreement within that dtype's limits, the first
    attention layer held apart, planted faults. The flash run is
    profiled (the chunked reference is not). Returns
    {flag: {"loss", "last" (last-position logits, f32), "launches",
    "wall"}}."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import lm
    loss_tol, logit_rtol, _ = _lm_limits(cfg)
    from repro_torch.models.layers import _dt
    route = FLASH_ROUTE_KEY[fa.route_for(_dt(cfg), cfg.resolved_head_dim)]
    n_attn = sum(stack.repeats for stack in cfg.stacks
                 for elem in stack.pattern
                 if elem.split("+")[0] in ("attn", "swa"))
    batch = batch or _lm_tokens(cfg)
    res, seen = {}, {}

    def keep_first(q, k, v, **kw):
        if not seen:
            seen.update(q=q.clone(), k=k.clone(), v=v.clone(), kw=kw)
        return fa.flash_attention(q, k, v, **kw)
    for flag in (True, False):
        c = dataclasses.replace(cfg, use_pallas_attn=flag)
        with _flash_in_model(keep_first):
            x = lm._embed_inputs(params, c, batch)
            last = lm.logits_fn(params, c, lm.forward_trunk(params, c, x)
                                [:, -1:]).float()       # also the warm-up
            del x
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.perf_counter()
        loss = float(lm.loss_fn(params, c, batch))
        wall = time.perf_counter() - t0
        launches = _launches()
        peak = torch.cuda.max_memory_allocated()
        label = "flash kernel" if flag else "chunked_attention"
        B = last.shape[0]
        S = (batch["embeddings"].shape[1] if cfg.embed_inputs
             else batch["tokens"].shape[1] + cfg.num_patch_tokens)
        log(f"[{tag}] loss_fn over {B} x {S} positions ({sorted(batch)}) "
            f"in {cfg.dtype} with {label}: loss {loss:.6f}, wall "
            f"{wall:.3f} s per forward, launches {launches}, peak memory "
            f"{peak / 2**30:.2f} GiB")
        if flag:
            _log_profile(tag, lambda: lm.loss_fn(params, c, batch))
        if not (np.isfinite(loss) and torch.isfinite(last).all()
                and last.shape == (B, 1, cfg.vocab_size)):
            raise AssertionError(f"{tag} {label}: non-finite output")
        res[flag] = {"loss": loss, "last": last, "launches": launches,
                     "wall": wall}
    scale = float(res[False]["last"].abs().max())

    def caught(loss, last) -> tuple[bool, str]:
        dloss = abs(loss - res[False]["loss"])
        dlogit = float((last - res[False]["last"]).abs().max())
        return (not (dloss <= loss_tol and dlogit <= logit_rtol * scale),
                f"|Δloss| {dloss:.3e} (tol {loss_tol:.1e}), max|Δlogits| "
                f"{dlogit:.4e} (tol {logit_rtol * scale:.4e}, max|logits| "
                f"{scale:.4f})")
    off, text = caught(res[True]["loss"], res[True]["last"])
    log(f"[{tag}] flash kernel vs chunked_attention: {text}")
    if off:
        raise AssertionError(f"{tag}: kernel vs chunked out of tolerance")
    n = res[True]["launches"]["flash_attention"]
    n_route = res[True]["launches"][route]
    if (n != n_attn or n_route != n
            or res[False]["launches"]["flash_attention"]):
        raise AssertionError(f"{tag}: {n} flash launches ({n_route} of "
                             f"{route}), expected {n_attn}, all of "
                             f"it (and 0 with the flag off)")
    _layer_hold(cfg, seen, tag)
    window = seen["kw"].get("window")
    seen.clear()
    # what the end-to-end limits make of the planted faults (reported;
    # the layer check above is the one held to catch them)
    c = dataclasses.replace(cfg, use_pallas_attn=True)
    for label, fault in _model_faults(window):
        with _flash_in_model(fault):
            hit, text = caught(*_forward(params, c, batch))
        log(f"[{tag}] planted fault, {label}, end to end: {text}: "
            f"{'caught' if hit else 'MISSED'}")
    return res


def lm_prefill_route(cfg, params, tag, batch) -> None:
    """`prefill_step_fn` over `batch` with `use_pallas_attn` and without:
    one launch of the tensor-core kernel per attention layer and call
    with the flag, none without; the last position's logits within the
    model's logit limit (`_lm_limits`) times max|logits|; layer 0's
    caches (its keys and values come before any attention) bit for bit."""
    import dataclasses

    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import lm
    rtol = _lm_limits(cfg)[1]
    n_attn = sum(stack.repeats for stack in cfg.stacks
                 for elem in stack.pattern
                 if elem.split("+")[0] in ("attn", "swa"))
    S = batch["tokens"].shape[1]
    out = {}
    for flag in (True, False):
        c = dataclasses.replace(cfg, use_pallas_attn=flag)
        with torch.inference_mode():
            torch.cuda.synchronize()
            fa.launches_tc = 0
            t0 = time.perf_counter()
            logits, caches = lm.prefill_step_fn(c, capacity=S)(params, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = fa.launches_tc
        first = {k: v[0].clone() for k, v in caches[0][0].items()}
        del caches
        out[flag] = logits.float(), first
        log(f"[{tag}] prefill_step_fn over {tuple(batch['tokens'].shape)} "
            f"tokens, use_pallas_attn={flag}: {wall:.3f} s, tensor-core "
            f"flash launches {launches}")
        if launches != (n_attn if flag else 0):
            raise AssertionError(f"{tag}: prefill with use_pallas_attn="
                                 f"{flag} launched the tensor-core kernel "
                                 f"{launches} times, expected "
                                 f"{n_attn if flag else 0}")
    (got, first), (want, ref) = out[True], out[False]
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    same = all(torch.equal(first[k], ref[k]) for k in ref)
    log(f"[{tag}] prefill, flash kernel vs chunked_attention: max|Δlogits| "
        f"{err:.4e} (tol {rtol * scale:.4e}, max|logits| {scale:.4f}); "
        f"layer 0's caches {'equal' if same else 'DIFFER'}")
    if not (bool(torch.isfinite(got).all()) and err <= rtol * scale
            and same):
        raise AssertionError(f"{tag}: prefill, kernel vs chunked out of "
                             "tolerance")


def _log_profile(tag, fn, top=5) -> float:
    """Profiles one `fn()` (`device_profile`): logs device seconds and
    the `top` kernels by device time, then the flash kernels wherever
    they rank (the pass's attention share); returns the device seconds."""
    prof, wall = device_profile(fn)
    busy = sum(us for _, us in prof.values()) / 1e6
    log(f"[{tag}] profiled pass: wall {wall:.3f} s, device {busy:.3f} s "
        f"({busy / wall:.1%}), {sum(c for c, _ in prof.values())} kernel "
        f"launches; top:")
    ranked = sorted(prof.items(), key=lambda kv: -kv[1][1])
    for name, (count, us) in ranked[:top] + [
            kv for kv in ranked[top:] if "flash" in kv[0]]:
        log(f"[{tag}]   {us / 1e3:10.3f} ms {count:5d}x  {_short(name)}")
    return busy


def as_f32(cfg, params, tag="lm-forward-f32"):
    """The f32 configuration of the model and its parameters: the same
    (seed-0, bf16) weights cast to f32, tensor by tensor; the bf16 tree
    is emptied as it goes, so that both never sit whole on the card."""
    import dataclasses

    import torch

    def cast(tree):
        if isinstance(tree, dict):
            for key in list(tree):
                tree[key] = cast(tree[key])
            return tree
        if isinstance(tree, (list, tuple)):
            out = [cast(t) for t in tree]
            return out if isinstance(tree, list) else tuple(out)
        return tree.float() if tree.is_floating_point() else tree
    t0 = time.perf_counter()
    f32 = cast(params)
    torch.cuda.synchronize()
    from repro_torch.models import lm
    n = lm.param_count(f32)
    log(f"[{tag}] {cfg.name} in float32: the seed-0 weights cast, "
        f"{n} params, {4 * n / 2**30:.2f} GiB, in "
        f"{time.perf_counter() - t0:.2f} s")
    return dataclasses.replace(cfg, dtype="float32"), f32


# -------------------------------------------------------------------- 10
def _near_ties(p, mc, xf):
    """[T] bool: the tokens of xf [T, D] whose k-th and (k+1)-th router
    selection scores (softmax, or sigmoid + e_bias) lie within
    MOE_TIE_RTOL of each other (relative to the k-th): top-k may order
    such a pair either way on two devices."""
    import torch
    logits = xf.float() @ p["router"]
    sel = (torch.sigmoid(logits) + p["e_bias"][None, :] if mc.router_scale
           else torch.softmax(logits, dim=-1))
    top = sel.topk(mc.top_k + 1, dim=-1).values
    return (top[:, -2] - top[:, -1]) <= MOE_TIE_RTOL * top[:, -2].abs()


@contextlib.contextmanager
def _moe_drops():
    """Routes and dispatches the input of every `moe_apply` call of the
    model once more, as `moe_apply` does, and counts from that dispatch
    the (token, choice) pairs dropped at capacity and marks the tokens
    that lose one; counts the top-k near-ties (`_near_ties`); keeps the
    first call's params and input. Yields {"dropped": [pairs per call],
    "tokens": [[B, S] bool per call], "ties": [per call], "p0": ...,
    "x0": ...}."""
    import torch
    from repro_torch.models import layers
    apply = layers.moe_apply
    rec = {"dropped": [], "tokens": [], "ties": [], "p0": None, "x0": None}

    def counting(p, cfg, x):
        mc = cfg.moe
        xf = x.reshape(-1, x.shape[-1])
        _, ids = layers._route(p, mc, xf)
        sort_idx, _, keep = layers.moe_dispatch(
            ids, mc.num_experts, layers.moe_capacity(xf.shape[0], mc))
        lost = torch.zeros(xf.shape[0], dtype=torch.bool, device=x.device)
        lost[sort_idx[~keep] // mc.top_k] = True
        rec["dropped"].append(int((~keep).sum()))
        rec["tokens"].append(lost.reshape(x.shape[:2]))
        rec["ties"].append(int(_near_ties(p, mc, xf).sum()))
        if rec["x0"] is None:
            rec["p0"], rec["x0"] = p, x.clone()
        return apply(p, cfg, x)
    layers.moe_apply = counting
    try:
        yield rec
    finally:
        layers.moe_apply = apply


@contextlib.contextmanager
def _decode_calls(pos):
    """Within: the first `layers.cache_attention` call at position `pos`
    of each distinct (q shape, cache shape, dtype, window, k_pos given)
    keeps copies of its inputs and of the output it returned."""
    from repro_torch.models import layers
    fn = layers.decode_attention
    calls = {}

    def recording(q, k_cache, v_cache, k_pos, at, *, window=None):
        out = fn(q, k_cache, v_cache, k_pos, at, window=window)
        key = (tuple(q.shape), tuple(k_cache.shape), q.dtype, window,
               k_pos is None)
        if at == pos and key not in calls:
            calls[key] = (q.clone(), k_cache.clone(), v_cache.clone(),
                          None if k_pos is None else k_pos.clone(), window,
                          out.clone())
        return out
    layers.decode_attention = recording
    try:
        yield calls
    finally:
        layers.decode_attention = fn


def _hold_decode_calls(tag, calls, pos) -> float:
    """Each call `_decode_calls` kept: the output the serve loop got from
    the kernel against the plain version on the same inputs, within
    `_decode_tol`. Returns the largest |Δ| (0.0 with no call)."""
    from repro_torch.kernels import decode_attention as dec
    worst = 0.0
    for (qs, cs, dtype, window, _), (q, k, v, k_pos, _, out) in \
            calls.items():
        ref = dec.decode_attention_plain(q, k, v, k_pos, pos, window=window)
        err = float((out.float() - ref.float()).abs().max())
        tol = _decode_tol(ref)
        n = dec.read_slots(cs[1], k_pos, pos)
        splits, _ = dec.plan(cs[0] * cs[2], n,
                             dec.tile_slots(cs[3], q.element_size()),
                             dec._sm_count(0))
        log(f"[{tag}] decode_attention on the serve loop's own call at "
            f"position {pos}: q {list(qs)}, cache {list(cs)} {dtype}, "
            f"window {window}, {'k_pos' if k_pos is not None else 'no k_pos'}"
            f", {n} slots read, {splits} split(s): max_abs_err {err:.3e} "
            f"against the plain version (limit {tol:.3e})")
        if not err <= tol:
            raise AssertionError(f"{tag}: decode_attention's serve call "
                                 f"{err} > {tol}")
        worst = max(worst, err)
    return worst


def lm_serve(cfg, params, tag="lm-serve") -> tuple[dict, float]:
    """The serve loop (batch SERVE_BATCH, prompt SERVE_PROMPT,
    SERVE_STEPS greedy steps) with its launches, one profiled decode
    step, and prefill on SERVE_PROMPT - 1 tokens + decode of the last
    against the forward's last position. Each decode-attention call of
    the loop at SERVE_DECODE_POS (one a cache shape) is held against the
    plain version on its own inputs (`_hold_decode_calls`). With MoE
    layers the decode vs forward check is
    made on the sequences that no drop at capacity reaches
    (`_clean_rows`: all of them where nothing is dropped) and fails if
    there are none. Returns the serve loop's kernel launches
    (`_launches`) and the largest |Δ| of its decode-attention calls."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import lm
    tokens = serve.prompts(cfg, SERVE_BATCH, SERVE_PROMPT, seed=0,
                           device=DEVICE)
    serve.serve_loop(params, cfg, tokens[:, :16], decode_steps=2)  # warm-up
    _reset_launches()
    with _decode_calls(SERVE_DECODE_POS) as calls:
        res = serve.serve_loop(params, cfg, tokens,
                               decode_steps=SERVE_STEPS)
    launches = _launches()
    if launches["decode_attention"] and not calls:
        raise AssertionError(f"{tag}: decode_attention launched, but no "
                             f"call at position {SERVE_DECODE_POS}")
    decode_err = _hold_decode_calls(tag, calls, SERVE_DECODE_POS)
    del calls
    toks = SERVE_BATCH * SERVE_STEPS
    gen = res["tokens"]
    log(f"[{tag}] {cfg.name} batch {SERVE_BATCH}, prompt {SERVE_PROMPT}, "
        f"{SERVE_STEPS} greedy steps on "
        f"{serve.device_label(torch.device(DEVICE))}: prefill "
        f"{res['prefill_s']:.4f} s, decode {res['decode_s']:.4f} s "
        f"({toks / res['decode_s']:.1f} tok/s, "
        f"{res['decode_s'] / SERVE_STEPS * 1e3:.2f} ms per step), "
        f"launches {launches}; req0 starts {gen[0, :8].tolist()}")
    if gen.shape != (SERVE_BATCH, SERVE_STEPS) or not bool(
            ((gen >= 0) & (gen < cfg.vocab_size)).all()):
        raise AssertionError(f"{tag}: generated ids out of range")
    with torch.inference_mode(), _moe_drops() as drops:
        x = lm._embed_inputs(params, cfg, {"tokens": tokens})
        full = lm.logits_fn(params, cfg, lm.forward_trunk(
            params, cfg, x)[:, -1]).float()
        del x
        _, cache = lm.prefill_step_fn(cfg, capacity=SERVE_PROMPT)(
            params, {"tokens": tokens[:, :-1]})
        decode = lm.decode_step_fn(cfg)
        step, _ = decode(params, cache, tokens[:, -1:], SERVE_PROMPT - 1)
    with torch.inference_mode():
        # where a decode step's time goes: the same step again (an
        # attention layer rewrites the same cache slot, an SSD layer
        # advances its state once more; its logits are not used), profiled
        # without `_moe_drops`' routing beside it
        prof, wall = device_profile(lambda: decode(
            params, cache, tokens[:, -1:], SERVE_PROMPT - 1))
    busy = sum(us for _, us in prof.values()) / 1e3
    top = sorted(prof.items(), key=lambda kv: -kv[1][1])[:4]
    log(f"[{tag}] one profiled decode step: wall {wall * 1e3:.2f} ms, "
        f"device busy {busy:.2f} ms ({busy / (wall * 1e3):.1%}), "
        f"{sum(c for c, _ in prof.values())} kernel launches; top: "
        + ", ".join(f"{_short(n)} {us / 1e3:.3f} ms ({c}x)"
                    for n, (c, us) in top))
    what = (f"prefill on {SERVE_PROMPT - 1} tokens + decode of token "
            f"{SERVE_PROMPT}")
    if cfg.moe:
        n = sum(s.repeats for s in cfg.stacks for e in s.pattern
                if e.endswith("+moe"))
        log(f"[{tag}] pairs dropped at capacity, per MoE layer: forward "
            f"over {SERVE_BATCH} x {SERVE_PROMPT} tokens "
            f"{drops['dropped'][:n]}, prefill {drops['dropped'][n:2 * n]}, "
            f"decode {drops['dropped'][2 * n:3 * n]}; top-k near-ties "
            f"{drops['ties'][:3 * n]}")
        rows = _clean_rows(cfg, drops["tokens"], n)
        log(f"[{tag}] sequences no drop reaches: {rows} of {SERVE_BATCH}")
        if not rows:
            raise AssertionError(f"{tag}: drops reach every sequence; "
                                 "decode vs forward cannot be held")
        step, full = step[rows], full[rows]
        what += f", sequences {rows}"
    _hold_decode(tag, cfg, step[:, 0], full, what)
    return launches, decode_err


def _clean_rows(cfg, tokens, n) -> list:
    """The sequences whose decode logits a capacity drop cannot move, from
    the [B, S] dropped-token marks of n MoE calls each of the forward,
    the prefill and the decode (`_moe_drops`): a drop in a MoE layer that
    a mixer follows moves its token's input to every later layer, and so
    the whole sequence through attention; a drop in the model's last
    layer moves its own token's output alone, which counts at the
    forward's last position and nowhere in the prefill (its last layer
    feeds no cache)."""
    last = cfg.stacks[-1].pattern[-1].endswith("+moe")
    fwd, pre, dec = tokens[:n], tokens[n:2 * n], tokens[2 * n:3 * n]
    hit = sum(t.any(dim=1) for t in fwd[:n - last] + pre[:n - last]
              + dec) + sum(t[:, -1] for t in fwd[n - last:])
    return [b for b in range(len(hit)) if not bool(hit[b])]


def _hold_decode(tag, cfg, got, want, what) -> None:
    """Decode's logits against the forward's last position, within the
    model's logit limit (`_lm_limits`) times max|logits|."""
    import torch
    rtol = _lm_limits(cfg)[1]
    got, want = got.float().reshape(want.shape), want.float()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    log(f"[{tag}] {what} vs the forward's last position: max|Δlogits| "
        f"{err:.4e} (tol {rtol * scale:.4e}, max|logits| {scale:.4f})")
    if not (bool(torch.isfinite(got).all()) and err <= rtol * scale):
        raise AssertionError(f"{tag}: decode vs forward out of tolerance")


# -------------------------------------------------------------------- 12
TILE_MAX_CONFIGS = 24      # bench_fig4.py
TILE_MAX_NODES = 64        # bench_fig4.py keeps kernels of <= 64 nodes
# examples/fusion_search.py's programs and its model + HW budget
FUSION_PROGRAMS = (("attention", 1), ("rnn", 2), ("norm", 0))
FUSION_BUDGET_S, FUSION_EVAL_S, FUSION_MODEL_STEPS = 6.0, 2.0, 300
SOCKET_CLIENTS = 4
AGG_KERNELS = ("graph_aggregate", "segment_aggregate", "segment_aggregate_i8")


def _tol(want) -> float:
    """The serving agreement limit: 1e-4 · max(1, max|pred|)."""
    import numpy as np
    return 1e-4 * max(1.0, float(np.max(np.abs(want))))


def _timed(svc):
    """`svc` with its `predict_many` timed: wall seconds add up in
    `svc.scoring_s` (predictions come back to the host, so each call
    ends synchronized)."""
    svc.scoring_s = 0.0
    inner = svc.predict_many

    def predict_many(graphs):
        t0 = time.perf_counter()
        out = inner(graphs)
        svc.scoring_s += time.perf_counter() - t0
        return out
    svc.predict_many = predict_many
    return svc


def _trained_service(trainer, norm, layout: str, use_kernels: bool):
    """A service over a model trained in phase 7 (the trainer's own
    parameters, as its checkpoint holds them), kernels on or off."""
    import dataclasses
    from repro_torch.core.evaluate import make_predict_fn
    from repro_torch.serving import CostModelService
    cfg = dataclasses.replace(trainer.model_cfg, adjacency=layout,
                              use_pallas_aggregate=use_kernels)
    return _timed(CostModelService(trainer.model, cfg, norm,
                                   predict_fn=make_predict_fn(cfg)))


def _ties(scores, tol) -> int:
    """Candidate pairs of one list whose scores lie within `tol`."""
    import numpy as np
    s = np.sort(np.asarray(scores))
    return int(sum(np.sum(s[i + 1:] - s[i] <= tol) for i in range(len(s))))


def table2(label, on, off, records) -> None:
    """`eval_tile_task` with the kernels on and off. The scores must agree
    within the serving limit; a program's metrics may differ only where
    it holds candidates tied within it."""
    import numpy as np
    from repro_torch.core.evaluate import eval_tile_task
    from repro_torch.data.tile_dataset import TileDataset
    ds = TileDataset(list(records))
    logs = {"on": [], "off": []}

    def recording(svc, out):
        score = svc.tile_scorer()

        def scorer(kernel, tiles):
            s = score(kernel, tiles)
            out.append(s)
            return s
        return scorer
    t0 = time.perf_counter()
    res = eval_tile_task(ds, recording(on, logs["on"]))
    wall = time.perf_counter() - t0
    ref = eval_tile_task(ds, recording(off, logs["off"]))
    got, want = np.concatenate(logs["on"]), np.concatenate(logs["off"])
    err, tol = float(np.max(np.abs(got - want))), _tol(want)
    ties, i = {}, 0
    for prog, recs in ds.by_program().items():
        ties[prog] = sum(_ties(s, tol) for s in logs["on"][i:i + len(recs)])
        i += len(recs)
    moved = [p for p in res["per_program"]
             if res["per_program"][p] != ref["per_program"][p]]
    log(f"[autotune] table 2 tile task, {label}: median APE "
        f"{res['median_ape']:.4f} mean APE {res['mean_ape']:.4f} median "
        f"tau {res['median_kendall']:.4f} mean tau "
        f"{res['mean_kendall']:.4f} over {len(res['per_program'])} "
        f"programs, {len(got)} queries in {wall:.3f} s; kernels off: "
        f"median APE {ref['median_ape']:.4f} mean tau "
        f"{ref['mean_kendall']:.4f}; max|on - off| {err:.3e} (tol "
        f"{tol:.3e}); {sum(ties.values())} candidate pairs tied within "
        f"tol; programs whose metrics moved: {moved}")
    if not err <= tol:
        raise AssertionError(f"table 2 {label}: scores {err} > {tol}")
    for p in moved:
        if not ties[p]:
            raise AssertionError(f"table 2 {label}: {p}'s metrics moved "
                                 f"with the kernels off and no tie")


def _picks_agree(label, kernels, on_res, off_res, on_svc, tol) -> int:
    """The picks of the kernels-on run equal those of the kernels-off
    run, but for candidates tied within `tol`; returns the ties."""
    ties = 0
    for k, a, b in zip(kernels, on_res.results, off_res.results):
        if a.chosen_tile == b.chosen_tile:
            continue
        s_on, s_off = on_svc.predict_many([k.with_tile(a.chosen_tile),
                                           k.with_tile(b.chosen_tile)])
        if not abs(float(s_on) - float(s_off)) <= tol:
            raise AssertionError(
                f"{label}: {k.name} picks {a.chosen_tile} with the kernels "
                f"on and {b.chosen_tile} off ({s_on} vs {s_off})")
        ties += 1
    return ties


def tile_autotune(trained, norm, programs) -> None:
    """`autotune_program_tiles` over the held-out programs' default-fused
    kernels: learned top-1 / top-10 through both trained layouts (kernels
    on, then off for the picks), analytical top-1 (the compiler default)
    and top-10, exhaustive."""
    from repro_torch.autotuner import autotune_program_tiles
    from repro_torch.core.analytical import AnalyticalModel
    from repro_torch.core.evaluate import analytical_tile_scorer
    from repro_torch.core.simulator import TPUSimulator
    from repro_torch.data.fusion import apply_fusion, default_fusion
    from repro_torch.search import LearnedEstimator
    sim = TPUSimulator()
    progs = [ks for ks in ([k for k in apply_fusion(p, default_fusion(p))
                            if k.num_nodes <= TILE_MAX_NODES]
                           for p in programs) if ks]

    def run(**kw):
        return [autotune_program_tiles(ks, sim, max_configs=TILE_MAX_CONFIGS,
                                       **kw) for ks in progs]

    def total(rs):
        return sum(r.total_runtime for r in rs)

    analytical = analytical_tile_scorer(AnalyticalModel())
    default = total(run(scorer=analytical, top_k=1))
    rows = {"exhaustive": run(),
            "analytical top-10": run(scorer=analytical, top_k=10)}
    for layout in ("sparse", "dense"):
        for top_k in (1, 10):
            on = _trained_service(trained[layout], norm, layout, True)
            off = _trained_service(trained[layout], norm, layout, False)
            res = run(estimator=LearnedEstimator(on), top_k=top_k)
            ref = run(estimator=LearnedEstimator(off), top_k=top_k)
            label = f"learned top-{top_k} {layout}"
            q, secs = on.stats().graphs, on.scoring_s
            tol = _tol(on.predict_many([k for ks in progs for k in ks]))
            ties = sum(_picks_agree(label, ks, a, b, on, tol)
                       for ks, a, b in zip(progs, res, ref))
            log(f"[autotune] tiles, {label}: scoring {secs:.3f} s for {q} "
                f"queries ({q / secs:.1f} queries/s), picks equal to the "
                f"kernels off but {ties} tied within tol {tol:.3e}")
            rows[label] = res
    ex = total(rows["exhaustive"])
    for label, rs in rows.items():
        t = total(rs)
        log(f"[autotune] tiles, {label}: total runtime {t:.6e} s, speedup "
            f"over the analytical top-1 default {default / t:.4f}, "
            f"hardware evals {sum(r.hardware_evals for r in rs)} "
            f"({len(progs)} programs, "
            f"{sum(len(ks) for ks in progs)} kernels)")
        if not ex <= t:
            raise AssertionError(f"tiles: exhaustive {ex} > {label} {t}")


def fusion_autotune(trained, norm) -> None:
    """`simulated_annealing_fusion` on examples/fusion_search.py's three
    programs, scored by `model_cost_fn` of the trained segmented fusion
    model through `segment_aggregate`; every decision it scored is
    re-scored with the kernels off."""
    import dataclasses
    from repro_torch.autotuner import model_cost_fn, \
        simulated_annealing_fusion
    from repro_torch.core.simulator import TPUSimulator
    from repro_torch.data.synthetic import generate_program
    tr = trained["segmented"]
    cfg_on = dataclasses.replace(tr.model_cfg, use_pallas_aggregate=True)
    cfg_off = dataclasses.replace(tr.model_cfg, use_pallas_aggregate=False)
    cap = int(FUSION_BUDGET_S / FUSION_EVAL_S)
    for fam, idx in FUSION_PROGRAMS:
        prog = generate_program(fam, idx, seed=0)
        on = model_cost_fn(tr.model, cfg_on, norm)
        off = model_cost_fn(tr.model, cfg_off, norm)
        scored = []

        def cost(kernels):
            ks = list(kernels)
            c = on(ks)
            scored.append((ks, c))
            return c
        t0 = time.perf_counter()
        r = simulated_annealing_fusion(
            prog, TPUSimulator(), model_cost=cost,
            hardware_budget_s=FUSION_BUDGET_S, model_steps=FUSION_MODEL_STEPS,
            eval_seconds=FUSION_EVAL_S, seed=0)
        wall = time.perf_counter() - t0
        worst = max(abs(off(ks) - c) / max(1.0, abs(c)) for ks, c in scored)
        log(f"[autotune] fusion {prog.name}: speedup {r.speedup:.4f} "
            f"(default {r.default_runtime:.6e} s -> {r.best_runtime:.6e} "
            f"s), hardware evals {r.hardware_evals} (cap {cap}), model "
            f"evals {r.model_evals} in {wall:.3f} s "
            f"({len(scored) / wall:.1f} decisions/s); {len(scored)} scored "
            f"decisions re-scored with the kernels off: largest "
            f"|Δcost| / max(1, cost) {worst:.3e} (limit 1e-4)")
        if not r.speedup >= 1.0:
            raise AssertionError(f"fusion {prog.name}: speedup {r.speedup}")
        if not r.hardware_evals <= cap:
            raise AssertionError(f"fusion {prog.name}: {r.hardware_evals} "
                                 f"hardware evals > {cap}")
        if not worst <= 1e-4:
            raise AssertionError(f"fusion {prog.name}: kernels on vs off "
                                 f"{worst} > 1e-4")


def _socket_replay(server, requests, clients: int):
    """`clients` threads, each replaying `requests` through its own
    `CostModelClient`. Returns ({client: its answers}, per-request
    latencies in ms, wall seconds, errors)."""
    import threading
    from repro_torch.serving.client import CostModelClient
    host, port = server.address
    answers, lat, errors = {}, [], []
    lock = threading.Lock()

    def client(i):
        mine, times = [], []
        try:
            with CostModelClient(host, port, retries=0) as c:
                for req in requests:
                    t0 = time.perf_counter()
                    mine.append(c.predict_many(req, deadline_ms=60_000))
                    times.append((time.perf_counter() - t0) * 1e3)
        except Exception as e:                      # noqa: BLE001
            errors.append(repr(e))
        with lock:
            answers[i] = mine
            lat.extend(times)
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise AssertionError("socket: a client thread hung")
    return answers, lat, wall, errors


def socket_serve(label, make_service, requests, clients: int) -> None:
    """A `CostModelServer` on 127.0.0.1:0 over `make_service()`, `clients`
    client threads replaying `requests`; every answer against an
    in-process service of the same model."""
    import numpy as np
    from repro_torch.serving.server import CostModelServer
    ref = make_service()
    want = np.concatenate([ref.predict_many(r) for r in requests])
    with CostModelServer(make_service(), max_queue=256) as server:
        answers, lat, wall, errors = _socket_replay(server, requests,
                                                    clients)
        st = server.stats
    if errors:
        raise AssertionError(f"socket {label}: {errors[:3]}")
    n = clients * sum(len(r) for r in requests)
    worst = max(float(np.max(np.abs(np.concatenate(a) - want)))
                for a in answers.values())
    tol = _tol(want)
    log(f"[autotune] socket, {label}: {clients} clients x {len(requests)} "
        f"requests, {n / wall:.1f} queries/s ({n} queries, {wall:.3f} s), "
        f"p50 {np.percentile(lat, 50):.3f} ms p99 "
        f"{np.percentile(lat, 99):.3f} ms per request; server completed "
        f"{st.completed}, shed {st.shed_overloaded + st.shed_deadline}, "
        f"worker failures {st.worker_failures}; max|socket - in-process| "
        f"{worst:.3e} (tol {tol:.3e})")
    if st.worker_failures or st.shed_overloaded or st.shed_deadline \
            or st.completed != clients * len(requests):
        raise AssertionError(f"socket {label}: stats {st.to_dict()}")
    if not worst <= tol:
        raise AssertionError(f"socket {label}: {worst} > {tol}")


def socket_faults_and_snapshot(make_service, requests, snap: str) -> None:
    """A planted `drop` comes back as the client's clean error (and the
    next call is answered); a snapshot written at stop warms a restarted
    server whose replay then hits the cache 100 %."""
    from repro_torch.serving.client import ClientError, CostModelClient
    from repro_torch.serving.server import CostModelServer
    with CostModelServer(make_service(), allow_request_faults=True) as srv:
        with CostModelClient(*srv.address, retries=1, timeout_s=30) as c:
            try:
                c.inject_fault(requests[0], "drop")
            except ClientError as e:
                caught = type(e).__name__
            else:
                raise AssertionError("socket: a planted drop was answered")
            after = c.predict_many(requests[0], deadline_ms=60_000)
    log(f"[autotune] socket, planted drop: {caught} at the client, the "
        f"next request answered ({len(after)} scores)")
    with CostModelServer(make_service(), snapshot_path=snap) as srv:
        with CostModelClient(*srv.address) as c:
            for req in requests:
                c.predict_many(req, deadline_ms=60_000)
    warm = make_service()
    with CostModelServer(warm, snapshot_path=snap) as srv:
        restored = srv.stats.restored_entries
        with CostModelClient(*srv.address) as c:
            for req in requests:
                c.predict_many(req, deadline_ms=60_000)
    st = warm.stats()
    log(f"[autotune] socket, snapshot -> restart -> replay: {restored} "
        f"entries restored, hits {st.cache.hits} misses {st.cache.misses} "
        f"(hit rate {st.hit_rate:.4f}), flushes {st.flushes}")
    if st.cache.misses or st.flushes or st.hit_rate != 1.0:
        raise AssertionError(f"socket: the warm replay missed: {st}")


def phase_autotune(card: str, trained: dict, replay, tmpdir: str) -> dict:
    """Phase 12: the trained model's consumers on the card. Returns the
    launch counts of the phase."""
    import dataclasses
    from repro_torch.core.analytical import AnalyticalModel
    from repro_torch.core.evaluate import analytical_tile_scorer, \
        eval_tile_task, make_predict_fn
    from repro_torch.data.tile_dataset import TileDataset
    from repro_torch.quant import QuantizedCostModel, quantize_params
    from repro_torch.serving import CostModelService
    log(f"[autotune] on {card}")
    t0 = time.perf_counter()
    data = trained["data"]
    norm = data["tile_norm"]
    _reset_launches()
    for layout in ("sparse", "dense"):
        table2(f"learned {layout} (trained, kernels on)",
               _trained_service(trained[layout], norm, layout, True),
               _trained_service(trained[layout], norm, layout, False),
               data["tile_test"])
    res = eval_tile_task(TileDataset(list(data["tile_test"])),
                         analytical_tile_scorer(AnalyticalModel()))
    log(f"[autotune] table 2 tile task, analytical: median APE "
        f"{res['median_ape']:.4f} mean APE {res['mean_ape']:.4f} median tau "
        f"{res['median_kendall']:.4f} mean tau {res['mean_kendall']:.4f}")
    tile_autotune(trained, norm, data["test_programs"])
    fusion_autotune(trained, data["whole_norm"])

    def sparse_service():
        return _trained_service(trained["sparse"], norm, "sparse", True)
    socket_serve("trained sparse f32", sparse_service, replay.requests,
                 SOCKET_CLIENTS)
    socket_faults_and_snapshot(sparse_service, replay.requests,
                               os.path.join(tmpdir, "warm.npz"))
    sparse = trained["sparse"]
    qm = quantize_params(
        sparse.model, dataclasses.replace(sparse.model_cfg,
                                          use_pallas_aggregate=True),
        calib_graphs=[g for req in replay.requests[:4] for g in req],
        normalizer=norm)

    def int8_service():
        q = QuantizedCostModel(qm.params, qm.act_scales, qm.config)
        return CostModelService(q, None, norm, predict_fn=make_predict_fn(
            q.serving_config()))
    socket_serve("trained sparse int8", int8_service, replay.requests, 1)
    launches = _launches()
    log(f"[autotune] aggregation kernel launches in the phase: "
        f"{ {k: launches[k] for k in AGG_KERNELS} }")
    for k in AGG_KERNELS:
        if not launches[k]:
            raise AssertionError(f"autotune: {k} never launched")
    log(f"[autotune] phase took {time.perf_counter() - t0:.1f} s")
    return launches


# -------------------------------------------------------------------- 13
# The profiler's post-processing of one pass of 17k-136k launches took
# 14-53 s on an H100 80GB HBM3 at 700 W, three quarters of this phase:
# its serving passes go unprofiled and its training window is 5 steps.
GAT_LSTM_TRAIN_STEPS, GAT_LSTM_TIMED, GAT_LSTM_PROFILED = 50, 20, 5


def _seed0():
    import torch
    return torch.Generator().manual_seed(0)


def _cpu_agree(label, cfg, graphs, norm) -> None:
    """The seed-0 weights of `cfg` on the card and on the CPU score
    `graphs` alike (within the serving limit)."""
    import numpy as np
    from repro_torch.core.evaluate import predict_kernels
    from repro_torch.core.model import cost_model_init
    preds = {dev: predict_kernels(cost_model_init(_seed0(), cfg, device=dev),
                                  cfg, graphs, norm)
             for dev in (DEVICE, "cpu")}
    err, tol = float(np.max(np.abs(preds[DEVICE] - preds["cpu"]))), \
        _tol(preds["cpu"])
    log(f"[gat-lstm] {label}, card vs CPU of the same weights over "
        f"{len(graphs)} graphs: max_abs_err={err:.3e} (tol {tol:.3e})")
    if not np.all(np.isfinite(preds[DEVICE])) or not err <= tol:
        raise AssertionError(f"{label}: card vs CPU {err} > {tol}")


def segmented_lstm(replay, whole) -> None:
    """One segmented graphsage + lstm pass over one 10k-node program: the
    LSTM takes one step per slot of the program's gather width."""
    import numpy as np
    import torch
    from repro_torch.core.evaluate import predict_kernels
    from repro_torch.core.model import CostModelConfig, cost_model_init
    preds, secs = {}, {}
    for kernels in (True, False):
        cfg = CostModelConfig(adjacency="segmented", reduction="lstm",
                              dropout=0.0, use_pallas_aggregate=kernels)
        model = cost_model_init(_seed0(), cfg, device=DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preds[kernels] = predict_kernels(model, cfg, whole[:1],
                                         replay.normalizer,
                                         node_budget=SEGMENT_BUDGET)
        secs[kernels] = time.perf_counter() - t0
    err, tol = float(np.max(np.abs(preds[True] - preds[False]))), \
        _tol(preds[False])
    log(f"[gat-lstm] segmented graphsage+lstm, one program of "
        f"{whole[0].num_nodes} nodes: {secs[True]:.3f} s per pass with the "
        f"kernels, {secs[False]:.3f} s without (host clock, first call of "
        f"the shape), prediction {float(preds[True][0]):.6f}, kernels on "
        f"vs off max_abs_err={err:.3e} (tol {tol:.3e})")
    if not np.all(np.isfinite(preds[True])) or not err <= tol:
        raise AssertionError(f"segmented lstm: {err} > {tol}")


def phase_gat_lstm(card: str, trained: dict, replay, whole) -> dict:
    """Phase 13: GAT and the LSTM reduction served over the replay at the
    default width (seed-0 weights), then trained briefly on the card.
    Returns the aggregation kernels' launches of its timed passes."""
    from repro_torch.core.model import CostModelConfig
    log(f"[gat-lstm] on {card}")
    t0 = time.perf_counter()
    data = trained["data"]
    unique = list({g.canonical_hash(): g for req in replay.requests
                   for g in req}.values())
    total = dict.fromkeys(AGG_KERNELS, 0)
    for name, kw, kernels in (("gat", dict(gnn="gat"), {}),
                              ("graphsage+lstm", dict(reduction="lstm"),
                               {"dense": "graph_aggregate",
                                "sparse": "segment_aggregate"})):
        served = {}
        for layout in ("dense", "sparse"):
            make = f32_services(replay, layout, **kw)
            if not kernels:         # GAT runs outside any kernel
                make = (lambda m: lambda _: m(False))(make)
            served[layout] = serve(
                f"{name} {layout}", make, replay.requests,
                [kernels[layout]] if kernels else [], tag="gat-lstm",
                profiled=False)
            for k in total:
                total[k] += served[layout]["launches"][k]
            _cpu_agree(f"{name} {layout}", CostModelConfig(
                adjacency=layout, dropout=0.0,
                use_pallas_aggregate=bool(kernels), **kw), unique,
                replay.normalizer)
        _agree(f"{name}, sparse vs dense layout", served["sparse"]["preds"],
               served["dense"]["preds"], tag="gat-lstm")
        log(f"[gat-lstm] {name} served, {time.perf_counter() - t0:.1f} s "
            f"into the phase")
    _reset_launches()
    segmented_lstm(replay, whole)
    for k in total:
        total[k] += _launches()[k]
    log(f"[gat-lstm] aggregation kernel launches of the timed passes and "
        f"the segmented pass: {total}")
    for k in ("graph_aggregate", "segment_aggregate"):
        if not total[k]:
            raise AssertionError(f"gat-lstm: {k} never launched")
    held = _tile_sampler(data["tile_test"], data["tile_norm"],
                         "dense").batch(0)
    for name, kw in (("gat", dict(gnn="gat")),
                     ("lstm", dict(reduction="lstm"))):
        tr = _trainer(CostModelConfig(adjacency="dense", **kw),
                      _tile_sampler(data["tile_train"], data["tile_norm"],
                                    "dense"), "tile")
        train_run(f"{name} tile dense, {GAT_LSTM_TRAIN_STEPS} steps", tr,
                  GAT_LSTM_TRAIN_STEPS, held, timed=GAT_LSTM_TIMED,
                  profiled=GAT_LSTM_PROFILED, tag="gat-lstm")
    log(f"[gat-lstm] phase took {time.perf_counter() - t0:.1f} s")
    return total


# -------------------------------------------------------------------- 14
# benchmarks/bench_flywheel.py's scenario at its own constants (BENCH_SCALE
# 1, nothing cut) on the port: the world, the hard set and the loop
FW_PROGRAMS = 20           # base-corpus programs
FW_CORPUS_CONFIGS = 16     # measured tiles per base-corpus kernel
FW_SHARD_RECORDS = 128     # build_corpus's default
FW_POOL = 20               # candidate target kernels to pick from
FW_TARGETS = 6             # hard-set size
FW_TARGET_NODES = 16
FW_CANDIDATES = 32         # enumerated tiles per target kernel
FW_ROUNDS = 3
FW_PER_KERNEL = 3          # hardware evals per target kernel, in total
FW_MIN_HARD_REGRET = 0.005
FW_STATIC_STEPS = 120
FW_FT_STEPS = 120          # per-round fine-tune
FW_WARM_STEPS = 150        # the warm-start vs scratch gate
FW_MC_SAMPLES = 8
FW_TIMED, FW_PROFILED = 20, 3
FW_PREFETCH_STEPS = 40     # the input pipeline on vs off, bit for bit


def flywheel_model_cfg(use_kernels: bool, adjacency: str = "dense"):
    """`benchmarks/common.py`'s `paper_tile_model()`: GraphSAGE + LSTM,
    hidden 64, opcode embedding 16, max_nodes 48, dropout 0.1."""
    from repro_torch.core.model import CostModelConfig
    return CostModelConfig(gnn="graphsage", reduction="lstm", hidden_dim=64,
                           opcode_embed_dim=16, max_nodes=48, dropout=0.1,
                           adjacency=adjacency,
                           use_pallas_aggregate=use_kernels)


def _module_cli(args, timeout: int = 600) -> str:
    """`python -m <args>` with the checkout's `src` on the path; its
    standard output. Fails on a non-zero exit."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (SRC, env.get("PYTHONPATH")) if p)
    res = subprocess.run([sys.executable, "-m", *args], env=env,
                         capture_output=True, text=True, timeout=timeout,
                         cwd=ROOT)
    if res.returncode:
        raise AssertionError(f"python -m {' '.join(args)} exited "
                             f"{res.returncode}: {res.stderr[-3000:]}")
    return res.stdout


def flywheel_world(work: str) -> dict:
    """The base corpus store, built by `python -m
    repro_torch.launch.build_corpus` (2 workers) in a subprocess, held
    against an in-process `write_corpus` of the same records under the
    same spec (equal manifest hashes); the normalizer fitted on it."""
    from repro_torch.core.simulator import TPUSimulator
    from repro_torch.data.fusion import apply_fusion, default_fusion
    from repro_torch.data.store import StreamingCorpus, write_corpus
    from repro_torch.data.synthetic import generate_corpus
    from repro_torch.data.tile_dataset import build_tile_records, \
        fit_tile_normalizer
    from repro_torch.launch.build_corpus import make_spec
    out = os.path.join(work, "corpus")
    t0 = time.perf_counter()
    stdout = _module_cli(["repro_torch.launch.build_corpus", "--out", out,
                          "--kind", "tile", "--programs", str(FW_PROGRAMS),
                          "--seed", "0", "--workers", "2", "--tile-configs",
                          str(FW_CORPUS_CONFIGS)])
    cli_s = time.perf_counter() - t0
    cli_hash = stdout.split("manifest_hash=")[1].split()[0]
    kernels = [k for p in generate_corpus(FW_PROGRAMS, seed=0)
               for k in apply_fusion(p, default_fusion(p))]
    records = build_tile_records(kernels, TPUSimulator(),
                                 max_configs_per_kernel=FW_CORPUS_CONFIGS,
                                 seed=0)
    spec = make_spec("tile", programs=FW_PROGRAMS, seed=0,
                     shard_records=FW_SHARD_RECORDS,
                     tile_opts={"max_configs_per_kernel": FW_CORPUS_CONFIGS,
                                "max_kernel_nodes": 64})
    inproc = write_corpus(os.path.join(work, "inproc"), "tile", records,
                          spec=spec, shard_records=FW_SHARD_RECORDS)
    store = os.path.join(out, "tile")
    base = list(StreamingCorpus.open(store))
    log(f"[flywheel] base store: build_corpus --workers 2 in {cli_s:.2f} s "
        f"(subprocess), {len(base)} records ({len(kernels)} kernels, "
        f"{FW_PROGRAMS} programs), manifest_hash {cli_hash}; in-process "
        f"write_corpus of the same {len(records)} records: "
        f"{inproc['manifest_hash']}")
    if cli_hash != inproc["manifest_hash"]:
        raise AssertionError("build_corpus and write_corpus disagree on "
                             "the manifest hash")
    return {"store": store, "records": records, "base": base,
            "norm": fit_tile_normalizer(base)}


def flywheel_static(world: dict, device, ckpt_dir: str):
    """The static round-0 model, trained as bench_flywheel.py's
    `train_static` (AdamW 2e-3, decayed 0.9 every quarter), kernels off;
    its params and AdamW state checkpointed in `ckpt_dir`."""
    from repro_torch.data.sampler import TileBatchSampler
    from repro_torch.training.checkpoint import save_checkpoint
    from repro_torch.training.optim import AdamWConfig
    from repro_torch.training.trainer import CostModelTrainer, \
        TrainerConfig
    quarter = max(FW_STATIC_STEPS // 4, 1)
    sampler = TileBatchSampler(world["base"], world["norm"],
                               kernels_per_batch=4, configs_per_kernel=8,
                               max_nodes=48)
    tc = TrainerConfig(task="tile", steps=FW_STATIC_STEPS, ckpt_every=0,
                       log_every=quarter,
                       optim=AdamWConfig(lr=2e-3, schedule="exponential",
                                         lr_decay=0.9, decay_every=quarter))
    tr = CostModelTrainer(flywheel_model_cfg(False), tc, sampler,
                          device=device)
    t0 = time.perf_counter()
    res = tr.run(resume=False)
    log(f"[flywheel] static model: {FW_STATIC_STEPS} steps in "
        f"{time.perf_counter() - t0:.2f} s, loss {res['loss']:.6f}")
    save_checkpoint(ckpt_dir, FW_STATIC_STEPS,
                    {"params": tr.params, "opt": tr.opt_state})
    return tr.model


def flywheel_hard_set(world: dict, model, cfg) -> dict:
    """bench_flywheel.py's hard set: the pool kernels whose static top-k
    regret is worst (at least FW_MIN_HARD_REGRET), scored under `cfg`."""
    import numpy as np
    from repro_torch.core.simulator import TPUSimulator
    from repro_torch.data.synthetic import random_kernel
    from repro_torch.data.tile_dataset import enumerate_tiles
    from repro_torch.search import LearnedEstimator
    sim = TPUSimulator()
    pool = [random_kernel(FW_TARGET_NODES, seed=7000 + i,
                          program=f"fw_target_{i}") for i in range(FW_POOL)]
    tiles = [enumerate_tiles(k, max_configs=FW_CANDIDATES) for k in pool]
    groups = [[k.with_tile(t) for t in ts] for k, ts in zip(pool, tiles)]
    scores = LearnedEstimator.from_params(
        model, cfg, world["norm"], max_nodes=cfg.max_nodes,
        cache_capacity=0).estimate_groups(groups)
    truth = [np.array([sim.measure(g) for g in grp], np.float64)
             for grp in groups]
    regrets = []
    for s, t in zip(scores, truth):
        picks = np.argsort(np.asarray(s), kind="stable")[:FW_PER_KERNEL]
        regrets.append(float(np.min(t[picks]) / np.min(t) - 1.0))
    order = sorted(range(FW_POOL), key=lambda i: (-regrets[i], i))
    hard = [i for i in order if regrets[i] >= FW_MIN_HARD_REGRET]
    hard = hard[:FW_TARGETS] or order[:FW_TARGETS]
    log(f"[flywheel] hard set: {[f'fw_target_{i}' for i in hard]} (static "
        f"top-{FW_PER_KERNEL} regrets {[round(regrets[i], 4) for i in hard]})")
    return {"targets": [pool[i] for i in hard],
            "tiles": [tiles[i] for i in hard],
            "groups": [groups[i] for i in hard],
            "scores0": [scores[i] for i in hard]}


def _record_blob(rec) -> str:
    """Canonical transit form of one record: the parity gate's bytes."""
    from repro_torch.data.store import pack_record
    return json.dumps(pack_record("tile", rec), sort_keys=True)


def _replay_delta_records(rounds, groups) -> list:
    """Each round's raw delta records rebuilt from the acquisition
    stream: one log fed round by round, its pending sweeps taken after
    each (what the loop's `MeasurementLog.flush_to` appended)."""
    from repro_torch.flywheel import MeasurementLog
    out = []
    ml = MeasurementLog("tile")
    for r in rounds:
        for gi, ci, rt in (r.acquired or []):
            ml.record(groups[gi][ci], rt)
        out.extend(ml.take_pending(min_configs=1))
    return out


def flywheel_loop(world: dict, model, cfg, hard: dict, work: str) -> dict:
    """`run_flywheel` against the hard set at the static plan's budget,
    scoring under `cfg`; the regret margin over the static plan and the
    delta-chain parity with a from-scratch rebuild."""
    from repro_torch.core.simulator import TPUSimulator
    from repro_torch.data.store import StreamingCorpus, write_corpus
    from repro_torch.flywheel import FlywheelConfig, run_flywheel
    from repro_torch.flywheel.loop import deploy_regret, static_plan
    budget = FW_PER_KERNEL * len(hard["targets"])
    fc = FlywheelConfig(rounds=FW_ROUNDS, budget_evals=budget,
                        finetune_steps=FW_FT_STEPS, warmup_steps=20,
                        mc_samples=FW_MC_SAMPLES, spread="kernel", seed=0,
                        max_configs=FW_CANDIDATES)
    t0 = time.perf_counter()
    res = run_flywheel(TPUSimulator(), world["store"], hard["targets"],
                       model, cfg, world["norm"], fc,
                       ckpt_dir=os.path.join(work, "rounds"),
                       tiles=hard["tiles"])
    loop_s = time.perf_counter() - t0
    static_regret = deploy_regret(res.truth, hard["scores0"],
                                  static_plan(hard["scores0"], budget))
    for r in res.rounds:
        log(f"[flywheel] round {r.round}: +{r.measured} evals "
            f"(+{r.delta_records} delta records), train loss "
            f"{r.train_loss:.6f} -> regret {r.regret:.6f}")
    chained = StreamingCorpus.open(world["store"]).with_deltas()
    rebuilt = os.path.join(work, "rebuild")
    write_corpus(rebuilt, "tile", world["records"] + _replay_delta_records(
        res.rounds, hard["groups"]), dedup=True)
    rebuilt = list(StreamingCorpus.open(rebuilt))
    parity = (len(chained) == len(rebuilt)
              and all(_record_blob(a) == _record_blob(b)
                      for a, b in zip(chained, rebuilt)))
    margin = static_regret - res.final_regret
    log(f"[flywheel] run_flywheel: {FW_ROUNDS} rounds in {loop_s:.2f} s, "
        f"{res.evals_charged}/{budget} evals charged; static plan regret "
        f"{static_regret:.6f}, flywheel {res.final_regret:.6f} "
        f"(margin {margin:.6f}, gate > 0), model pick without "
        f"measurements {res.regret0:.6f}; delta parity: chained "
        f"{len(chained)} records ({chained.num_deltas} deltas, chain "
        f"{chained.chain_hash[:12]}) vs rebuild {len(rebuilt)}: "
        f"{'identical' if parity else 'MISMATCH'}")
    return {"res": res, "margin": margin, "parity": parity,
            "chained": chained, "seconds": loop_s}


def flywheel_warm_gate(world: dict, chained, static_ckpt: str, device,
                       work: str) -> float:
    """Warm start (the static checkpoint, params + AdamW moments) against
    scratch on the chained corpus: the step at which the warm run first
    reaches the scratch run's final `tile_val_loss` (a fixed set of
    base-corpus batches), over FW_WARM_STEPS. Returns that ratio (2.0:
    never)."""
    import torch
    from repro_torch.core.model import cost_model_init
    from repro_torch.data.sampler import TileBatchSampler
    from repro_torch.flywheel import fine_tune
    from repro_torch.training.checkpoint import save_checkpoint
    from repro_torch.training.optim import adamw_init
    cfg = flywheel_model_cfg(True)
    val = TileBatchSampler(world["base"], world["norm"], kernels_per_batch=4,
                           configs_per_kernel=8, max_nodes=48, seed=123)
    every = max(FW_WARM_STEPS // 10, 1)
    init_dir = os.path.join(work, "init")
    tree = cost_model_init(torch.Generator().manual_seed(1), cfg,
                           device=device).tree()
    save_checkpoint(init_dir, 0, {"params": tree, "opt": adamw_init(tree)})
    kw = dict(steps=FW_WARM_STEPS, lr=1e-3, warmup_steps=20, seed=5,
              val_sampler=val, eval_every=every, device=device)
    scratch = fine_tune(chained, world["norm"], cfg, warm_start_dir=init_dir,
                        **kw)
    target = scratch.val_history[-1][1]
    warm = fine_tune(chained, world["norm"], cfg,
                     warm_start_dir=static_ckpt, **kw)
    match = next((s for s, v in warm.val_history if v <= target), None)
    ratio = match / FW_WARM_STEPS if match is not None else 2.0
    log(f"[flywheel] warm start: scratch {FW_WARM_STEPS} steps -> val "
        f"{target:.6f}; warm start reaches it at step {match} (ratio "
        f"{ratio:.4f}, gate <= 0.5); warm val history "
        f"{[(s, round(v, 6)) for s, v in warm.val_history]}")
    return ratio


def flywheel_mc(model, world: dict, hard: dict) -> dict:
    """MC-dropout acquisition over the hard set's candidates with the
    kernels on and off, from the same seeds: dense (graph_aggregate) and
    sparse (segment_aggregate); mean and std within 1e-4·max|pred|.
    Returns the kernels' launches of the kernels-on runs."""
    import numpy as np
    import torch
    from repro_torch.search import AcquisitionEstimator
    flat = [k for g in hard["groups"] for k in g]
    launches = {}
    for layout, kernel in (("dense", "graph_aggregate"),
                           ("sparse", "segment_aggregate")):
        got = {}
        for on in (True, False):
            acq = AcquisitionEstimator(
                model, flywheel_model_cfg(on, layout), world["norm"],
                samples=FW_MC_SAMPLES, seed=0, max_nodes=48)
            acq.estimate_with_variance(flat[:8])          # warm-up
            torch.cuda.synchronize()
            _reset_launches()
            t0 = time.perf_counter()
            got[on] = acq.estimate_with_variance(flat)    # host arrays
            secs = time.perf_counter() - t0
            if on:
                launches[kernel] = _launches()[kernel]
                log(f"[flywheel] MC acquisition {layout}, kernels on: "
                    f"{len(flat)} candidates x {FW_MC_SAMPLES} passes in "
                    f"{secs:.4f} s: {len(flat) / secs:.1f} candidates/s "
                    f"({len(flat) * FW_MC_SAMPLES / secs:.1f} graph "
                    f"forwards/s), {launches[kernel]} {kernel} launches")
        tol = _tol(got[False][0])
        err_mean = float(np.max(np.abs(got[True][0] - got[False][0])))
        err_std = float(np.max(np.abs(got[True][1] - got[False][1])))
        std = got[True][1]
        log(f"[flywheel] MC {layout}, kernels on vs off: mean max_abs_err "
            f"{err_mean:.3e}, std max_abs_err {err_std:.3e} (tol "
            f"{tol:.3e}); std over candidates {float(np.min(std)):.4f}.."
            f"{float(np.max(std)):.4f}")
        if not (np.all(np.isfinite(got[True][0])) and err_mean <= tol
                and err_std <= tol):
            raise AssertionError(f"MC {layout}: kernels on vs off "
                                 f"{err_mean}, {err_std} > {tol}")
        if not launches[kernel]:
            raise AssertionError(f"MC {layout}: {kernel} never launched")
    return launches


def flywheel_prefetch(world: dict, chained, static_ckpt: str,
                      work: str) -> None:
    """A fine-tune (FW_PREFETCH_STEPS from the static checkpoint on the
    chained corpus, as a round's) with the input pipeline off and on (depth 2,
    device copies on a side stream): the same loss at every step and the
    same final parameters, bit for bit; then a timed and profiled
    window of each, and of the pipeline without device copies (its
    batches copied by the step, as with it off)."""
    import torch
    from repro_torch.data.sampler import TileBatchSampler
    from repro_torch.flywheel import fine_tune
    from repro_torch.training.optim import tree_leaves
    from repro_torch.training.trainer import CostModelTrainer, \
        TrainerConfig
    cfg = flywheel_model_cfg(True)
    runs = {}
    for depth in (0, 2):
        path = os.path.join(work, f"prefetch-{depth}.jsonl")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ft = fine_tune(chained, world["norm"], cfg,
                       warm_start_dir=static_ckpt, steps=FW_PREFETCH_STEPS,
                       lr=1e-3, warmup_steps=20, seed=0, prefetch=depth,
                       prefetch_device_put=depth > 0, log_every=1,
                       metrics_path=path, device=DEVICE)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        with open(path) as f:
            losses = [json.loads(line)["loss"] for line in f]
        runs[depth] = (ft.params, losses)
        log(f"[flywheel] pipeline check, prefetch {depth}: {secs:.3f} s "
            f"for {FW_PREFETCH_STEPS} steps "
            f"({secs / FW_PREFETCH_STEPS * 1e3:.3f} ms "
            f"a step, host clock, a loss read back every step), last loss "
            f"{losses[-1]:.6f}")
    same_params = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(runs[0][0].tree()), tree_leaves(runs[2][0].tree())))
    same_losses = (runs[0][1] == runs[2][1]
                   and len(runs[0][1]) == FW_PREFETCH_STEPS)
    log(f"[flywheel] prefetch 2 vs 0: losses bit-identical at all "
        f"{len(runs[0][1])} steps: {same_losses}; final parameters "
        f"bit-identical: {same_params}")
    if not (same_losses and same_params):
        raise AssertionError("prefetch changed the fine-tune")
    held = TileBatchSampler(chained, world["norm"], kernels_per_batch=4,
                            configs_per_kernel=8, max_nodes=48,
                            seed=123).batch(0)
    steps = 1 + FW_TIMED + FW_PROFILED
    for depth, put in ((0, False), (2, False), (2, True)):
        tr = CostModelTrainer(
            flywheel_model_cfg(False),
            TrainerConfig(task="tile", steps=steps, ckpt_every=0,
                          log_every=steps, prefetch=depth,
                          prefetch_device_put=put),
            TileBatchSampler(chained, world["norm"], kernels_per_batch=4,
                             configs_per_kernel=8, max_nodes=48),
            device=DEVICE)
        tr.warm_start(static_ckpt)
        train_run(f"fine-tune, prefetch {depth}"
                  f"{', device copies' if put else ''}", tr, steps, held,
                  timed=FW_TIMED, profiled=FW_PROFILED, gate_held=False,
                  tag="flywheel")


def flywheel_clis(work: str, store: str, device) -> None:
    """The CLIs on `device`, each in its own process: `train cost-model
    --from-store` into a base checkpoint, then `--deltas --warm-start`
    from it; `launch.flywheel` twice on one fresh store (the second run,
    at another seed, appends to the delta chain). The two chains share
    nothing and run side by side; their times overlap."""
    from concurrent.futures import ThreadPoolExecutor
    base, warm = os.path.join(work, "cli-base"), os.path.join(work,
                                                             "cli-warm")
    common = ["repro_torch.launch.train", "cost-model", "--task", "tile",
              "--from-store", store, "--log-every", "10", "--device",
              str(device)]

    def train_chain() -> tuple[str, float]:
        t0 = time.perf_counter()
        out = _module_cli(common + ["--steps", "20", "--ckpt-dir", base])
        out += _module_cli(common + ["--deltas", "--warm-start", base,
                                     "--steps", "10", "--ckpt-dir", warm])
        return out, time.perf_counter() - t0
    with ThreadPoolExecutor(1) as pool:
        train = pool.submit(train_chain)
        flywheel_cli_chain(work, device)
        out, secs = train.result()
    log(f"[flywheel] train CLI --from-store, then --deltas --warm-start "
        f"(beside launch.flywheel): {secs:.2f} s; "
        + " | ".join(line for line in out.splitlines() if line))
    if not ("chained" in out and "warm-started from" in out
            and "done: step=10" in out):
        raise AssertionError("train --from-store --deltas did not run")


def flywheel_cli_chain(work: str, device) -> None:
    """`launch.flywheel` twice on one fresh store, the second at another
    seed: it must append to the first's delta chain."""
    import re
    flags = ["repro_torch.launch.flywheel", "--store",
             os.path.join(work, "cli-store"), "--ckpt-dir",
             os.path.join(work, "cli-fw"), "--rounds", "2",
             "--budget-evals", "8", "--programs", "4", "--targets", "3",
             "--static-steps", "40", "--finetune-steps", "30",
             "--device", str(device)]
    deltas = []
    for extra in ([], ["--seed", "1"]):
        t0 = time.perf_counter()
        out = _module_cli(flags + extra)
        found = re.search(r"store: (\d+) records, (\d+) delta", out)
        if found is None:
            raise AssertionError(f"launch.flywheel printed no store: {out}")
        deltas.append(int(found.group(2)))
        log(f"[flywheel] launch.flywheel {' '.join(extra) or '(seed 0)'} "
            f"(beside the train CLI): "
            f"{time.perf_counter() - t0:.2f} s; "
            + " | ".join(line for line in out.splitlines() if line))
    if not 0 < deltas[0] < deltas[1]:
        raise AssertionError(f"the second flywheel run appended no delta: "
                             f"{deltas}")


def phase_flywheel(card: str, work: str) -> dict:
    """Phase 14: the data flywheel at bench_flywheel.py's constants.
    Returns the aggregation kernels' launches of its kernels-on runs
    (run_flywheel's scoring and acquisition, the MC check)."""
    from concurrent.futures import ThreadPoolExecutor
    log(f"[flywheel] on {card}")
    t0 = time.perf_counter()
    world = flywheel_world(work)
    static_ckpt = os.path.join(work, "static")
    model = flywheel_static(world, DEVICE, static_ckpt)
    cfg = flywheel_model_cfg(True)
    hard = flywheel_hard_set(world, model, cfg)
    launches = flywheel_mc(model, world, hard)
    _reset_launches()
    loop = flywheel_loop(world, model, cfg, hard, work)
    fly = _launches()
    log(f"[flywheel] run_flywheel launches: {fly['graph_aggregate']} "
        f"graph_aggregate, {fly['segment_aggregate']} segment_aggregate")
    if not fly["graph_aggregate"]:
        raise AssertionError("run_flywheel never launched graph_aggregate")
    launches["graph_aggregate"] += fly["graph_aggregate"]
    if not loop["margin"] > 0:
        raise AssertionError(f"flywheel regret margin {loop['margin']} "
                             "not above 0")
    if not loop["parity"]:
        raise AssertionError("delta chain differs from its rebuild")
    # the CLIs (processes of their own) run beside the warm-start gate,
    # whose outcome no timing moves; the timed windows come after both
    with ThreadPoolExecutor(1) as pool:
        clis = pool.submit(flywheel_clis, work, world["store"], DEVICE)
        ratio = flywheel_warm_gate(world, loop["chained"], static_ckpt,
                                   DEVICE, work)
        clis.result()
    if not ratio <= 0.5:
        raise AssertionError(f"warm-start steps ratio {ratio} > 0.5")
    flywheel_prefetch(world, loop["chained"], static_ckpt, work)
    log(f"[flywheel] phase took {time.perf_counter() - t0:.1f} s; kernel "
        f"launches of its kernels-on runs: {launches}")
    return launches


# -------------------------------------------------------------------- 15
DDP_STEPS = 50            # each run's steps: dp 0 and 1, dp 2 plain and int8
DDP_WARM = 5              # of them, before the timed window


def _ddp_cfg():
    from repro_torch.core.model import CostModelConfig
    return CostModelConfig(adjacency="dense")     # [train]'s, dropout 0.1


def _ddp_trainer(data, dp, device=None, **tc_kw):
    """[train]'s dense trainer, at data-parallel size `dp`."""
    return _trainer(_ddp_cfg(), _tile_sampler(
        data["tile_train"], data["tile_norm"], "dense"), "tile", device,
        dp=dp, **tc_kw)


def _ddp_run(tr, held) -> dict:
    """Train `tr` from step 0 to DDP_STEPS: step 1 alone (its loss), on
    to DDP_WARM, then the timed window between CUDA events; the step's
    reduction (`CostModelTrainer._reduce`) is bracketed by CUDA events
    too. Also the held-out loss before and after."""
    import torch
    spans = []
    reduce = tr._reduce

    def timed(grads, loss):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = reduce(grads, loss)
        b.record()
        spans.append((a, b))
        return out
    tr._reduce = timed
    held0 = _held_loss(tr, held)
    first = tr.run(1, resume=False)["loss"]
    tr.run(DDP_WARM, resume=False)
    spans.clear()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    last = tr.run(DDP_STEPS, resume=False)["loss"]
    end.record()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3
    n = DDP_STEPS - DDP_WARM
    ms = start.elapsed_time(end) / n
    reduce_ms = sum(a.elapsed_time(b) for a, b in spans) / len(spans)
    del tr._reduce
    return {"ms": ms, "host_ms": host / n, "reduce_ms": reduce_ms,
            "share": reduce_ms / ms, "first": first, "last": last,
            "held": [held0, _held_loss(tr, held)]}


def _ddp_rank(out: str, data: dict, device: str) -> None:
    """One rank of the dp=2 runs (spawned): plain, then int8-compressed
    gradients; writes its params and numbers under `out`, rank 0 the
    checkpoints."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.training.optim import tree_leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = dist.get_rank()
    held = _tile_sampler(data["tile_test"], data["tile_norm"],
                         "dense").batch(0)
    res = {}
    for tag in ("plain", "int8"):
        tr = _ddp_trainer(data, 2, device, compress_grads=tag == "int8",
                          ckpt_dir=os.path.join(out, tag))
        res[tag] = _ddp_run(tr, held)
        res[tag]["device"] = str(tr.device)
        np.savez(os.path.join(out, f"{tag}{rank}.npz"),
                 *[x.detach().cpu().numpy() for x in tree_leaves(tr.params)])
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def _bytes_equal(a: list, b: list) -> bool:
    return len(a) == len(b) and all(x.tobytes() == y.tobytes()
                                    for x, y in zip(a, b))


def _params_np(tr) -> list:
    from repro_torch.training.optim import tree_leaves
    return [x.detach().cpu().numpy() for x in tree_leaves(tr.params)]


def _ddp_line(label, r) -> None:
    log(f"[ddp] {label}: {r['ms']:.3f} ms/step (CUDA events over "
        f"{DDP_STEPS - DDP_WARM} steps; host clock {r['host_ms']:.3f}), "
        f"reduction {r['reduce_ms']:.3f} ms a step ({r['share']:.1%} of "
        f"it), loss step 1 {r['first']:.6f} -> step {DDP_STEPS} "
        f"{r['last']:.6f}, held-out loss {r['held'][0]:.6f} -> "
        f"{r['held'][1]:.6f}")


def phase_ddp(card: str, trained: dict, work: str) -> dict:
    """Phase 15: data-parallel training of the cost model at [train]'s
    width and corpus. Returns the aggregation kernels' launches of the
    dp=2 checkpoint's serving runs."""
    import shutil
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.sharding import init_distributed, spawn_ranks
    from repro_torch.training.optim import tree_leaves
    log(f"[ddp] on {card}")
    t0 = time.perf_counter()
    data = trained["data"]
    held = _tile_sampler(data["tile_test"], data["tile_norm"],
                         "dense").batch(0)
    runs = {}
    t_dp0 = _ddp_trainer(data, 0)
    runs[0] = _ddp_run(t_dp0, held)
    backend = init_distributed(DEVICE, rank=0, world_size=1,
                               init_method="file://" + os.path.join(
                                   work, "store1"))
    try:
        t_dp1 = _ddp_trainer(data, 1)
        log(f"[ddp] dp=1: process group of 1 rank, backend {backend}, "
            f"device {t_dp1.device}")
        runs[1] = _ddp_run(t_dp1, held)
        same = (runs[0]["last"] == runs[1]["last"]
                and _bytes_equal(_params_np(t_dp0), _params_np(t_dp1))
                and _bytes_equal(
                    [x.cpu().numpy() for x in tree_leaves(t_dp0.opt_state)],
                    [x.cpu().numpy() for x in tree_leaves(t_dp1.opt_state)]))
        for dp in (0, 1):
            _ddp_line(f"dp={dp}", runs[dp])
        log(f"[ddp] dp=1 vs dp=0 after {DDP_STEPS} steps (dropout 0.1): "
            f"loss {runs[1]['last']!r} vs {runs[0]['last']!r}, params and "
            f"AdamW state bit-identical: {same}")
        if not same:
            raise AssertionError("dp=1 is not bit-identical to dp=0")
        out = os.path.join(work, "dp2")
        os.makedirs(out)
        t1 = time.perf_counter()
        spawn_ranks(_ddp_rank, (out, data, DEVICE), 2, device=DEVICE)
        log(f"[ddp] dp=2: 2 ranks spawned on one card (backend gloo: "
            f"NCCL takes one rank a card), both runs in "
            f"{time.perf_counter() - t1:.1f} s of host time, process "
            "start-up included")
        for tag in ("plain", "int8"):
            rs = []
            for r in (0, 1):
                with open(os.path.join(out, f"rank{r}.json")) as f:
                    rs.append(json.load(f)[tag])
            with np.load(os.path.join(out, f"{tag}0.npz")) as z0, \
                    np.load(os.path.join(out, f"{tag}1.npz")) as z1:
                equal = _bytes_equal([z0[k] for k in z0.files],
                                     [z1[k] for k in z1.files])
            _ddp_line(f"dp=2 {tag} (rank 0 on {rs[0]['device']}, rank 1 "
                      f"on {rs[1]['device']})", rs[0])
            log(f"[ddp] dp=2 {tag}: rank 1 {rs[1]['ms']:.3f} ms/step, "
                f"reduction {rs[1]['reduce_ms']:.3f} ms; params bit-equal "
                f"across the ranks: {equal}")
            if not equal:
                raise AssertionError(f"dp=2 {tag}: ranks diverged")
            r = rs[0]
            if not (np.isfinite(r["first"]) and np.isfinite(r["last"])
                    and r["held"][1] < r["held"][0]):
                raise AssertionError(f"dp=2 {tag}: held-out loss "
                                     f"{r['held']} did not fall")
            runs[f"2 {tag}"] = r
        log(f"[ddp] scaling over cards: not measured: one card (two ranks "
            f"share it; dp=2 vs dp=0 step time "
            f"{runs['2 plain']['ms'] / runs[0]['ms']:.3f}x)")
        # the dp=2 checkpoints restore under dp=1
        for tag, kw in (("plain", {}), ("int8", dict(compress_grads=True))):
            ck = os.path.join(work, f"restore_{tag}")
            shutil.copytree(os.path.join(out, tag), ck)
            tr = _ddp_trainer(data, 1, ckpt_dir=ck, **kw)
            ok = tr.maybe_resume() and tr.step == DDP_STEPS
            with np.load(os.path.join(out, f"{tag}0.npz")) as z:
                exact = _bytes_equal(_params_np(tr), [z[k] for k in z.files])
            ef = ("" if not kw else ", error feedback restarted at zero: "
                  + str(not any(bool(e.any()) for e in
                                tree_leaves(tr.opt_state["ef"]))))
            log(f"[ddp] dp=2 {tag} checkpoint restored under dp=1 at step "
                f"{tr.step}: params bit-exact: {exact}{ef}")
            if not (ok and exact) or (kw and "False" in ef):
                raise AssertionError(f"dp=2 {tag} checkpoint: restore "
                                     "under dp=1 not exact")
    finally:
        dist.destroy_process_group()
    # the dp=2 model served through both kernels, against them off
    requests = [[r.kernel.with_tile(t) for t in r.tiles]
                for r in data["tile_test"]]
    launches = {}
    for layout, kernel in (("dense", "graph_aggregate"),
                           ("sparse", "segment_aggregate")):
        res = serve(f"dp=2 checkpoint {layout}", trained_services(
            data, os.path.join(out, "plain"), _ddp_cfg(), layout), requests,
            [kernel], tag="ddp", profiled=False)
        launches[kernel] = res["launches"][kernel]
    log(f"[ddp] phase took {time.perf_counter() - t0:.1f} s; kernel "
        f"launches of its serving runs: {launches}")
    return launches


# -------------------------------------------------------------------- 16
LM_TRAIN_SEQ, LM_TRAIN_BATCH, LM_TRAIN_MICRO = 2048, 4, 2
LM_TRAIN_STEPS = 3        # a run, per optimizer, on one repeated batch
LM_TRAIN_DEPTHS = (24, 20, 16, 12)   # the config's 24 first, then cuts
# Adafactor scales its step by the parameter's RMS (~0.02 at init): at
# AdamW's 3e-4 that is below a bf16 ulp of the weights and moves nothing
LM_ADAFACTOR_LR = 1e-2
# grad_of_scan and scan_of_grads take the same forward; their step-1
# losses (both of the seed-0 params) agree to f32 rounding of the mean
LM_ACCUM_RTOL = 1e-6


def _lm_train_run(cfg, batch, optimizer: str, lr, tag="lm-train") -> dict:
    """LM_TRAIN_STEPS steps of `train_step_fn` from the seed-0 params on
    one repeated batch (Adafactor's first differentiates the microbatch
    loop whole): losses, s a step after the first, tokens/s, model
    TFLOP/s and peak memory; fails unless the losses are finite and
    falling."""
    import dataclasses
    import gc
    import numpy as np
    import torch
    from repro_torch.models import lm
    from repro_torch.training.optim import AdamWConfig
    c = dataclasses.replace(cfg, optimizer=optimizer)
    opt_cfg = None if lr is None else AdamWConfig(lr=lr)
    params = lm.init_params(torch.Generator(device=DEVICE).manual_seed(0),
                            c, device=DEVICE)
    n_params = lm.param_count(params)
    state = lm.make_optimizer(c, opt_cfg)[0](params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, secs, modes = [], [], []
    for i in range(LM_TRAIN_STEPS):
        # Adafactor's first step differentiates the microbatch loop whole
        mode = ("grad_of_scan" if optimizer == "adafactor" and i == 0
                else "scan_of_grads")
        step = lm.train_step_fn(dataclasses.replace(c, grad_accum=mode),
                                opt_cfg)
        t0 = time.perf_counter()
        params, state, stats = step(params, state, batch)
        losses.append(float(stats["loss"]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        modes.append(mode)
    peak = torch.cuda.max_memory_allocated()
    if optimizer == "adamw":        # where the time goes: one more step
        prof, wall = device_profile(lambda: step(params, state, batch))
        busy = sum(us for _, us in prof.values()) / 1e6
        log(f"[{tag}] {optimizer} profiled step: wall {wall:.3f} s, "
            f"device busy {busy:.3f} s ({busy / wall:.1%}), "
            f"{sum(c for c, _ in prof.values())} kernel launches")
        for name, (count, us) in sorted(prof.items(),
                                        key=lambda kv: -kv[1][1])[:8]:
            log(f"[{tag}]   {us / 1e3:9.3f} ms {count:6d}x  "
                f"{_short(name)}")
    del params, state, stats
    gc.collect()
    torch.cuda.empty_cache()
    tokens = batch["tokens"].numel()
    s = float(np.mean(secs[1:]))
    flops = 6 * n_params * tokens / s           # model FLOP/s
    lr_text = "3e-4, cosine (the default)" if lr is None else f"{lr:g}"
    log(f"[{tag}] {optimizer} (lr {lr_text}): losses "
        f"{[round(x, 6) for x in losses]} ({modes}); s per step "
        f"{[round(x, 3) for x in secs]}: {s:.3f} s a step after the first, "
        f"{tokens / s:.1f} tokens/s, model {flops / 1e12:.1f} TFLOP/s "
        f"(6·N·tokens/s; {flops / PEAK_BF16_FLOP_PER_S:.1%} of the bf16 "
        f"peak), peak memory {peak / 2 ** 30:.2f} GiB ({peak / 1e9:.2f} GB)")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"[{tag}] {optimizer}: losses {losses} not "
                             "finite and falling")
    return {"losses": losses, "s": s, "peak": peak, "params": n_params}


def phase_lm_train(card: str) -> dict:
    """Phase 16: the LM train step at h2o-danube-3-4b's full width."""
    import dataclasses
    import gc
    import torch
    from repro_torch.models import registry
    from repro_torch.models.config import ShapeSpec, Stack
    from repro_torch.models.inputs import make_batch
    log(f"[lm-train] on {card}")
    t0 = time.perf_counter()
    full = registry.get_config(ARCH)
    for depth in LM_TRAIN_DEPTHS:
        (stack,) = full.stacks
        cfg = dataclasses.replace(full, microbatch=LM_TRAIN_MICRO,
                                  stacks=(Stack(stack.pattern, depth),))
        log(f"[lm-train] {ARCH}: d_model {cfg.d_model}, {cfg.num_heads} "
            f"heads ({cfg.num_kv_heads} kv), d_ff {cfg.d_ff}, vocab "
            f"{cfg.vocab_size}, {cfg.dtype}, remat {cfg.remat}; depth "
            f"{depth} of {full.num_layers}"
            f"{'' if depth == full.num_layers else ' (cut: deeper OOMs)'}; "
            f"global batch {LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} tokens, "
            f"microbatch {LM_TRAIN_MICRO} (the config's {full.microbatch} "
            f"overridden), random weights from seed 0, one repeated batch")
        try:
            batch = make_batch(cfg, ShapeSpec("train", LM_TRAIN_SEQ,
                                              LM_TRAIN_BATCH, "train"),
                               seed=0, device=DEVICE)
            adamw = _lm_train_run(cfg, batch, "adamw", None)
            ada = _lm_train_run(cfg, batch, "adafactor", LM_ADAFACTOR_LR)
            break
        except torch.cuda.OutOfMemoryError as e:
            log(f"[lm-train] depth {depth} does not fit: "
                f"{str(e).splitlines()[0]}")
        batch = None
        gc.collect()
        torch.cuda.empty_cache()
    else:
        raise AssertionError("[lm-train] no depth fits")
    a, b = adamw["losses"][0], ada["losses"][0]
    rel = abs(a - b) / abs(a)
    log(f"[lm-train] step-1 loss of the seed-0 params: scan_of_grads "
        f"{a!r}, grad_of_scan {b!r}, |Δ|/|loss| {rel:.3e} (limit "
        f"{LM_ACCUM_RTOL:g}); {adamw['params']} params; phase took "
        f"{time.perf_counter() - t0:.1f} s")
    if not rel <= LM_ACCUM_RTOL:
        raise AssertionError(f"grad_of_scan vs scan_of_grads: {rel}")
    return {"depth": depth, "adamw": adamw, "adafactor": ada}


# -------------------------------------------------------------- 17-19
MOE_ARCH = "granite-moe-3b-a800m"
MUSICGEN_ARCH, LLAVA_ARCH = "musicgen-large", "llava-next-34b"
SSD_ARCH = "mamba2-2.7b"
# llava-next-34b's 60 layers (68.8 GB of bf16 params) do not fit beside
# the 2 x 8192 forward; 45 is the deepest that does on an 80 GB H100.
# The script's time limit cuts it to the first of these that fits
LLAVA_DEPTHS = (30, 24)
FRONT_DECODE_STEPS = 8     # musicgen: greedy steps after its prefill
# near-tie of top-k routing: the k-th and (k+1)-th router scores within
# this of each other (relative to the k-th), ~100 f32 ulps: the two
# devices may order such a pair either way
MOE_TIE_RTOL = 1e-5
# moe_apply in f32, card vs CPU, on the tokens both route alike:
# max|Δ| <= 1e-5·max|ref| (f32 sums in another order)
MOE_CARD_RTOL = 1e-5


def _free_card() -> None:
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _kept(ids, E: int, cap: int):
    """[T, E] bool: token t's choice of expert e survives capacity."""
    import torch
    from repro_torch.models import layers
    sort_idx, _, keep = layers.moe_dispatch(ids, E, cap)
    K = ids.shape[1]
    kept = torch.zeros((ids.shape[0], E), dtype=torch.bool,
                       device=ids.device)
    kept[sort_idx // K, ids.reshape(-1)[sort_idx]] = keep
    return kept


def moe_card_vs_cpu(tag, cfg, p0, x0) -> None:
    """Layer 0's `moe_apply` in f32 on the card against the same function
    on the CPU, from the same inputs (the layer's bf16 weights and the
    input the forward gave it, cast to f32): the tokens whose expert
    choices (top-k, then capacity) agree on both devices are held
    within MOE_CARD_RTOL; every token routed apart must be a top-k
    near-tie; near-ties and tokens routed apart are counted."""
    import dataclasses

    import torch
    from repro_torch.models import layers
    c32 = dataclasses.replace(cfg, dtype="float32")
    mc = cfg.moe
    p_card = {k: v.float() for k, v in p0.items()}
    p_cpu = {k: v.cpu() for k, v in p_card.items()}
    x_card = x0.float()
    x_cpu = x_card.cpu()
    t0 = time.perf_counter()
    out_card = layers.moe_apply(p_card, c32, x_card).cpu()
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    out_cpu = layers.moe_apply(p_cpu, c32, x_cpu)
    t_cpu = time.perf_counter() - t0
    D = x0.shape[-1]
    T = x0.numel() // D
    cap = layers.moe_capacity(T, mc)
    _, ids_card = layers._route(p_card, mc, x_card.reshape(T, D))
    _, ids_cpu = layers._route(p_cpu, mc, x_cpu.reshape(T, D))
    ids_card = ids_card.cpu()
    ties = _near_ties(p_cpu, mc, x_cpu.reshape(T, D))
    same_ids = (ids_card.sort(-1).values == ids_cpu.sort(-1).values).all(-1)
    same_kept = (_kept(ids_card, mc.num_experts, cap)
                 == _kept(ids_cpu, mc.num_experts, cap)).all(-1)
    rows = same_ids & same_kept
    ref = out_cpu.reshape(T, D)
    err = float((out_card.reshape(T, D)[rows] - ref[rows]).abs().max())
    scale = float(ref.abs().max())
    apart = int((~same_ids).sum())
    log(f"[{tag}] layer 0 moe_apply in f32, card vs CPU over {T} tokens "
        f"(cap {cap}): {int(ties.sum())} top-k near-ties (k-th vs (k+1)-th "
        f"within {MOE_TIE_RTOL:g} relative), {apart} tokens routed apart, "
        f"{int((same_ids & ~same_kept).sum())} more kept apart at capacity; "
        f"dropped pairs card {layers.moe_dropped(p_card, c32, x_card)}, "
        f"CPU {layers.moe_dropped(p_cpu, c32, x_cpu)}; on the "
        f"{int(rows.sum())} others max|Δ| {err:.3e} (tol "
        f"{MOE_CARD_RTOL * scale:.3e}, max|ref| {scale:.4f}); card "
        f"{t_card:.3f} s, CPU {t_cpu:.3f} s")
    if not (bool((same_ids | ties).all()) and err <= MOE_CARD_RTOL * scale):
        raise AssertionError(f"{tag}: moe_apply card vs CPU")


def phase_lm_moe(card: str) -> dict:
    """Phase 17: granite-moe-3b-a800m at its full config: the pairs each
    layer drops at capacity, `lm_forward` (flash kernel at hd 64 vs
    chunked_attention), the prefill's route (`lm_prefill_route`), layer
    0's MoE card vs CPU, the serve loop. Returns the flash run's
    launches."""
    import dataclasses

    from repro_torch.models import layers, lm
    log(f"[lm-moe] on {card}")
    t0 = time.perf_counter()
    _free_card()
    cfg, params = _lm_model(MOE_ARCH, "lm-moe")
    batch = _lm_tokens(cfg)
    c = dataclasses.replace(cfg, use_pallas_attn=True)
    with _moe_drops() as drops:
        lm.forward_trunk(params, c, lm._embed_inputs(params, c, batch))
    T = LM_BATCH * LM_SEQ
    cap = layers.moe_capacity(T, cfg.moe)
    log(f"[lm-moe] pairs dropped at capacity {cap} per layer (mean load "
        f"{T * cfg.moe.top_k / cfg.moe.num_experts:g} of {T} tokens x top-"
        f"{cfg.moe.top_k} over {cfg.moe.num_experts} experts): "
        f"{drops['dropped']} (total {sum(drops['dropped'])} of "
        f"{T * cfg.moe.top_k * cfg.num_layers})")
    res = lm_forward(cfg, params, "lm-moe", batch)
    lm_prefill_route(cfg, params, "lm-moe", batch)
    moe_card_vs_cpu("lm-moe", cfg, drops["p0"], drops["x0"])
    del drops
    lm_serve(cfg, params, "lm-moe")
    del params
    _free_card()
    log(f"[lm-moe] phase took {time.perf_counter() - t0:.1f} s")
    return res[True]["launches"]


def musicgen_decode(cfg, params, tag) -> None:
    """Prefill on SERVE_BATCH x (SERVE_PROMPT - 1) frame embeddings, then
    decode a token: its logits against the forward over the same frames
    followed by that token's scaled embedding (decode embeds tokens);
    then FRONT_DECODE_STEPS greedy steps, timed."""
    import numpy as np
    import torch
    from repro_torch.models import lm
    from repro_torch.models.config import ShapeSpec
    from repro_torch.models.inputs import make_batch
    frames = make_batch(cfg, ShapeSpec("prefill", SERVE_PROMPT - 1,
                                       SERVE_BATCH, "prefill"), seed=1,
                        device=DEVICE)["embeddings"]
    tok = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (SERVE_BATCH, 1))).to(DEVICE)
    capacity = SERVE_PROMPT + FRONT_DECODE_STEPS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, cache = lm.prefill_step_fn(cfg, capacity)(params,
                                                 {"embeddings": frames})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    decode = lm.decode_step_fn(cfg)
    logits, cache = decode(params, cache, tok, SERVE_PROMPT - 1)
    x = torch.cat([frames, lm._embed_tokens(params, cfg, tok)], dim=1)
    full = lm.logits_fn(params, cfg, lm.forward_trunk(params, cfg, x)
                        [:, -1]).float()
    _hold_decode(tag, cfg, logits[:, 0], full,
                 f"{cfg.name}: prefill on {SERVE_PROMPT - 1} frame "
                 f"embeddings + decode of a token")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(SERVE_PROMPT, capacity):
        nxt = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
        logits, cache = decode(params, cache, nxt, t)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    log(f"[{tag}] {cfg.name} batch {SERVE_BATCH}: prefill of "
        f"{SERVE_PROMPT - 1} frames {prefill_s:.4f} s, "
        f"{FRONT_DECODE_STEPS - 1} greedy steps {s:.4f} s "
        f"({SERVE_BATCH * (FRONT_DECODE_STEPS - 1) / s:.1f} tok/s)")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{tag}: non-finite decode logits")


def phase_lm_frontends(card: str) -> dict:
    """Phase 18: musicgen-large (frame embeddings) at its full config,
    llava-next-34b (1152 patch positions + 7040 text tokens) at full
    width and the first of LLAVA_DEPTHS that fits. Returns each one's flash
    launches."""
    import torch
    from repro_torch.models import lm
    from repro_torch.models.config import ShapeSpec
    from repro_torch.models.inputs import make_batch
    log(f"[lm-frontends] on {card}")
    t0 = time.perf_counter()
    shape = ShapeSpec("train", LM_SEQ, LM_BATCH, "train")
    launches = {}
    _free_card()
    cfg, params = _lm_model(MUSICGEN_ARCH, "lm-frontends")
    batch = make_batch(cfg, shape, seed=0, device=DEVICE)
    res = lm_forward(cfg, params, "lm-frontends", batch)
    launches[MUSICGEN_ARCH] = res[True]["launches"]["flash_attention_tc"]
    musicgen_decode(cfg, params, "lm-frontends")
    del params, batch, res
    _free_card()
    log(f"[time] musicgen done in {time.perf_counter() - t0:.1f} s")
    for depth in LLAVA_DEPTHS:
        try:
            cfg, params = _lm_model(LLAVA_ARCH, "lm-frontends", depth)
            batch = make_batch(cfg, shape, seed=0, device=DEVICE)
            res = lm_forward(cfg, params, "lm-frontends", batch)
            break
        except torch.cuda.OutOfMemoryError as e:
            log(f"[lm-frontends] {LLAVA_ARCH} at depth {depth} does not "
                f"fit: {str(e).splitlines()[0]}")
        params = batch = res = None
        _free_card()
    else:
        raise AssertionError(f"[lm-frontends] {LLAVA_ARCH}: no depth fits")
    cut = "" if depth == 60 else " (cut: 45 is the deepest that fits " \
        "beside the forward, the script's time limit cuts it further)"
    log(f"[lm-frontends] {LLAVA_ARCH}: depth {depth} of 60{cut}")
    launches[LLAVA_ARCH] = res[True]["launches"]["flash_attention_tc"]
    # prefill with the patches on all but the last text token, then
    # decode it: against the chunked forward's last position
    pre = {"tokens": batch["tokens"][:, :-1],
           "patch_embeds": batch["patch_embeds"]}
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    _, cache = lm.prefill_step_fn(cfg, capacity=LM_SEQ)(params, pre)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t1
    step, _ = lm.decode_step_fn(cfg)(params, cache, batch["tokens"][:, -1:],
                                     LM_SEQ - 1)
    _hold_decode("lm-frontends", cfg, step[:, 0], res[False]["last"][:, 0],
                 f"{LLAVA_ARCH}: prefill on {cfg.num_patch_tokens} patches "
                 f"+ {LM_SEQ - cfg.num_patch_tokens - 1} tokens "
                 f"({prefill_s:.3f} s) + decode of the last token")
    del params, batch, res, cache, pre
    _free_card()
    log(f"[lm-frontends] phase took {time.perf_counter() - t0:.1f} s")
    return launches


def phase_lm_ssd(card: str) -> dict:
    """Phase 19: mamba2-2.7b at its full config: `loss_fn` over 2 x 8192
    tokens (no flash, no ssd_scan launch: the mixer runs the reference's
    chunked algorithm), prefill on all but the last token + its decode
    against the forward, the serve loop."""
    import numpy as np
    import torch
    from repro_torch.models import lm
    log(f"[lm-ssd] on {card}")
    t0 = time.perf_counter()
    _free_card()
    cfg, params = _lm_model(SSD_ARCH, "lm-ssd")
    batch = _lm_tokens(cfg)
    _, last = _forward(params, cfg, batch)              # also the warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t1 = time.perf_counter()
    loss = float(lm.loss_fn(params, cfg, batch))
    wall = time.perf_counter() - t1
    launches = _launches()
    peak = torch.cuda.max_memory_allocated()
    log(f"[lm-ssd] loss_fn over {LM_BATCH} x {LM_SEQ} tokens in "
        f"{cfg.dtype}: loss {loss:.6f}, wall {wall:.3f} s per forward, "
        f"launches {launches}, peak memory {peak / 2**30:.2f} GiB")
    _log_profile("lm-ssd", lambda: lm.loss_fn(params, cfg, batch), top=8)
    if not (np.isfinite(loss) and bool(torch.isfinite(last).all())):
        raise AssertionError("lm-ssd: non-finite output")
    if launches["flash_attention"] or launches["ssd_scan"]:
        raise AssertionError(f"lm-ssd: kernel launches {launches}, "
                             "expected none")
    tokens = batch["tokens"]
    _, cache = lm.prefill_step_fn(cfg, capacity=LM_SEQ)(
        params, {"tokens": tokens[:, :-1]})
    step, _ = lm.decode_step_fn(cfg)(params, cache, tokens[:, -1:],
                                     LM_SEQ - 1)
    _hold_decode("lm-ssd", cfg, step[:, 0], last[:, 0],
                 f"prefill on {LM_SEQ - 1} tokens (padded to the chunk) + "
                 f"decode of token {LM_SEQ}")
    del cache, step
    lm_serve(cfg, params, "lm-ssd")
    del params
    _free_card()
    log(f"[lm-ssd] phase took {time.perf_counter() - t0:.1f} s")
    return launches


# -------------------------------------------------------------------- 20
RG_ARCH = "recurrentgemma-9b"
# the full 38 layers first; a cut keeps the (lru, lru, attn) pattern
RG_DEPTHS = (38, 30, 24)
# the f32 pass on the hd-256 f32 route: the first (lru, lru, attn) block
RG_F32_DEPTH = 3
# the RG-LRU mixer in f32, card vs CPU: max|Δ| <= 1e-5·max|ref| (f32 sums
# of the four 4096-long products in another order, ~1e-6 relative; the
# recurrence combines in the same order on both)
RGLRU_CARD_RTOL = 1e-5


def _rg_config(depth):
    """recurrentgemma-9b's full config, or its first `depth` layers as
    (lru, lru, attn) blocks."""
    import dataclasses

    from repro_torch.models import registry
    from repro_torch.models.config import Stack
    full = registry.get_config(RG_ARCH)
    if depth == full.num_layers:
        return full
    return dataclasses.replace(full, stacks=(Stack(full.stacks[0].pattern,
                                                   depth // 3),))


@contextlib.contextmanager
def _first_call(name: str):
    """Keeps the params and input of the model's first call of the mixer
    `layers.<name>` (rglru_apply_train, mla_apply_train)."""
    from repro_torch.models import layers
    apply = getattr(layers, name)
    rec = {}

    def keep(p, cfg, x, **kw):
        if not rec:
            rec.update(p=p, x=x.clone())
        return apply(p, cfg, x, **kw)
    setattr(layers, name, keep)
    try:
        yield rec
    finally:
        setattr(layers, name, apply)


def rglru_card_vs_cpu(cfg, p0, x0) -> None:
    """Layer 0's RG-LRU mixer (`rglru_core`) in f32 on the card against the
    CPU, from the same inputs (the layer's bf16 weights and the first
    sequence the forward gave it, cast to f32): y, the conv state and h at
    the last step, each within RGLRU_CARD_RTOL of its max|ref|."""
    import dataclasses

    import torch
    from repro_torch.models import layers
    c32 = dataclasses.replace(cfg, dtype="float32")
    p_card = {k: v.float() for k, v in p0.items()}
    x_card = x0[:1].float()
    t0 = time.perf_counter()
    got = [t.cpu() for t in layers.rglru_core(p_card, c32, x_card)]
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = layers.rglru_core({k: v.cpu() for k, v in p_card.items()}, c32,
                             x_card.cpu())
    t_cpu = time.perf_counter() - t0
    errs = []
    for name, g, w in zip(("y", "conv state", "h_last"), got, want):
        err, scale = float((g - w).abs().max()), float(w.abs().max())
        errs.append(err <= RGLRU_CARD_RTOL * scale)
        log(f"[lm-rglru] layer 0 rglru_core in f32 over {tuple(x_card.shape)}"
            f", card vs CPU, {name}: max|Δ| {err:.3e} (tol "
            f"{RGLRU_CARD_RTOL * scale:.3e}, max|ref| {scale:.4f})")
    log(f"[lm-rglru] rglru_core card {t_card:.3f} s, CPU {t_cpu:.3f} s")
    if not all(errs):
        raise AssertionError("lm-rglru: rglru_core card vs CPU")


def phase_lm_rglru(card: str) -> dict:
    """Phase 20: recurrentgemma-9b at full width and the deepest of
    RG_DEPTHS that fits (the full 38 layers first): `lm_forward` (the
    hd-256 bf16 flash route in its 12 local-attention layers vs
    chunked_attention), layer 0's RG-LRU mixer card vs CPU in f32, the
    serve loop; then its first RG_F32_DEPTH layers in f32 through
    `lm_forward` on the hd-256 f32 route. Returns the two routes'
    launches."""
    import torch
    from repro_torch.models import lm
    log(f"[lm-rglru] on {card}")
    t0 = time.perf_counter()
    for depth in RG_DEPTHS:
        _free_card()
        params = res = None
        try:
            cfg = _rg_config(depth)
            params = lm.init_params(
                torch.Generator(device=DEVICE).manual_seed(0), cfg,
                device=DEVICE)
            log(f"[lm-rglru] {RG_ARCH}: {cfg.num_layers} layers, "
                f"d_model {cfg.d_model}, {cfg.num_heads} heads "
                f"({cfg.num_kv_heads} kv), head_dim {cfg.resolved_head_dim},"
                f" window {cfg.sliding_window}, lru {cfg.rglru}, d_ff "
                f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}; "
                f"{lm.param_count(params)} params")
            with _first_call("rglru_apply_train") as first:
                res = lm_forward(cfg, params, "lm-rglru")
            break
        except torch.cuda.OutOfMemoryError as e:
            log(f"[lm-rglru] depth {depth} does not fit: "
                f"{str(e).splitlines()[0]}")
    else:
        raise AssertionError("[lm-rglru]: no depth fits")
    full = RG_DEPTHS[0]
    log(f"[lm-rglru] depth {cfg.num_layers} of {full}"
        f"{'' if depth == full else ' (cut: deeper does not fit)'}")
    rglru_card_vs_cpu(cfg, first["p"], first["x"])
    first.clear()
    lm_serve(cfg, params, "lm-rglru")
    launches = {"flash_attention_hd256":
                res[True]["launches"]["flash_attention_hd256"]}
    del params, res
    _free_card()
    log(f"[time] recurrentgemma bf16 done in {time.perf_counter() - t0:.1f}"
        " s")
    cfg = _rg_config(RG_F32_DEPTH)
    params = lm.init_params(torch.Generator(device=DEVICE).manual_seed(0),
                            cfg, device=DEVICE)
    cfg32, params = as_f32(cfg, params, "lm-rglru-f32")
    res = lm_forward(cfg32, params, "lm-rglru-f32")
    launches["flash_attention_hd256_f32"] = res[True]["launches"][
        "flash_attention_hd256_f32"]
    del params, res
    _free_card()
    log(f"[lm-rglru] phase took {time.perf_counter() - t0:.1f} s")
    return launches


# -------------------------------------------------------------------- 21
# benchmarks/common.py's five arch programs
IMPORT_ARCHS = ("yi-9b", "mamba2-2.7b", "granite-moe-3b-a800m",
                "recurrentgemma-9b", "musicgen-large")


def phase_import(card: str, replay, seg_qm) -> dict:
    """Phase 21: the program importer on the card: each of IMPORT_ARCHS'
    smoke `loss_fn` traced into a program (the same program, by
    kernel_hash, as traced on the CPU); then a WHOLE_NODES-node
    `whole_model_graph` of their blocks in turn, scored through the
    segmented service (budget 512) in f32 and int8, kernels on vs off.
    Returns the aggregation launches of the two timed runs."""
    import math

    import torch
    from repro_torch.core import hlo_import, opset
    from repro_torch.data.corpus import kernel_hash
    from repro_torch.data.synthetic import whole_model_graph
    log(f"[import] on {card}")
    t0 = time.perf_counter()
    for arch in IMPORT_ARCHS:
        t1 = time.perf_counter()
        g = hlo_import.import_arch_program(arch, device=DEVICE)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        dots = [n for n in g.nodes if n.op is opset.DOT]
        flops = sum(2 * n.contract_dim * math.prod(n.shape) for n in dots)
        same = kernel_hash(g) == kernel_hash(
            hlo_import.import_arch_program(arch, device="cpu"))
        log(f"[import] {g.name}: {g.num_nodes} nodes, {len(dots)} DOTs, "
            f"DOT FLOPs {flops:.4e}, traced on the card in {dt:.3f} s; the "
            f"CPU's program {'equal' if same else 'DIFFERS'}")
        if not (same and dots and g.num_nodes
                < hlo_import._MAX_NODES_PER_PROGRAM):
            raise AssertionError(f"import {arch}: program out of order")
    t1 = time.perf_counter()
    whole = whole_model_graph(WHOLE_NODES, seed=0, arch_blocks=IMPORT_ARCHS,
                              device=DEVICE)
    log(f"[import] whole_model_graph of {IMPORT_ARCHS}: {whole.num_nodes} "
        f"nodes, {sum(n.op is opset.DOT for n in whole.nodes)} DOTs, built "
        f"in {time.perf_counter() - t1:.3f} s")
    seg_kw = dict(reduction="column_wise")
    requests = [[whole]]
    f32 = serve("imported f32", f32_services(replay, "segmented", **seg_kw),
                requests, ["segment_aggregate"], tag="import")
    i8 = serve("imported int8", int8_services(replay, seg_qm, "segmented"),
               requests, ["segment_aggregate_i8"], tag="import")
    log(f"[import] predictions f32 {f32['preds'].tolist()} int8 "
        f"{i8['preds'].tolist()}; phase took "
        f"{time.perf_counter() - t0:.1f} s")
    return {"segment_aggregate": f32["launches"]["segment_aggregate"],
            "segment_aggregate_i8": i8["launches"]["segment_aggregate_i8"]}


# -------------------------------------------------------------------- 22
MLA_ARCH = "deepseek-v3-671b"
# (dense, MoE) layers of its (3, 58), at full width: the deepest cut that
# one card holds beside the 2 x 8192 forward (each MoE layer is 21.4 GiB
# of bf16 weights; at (3, 2) `_winit` draws a stacked expert leaf in f32,
# 28 GiB, beside its cast and the leaves made before it)
DS_DEPTHS = ((3, 2), (3, 1))
# LM_TRAIN_STEPS Adafactor steps (`_lm_train_run`) on 1 x DS_TRAIN_SEQ
# tokens: at (3, 1) 28 GiB of weights and 28 GiB of bf16 gradients leave
# less than the update's f32 temporaries of an expert stack (14 GiB
# each); then the three dense layers alone
DS_TRAIN_DEPTHS = ((3, 1), (3, 0))
DS_TRAIN_SEQ = 2048
# layer 0's MLA in f32, card vs CPU, on the first MLA_CARD_SEQ positions
# of the first sequence: max|Δ| <= 1e-5·max|ref| (the RG-LRU check's
# limit; f32 sums in another order)
MLA_CARD_RTOL = 1e-5
MLA_CARD_SEQ = 2048


def mla_card_vs_cpu(cfg, p0, x0) -> None:
    """Layer 0's `mla_apply_train` in f32 on the card against the CPU,
    from the same inputs (the layer's bf16 weights and the input the
    forward gave it, cast to f32), within MLA_CARD_RTOL·max|ref|; then
    three planted faults, each run on the card, which the check must
    catch: the rope key roped at positions + 1, the KV latent's RMSNorm
    left out, the causal mask shifted by one (q_offset=1: each query
    sees the next key; rope is relative, so q_offset moves nothing
    else)."""
    import dataclasses

    import torch
    from repro_torch.models import layers
    c32 = dataclasses.replace(cfg, dtype="float32")

    def f32(tree, dev):
        return {k: f32(v, dev) if isinstance(v, dict)
                else v.to(dev, torch.float32) for k, v in tree.items()}
    p_card, p_cpu = f32(p0, DEVICE), f32(p0, "cpu")
    x_card = x0[:1, :MLA_CARD_SEQ].float()
    t0 = time.perf_counter()
    got = layers.mla_apply_train(p_card, c32, x_card).cpu()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = layers.mla_apply_train(p_cpu, c32, x_card.cpu())
    t_cpu = time.perf_counter() - t0
    scale = float(want.abs().max())
    tol = MLA_CARD_RTOL * scale
    err = float((got - want).abs().max())
    log(f"[lm-mla] layer 0 mla_apply_train in f32 over "
        f"{tuple(x_card.shape)} ({x_card.shape[1]} positions), card vs CPU:"
        f" max|Δ| {err:.3e} (tol {tol:.3e}, max|ref| {scale:.4f}); card "
        f"{t_card:.3f} s, CPU {t_cpu:.3f} s")
    if not (bool(torch.isfinite(got).all()) and err <= tol):
        raise AssertionError("lm-mla: mla_apply_train card vs CPU")
    latent = layers._mla_kv_latent

    def rope_shifted(p, c, x, positions):
        return latent(p, c, x, positions)[0], latent(p, c, x,
                                                     positions + 1)[1]

    def unnormed(p, c, x, positions):
        ckv = (x @ p["wdkv"])[..., :c.mla.kv_lora_rank]
        return ckv, latent(p, c, x, positions)[1]
    for label, fault, kw in (("k_rope at positions + 1", rope_shifted, {}),
                             ("the KV latent's RMSNorm left out", unnormed,
                              {}),
                             ("the causal mask shifted by one (q_offset=1)",
                              latent, {"q_offset": 1})):
        layers._mla_kv_latent = fault
        try:
            out = layers.mla_apply_train(p_card, c32, x_card, **kw).cpu()
        finally:
            layers._mla_kv_latent = latent
        ferr = float((out - want).abs().max())
        log(f"[lm-mla] planted fault, {label}: max|Δ| {ferr:.3e} (tol "
            f"{tol:.3e}): {'caught' if ferr > tol else 'MISSED'}")
        if not ferr > tol:
            raise AssertionError(f"lm-mla: the card vs CPU check misses "
                                 f"{label}")


def phase_lm_mla(card: str) -> None:
    """Phase 22: deepseek-v3-671b (MLA, then the sigmoid-routed MoE) at
    full width and the deepest of DS_DEPTHS that fits: the pairs each MoE
    layer drops at capacity over `loss_fn` at LM_BATCH x LM_SEQ, that
    forward timed and profiled, the same with `use_pallas_attn` (no
    kernel launch: MLA attends with chunked_attention, as the
    reference), layer 0's MLA card vs CPU in f32 with planted faults,
    the serve loop with decode held against the forward; then
    LM_TRAIN_STEPS Adafactor steps at the first of DS_TRAIN_DEPTHS that
    fits."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.models import layers, lm, registry
    from repro_torch.models.config import ShapeSpec
    from repro_torch.models.inputs import make_batch
    log(f"[lm-mla] on {card}")
    t0 = time.perf_counter()
    full = registry.get_config(MLA_ARCH)
    shape = tuple(s.repeats for s in full.stacks)
    with torch.inference_mode():
        for depth in DS_DEPTHS:
            params = batch = drops = first = None
            _free_card()
            try:
                cfg, params = _lm_model(MLA_ARCH, "lm-mla", depth)
                batch = _lm_tokens(cfg)
                with _moe_drops() as drops, \
                        _first_call("mla_apply_train") as first:
                    lm.loss_fn(params, cfg, batch)      # also the warm-up
                break
            except torch.cuda.OutOfMemoryError as e:
                log(f"[lm-mla] depth {depth} (dense, MoE) does not fit: "
                    f"{str(e).splitlines()[0]}")
        else:
            raise AssertionError("[lm-mla]: no depth fits")
        log(f"[lm-mla] depth {depth} (dense, MoE) of {shape}"
            f"{'' if depth == shape else ' (cut: deeper does not fit)'}")
        T = LM_BATCH * LM_SEQ
        mc = cfg.moe
        log(f"[lm-mla] over loss_fn at {LM_BATCH} x {LM_SEQ} tokens, pairs "
            f"dropped at capacity {layers.moe_capacity(T, mc)} per MoE layer"
            f" (mean load {T * mc.top_k / mc.num_experts:g} of {T} tokens x "
            f"top-{mc.top_k} over {mc.num_experts} experts): "
            f"{drops['dropped']} of {T * mc.top_k} each; top-{mc.top_k} "
            f"near-ties (within {MOE_TIE_RTOL:g}): {drops['ties']}")
        drops = None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t1 = time.perf_counter()
        loss = float(lm.loss_fn(params, cfg, batch))
        wall = time.perf_counter() - t1
        launches = _launches()
        peak = torch.cuda.max_memory_allocated()
        log(f"[lm-mla] loss_fn over {LM_BATCH} x {LM_SEQ} tokens in "
            f"{cfg.dtype}: loss {loss:.6f}, wall {wall:.3f} s per forward, "
            f"launches {launches}, peak memory {peak / 2**30:.2f} GiB")
        _log_profile("lm-mla", lambda: lm.loss_fn(params, cfg, batch),
                     top=8)
        if not np.isfinite(loss) or any(launches.values()):
            raise AssertionError(f"lm-mla: loss {loss}, launches {launches}")
        c = dataclasses.replace(cfg, use_pallas_attn=True)
        _reset_launches()
        loss_flag = float(lm.loss_fn(params, c, batch))
        flagged = _launches()
        log(f"[lm-mla] loss_fn with use_pallas_attn=True: loss "
            f"{loss_flag!r}, with it off {loss!r} (|Δ| "
            f"{abs(loss_flag - loss):.3e}, tol {LM_LOSS_TOL:g}); launches "
            f"{flagged}")
        if any(flagged.values()) or not abs(loss_flag - loss) <= LM_LOSS_TOL:
            raise AssertionError("lm-mla: use_pallas_attn launched a kernel "
                                 "or moved the loss")
        mla_card_vs_cpu(cfg, first["p"], first["x"])
        first = None
        lm_serve(cfg, params, "lm-mla")
        params = batch = None
    _free_card()
    log(f"[time] deepseek forward and serve done in "
        f"{time.perf_counter() - t0:.1f} s")
    for depth in DS_TRAIN_DEPTHS:
        _free_card()
        cfg = dataclasses.replace(_cut(full, depth), microbatch=1)
        log(f"[lm-mla] train at depth {depth} (dense, MoE) of {shape}: "
            f"{LM_TRAIN_STEPS} steps on 1 x {DS_TRAIN_SEQ} tokens, microbatch"
            f" 1 (the config's {full.microbatch} replaced)")
        try:
            batch = make_batch(cfg, ShapeSpec("train", DS_TRAIN_SEQ, 1,
                                              "train"), seed=0, device=DEVICE)
            _lm_train_run(cfg, batch, "adafactor", LM_ADAFACTOR_LR, "lm-mla")
            break
        except torch.cuda.OutOfMemoryError as e:
            log(f"[lm-mla] train step at depth {depth} (dense, MoE) does "
                f"not fit: {str(e).splitlines()[0]}")
    else:
        raise AssertionError("[lm-mla]: no train depth fits")
    _free_card()
    log(f"[lm-mla] phase took {time.perf_counter() - t0:.1f} s")


# -------------------------------------------------------------------- 23
ROOFLINE_ARCH, ROOFLINE_SHAPE = "deepseek-v3-671b", "train_4k"
# the dry-run's probe processes, beside the cell's and the phases of the
# card: 6 of the host's 8 cores busy
ROOFLINE_WORKERS = 4
# lowers [lm-train]'s cell on a one-rank fake group; prints its record
_ROOFLINE_CELL = """
import dataclasses, json, sys
from repro_torch.launch.lowering import lower_cell
from repro_torch.launch.mesh import fake_world, make_mesh
from repro_torch.models import registry
from repro_torch.models.config import ShapeSpec, Stack
arch, depth, micro, seq, batch = json.loads(sys.argv[1])
full = registry.get_config(arch)
cfg = dataclasses.replace(full, microbatch=micro, optimizer="adamw",
                          stacks=(Stack(full.stacks[0].pattern, depth),))
with fake_world(1):
    mesh = make_mesh((1, 1), ("data", "model"))
    cell = lower_cell(arch, cfg, ShapeSpec("train", seq, batch, "train"),
                      mesh, "1x1")
print(json.dumps({"cost": cell.cost_analysis,
                  "memory": vars(cell.memory_analysis),
                  "collectives": cell.collective_bytes,
                  "params_bytes": cell.params_bytes,
                  "fallbacks": cell.fallbacks}))
"""


def _cpu_process(args: list) -> subprocess.Popen:
    """Starts `python args...` from the checkout with the card hidden (the
    dry-run needs none, and its fake process group stays in it). Its
    output goes to temporary files (`proc.logs`): no pipe fills while
    nobody reads it."""
    env = dict(os.environ, PYTHONPATH=SRC, CUDA_VISIBLE_DEVICES="")
    logs = (tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
    proc = subprocess.Popen([sys.executable, *args], cwd=ROOT, env=env,
                            stdout=logs[0], stderr=logs[1], text=True)
    proc.logs = logs
    return proc


def _finish(proc: subprocess.Popen, timeout: int = 300) -> str:
    """`proc`'s standard output once it exits 0; kills it past `timeout`
    and raises on any other end."""
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError(f"[roofline] {proc.args[1:4]} ran past "
                             f"{timeout} s")
    for f in proc.logs:
        f.seek(0)
    out, err = (f.read() for f in proc.logs)
    if proc.returncode != 0:
        raise AssertionError(f"[roofline] {proc.args[1:4]} failed "
                             f"({proc.returncode}): {out[-1500:]} "
                             f"{err[-3000:]}")
    return out


@contextlib.contextmanager
def roofline_lowerings(depth: int):
    """Phase 23's two lowerings, each started in a CPU process of its own:
    [lm-train]'s cell at `depth`, and deepseek's dry-run with
    ROOFLINE_WORKERS probe processes. They run beside phases 17-22, which
    keep the card busy and leave most of the host's cores idle;
    `phase_roofline` collects them. Whatever still runs at the exit is
    killed."""
    out_dir = tempfile.TemporaryDirectory()
    procs = {}
    try:
        procs["dryrun"] = _cpu_process([
            "-m", "repro_torch.launch.dryrun", "--arch", ROOFLINE_ARCH,
            "--shape", ROOFLINE_SHAPE, "--mesh", "single", "--workers",
            str(ROOFLINE_WORKERS), "--out", out_dir.name])
        procs["cell"] = _cpu_process(["-c", _ROOFLINE_CELL, json.dumps(
            [ARCH, depth, LM_TRAIN_MICRO, LM_TRAIN_SEQ, LM_TRAIN_BATCH])])
        yield dict(procs, t0=time.perf_counter(), out=out_dir.name)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            for f in proc.logs:
                f.close()
        out_dir.cleanup()


def phase_roofline(card: str, lm_train: dict, started: dict) -> None:
    """Phase 23: the lowering's counts against [lm-train]'s measured step,
    then deepseek-v3-671b's train cell on the 16x16 mesh, from the
    processes `roofline_lowerings` started."""
    import dataclasses

    import torch
    from repro_torch.models import SHAPES, registry
    from repro_torch.models.config import ShapeSpec, Stack
    from repro_torch.roofline.analysis import H100_HW, model_flops, \
        roofline_terms
    log(f"[roofline] on {card}")
    t0 = time.perf_counter()
    depth = lm_train["depth"]
    measured_s = lm_train["adamw"]["s"]
    peak = lm_train["adamw"]["peak"]
    cell = json.loads(_finish(started["cell"]).strip().splitlines()[-1])
    full = registry.get_config(ARCH)
    cfg = dataclasses.replace(full, microbatch=LM_TRAIN_MICRO,
                              stacks=(Stack(full.stacks[0].pattern, depth),))
    shape = ShapeSpec("train", LM_TRAIN_SEQ, LM_TRAIN_BATCH, "train")
    rec = dict(cell, arch=ARCH, shape="train", mesh="1x1", devices=1)
    row = roofline_terms(rec, cfg, shape, H100_HW)
    flops = cell["cost"]["flops"]
    mf = model_flops(cfg, shape, cell["params_bytes"] // 2)
    args_bytes = cell["memory"]["argument_size_in_bytes"]
    t_cell = time.perf_counter() - started["t0"]
    log(f"[roofline] {ARCH} train cell of [lm-train] (depth {depth}, "
        f"{LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} tokens, microbatch "
        f"{LM_TRAIN_MICRO}, AdamW) lowered on a 1x1 mesh, {t_cell:.1f} s "
        f"from its start (beside phases 17-22) to its record: counted FLOPs {flops:.6e}, model FLOPs "
        f"{mf:.6e} (6·N·tokens + head), useful ratio "
        f"{row.useful_ratio:.4f}")
    log(f"[roofline] ops run replicated: {cell['fallbacks'] or 'none'} "
        f"(one rank: plain meta tensors)")
    log(f"[roofline] H100 terms: compute {row.compute_s:.6f} s (989 TF/s "
        f"bf16), memory {row.memory_s:.6f} s (unfused bytes "
        f"{cell['cost']['bytes accessed']:.6e} at 3.35 TB/s); predicted "
        f"argument bytes {args_bytes} ({args_bytes / 1e9:.3f} GB)")
    est_peak = cell["memory"]["peak_memory_in_bytes"]
    log(f"[roofline] [lm-train] measured: {measured_s:.6f} s a step, peak "
        f"{peak} bytes ({peak / 1e9:.3f} GB); roofline reached: compute "
        f"term / measured = {row.compute_s / measured_s:.4f}, arguments "
        f"/ peak = {args_bytes / peak:.4f}; the lowering's peak estimate "
        f"(live storages of the eager step) {est_peak} bytes = "
        f"{est_peak / peak:.4f} of the measured peak")
    if not row.compute_s <= measured_s:
        raise AssertionError(f"[roofline] compute term {row.compute_s} s "
                             f"exceeds the measured step {measured_s} s")
    if not args_bytes <= peak:
        raise AssertionError(f"[roofline] predicted arguments {args_bytes} "
                             f"exceed the measured peak {peak}")

    _finish(started["dryrun"], timeout=600)
    with open(os.path.join(started["out"], f"pod16x16__{ROOFLINE_ARCH}__"
                           f"{ROOFLINE_SHAPE}.json")) as f:
        ds = json.load(f)
    if ds.get("status") != "ok":
        raise AssertionError(f"[roofline] dry-run record: {ds}")
    ds_cfg = registry.get_config(ROOFLINE_ARCH)
    ds_row = roofline_terms(ds, ds_cfg, SHAPES[ROOFLINE_SHAPE], H100_HW)
    parts = ds["arguments"]
    dev_total = torch.cuda.get_device_properties(0).total_memory
    arg_b = ds["memory"]["argument_size_in_bytes"]
    ds_peak = ds["memory"]["peak_memory_in_bytes"]
    log(f"[roofline] {ROOFLINE_ARCH} {ROOFLINE_SHAPE} on the 16x16 mesh "
        f"(256 ranks; cost from {ds['cost_from']}, lowered in "
        f"{ds['compile_s']} s beside the cell): per device params "
        f"{parts['params']} B, optimizer ({ds_cfg.optimizer}) "
        f"{parts['optimizer']} B, batch {parts['batch']} B, arguments "
        f"{arg_b} B ({arg_b / 1e9:.3f} GB)")
    for what, n in (("arguments", arg_b), ("peak estimate (probes)",
                                            ds_peak)):
        log(f"[roofline] fits: {what} {n / 1e9:.3f} GB a device against "
            f"H100_HW's {H100_HW['hbm_bytes'] / 1e9:g} GB: "
            f"{'yes' if n <= H100_HW['hbm_bytes'] else 'NO'}; against this "
            f"card's {dev_total / 1e9:.3f} GB: "
            f"{'yes' if n <= dev_total else 'NO'}")
    coll = sum(v for k, v in ds["collectives"].items() if k != "_counts")
    fb = ds["fallback_collective_bytes"]
    log(f"[roofline] ops run replicated (summed over the probes): "
        f"{ds['fallbacks']}; their collective bytes {fb:.6e} of "
        f"{coll:.6e} a device ({fb / coll:.6f})")
    log(f"[roofline] H100 terms a step: compute {ds_row.compute_s:.4f} s, "
        f"memory {ds_row.memory_s:.4f} s, collective "
        f"{ds_row.collective_s:.4f} s (at 50 GB/s a card: sharded "
        f"{(coll - fb) / H100_HW['link_bw']:.4f} s, from the ops run "
        f"replicated {fb / H100_HW['link_bw']:.4f} s) -> "
        f"{ds_row.dominant}; useful ratio {ds_row.useful_ratio:.4f}")
    log(f"[roofline] phase took {time.perf_counter() - t0:.1f} s after "
        f"phase 22 ({time.perf_counter() - started['t0']:.1f} s from the "
        f"lowerings' start)")


# -------------------------------------------------------------------- 24
# the [zoo-kernels] layers each bf16 flash instantiation is held at:
# (label, B, S, H, KH, hd, causal, window, timed calls)
EX_FLASH_CASES = (
    ("layer", LM_BATCH, LM_SEQ, 32, 8, 120, True, 4096, 5),
    ("granite-layer", LM_BATCH, LM_SEQ, 24, 8, 64, True, None, 5),
    ("musicgen-layer", LM_BATCH, LM_SEQ, 32, 32, 64, True, None, 5),
    ("llava-layer", LM_BATCH, LM_SEQ, 56, 8, 128, True, None, 5))
# the kernels-line row of each instantiation ((128, 128) is the default,
# the "flash_attention" row of [zoo-kernels])
FLASH_BLOCK_ROWS = {(128, 128): "flash_attention",
                    (128, 64): "flash_attention_128x64",
                    (64, 128): "flash_attention_64x128",
                    (64, 64): "flash_attention_64x64"}
# two candidates of one list within this of each other (relative to the
# list's largest |score|) are a near-tie: counted, not excused
EX_TIE_RTOL = 1e-5
# train_cost_model's --steps (the reference's default 600), cut for the
# script's time limit; its checkpoint and evaluation cadence is 200
EX_TRAIN_STEPS = 200


def _example(name: str, argv: list, **kw):
    """`repro_torch.examples.<name>.main(argv, **kw)` with its stdout
    logged as [examples] lines. Returns (main's result, its lines)."""
    import importlib
    import io

    import torch
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = mod.main(argv, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(f"[examples] {name}: {line}")
    log(f"[examples] {name} {' '.join(argv)}"
        f"{' use_kernels' if kw.get('use_kernels') else ''}: "
        f"{seconds:.1f} s wall")
    return out, lines


def _hold_scores(label, on, off, groups) -> None:
    """Kernels on vs off over candidate lists (`groups`: slices of the
    score vectors): every score within the serving limit, each list's
    pick equal; near-ties within a list counted and printed."""
    import numpy as np
    on, off = np.asarray(on), np.asarray(off)
    err, tol = float(np.max(np.abs(on - off))), _tol(off)
    picks = sum(int(np.argmin(on[g]) != np.argmin(off[g])) for g in groups)
    ties = sum(_ties(off[g], EX_TIE_RTOL * float(np.max(np.abs(off[g]))))
               for g in groups)
    log(f"[examples] {label}, kernels on vs off: {on.size} scores in "
        f"{len(groups)} candidate lists, max_abs_err={err:.3e} (tol "
        f"{tol:.3e}), picks that differ {picks}, near-ties (within "
        f"{EX_TIE_RTOL:g} of the list's max) {ties}")
    if not np.all(np.isfinite(on)) or not err <= tol or picks:
        raise AssertionError(f"{label}: kernels on vs off: err {err} "
                             f"(tol {tol}), {picks} picks differ")


def _groups(sizes) -> list:
    import numpy as np
    ends = np.cumsum(sizes)
    return [slice(int(e - n), int(e)) for e, n in zip(ends, sizes)]


def _need(label, launches: dict, names) -> None:
    for name in names:
        if launches[name] == 0:
            raise AssertionError(f"{label}: {name} never launched")


def ex_quickstart() -> dict:
    """quickstart at its defaults, then its serving step again with the
    trained model under `use_pallas_aggregate` (dense: graph_aggregate),
    every record's tile scores held against the kernels-off service."""
    import dataclasses

    from repro_torch.examples import quickstart
    qs, _ = _example("quickstart", ["--device", DEVICE])
    on_cfg = dataclasses.replace(qs["model_cfg"], use_pallas_aggregate=True)
    _reset_launches()
    on = quickstart.serve(qs["trainer"].model, on_cfg, qs["norm"],
                          qs["dataset"], qs["sim"])
    launches = _launches()
    _need("quickstart serving", launches, ["graph_aggregate"])
    recs = qs["dataset"].records
    scores = {}
    for tag, served in (("on", on), ("off", qs["served"])):
        scorer = served["service"].tile_scorer()      # from its cache
        scores[tag] = [s for r in recs for s in scorer(r.kernel, r.tiles)]
    _hold_scores("quickstart tile scores", scores["on"], scores["off"],
                 _groups([len(r.tiles) for r in recs]))
    log(f"[examples] quickstart serving with the kernels on: launches "
        f"graph_aggregate={launches['graph_aggregate']}; mean tile APE "
        f"{on['metrics']['mean_ape']:.4f}% (off "
        f"{qs['served']['metrics']['mean_ape']:.4f}%)")
    return {"graph_aggregate": launches["graph_aggregate"]}


def ex_train_cost_model(tmp: str) -> dict:
    """train_cost_model at EX_TRAIN_STEPS, dense then sparse, evaluating
    and autotuning with the kernels on, into a temporary --ckpt-dir; the
    dense run once more, resumed from its last checkpoint, must report
    what the first did."""
    out = {"graph_aggregate": 0, "segment_aggregate": 0}
    lines = {}
    log(f"[examples] cut: train_cost_model --steps {EX_TRAIN_STEPS} (the "
        "reference's default 600; the script's time limit)")
    for run, adjacency, kernel in (("dense", "dense", "graph_aggregate"),
                                   ("sparse", "sparse", "segment_aggregate"),
                                   ("resumed", "dense", "graph_aggregate")):
        ckpt = os.path.join(tmp, adjacency)
        _reset_launches()
        _, lines[run] = _example(
            "train_cost_model", ["--steps", str(EX_TRAIN_STEPS),
                                 "--adjacency", adjacency, "--ckpt-dir",
                                 ckpt, "--device", DEVICE],
            use_kernels=True)
        launches = _launches()
        _need(f"train_cost_model {run}", launches, [kernel])
        out[kernel] += launches[kernel]
        if not os.path.exists(os.path.join(ckpt, "metrics.jsonl")):
            raise AssertionError(f"train_cost_model {run}: no metrics.jsonl")
    # the resumed run trains no step (its loss reads nan) and must give
    # the first run's held-out metrics and autotuner result
    same = lines["resumed"][-2:] == lines["dense"][-2:]
    log(f"[examples] train_cost_model resumed from its last checkpoint: "
        f"held-out and autotuner lines {'equal' if same else 'DIFFER'}")
    if not same:
        raise AssertionError("train_cost_model: the resumed run differs")
    return out


def ex_autotune_zoo() -> dict:
    """autotune_zoo at its defaults with the learned estimators under
    `use_pallas_aggregate` (sparse: segment_aggregate), then each arch's
    search again with the kernels off: the same fusion decision and tile
    picks, and the learned scores of every fused kernel's candidate
    tiles held as in quickstart."""
    import dataclasses

    from repro_torch.data.tile_dataset import enumerate_tiles
    from repro_torch.examples import autotune_zoo
    _reset_launches()
    zoo, _ = _example("autotune_zoo", ["--device", DEVICE],
                      use_kernels=True)
    launches = _launches()
    _need("autotune_zoo", launches, ["segment_aggregate"])
    off_cfg = dataclasses.replace(zoo["serve_cfg"],
                                  use_pallas_aggregate=False)
    model, norm, sim = zoo["trainer"].model, zoo["norm"], zoo["sim"]
    for arch, t_on in zoo["runs"].items():
        t_off = autotune_zoo.tune_arch(t_on["prog"], model, off_cfg, norm,
                                       zoo["args"], sim)
        same = (t_on["fusion"].best_decision == t_off["fusion"].best_decision
                and [r.chosen_tile for r in t_on["tiles"].results]
                == [r.chosen_tile for r in t_off["tiles"].results]
                and t_on["meter"].spent_s == t_off["meter"].spent_s)
        log(f"[examples] autotune_zoo {arch}, kernels on vs off: fusion "
            f"decision, tile picks and budget {'equal' if same else 'DIFFER'}")
        if not same:
            raise AssertionError(f"autotune_zoo {arch}: picks differ")
        cands = [[k.with_tile(tile) for tile in enumerate_tiles(k, 12,
                                                                sim.hw)]
                 for k in t_on["kernels"]]
        graphs = [g for c in cands for g in c]
        scores = {c.use_pallas_aggregate: autotune_zoo.learned_estimator(
            model, c, norm, None).estimate(graphs)
            for c in (zoo["serve_cfg"], off_cfg)}
        _hold_scores(f"autotune_zoo {arch} learned scores", scores[True],
                     scores[False], _groups([len(c) for c in cands]))
    return {"segment_aggregate": launches["segment_aggregate"]}


def check_flash_blocks() -> dict:
    """Every bf16 flash instantiation against the plain version at the
    EX_FLASH_CASES layers (FLASH_TOL), each timed (CUDA events; device
    time by the profiler) beside its bound, the plain version and SDPA.
    Returns the kernels-line numbers of each instantiation at h2o-danube-
    3-4b's layer (the first case)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    rtol, atol = FLASH_TOL["bfloat16"]
    rows = {}
    for label, B, S, H, KH, hd, causal, window, iters in EX_FLASH_CASES:
        q = torch.randn((B, S, H, hd), generator=gen,
                        device=DEVICE).bfloat16()
        k = torch.randn((B, S, KH, hd), generator=gen,
                        device=DEVICE).bfloat16()
        v = torch.randn((B, S, KH, hd), generator=gen,
                        device=DEVICE).bfloat16()

        def plain():
            return fa.flash_attention_plain(q, k, v, causal=causal,
                                            window=window)
        ref = plain()
        plain_ms = time_ms(plain, warmup=0, iters=1)
        sq, sk, sv, mask = _sdpa_inputs(q, k, v, causal, window)

        def library():
            return F.scaled_dot_product_attention(sq, sk, sv, attn_mask=mask)
        lib_ms = time_ms(library, warmup=1, iters=iters)
        del sq, sk, sv, mask
        pairs = _attn_pairs(S, S, causal, window)
        flops = 4 * hd * pairs * B * H
        nbytes = 2 * 2 * hd * (B * S * H + B * S * KH)
        b_ms, b_by = bound(nbytes, flops, PEAK_BF16_FLOP_PER_S)
        for bq, bk in fa.BLOCK_SHAPES["sm90"]:
            def run():
                return fa.flash_attention(q, k, v, causal=causal,
                                          window=window, block_q=bq,
                                          block_k=bk)
            out = run()
            torch.cuda.synchronize()
            ok, err, worst = _within(out, ref, rtol, atol)
            del out
            ms = time_ms(run, warmup=1, iters=iters)
            dev_ms, split = device_ms(run, iters)
            log(f"[examples] flash_attention ({bq}, {bk}) {label} B={B} "
                f"S={S} H={H} KH={KH} hd={hd} causal={causal} "
                f"window={window} bf16: max_abs_err={err:.3e} (worst "
                f"{worst:.3f} of the limit) kernel {ms:.4f} ms call, "
                f"device {dev_ms:.4f} ms [{split}], "
                f"{flops / ms / 1e9:.1f} TFLOP/s, bound {b_ms:.4f} ms "
                f"({b_by}), bound / call {b_ms / ms:.1%}; plain "
                f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms")
            if not ok:
                raise AssertionError(f"flash_attention ({bq}, {bk}) "
                                     f"{label}: worst {worst} of the limit")
            if label == EX_FLASH_CASES[0][0]:
                rows[FLASH_BLOCK_ROWS[(bq, bk)]] = {
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": lib_ms}
        del q, k, v, ref
    return rows


def phase_examples(card: str) -> dict:
    """24: the six example twins on the card at the reference scripts'
    defaults, the aggregation kernels
    launched from their serving paths against the kernels off, and every
    bf16 flash instantiation. Returns {"rows": kernels-line numbers of
    the instantiations, "launches": the examples' own launch counts}."""
    from repro_torch.kernels import flash_attention as fa
    t0 = time.perf_counter()
    log(f"[examples] {card}: the six twins at the reference's defaults, "
        "but for the cut below")
    _example("fusion_search", [])
    # Part B times each candidate on the card: the instantiations' path
    _reset_launches()
    _example("autotune_tilesize", ["--device", DEVICE])
    blocks = dict(fa.launches_sm90)
    for shape, n in blocks.items():
        if n == 0:
            raise AssertionError(f"autotune_tilesize: flash block {shape} "
                                 "never launched")
    launches = {FLASH_BLOCK_ROWS[s]: n for s, n in blocks.items()}
    counts = [ex_quickstart()]
    _example("serve_lm", ["--device", DEVICE])
    with tempfile.TemporaryDirectory() as tmp:
        counts.append(ex_train_cost_model(tmp))
    counts.append(ex_autotune_zoo())
    for c in counts:
        for name, n in c.items():
            launches[name] = launches.get(name, 0) + n
    log(f"[examples] launches of the examples' paths: {launches}")
    log(f"[time] examples twins done in {time.perf_counter() - t0:.1f} s")
    rows = check_flash_blocks()
    log(f"[time] examples phase done in {time.perf_counter() - t0:.1f} s")
    return {"rows": rows, "launches": launches}


def main() -> int:
    t_start = time.perf_counter()
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
    import numpy as np

    card = phase_device()
    phase_build()
    replay = _replay()
    log(f"[serve] replay: {replay.num_kernels} kernels, "
        f"{len(replay.requests)} requests, {replay.num_queries} queries, "
        f"{replay.num_unique} unique graphs")
    whole = _whole_programs()
    log(f"[segmented] {len(whole)} whole programs of "
        f"{[g.num_nodes for g in whole]} nodes, budget {SEGMENT_BUDGET}")
    gen = torch.Generator().manual_seed(0)
    rows = {"graph_aggregate": check_graph_aggregate(gen),
            "segment_aggregate": check_segment_aggregate(gen, replay),
            "segment_aggregate_i8": check_segment_aggregate_i8(gen, replay,
                                                               whole)}

    # 4: f32, both layouts
    log(f"[time] {time.perf_counter() - t_start:.1f} s: phase 4")
    requests = replay.requests
    sparse = serve("sparse", f32_services(replay, "sparse"), requests,
                   ["segment_aggregate"])
    dense = serve("dense", f32_services(replay, "dense"), requests,
                  ["graph_aggregate"])
    _agree("sparse vs dense layout", sparse["preds"], dense["preds"])

    # 5: int8, both layouts
    from repro_torch.quant import tree_bytes
    qm, f32_model = quantize_like_the_cli(replay, adjacency="sparse")
    q_sparse = serve("int8 sparse", int8_services(replay, qm, "sparse"),
                     requests, ["segment_aggregate_i8"])
    q_dense = serve("int8 dense", int8_services(replay, qm, "dense"),
                    requests, ["graph_aggregate"])
    _agree("int8 sparse vs int8 dense layout", q_sparse["preds"],
           q_dense["preds"])
    f32 = sparse["preds"]
    log(f"[int8] weight bytes {qm.quantized_bytes()} / "
        f"{tree_bytes(f32_model)} = "
        f"{qm.quantized_bytes() / tree_bytes(f32_model):.4f} (reference "
        f"gate 0.35); max|int8 - f32| / std(f32) = "
        f"{float(np.max(np.abs(q_sparse['preds'] - f32)) / np.std(f32)):.4f}"
        f" over {f32.size} predictions; {qm.num_quantized} leaves "
        f"quantized; act_scales {qm.act_scales}")

    # 6: whole programs, f32 and int8
    seg_requests = list(replay.requests) + [[g] for g in whole]
    n_small = replay.num_queries
    seg_kw = dict(reduction="column_wise")
    seg = serve("segmented f32",
                f32_services(replay, "segmented", **seg_kw), seg_requests,
                ["segment_aggregate"])
    small = serve("sparse f32 column_wise",
                  f32_services(replay, "sparse", **seg_kw), requests,
                  ["segment_aggregate"])
    _agree("segmented identity path vs sparse service",
           seg["preds"][:n_small], small["preds"])
    seg_qm, _ = quantize_like_the_cli(replay, adjacency="segmented",
                                      **seg_kw)
    q_seg = serve("segmented int8",
                  int8_services(replay, seg_qm, "segmented"), seg_requests,
                  ["segment_aggregate_i8"])
    log(f"[segmented] whole-program predictions f32 "
        f"{seg['preds'][n_small:].tolist()} int8 "
        f"{q_seg['preds'][n_small:].tolist()}")

    # 7: train on the card, then serve the trained checkpoint
    log(f"[time] {time.perf_counter() - t_start:.1f} s: phase 7")
    tmp = tempfile.TemporaryDirectory()
    trained = phase_train(card, tmp.name)

    # 8-10: the LM zoo
    log(f"[time] {time.perf_counter() - t_start:.1f} s: phase 8-11")
    flash = check_flash_attention()
    rows.update(flash)
    rows["ssd_scan"] = check_ssd_scan()
    # decode_attention's row: h2o's serve shape, the serve loop's
    # launches, and the worst |Δ| of that shape and the loop's own calls
    rows["decode_attention"] = check_decode_attention()["h2o-serve"]
    with torch.inference_mode():
        cfg, params = _lm_model()
        # the main path's counts
        launches = lm_forward(cfg, params)[True]["launches"]
        served, decode_err = lm_serve(cfg, params)
        row = rows["decode_attention"]
        row["launches"] = served["decode_attention"]
        row["max_abs_err"] = max(row["max_abs_err"], decode_err)
        # 11: the same model in f32, on the f32 route
        cfg32, params = as_f32(cfg, params)
        launches32 = lm_forward(cfg32, params,
                                "lm-forward-f32")[True]["launches"]
        del params
    rows["flash_attention"]["launches"] = launches["flash_attention_tc"]
    rows["flash_attention_f32"]["launches"] = launches32[
        "flash_attention_f32"]
    rows["ssd_scan"]["launches"] = launches["ssd_scan"]   # on no path: 0

    # 12-13: the model's consumers, then GAT and the LSTM reduction
    log(f"[time] {time.perf_counter() - t_start:.1f} s: phase 12-13")
    with tmp:
        autotune = phase_autotune(card, trained, replay, tmp.name)
    gat_lstm = phase_gat_lstm(card, trained, replay, whole)

    # 14: the data flywheel
    log(f"[time] {time.perf_counter() - t_start:.1f} s: phase 14")
    with tempfile.TemporaryDirectory() as fw_tmp:
        flywheel = phase_flywheel(card, fw_tmp)

    # 15-16: data-parallel cost-model training, the LM train step
    log(f"[time] {time.perf_counter() - t_start:.1f} s: phase 15-16")
    with tempfile.TemporaryDirectory() as ddp_tmp:
        ddp = phase_ddp(card, trained, ddp_tmp)
    del trained
    lm_train = phase_lm_train(card)

    # 23's lowerings (CPU processes) run from here beside 17-22
    with roofline_lowerings(lm_train["depth"]) as lowerings:
        # 17-19: the MoE ffn, the two front ends, the SSD mixer
        log(f"[time] {time.perf_counter() - t_start:.1f} s: phase 17")
        with torch.inference_mode():
            moe = phase_lm_moe(card)
            log(f"[time] {time.perf_counter() - t_start:.1f} s: phase 18")
            fronts = phase_lm_frontends(card)
            log(f"[time] {time.perf_counter() - t_start:.1f} s: phase 19")
            ssd = phase_lm_ssd(card)
        rows["flash_attention"]["launches"] += (moe["flash_attention_tc"]
                                               + sum(fronts.values()))
        rows["ssd_scan"]["launches"] += ssd["ssd_scan"]

        # 20-21: the RG-LRU mixer with the hd-256 flash routes, the importer
        log(f"[time] {time.perf_counter() - t_start:.1f} s: phase 20")
        with torch.inference_mode():
            rows_rg = phase_lm_rglru(card)
        for name, n in rows_rg.items():
            rows[name]["launches"] = n
        log(f"[time] {time.perf_counter() - t_start:.1f} s: phase 21")
        imported = phase_import(card, replay, seg_qm)

        # 22: deepseek-v3-671b's MLA (no kernel, as in the reference)
        log(f"[time] {time.perf_counter() - t_start:.1f} s: phase 22")
        phase_lm_mla(card)

        # 23: the dry-run lowering against [lm-train]'s step, deepseek on
        # the 16x16 mesh
        log(f"[time] {time.perf_counter() - t_start:.1f} s: phase 23")
        phase_roofline(card, lm_train, lowerings)

    # 24: the six examples, the flash kernel's block shapes
    log(f"[time] {time.perf_counter() - t_start:.1f} s: phase 24")
    examples = phase_examples(card)
    rows.update((name, dict(r, launches=0))
                for name, r in examples["rows"].items()
                if name != "flash_attention")
    for name in FLASH_BLOCK_ROWS.values():      # Part B's timed candidates
        rows[name]["launches"] += examples["launches"][name]

    # each path's own count: the serving runs of 4-5, then 12-15, 21, 24
    for name, main_run in (("graph_aggregate", dense),
                           ("segment_aggregate", sparse),
                           ("segment_aggregate_i8", q_sparse)):
        rows[name]["launches"] = (main_run["launches"][name]
                                  + examples["launches"].get(name, 0)
                                  + autotune[name] + gat_lstm[name]
                                  + flywheel.get(name, 0)
                                  + ddp.get(name, 0)
                                  + imported.get(name, 0))
    kernels = []
    for name, source, replaces in (
            ("graph_aggregate", "graph_aggregate",
             "src/repro/kernels/graph_aggregate/kernel.py:45"),
            ("segment_aggregate", "segment_aggregate",
             "src/repro/kernels/segment_aggregate/kernel.py:89"),
            ("segment_aggregate_i8", "segment_aggregate",
             "src/repro/kernels/segment_aggregate/kernel.py:89"),
            ("flash_attention", "flash_attention_sm90",
             "src/repro/kernels/flash_attention/kernel.py:79"),
            ("flash_attention_128x64", "flash_attention_sm90",
             "src/repro/kernels/flash_attention/kernel.py:79"),
            ("flash_attention_64x128", "flash_attention_sm90",
             "src/repro/kernels/flash_attention/kernel.py:79"),
            ("flash_attention_64x64", "flash_attention_sm90",
             "src/repro/kernels/flash_attention/kernel.py:79"),
            ("flash_attention_f32", "flash_attention_tf32",
             "src/repro/kernels/flash_attention/kernel.py:79"),
            ("flash_attention_hd256", "flash_attention_hd256",
             "src/repro/kernels/flash_attention/kernel.py:79"),
            ("flash_attention_hd256_f32", "flash_attention_hd256_tf32",
             "src/repro/kernels/flash_attention/kernel.py:79"),
            ("ssd_scan", "ssd_scan",
             "src/repro/kernels/ssd_scan/kernel.py:48"),
            ("decode_attention", "decode_attention",
             "none: src/repro/models/layers.py cache_attention is plain "
             "jnp")):
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}.cu",
            "replaces": replaces, "launches": r["launches"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms")})
    for k in kernels:
        if not all(np.isfinite(x) for x in k.values()
                   if isinstance(x, float)):
            raise AssertionError(f"kernels line: non-finite number in {k}")
    log(f"[done] every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

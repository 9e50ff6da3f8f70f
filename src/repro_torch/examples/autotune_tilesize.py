"""Tile-size autotuning (paper §7.2), including the port's own
flash-attention block shapes.

Counterpart of examples/autotune_tilesize.py. Part A reproduces the
autotuner comparison on corpus kernels: exhaustive vs learned-top-k vs
analytical-top-k hardware usage (host only; the same output line for
line).

Part B closes the loop on the framework itself: the bf16 flash kernel's
(block_q, block_k) instantiations (`kernels.flash_attention.
block_candidates`: Hopper's, where the reference lists the TPU kernel's)
are encoded as tile sizes of an attention kernel graph and ranked by the
same machinery. On the card each candidate is also launched at S=4096,
hd=128 and timed (CUDA events), printed beside its rank: the ranking
comes from the simulator, the times from the card, and nothing is
chosen by the times.

  PYTHONPATH=src python -m repro_torch.examples.autotune_tilesize [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.autotuner import autotune_program_tiles, tune_kernel_tiles
from repro_torch.core import opset
from repro_torch.core.analytical import AnalyticalModel
from repro_torch.core.device import resolve_device
from repro_torch.core.evaluate import analytical_tile_scorer
from repro_torch.core.graph import KernelGraph, Node
from repro_torch.core.simulator import TPUSimulator
from repro_torch.data.fusion import apply_fusion, default_fusion
from repro_torch.data.synthetic import generate_program
from repro_torch.kernels import flash_attention as fa

S, HD = 4096, 128
PROGRAM = "repro_torch.kernels.flash_attention"
# the timed call: one layer of B x S tokens, H query heads over KH kv
# heads at HD, as the graph's slice (no mask), bf16
TIME_B, TIME_H, TIME_KH = 1, 32, 8
TIME_WARMUP, TIME_ITERS = 2, 10


def part_a(sim: TPUSimulator, scorer) -> dict:
    prog = generate_program("attention", 0, seed=42)
    kernels = apply_fusion(prog, default_fusion(prog))
    return {"kernels": kernels,
            "ex": autotune_program_tiles(kernels, sim, scorer=None,
                                         max_configs=24),
            "top10": autotune_program_tiles(kernels, sim, scorer=scorer,
                                            top_k=10, max_configs=24),
            "top1": autotune_program_tiles(kernels, sim, scorer=scorer,
                                           top_k=1, max_configs=24)}


def report_a(a: dict) -> None:
    print("Part A — attention program,", len(a["kernels"]), "kernels")
    print(f"  exhaustive: {a['ex'].total_runtime:.3e}s "
          f"({a['ex'].hardware_evals} hardware evals)")
    print(f"  model top-10: {a['top10'].total_runtime:.3e}s "
          f"({a['top10'].hardware_evals} evals)")
    print(f"  model top-1 (in-compiler): {a['top1'].total_runtime:.3e}s "
          f"({a['top1'].hardware_evals} evals)")


def attention_kernel(program: str = PROGRAM) -> KernelGraph:
    """One (batch*heads) slice of flash attention as a kernel graph: the
    kernel's grid tiles the [S_q, S_k] score space with (block_q,
    block_k). `program` is the graph's label (the simulator keys its
    measurement noise on it)."""
    nodes = [
        Node(opset.PARAMETER, (S, HD), 2),                 # q
        Node(opset.PARAMETER, (S, HD), 2),                 # k
        Node(opset.PARAMETER, (S, HD), 2),                 # v
        Node(opset.DOT, (S, S), 2, (0, 1), contract_dim=HD),   # scores
        Node(opset.REDUCE_MAX, (S,), 2, (3,), reduced_dims=(S,)),
        Node(opset.BROADCAST, (S, S), 2, (4,)),
        Node(opset.SUB, (S, S), 2, (3, 5)),
        Node(opset.EXP, (S, S), 2, (6,)),
        Node(opset.DOT, (S, HD), 2, (7, 2), contract_dim=S,
             is_output=True),                              # p @ v
    ]
    return KernelGraph(nodes, program=program,
                       name=f"flash_attention[{S},{HD}]")


def part_b(sim: TPUSimulator, scorer, tiles=None, program: str = PROGRAM):
    """(tune_kernel_tiles result, candidates, their scores). `tiles`
    defaults to the port's bf16 candidates at S, HD."""
    kernel = attention_kernel(program)
    tiles = [tuple(t) for t in (tiles if tiles is not None
                                else fa.block_candidates(S, S))]
    res = tune_kernel_tiles(kernel, sim, scorer=scorer, top_k=5,
                            tiles=tiles)
    return res, tiles, np.asarray(scorer(kernel, tiles))


def time_blocks(tiles, device) -> dict:
    """{(block_q, block_k): ms a call} of the flash kernel at each
    candidate, on the card (random bf16 inputs from seed 0)."""
    gen = torch.Generator(device=device).manual_seed(0)
    q = torch.randn((TIME_B, S, TIME_H, HD), generator=gen,
                    device=device).bfloat16()
    k, v = (torch.randn((TIME_B, S, TIME_KH, HD), generator=gen,
                        device=device).bfloat16() for _ in range(2))
    out = {}
    for bq, bk in tiles:
        def call():
            return fa.flash_attention(q, k, v, causal=False, block_q=bq,
                                      block_k=bk)
        for _ in range(TIME_WARMUP):
            call()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(TIME_ITERS):
            call()
        end.record()
        torch.cuda.synchronize()
        out[(bq, bk)] = start.elapsed_time(end) / TIME_ITERS
    return out


def report_b(res, tiles, scores, times: dict | None) -> None:
    print("\nPart B — Hopper flash-attention block shapes")
    print(f"  candidates: {len(tiles)}; chosen (block_q, block_k) = "
          f"{res.chosen_tile}")
    print(f"  chosen runtime {res.chosen_runtime:.3e}s, exhaustive best "
          f"{res.best_runtime:.3e}s, regret {100*res.regret:.2f}%")
    for rank, i in enumerate(np.argsort(scores, kind="stable"), 1):
        t = tiles[int(i)]
        timed = ("" if times is None else
                 f"; on the card {times[t]:.4f} ms a call "
                 f"(B={TIME_B}, H={TIME_H}, KH={TIME_KH}, bf16)")
        print(f"  rank {rank}: {t} score {scores[int(i)]:.3e}{timed}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    sim = TPUSimulator()
    scorer = analytical_tile_scorer(AnalyticalModel())
    report_a(part_a(sim, scorer))
    res, tiles, scores = part_b(sim, scorer)
    # the plain version on the CPU ignores the block shape: no times there
    times = time_blocks(tiles, device) if device.type == "cuda" else None
    report_b(res, tiles, scores, times)


if __name__ == "__main__":
    main()

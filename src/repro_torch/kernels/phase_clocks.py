"""Where one block of the tensor-core kernels spends its cycles, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.phase_clocks

Builds `csrc/graph_aggregate.cu`, `csrc/segment_aggregate.cu`,
`csrc/flash_attention_tf32.cu`, `csrc/flash_attention_hd256.cu` and
`csrc/flash_attention_hd256_tf32.cu` once more with `-DREPRO_PHASE_CLOCKS`
(into `kernels/build/phase_clocks/`): block (0, 0) of the GraphSAGE
kernels then records `clock64()` after a block barrier at each
`REPRO_PHASE(i)` mark; the f32 flash kernels' block (0, 0, 0), the
heaviest query tile, records from its first consumer thread, without
barriers, its start, Q split and first key tile, and the cycles it spent
per phase summed over its key tiles (Q·K^T, softmax and P split, waiting
for V, P·V and the fold, waiting for K), at h2o-danube-3-4b's layer shape
(hd <= 128) and at recurrentgemma-9b's (hd 256; there Q·K^T waits for
K's lo half, issues its hi·lo products, then waits for the hi half: both
waits count as waiting for K); the hd-256 bf16 kernel's block (0, 0, 0)
likewise from its first consumer warpgroup (waiting for K and V, Q·K^T,
softmax and P split, P·V and the fold), at recurrentgemma-9b's layer
shape. Each case calls those builds' entry points directly (the wrappers
keep the normal builds), a few times, and the phases of its last call
are printed as cycles since the block's start (for a block that walks
several tiles or graphs, those of its last one). The barriers the marks
add cost a few hundred cycles in all; the normal build has no marks. It first prints, for the
normal builds, how many tensor-core products (HGMMA) the SASS holds and
how many waits for all of them (WARPGROUP.DEPBAR): one wait per product
means the compiler serialized them (tf32_mma.cuh), and ptxas's advisories
about wgmma say why. Needs a CUDA device.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import torch

from repro_torch.kernels import build
from repro_torch.kernels import graph_aggregate as ga
from repro_torch.kernels import segment_aggregate as sa

OUT = os.path.join(build.BUILD_DIR, "phase_clocks")
SEGMENT_PHASES = {1: "stage issued", 2: "operands landed", 3: "w split",
                  4: "x split", 5: "products", 6: "messages kept",
                  7: "cluster barrier", 10: "walk", 8: "outputs stored",
                  9: "last barrier"}
GRAPH_PHASES = {1: "stage issued", 2: "operands landed", 3: "W split",
                4: "X split", 5: "X.W", 6: "msg^T split", 7: "A staged",
                8: "A.msg", 10: "mean", 11: "outputs stored", 9: "end"}


def _instrumented(name: str) -> ctypes.CDLL:
    os.makedirs(OUT, exist_ok=True)
    so = os.path.join(OUT, f"lib{name}.so")
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-DREPRO_PHASE_CLOCKS",
                    "-o", so, os.path.join(build.CSRC, f"{name}.cu")],
                   check=True, capture_output=True)
    return ctypes.CDLL(so)


SASS_LIBS = ("graph_aggregate", "segment_aggregate", "flash_attention_tf32",
             "flash_attention_sm90", "flash_attention_hd256",
             "flash_attention_hd256_tf32")
FLASH_PHASES = ("Q.K^T", "softmax + P split", "V wait", "P.V + fold",
                "K wait")
HD256_PHASES = ("K and V wait", "Q.K^T", "softmax + P split", "P.V + fold")


def _sass_waits() -> None:
    reports = build.build(SASS_LIBS)
    for name, report in sorted(reports.items()):
        for line in report.splitlines():
            if "wgmma" in line or "GMMA" in line:       # ptxas advisories
                print(f"[ptxas] {name}: {line.strip()[:300]}", flush=True)
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    for name in SASS_LIBS:
        sass = subprocess.run([tool, "-sass", build.library_path(name)],
                              capture_output=True, text=True,
                              check=True).stdout
        print(f"[sass] {name}: {sass.count('HGMMA')} HGMMA, "
              f"{sass.count('WARPGROUP.DEPBAR')} WARPGROUP.DEPBAR",
              flush=True)


def _phases(lib, fn, label: str, names: dict) -> None:
    for _ in range(3):
        if fn():
            raise RuntimeError(f"{label}: launch failed")
    torch.cuda.synchronize()
    clocks = (ctypes.c_ulonglong * 16)()
    if lib.repro_read_phase_clocks(clocks):
        raise RuntimeError("reading the phase clocks failed")
    t0 = clocks[0]
    parts = [f"{name} {clocks[i] - t0}" for i, name in names.items()
             if t0 <= clocks[i] < t0 + 10 ** 9]
    print(f"[phases] {label}: cycles since the block's start: "
          + ", ".join(parts), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("phase_clocks: needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    _sass_waits()
    seg, graph = _instrumented("segment_aggregate"), \
        _instrumented("graph_aggregate")
    seg_f32, seg_i8, fused_max_rows = sa._bind(seg)
    graph_f32, _ = ga._bind(graph)
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator().manual_seed(0)
    D = F = 192
    for M in (64, 512, 16384):              # fused, fused, two launches
        x = torch.randn(M, D, generator=gen).cuda()
        w = (torch.randn(D, F, generator=gen) / D ** 0.5).cuda()
        wq = torch.randint(-127, 128, (D, F), generator=gen,
                           dtype=torch.int8).cuda()
        ones = torch.ones(F, device="cuda")
        nm = torch.ones(M, device="cuda")
        src, dst = (torch.randint(0, M, (2 * M,), generator=gen).cuda()
                    for _ in range(2))
        edges = sa.edge_csr(src, dst, torch.ones(2 * M, device="cuda"), M)
        out = torch.empty(M, F, device="cuda")
        msg = torch.empty(M, F, device="cuda") if M > fused_max_rows \
            else None
        for label, fn, ww, scale in (("f32", seg_f32, w, ones),
                                     ("int8", seg_i8, wq, ones / 64)):
            def run(fn=fn, ww=ww, scale=scale):
                return fn(x.data_ptr(), ww.data_ptr(), scale.data_ptr(),
                          nm.data_ptr(), edges.rowptr.data_ptr(),
                          edges.src.data_ptr(), edges.weight.data_ptr(),
                          None if msg is None else msg.data_ptr(),
                          out.data_ptr(), M, D, F, 1, 1, stream)
            _phases(seg, run, f"segment_aggregate {label} M={M}",
                    SEGMENT_PHASES)
    for N in (17, 64):
        B = 128
        adj = (torch.rand(B, N, N, generator=gen) < 2 / N).float().cuda()
        x = torch.randn(B, N, D, generator=gen).cuda()
        w = (torch.randn(D, F, generator=gen) / D ** 0.5).cuda()
        out = torch.empty(B, N, F, device="cuda")

        def run():
            return graph_f32(adj.data_ptr(), x.data_ptr(), w.data_ptr(),
                             out.data_ptr(), None, B, N, D, F, 1, 1, stream)
        _phases(graph, run, f"graph_aggregate B={B} N={N}", GRAPH_PHASES)
    # h2o-danube-3-4b's layer shape in f32, then recurrentgemma-9b's
    _flash_phases("tf32", 2, 8192, 32, 8, 120, 4096)
    _flash_phases("hd256_f32", 2, 8192, 16, 1, 256, 2048)
    _hd256_phases()


def _flash_phases(route, B, S, H, KH, hd, window) -> None:
    """One block of an f32 flash kernel (`route`: tf32 or hd256_f32) at
    a causal layer shape."""
    from repro_torch.kernels import flash_attention as fa
    name = fa.ROUTES[route][0]
    lib = _instrumented(name)
    fn, scratch_bytes = fa._bind(lib, route)
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(B, S, H, hd, generator=gen).cuda()
    k, v = (torch.randn(B, S, KH, hd, generator=gen).cuda()
            for _ in range(2))
    out = torch.empty_like(q)
    scratch = torch.empty(scratch_bytes(B, S, KH, hd), dtype=torch.uint8,
                          device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(3):
        if fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              scratch.data_ptr(), B, S, S, H, KH, hd, *q.stride()[:3],
              *k.stride()[:3], *v.stride()[:3], *out.stride()[:3], 1,
              window, 0, hd ** -0.5, stream):
            raise RuntimeError(f"{name}: launch failed")
    torch.cuda.synchronize()
    clocks = (ctypes.c_ulonglong * 16)()
    if lib.repro_read_phase_clocks(clocks):
        raise RuntimeError("reading the phase clocks failed")
    t0, tiles = clocks[0], max(1, clocks[9])
    ref = fa.flash_attention_plain(q[:, -64:], k, v, causal=True,
                                   window=window, q_offset=S - 64)
    worst = float(((out[:, -64:] - ref).abs()
                   / (2e-5 * ref.abs() + 5e-6)).max())
    print(f"[phases] {name} layer shape, block (0, 0, 0) "
          f"(query rows {S - 64}..{S - 1}, {tiles} key tiles): Q split "
          f"{clocks[1] - t0}, first K landed {clocks[2] - t0}, end "
          f"{clocks[8] - t0} cycles since its start; per key tile: "
          + ", ".join(f"{phase} {clocks[3 + j] / tiles:.0f}"
                      for j, phase in enumerate(FLASH_PHASES))
          + f"; its rows vs plain: worst {worst:.3f} of the limit",
          flush=True)


def _hd256_phases() -> None:
    """One block of the hd-256 bf16 flash kernel at recurrentgemma-9b's
    local-attention shape (B=2, S=8192, H=16, KH=1, hd=256, causal,
    window 2048)."""
    from repro_torch.kernels import flash_attention as fa
    lib = _instrumented("flash_attention_hd256")
    fn, _ = fa._bind(lib, "hd256")
    B, S, H, KH, hd, window = 2, 8192, 16, 1, 256, 2048
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(B, S, H, hd, generator=gen).cuda().bfloat16()
    k, v = (torch.randn(B, S, KH, hd, generator=gen).cuda().bfloat16()
            for _ in range(2))
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(3):
        if fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
              S, S, H, KH, hd, *q.stride()[:3], *k.stride()[:3],
              *v.stride()[:3], *out.stride()[:3], 1, window, 0,
              hd ** -0.5, stream):
            raise RuntimeError("flash_attention_hd256: launch failed")
    torch.cuda.synchronize()
    clocks = (ctypes.c_ulonglong * 16)()
    if lib.repro_read_phase_clocks(clocks):
        raise RuntimeError("reading the phase clocks failed")
    t0, tiles, computed = clocks[0], max(1, clocks[9]), max(1, clocks[10])
    ref = fa.flash_attention_plain(q[:, -128:], k, v, causal=True,
                                   window=window, q_offset=S - 128)
    worst = float(((out[:, -128:].float() - ref.float()).abs()
                   / (2.0 ** -6 * ref.float().abs() + 1e-5)).max())
    print(f"[phases] flash_attention_hd256 bf16 layer shape, block (0, 0, "
          f"0) (query rows {S - 128}..{S - 1}; its first warpgroup walks "
          f"{clocks[9]} key tiles and computes {clocks[10]}): Q landed "
          f"{clocks[1] - t0}, first K and V landed {clocks[2] - t0}, end "
          f"{clocks[8] - t0} cycles since its start; per key tile walked: "
          f"{HD256_PHASES[0]} {clocks[3] / tiles:.0f}; per tile computed: "
          + ", ".join(f"{name} {clocks[3 + j] / computed:.0f}"
                      for j, name in enumerate(HD256_PHASES) if j)
          + f"; its rows vs plain: worst {worst:.3f} of the limit",
          flush=True)


if __name__ == "__main__":
    main()

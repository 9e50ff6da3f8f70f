"""Times the f32 route of `flash_attention` on the card (or, with
`--route hd256` / `hd256_f32`, the hd-256 bf16 / f32 route), and holds it
against the plain version element by element.

    python3 src/repro_torch/kernels/flash_time.py [--src DIR] [--iters N]
        [--route f32|hd256|hd256_f32]

Imports `repro_torch` from `--src` (default: this checkout's `src/`), so
the same script times another checkout's kernel, an earlier version say,
unpacked with `git archive` into a git-ignored directory: run it on both
trees in turns (earlier, this, this, earlier) inside one chip call. Each
shape prints one line: call time by CUDA events over back-to-back calls
after a warm-up, device time per call from the profiler (the sum of the
call's kernels), and the worst |out - ref| / (2e-5·|ref| + 5e-6) against
`flash_attention_plain` (TF32 off). Shapes: h2o-danube-3-4b's layer in
f32 (B=2, S=8192, H=32, KH=8, hd=120, causal, window 4096) and the f32
check shape of `chip_smoke.py` (B=1, S=1024, window 256); for hd256 and
hd256_f32, recurrentgemma-9b's local attention (B=2, S=8192, H=16, KH=1,
hd=256, causal, window 2048), in bf16 held to 2^-6·|ref| + 1e-5, in f32
to the f32 limit.

Then, for the f32 routes, at their check shape (hd256_f32: `chip_smoke.py`
`rg-f32-q3`'s, B=1, S=1024, H=16, KH=1, hd=256, window 256), for seeds
0-3 and q scaled by 1 and by 3, the same worst ratio between each pair
of: the kernel, the plain version, PyTorch's f32 SDPA and an exact
attention in float64: how far the plain version itself sits from exact
arithmetic under the f32 limit. Needs a CUDA device; imports nothing else
of the repository.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

SHAPES = {"layer": (2, 8192, 32, 8, 120, True, 4096),
          "check": (1, 1024, 32, 8, 120, True, 256)}
RTOL, ATOL = 2e-5, 5e-6
HD256_SHAPES = {"rg-layer": (2, 8192, 16, 1, 256, True, 2048),
                "rg-check": (1, 1024, 16, 1, 256, True, 256)}
HD256_RTOL, HD256_ATOL = 2.0 ** -6, 1e-5
# route -> (dtype, shapes timed, (rtol, atol), the precision shape or None)
ROUTES = {"f32": ("float32", ("layer", "check"), (RTOL, ATOL), "check"),
          "hd256": ("bfloat16", ("rg-layer",), (HD256_RTOL, HD256_ATOL),
                    None),
          "hd256_f32": ("float32", ("rg-layer",), (RTOL, ATOL), "rg-check")}


def main() -> None:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.normpath(
        os.path.join(here, "..", "..")))
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--label", default=None)
    ap.add_argument("--route", choices=tuple(ROUTES), default="f32")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import flash_attention as fa
    if not torch.cuda.is_available():
        raise SystemExit("flash_time: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    label = args.label or args.src
    dtype, names, (rtol, atol), check = ROUTES[args.route]
    dtype = getattr(torch, dtype)
    shapes = {**SHAPES, **HD256_SHAPES}
    gen = torch.Generator(device="cuda").manual_seed(1)
    for name in names:
        B, S, H, KH, hd, causal, window = shapes[name]
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                   for shape in ((B, S, H, hd), (B, S, KH, hd),
                                 (B, S, KH, hd)))

        def run():
            return fa.flash_attention(q, k, v, causal=causal, window=window)
        out = run()
        ref = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
        out, ref = out.float(), ref.float()
        worst = float(((out - ref).abs() / (rtol * ref.abs() + atol)).max())
        del out, ref
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        run()
        start.record()
        for _ in range(args.iters):
            run()
        end.record()
        torch.cuda.synchronize()
        call_ms = start.elapsed_time(end) / args.iters
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(args.iters):
                run()
            torch.cuda.synchronize()
        kernels = {e.key[:48]: (e.count, e.self_device_time_total / 1e3)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA}
        device_ms = sum(ms for _, ms in kernels.values()) / args.iters
        print(json.dumps({
            "tree": label, "shape": name, "B": B, "S": S, "H": H, "KH": KH,
            "hd": hd, "window": window, "dtype": str(dtype)[6:],
            "call_ms": call_ms,
            "device_ms": device_ms, "kernels": kernels,
            "worst_of_limit": worst, "card": card}), flush=True)
        del q, k, v
    if check:
        _precision(fa, card, label, shapes[check], check)


def _exact(q, k, v, causal, window):
    """The attention of the plain version, in float64 from q·scale on."""
    import torch
    B, S, H, hd = q.shape
    rep = H // k.shape[2]
    qf = (q * (1.0 / math.sqrt(hd))).double().transpose(1, 2)
    kf = k.double().repeat_interleave(rep, 2).transpose(1, 2)
    vf = v.double().repeat_interleave(rep, 2).transpose(1, 2)
    pos = torch.arange(S, device=q.device)
    keep = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        keep &= pos[None, :] <= pos[:, None]
    if window:
        keep &= pos[:, None] - pos[None, :] < window
    s = (qf @ kf.transpose(-1, -2)).masked_fill(~keep, -1e30)
    return (torch.softmax(s, -1) @ vf).transpose(1, 2), keep


def _precision(fa, card, label, shape, name) -> None:
    import torch
    import torch.nn.functional as F
    B, S, H, KH, hd, causal, window = shape

    def worst(a, ref):
        a, ref = a.double(), ref.double()
        return float(((a - ref).abs() / (RTOL * ref.abs() + ATOL)).max())
    for seed in range(4):
        for qmul in (1.0, 3.0):
            gen = torch.Generator(device="cuda").manual_seed(seed)
            q = torch.randn((B, S, H, hd), generator=gen, device="cuda") \
                * qmul
            k = torch.randn((B, S, KH, hd), generator=gen, device="cuda")
            v = torch.randn((B, S, KH, hd), generator=gen, device="cuda")
            out = fa.flash_attention(q, k, v, causal=causal, window=window)
            ref = fa.flash_attention_plain(q, k, v, causal=causal,
                                           window=window)
            exact, keep = _exact(q, k, v, causal, window)
            rep = H // KH
            sdpa = F.scaled_dot_product_attention(
                q.transpose(1, 2), k.repeat_interleave(rep, 2).transpose(
                    1, 2), v.repeat_interleave(rep, 2).transpose(1, 2),
                attn_mask=keep).transpose(1, 2)
            print(json.dumps({
                "tree": label, "precision": name, "seed": seed,
                "q_scale": qmul, "kernel_vs_plain": worst(out, ref),
                "plain_vs_exact": worst(ref, exact),
                "kernel_vs_exact": worst(out, exact),
                "sdpa_vs_plain": worst(sdpa, ref),
                "sdpa_vs_exact": worst(sdpa, exact), "card": card}),
                flush=True)


if __name__ == "__main__":
    main()

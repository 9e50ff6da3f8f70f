"""Serve a small model with batched requests: prefill + iterative decode
through the production serving steps (the code paths the decode_32k /
long_500k dry-run cells lower at full scale).

Counterpart of examples/serve_lm.py on the port: the arch's smoke config,
random weights (seed 0), prompts drawn by numpy from seed 0, greedy
decode, the same prints, the device's name where the reference names
its path. Archs whose prefill needs more than token prompts
(musicgen-large: frame embeddings; llava-next-34b: a patch prefix) are
refused before anything is built, with the `launch.serve` CLI's
ValueError (the reference fails on them later, with a KeyError).

  PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch h2o-danube-3-4b [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.launch.serve import check_token_prompts
from repro_torch.models import lm, registry


def setup(arch: str):
    """The arch's smoke config; raises ValueError for an arch that does
    not take token prompts."""
    cfg = registry.get_smoke_config(arch)
    check_token_prompts(cfg)
    return cfg


def make_prompts(cfg, batch: int, prompt_len: int, device) -> torch.Tensor:
    rng = np.random.default_rng(0)
    return torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (batch, prompt_len))).to(device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def generate(params, cfg, prompts: torch.Tensor, decode_steps: int,
             keep_logits: bool = False) -> dict:
    """Prefill `prompts` [B, P] into a cache of P + decode_steps, then
    greedy decode: {"tokens" [B, decode_steps] numpy, "prefill_s",
    "decode_s" (each ending in a device synchronise), and with
    `keep_logits` the prefill's and every step's last-position logits
    as f32 numpy}."""
    B, P = prompts.shape
    capacity = P + decode_steps
    prefill = lm.prefill_step_fn(cfg, capacity=capacity)
    decode = lm.decode_step_fn(cfg)
    dev = prompts.device
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": prompts})
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    kept = [logits[:, -1].float().cpu().numpy()] if keep_logits else []
    generated = []
    t0 = time.perf_counter()
    for t in range(P, capacity):
        nxt = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
        generated.append(nxt[:, 0].cpu().numpy())
        logits, cache = decode(params, cache, nxt, t)
        if keep_logits:
            kept.append(logits[:, -1].float().cpu().numpy())
    _sync(dev)
    return {"tokens": np.stack(generated, 1) if generated
            else np.zeros((B, 0), np.int64),
            "prefill_s": prefill_s, "decode_s": time.perf_counter() - t0,
            "logits": kept}


def device_label(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "CPU")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="h2o-danube-3-4b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--decode-steps", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = setup(args.arch)
    dev = resolve_device(args.device)
    params = lm.init_params(torch.Generator(dev).manual_seed(0), cfg,
                            device=dev)
    prompts = make_prompts(cfg, args.batch, args.prompt_len, dev)
    out = generate(params, cfg, prompts, args.decode_steps)
    print(f"{cfg.name}: prefill {args.batch}x{args.prompt_len} in "
          f"{out['prefill_s']:.2f}s")
    n = args.decode_steps * args.batch
    dt = out["decode_s"]
    print(f"decoded {n} tokens in {dt:.2f}s -> {n/dt:.1f} tok/s "
          f"({device_label(dev)})")
    print("first request's continuation:", out["tokens"][0][:16].tolist())
    return out


if __name__ == "__main__":
    main()

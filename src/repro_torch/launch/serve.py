"""Serving launcher: batched prefill + decode loop for the LM zoo.

Port of `repro.launch.serve`, for the architectures whose prompts are
tokens: h2o-danube-3-4b, yi-9b, yi-34b, qwen3-14b, granite-moe-3b-a800m,
deepseek-v3-671b, mamba2-2.7b and recurrentgemma-9b. The loop feeds
prompts as `{"tokens"}` alone, as the reference's does; musicgen-large
(frame embeddings) and llava-next-34b (a patch prefix) need more, and
are refused with a ValueError that names the missing input (the
reference fails there with a KeyError).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-3-4b \
      --smoke --device cpu --batch 4 --prompt-len 32 --decode-steps 16

Flags:
  --arch NAME         architecture from `repro_torch.models.registry`
  --smoke | --full    `--smoke` (default) runs the reduced config;
                      `--full` initializes the full-size config on the
                      device (h2o-danube-3-4b: ~7.9 GB of bf16 params;
                      deepseek-v3-671b's 1.25 TiB fit no single card)
  --batch N           concurrent request streams          (default 4)
  --prompt-len N      prefill length in tokens            (default 32)
  --decode-steps N    autoregressive steps after prefill  (default 16)
  --temperature F     0 = greedy argmax, >0 = sampling    (default 0.0)
  --seed N            params/prompt/sampling seed         (default 0)
  --device DEV        cuda (default; raises without a card) or cpu

Prompts come from numpy's `default_rng(seed)` as in the reference;
params and sampling from `torch.Generator`s seeded with `seed` and
`seed + 1` (their numbers are not JAX's). Rates are printed with the
device they ran on.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.device import resolve_device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_label(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type.upper()


def prompts(cfg, batch: int, prompt_len: int, seed: int,
            device) -> torch.Tensor:
    """[batch, prompt_len] token ids drawn as the reference draws them."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (batch, prompt_len))).to(device)


def check_token_prompts(cfg) -> None:
    """Raise ValueError for an arch whose prefill needs more than tokens."""
    need = ("embeddings (frame embeddings)" if cfg.embed_inputs
            else "patch_embeds (the image's patch prefix)"
            if cfg.num_patch_tokens else None)
    if need:
        raise ValueError(f"{cfg.name}: prefill needs batch[{need}], and the "
                         "serve loop feeds token prompts only")


@torch.inference_mode()
def serve_loop(params, cfg, tokens: torch.Tensor, *, decode_steps: int,
               temperature: float = 0.0,
               generator: torch.Generator | None = None) -> dict:
    """Prefill `tokens` [B, P], then decode `decode_steps` tokens, greedy
    (temperature 0) or sampled from `generator`. Returns the generated
    ids [B, decode_steps] and the prefill and decode wall seconds (the
    device synchronised at the end of each)."""
    from repro_torch.models import lm

    check_token_prompts(cfg)
    B, P = tokens.shape
    capacity = P + decode_steps
    prefill = lm.prefill_step_fn(cfg, capacity=capacity)
    decode = lm.decode_step_fn(cfg)
    dev = tokens.device
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": tokens})
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    out = []
    t0 = time.perf_counter()
    for t in range(P, capacity):
        last = logits[:, -1, :].float()
        if temperature > 0:
            probs = torch.softmax(last / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)
        else:
            nxt = torch.argmax(last, dim=-1, keepdim=True)
        out.append(nxt)
        logits, cache = decode(params, cache, nxt, t)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    generated = (torch.cat(out, dim=1) if out
                 else tokens.new_zeros((B, 0)))
    return {"tokens": generated, "prefill_s": prefill_s,
            "decode_s": decode_s}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Batched prefill+decode serving loop for the LM zoo.")
    ap.add_argument("--arch", required=True)
    size = ap.add_mutually_exclusive_group()
    size.add_argument("--smoke", dest="size", action="store_const",
                      const="smoke", help="reduced config (default)")
    size.add_argument("--full", dest="size", action="store_const",
                      const="full", help="full-size config")
    ap.set_defaults(size="smoke")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode-steps", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.models import lm, registry

    dev = resolve_device(args.device)
    cfg = registry.get_smoke_config(args.arch) if args.size == "smoke" \
        else registry.get_config(args.arch)
    check_token_prompts(cfg)
    params = lm.init_params(torch.Generator(dev).manual_seed(args.seed),
                            cfg, device=dev)
    tokens = prompts(cfg, args.batch, args.prompt_len, args.seed, dev)
    res = serve_loop(params, cfg, tokens, decode_steps=args.decode_steps,
                     temperature=args.temperature,
                     generator=torch.Generator(dev).manual_seed(
                         args.seed + 1))
    where = device_label(dev)
    print(f"prefill[{args.batch}x{args.prompt_len}] "
          f"{res['prefill_s']:.2f}s on {where}")
    toks = args.decode_steps * args.batch
    rate = toks / res["decode_s"] if res["decode_s"] > 0 else float("inf")
    print(f"decoded {toks} tokens in {res['decode_s']:.2f}s "
          f"({rate:.1f} tok/s on {where})")
    print("sample streams:")
    arr = res["tokens"].cpu().numpy()
    for b in range(min(args.batch, 4)):
        print(f"  req{b}: {arr[b].tolist()}")


if __name__ == "__main__":
    main()

"""Batched greedy decoding, as `repro_torch.launch.serve.serve_loop` chains
the program's `prefill_step_fn` and `decode_step_fn`: `batch` sequences
of `prompt_len` prompt tokens, each served `decode_tokens` tokens (cache
capacity `prompt_len + decode_tokens`). Every step's new tokens are
copied to the host, as a streaming server sends them. When a batch has
served all its tokens, a fresh batch is prefilled in its place. The
first batch is prefilled in set-up.

End-to-end metrics: `decode_tokens_per_s`, every generated token copied
to the host in the window (a refill's first tokens too) over the
window's seconds, refill prefills counted in the time; `itl_p95_ms`, the
95th percentile of the host time between one step's tokens reaching the
host and the next step's, over every step of the window (a gap across a
refill is time to a first token, and left out).

Compared once the window has closed: the first batch, run to its end
after the window if it had not finished inside it, of which
`check_sequences` sequences drawn from the seed have the reference's
logits compared at every served position (`token_gap`), and every
sequence its final cache (`cache_err`). The reference runs over all the
batch's sequences, since a call's tokens share the experts' capacity.
"""
from __future__ import annotations

import random
import time

import torch

from portbench import compare, port_lm, traffic


class Driver:
    def __init__(self, cell, seed: int, device):
        from repro_torch.models import lm

        t = cell.traffic
        cfg, self.params = port_lm.build(cell, seed, device)
        self.cell, self.seed, self.device = cell, seed, device
        self.B, self.P, self.N = t["batch"], t["prompt_len"], \
            t["decode_tokens"]
        self.vocab = cfg.vocab_size
        self.prefill = lm.prefill_step_fn(cfg, capacity=self.P + self.N)
        self.decode = lm.decode_step_fn(cfg)
        self.kept = None
        self.batches = 0
        self._start(traffic.WARMUP_STREAM)    # every shape of the window
        for _ in range(3):
            self._step()
        self._start(0)

    @torch.inference_mode()
    def _start(self, call: int) -> None:
        tokens = traffic.prompts(self.seed, call, self.B, self.P,
                                 self.vocab, self.device)
        logits, cache = self.prefill(self.params, {"tokens": tokens})
        nxt = logits[:, -1].argmax(-1, keepdim=True)
        served = torch.empty((self.B, self.N), dtype=torch.long,
                             device=self.device)
        served[:, 0] = nxt[:, 0]
        nxt.cpu()
        self.batch = {"call": call, "cache": cache, "nxt": nxt,
                      "served": served, "i": 1}

    @torch.inference_mode()
    def _step(self) -> int:
        b = self.batch
        pos = self.P + b["i"] - 1
        logits, _ = self.decode(self.params, b["cache"], b["nxt"], pos)
        nxt = logits[:, -1].argmax(-1, keepdim=True)
        b["served"][:, b["i"]] = nxt[:, 0]
        nxt.cpu()
        b["nxt"] = nxt
        b["i"] += 1
        return pos

    def _advance(self):
        """One step, or, when the batch is done, a refill. Returns the
        step's position, or None for a refill."""
        if self.batch["i"] < self.N:
            return self._step()
        if self.kept is None and self.batch["call"] == 0:
            self.kept = self.batch
        self.batches += 1
        self._start(self.batches)
        return None

    def window(self, seconds: float) -> dict:
        gaps, positions = [], []
        tokens, refills, attempted = 0, 0, self.B
        t0 = prev = time.perf_counter()
        while True:
            pos = self._advance()
            now = time.perf_counter()
            tokens += self.B
            if pos is None:
                refills += 1
                attempted += self.B
            else:
                gaps.append(now - prev)
                positions.append(pos)
            prev = now
            if now - t0 >= seconds:
                break
        secs = now - t0
        gaps.sort()

        def pct(q):
            return gaps[max(0, -(-q * len(gaps) // 100) - 1)]

        p95 = pct(95)
        return {"metrics": {"decode_tokens_per_s": tokens / secs,
                            "itl_p95_ms": p95 * 1e3},
                "attempted": attempted, "failed": 0, "seconds": secs,
                "calls": len(positions), "per_call_s": secs / max(
                    1, len(positions)),
                "note": f"gaps ms p5 {pct(5) * 1e3:.4f} p50 "
                        f"{pct(50) * 1e3:.4f} p95 {p95 * 1e3:.4f} max "
                        f"{gaps[-1] * 1e3:.4f}; {refills} refills",
                "work": [{"kind": "decode", "batch": self.B,
                          "positions": positions},
                         {"kind": "prefill", "batch": self.B, "seq": self.P,
                          "count": refills}]}

    def ready(self) -> None:
        """Before the traced slice: the first batch run to its end, and a
        batch with the slice's steps still to serve."""
        while self.kept is None or \
                self.N - self.batch["i"] < self.cell.traffic["trace_steps"]:
            self._advance()

    def slice(self) -> dict:
        steps = self.cell.traffic["trace_steps"]
        for _ in range(steps):
            self._step()
        return {"calls": steps, "steps": steps}

    def finish(self) -> None:
        """Run the first batch to its end, if the window did not."""
        while self.kept is None:
            self._advance()

    def release(self) -> None:
        """Free the program's state but the first batch's outputs."""
        self.finish()
        self.batch = None
        self.prefill = self.decode = None

    @torch.inference_mode()
    def check(self, ref, cfg_json: dict, control: bool = False):
        """The comparison numbers of the first batch's sampled sequences;
        with `control`, also those of the reference in fp8 put in the
        program's place (its top token at each of the same positions), as
        (program's, control's)."""
        self.finish()
        B, P, N = self.B, self.P, self.N
        L = P + N - 1                    # the last served token is not fed
        served = self.kept["served"]
        tokens = torch.cat([traffic.prompts(self.seed, 0, B, P, self.vocab,
                                            self.device),
                            served[:, :-1]], dim=1)
        idx = torch.arange(B * L, device=self.device).view(B, L)
        groups = [idx[:, :P].reshape(-1)] + [idx[:, s] for s in range(P, L)]
        picked = sorted(random.Random(self.seed).sample(
            range(B), self.cell.traffic["check_sequences"]))
        rows = idx[picked, P - 1:].reshape(-1)
        want, want_caches = ref.forward(self.params, cfg_json, tokens,
                                        groups, rows)
        program = {"token_gap": compare.token_gap(
                       want, served[picked].reshape(-1)),
                   "cache_err": compare.cache_err(
                       compare.program_caches(self.kept["cache"]),
                       want_caches)}
        if not control:
            return program
        got, got_caches = ref.forward(self.params, cfg_json, tokens, groups,
                                      rows, prec="fp8")
        return program, {"token_gap": compare.token_gap(want,
                                                        got.argmax(-1)),
                         "cache_err": compare.cache_err(got_caches,
                                                        want_caches)}

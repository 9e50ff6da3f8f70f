"""Closed-loop prefill: each call prefills `batch` fresh prompts of
`prompt_len` tokens through the program's `prefill_step_fn` (capacity
`prompt_len`), and its first tokens (the greedy argmax of the last
position's logits) are copied to the host before the next call starts,
as a client waits for its reply.

End-to-end metric: `prefill_tokens_per_s`, every prompt token of the
calls that completed in the window over the window's seconds; the window
ends at the synchronize of the call that crossed `--seconds`, so no call
is cut. Compared once the window has closed: one call of the window,
drawn from the seed, its last position's logits and its caches against
the reference's forward over the same prompts.
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
        self.B, self.S = t["batch"], t["prompt_len"]
        self.vocab = cfg.vocab_size
        self.fn = lm.prefill_step_fn(cfg, capacity=self.S)
        self.kept = None
        for i in range(2):            # every shape of the window, twice
            self._call(traffic.WARMUP_STREAM + i)

    def _prompts(self, call: int) -> torch.Tensor:
        return traffic.prompts(self.seed, call, self.B, self.S, self.vocab,
                               self.device)

    @torch.inference_mode()
    def _call(self, call: int):
        logits, caches = self.fn(self.params,
                                 {"tokens": self._prompts(call)})
        logits[:, -1].argmax(-1).cpu()
        return logits, caches

    def window(self, seconds: float) -> dict:
        pick = random.Random(self.seed)
        n = 0
        t0 = time.perf_counter()
        while True:
            out = self._call(n)
            n += 1
            if pick.random() * n < 1.0:     # a reservoir of one call
                self.kept = (n - 1, out)
            now = time.perf_counter()
            if now - t0 >= seconds:
                break
        secs = now - t0
        return {"metrics": {"prefill_tokens_per_s": n * self.B * self.S
                            / secs},
                "attempted": n * self.B, "failed": 0, "seconds": secs,
                "calls": n, "per_call_s": secs / n,
                "work": [{"kind": "prefill", "batch": self.B,
                          "seq": self.S, "count": n}]}

    def ready(self) -> None:
        """Before the traced slice: nothing to do."""

    def slice(self) -> dict:
        calls = self.cell.traffic["trace_calls"]
        for i in range(calls):
            self._call(traffic.TRACE_STREAM + i)
        return {"calls": calls, "steps": calls}

    def release(self) -> None:
        """Free the program's state but the kept call's outputs."""
        self.fn = None

    @torch.inference_mode()
    def check(self, ref, cfg_json: dict, control: bool = False):
        """The comparison numbers of the kept call; with `control`, also
        those of the reference in fp8 put in the program's place, as
        (program's, control's)."""
        call, (logits, caches) = self.kept
        tokens = self._prompts(call)
        groups = [torch.arange(self.B * self.S, device=self.device)]
        rows = torch.arange(self.B, device=self.device) * self.S \
            + self.S - 1
        want, want_caches = ref.forward(self.params, cfg_json, tokens,
                                        groups, rows)

        def readings(got, got_caches):
            return {"logits_err": max(compare.rel_err(got[b], want[b])
                                      for b in range(self.B)),
                    "cache_err": compare.cache_err(got_caches,
                                                   want_caches)}

        program = readings(logits[:, -1].float(),
                           compare.program_caches(caches))
        if not control:
            return program
        return program, readings(*ref.forward(self.params, cfg_json, tokens,
                                              groups, rows, prec="fp8"))

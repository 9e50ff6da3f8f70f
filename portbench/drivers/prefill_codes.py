"""Closed-loop prefill of a codebook model with cross-attention
(MusicGen's decoder): each call prefills `batch` fresh delayed prompts of
`prompt_len` positions (one code a codebook a position) with `text_len`
text states each through the program's `prefill_step_fn` (capacity
`prompt_len`), and each prompt's next frame, the greedy argmax of every
codebook's logits at the last position, is copied to the host before the
next call starts, as a client waits for its reply. Inputs: `codes.py`.

End-to-end metric: `prefill_tokens_per_s`, every prompt position (frame)
of the calls that completed in the window over the window's seconds; the
window ends at the synchronize of the call that crossed `--seconds`, so
no call is cut. Compared once the window has closed: one call of the
window, drawn from the seed, against the reference's forward over the
same codes and text states: `logits_err`, the largest over prompts and
codebooks of ||Δ|| / ||ref|| of the last position's logits, and
`cache_err` over the self-attention's and the cross-attention's caches.
"""
from __future__ import annotations

import random
import time

import torch

from portbench import codes, compare, port_lm, traffic


class Driver:
    def __init__(self, cell, seed: int, device):
        from repro_torch.models import lm

        t = cell.traffic
        cfg, self.params = port_lm.build(cell, seed, device)
        self.cell, self.seed, self.device = cell, seed, device
        self.B, self.S, self.T = t["batch"], t["prompt_len"], \
            codes.text_len(cell)
        self.K, self.V, self.DX = cfg.num_codebooks, cfg.vocab_size, \
            cfg.cross_attn_dim
        self.fn = lm.prefill_step_fn(cfg, capacity=self.S)
        self.kept = None
        for i in range(2):            # every shape of the window, twice
            self._call(traffic.WARMUP_STREAM + i)

    def _inputs(self, call: int):
        return codes.inputs(self.seed, call, self.B, self.K, self.S, self.V,
                            self.T, self.DX, self.device)

    @torch.inference_mode()
    def _call(self, call: int):
        c, text = self._inputs(call)
        logits, caches = self.fn(self.params, {"codes": c, "text": text})
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
        c, text = self._inputs(call)
        rows = torch.arange(self.B, device=self.device) * self.S \
            + self.S - 1
        want, want_caches = ref.forward(self.params, cfg_json, c, text, rows)

        def readings(got, got_caches):
            return {"logits_err": max(compare.rel_err(got[b, k], want[b, k])
                                      for b in range(self.B)
                                      for k in range(self.K)),
                    "cache_err": compare.cache_err(got_caches,
                                                   want_caches)}

        program = readings(logits[:, -1].float(),
                           compare.program_caches(caches))
        if not control:
            return program
        return program, readings(*ref.forward(self.params, cfg_json, c,
                                              text, rows, prec="fp8"))

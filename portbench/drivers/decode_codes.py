"""Batched greedy decoding of a codebook model with cross-attention
(MusicGen's decoder), as `repro_torch.launch.serve.serve_loop` chains the
program's `prefill_step_fn` and `decode_step_fn`: `batch` requests, each
a delayed prompt of `prompt_len` positions (the start code alone at 1)
and `text_len` text states, each served `decode_frames` frames: the
frames plus the delay (codebook k runs k positions behind codebook 0)
make `decode_frames + K - 1` served positions of K codes (cache capacity
`prompt_len` + those). Each step's codes are the argmax of every
codebook's logits put through the program's delay pattern
(`models.lm.delay_codes`) on the device, and are copied to the host, as a
streaming server sends them. When a batch has served all its positions,
a fresh batch is prefilled in its place. The first batch is prefilled in
set-up. Inputs: `codes.py`.

End-to-end metrics: `decode_tokens_per_s`, every position served (a row's
K codes count one) copied to the host in the window (a refill's first
too) over the window's seconds, refill prefills counted in the time;
`itl_p95_ms`, the 95th percentile of the host time between one step's
codes reaching the host and the next step's, over every step of the
window (a gap across a refill is time to a first frame, and left out).

Compared once the window has closed: the first batch, run to its end
after the window if it had not finished inside it. Of `check_sequences`
requests drawn from the seed, the reference's logits over their whole
served sequence (prompt, then every served position but the last) are
compared at every served position and codebook where the delay leaves
the code free (`token_gap`; a code that the delay should have padded
and did not reads inf), and their final caches, self and cross
(`cache_err`). The requests of a batch are independent (no routing
couples them), so the reference runs over these requests alone.
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
        self.B, self.P, self.T = t["batch"], t["prompt_len"], \
            codes.text_len(cell)
        self.K, self.V, self.DX = cfg.num_codebooks, cfg.vocab_size, \
            cfg.cross_attn_dim
        self.frames = self.P - 1 + t["decode_frames"]
        self.N = t["decode_frames"] + self.K - 1     # positions served
        self.delay = lm.delay_codes
        self.prefill = lm.prefill_step_fn(cfg, capacity=self.P + self.N)
        self.decode = lm.decode_step_fn(cfg)
        self.picked = sorted(random.Random(seed).sample(
            range(self.B), t["check_sequences"]))
        self.kept = None
        self.batches = 0
        self._start(traffic.WARMUP_STREAM)    # every shape of the window
        for _ in range(3):
            self._step()
        self.batch = None
        self._start(0)

    def _inputs(self, call: int):
        return codes.inputs(self.seed, call, self.B, self.K, self.P, self.V,
                            self.T, self.DX, self.device)

    def _next(self, logits, pos: int) -> torch.Tensor:
        """The codes [B, K] of position `pos` from the logits before it."""
        return self.delay(logits[:, -1].argmax(-1), pos, self.frames,
                          self.V)

    @torch.inference_mode()
    def _start(self, call: int) -> None:
        c, text = self._inputs(call)
        logits, cache = self.prefill(self.params, {"codes": c, "text": text})
        nxt = self._next(logits, self.P)
        served = torch.empty((self.B, self.K, self.N), dtype=torch.long,
                             device=self.device)
        served[:, :, 0] = nxt
        nxt.cpu()
        self.batch = {"call": call, "cache": cache, "nxt": nxt,
                      "served": served, "i": 1}

    @torch.inference_mode()
    def _step(self) -> int:
        b = self.batch
        pos = self.P + b["i"] - 1
        logits, _ = self.decode(self.params, b["cache"], b["nxt"][..., None],
                                pos)
        nxt = self._next(logits, pos + 1)
        b["served"][:, :, b["i"]] = nxt
        nxt.cpu()
        b["nxt"] = nxt
        b["i"] += 1
        return pos

    def _keep(self) -> None:
        """The first batch's checked requests: their served codes and final
        caches, one dict a layer, copied out of the batch's."""
        b = self.batch
        self.kept = {"served": b["served"][self.picked],
                     "caches": [{k: v[self.picked] for k, v in layer.items()}
                                for layer in compare.program_caches(
                                    b["cache"])]}

    def _advance(self):
        """One step, or, when the batch is done, a refill. Returns the
        step's position, or None for a refill."""
        if self.batch["i"] < self.N:
            return self._step()
        if self.kept is None and self.batch["call"] == 0:
            self._keep()
        self.batch = None                # its cache freed before the next
        self.batches += 1
        self._start(self.batches)
        return None

    def window(self, seconds: float) -> dict:
        gaps, positions = [], []
        served, refills, attempted = 0, 0, self.B
        t0 = prev = time.perf_counter()
        while True:
            pos = self._advance()
            now = time.perf_counter()
            served += self.B
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
        return {"metrics": {"decode_tokens_per_s": served / secs,
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
        """Free the program's state but the first batch's kept outputs."""
        self.finish()
        self.batch = None
        self.prefill = self.decode = None

    @torch.inference_mode()
    def check(self, ref, cfg_json: dict, control: bool = False):
        """The comparison numbers of the first batch's checked requests;
        with `control`, also those of the reference in fp8 put in the
        program's place (its top code at each of the same positions), as
        (program's, control's)."""
        self.finish()
        P, N, K, V = self.P, self.N, self.K, self.V
        c, text = self._inputs(0)
        c, text = c[self.picked], text[self.picked]
        served = self.kept["served"]                    # [n, K, N]
        n = served.shape[0]
        seq = torch.cat([c, served[:, :, :-1]], dim=-1)  # the fed positions
        L = P + N - 1
        idx = torch.arange(n * L, device=self.device).view(n, L)
        rows = idx[:, P - 1:].reshape(-1)               # logits of P..P+N-1
        # where the delay leaves a served position's code free [N, K]
        pos = torch.arange(P, P + N, device=self.device)[:, None]
        k = torch.arange(K, device=self.device)[None, :]
        free = ((k < pos) & (pos <= self.frames + k)).expand(n, N, K) \
            .reshape(-1, K)
        codes_at = served.transpose(1, 2).reshape(-1, K)   # [n·N, K]
        want, want_caches = ref.forward(self.params, cfg_json, seq, text,
                                        rows)

        def gap(got_codes):
            if bool((got_codes[~free] != V).any()):
                return float("inf")
            return compare.token_gap(want[free], got_codes[free])

        program = {"token_gap": gap(codes_at),
                   "cache_err": compare.cache_err(self.kept["caches"],
                                                  want_caches)}
        if not control:
            return program
        got, got_caches = ref.forward(self.params, cfg_json, seq, text, rows,
                                      prec="fp8")
        return program, {"token_gap": gap(torch.where(free, got.argmax(-1),
                                                      V)),
                         "cache_err": compare.cache_err(got_caches,
                                                        want_caches)}

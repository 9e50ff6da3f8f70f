"""The one generator of the benchmark's traffic.

A traffic mix is a data file, `traffic/<name>.json`, read by this module
and by the driver that it names. Its keys: `driver` (the file under
`drivers/` that runs the window), `batch` (sequences a call),
`prompt_len` (tokens a prompt), for decode `decode_tokens` (tokens served
a sequence) and `check_sequences` (sequences of a finished batch whose
served tokens are compared), `trace_calls` or `trace_steps` (the slice
that a `--trace 1` run profiles), and `why`.

Prompts are drawn uniformly over the vocabulary on the device. Call `i`
of a run draws from its own stream of the run's seed, so that the
reference can draw the same prompt again, and every seed gives the same
sizes. Warm-up and traced calls draw from streams of their own.
"""
from __future__ import annotations

import torch

from portbench.weights import seed_of

WARMUP_STREAM = 1 << 40          # + i: the set-up's warm-up calls
TRACE_STREAM = 2 << 40           # + i: the traced slice's calls


def prompts(seed: int, call: int, batch: int, length: int, vocab: int,
            device) -> torch.Tensor:
    """[batch, length] int64 token ids of call `call` of seed `seed`."""
    gen = torch.Generator(device).manual_seed(seed_of(seed, call + 1))
    return torch.randint(0, vocab, (batch, length), generator=gen,
                         device=device)

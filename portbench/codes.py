"""The inputs of a codebook model's traffic (MusicGen's): delayed codes and
conditioning text states, drawn from the run's seed on the device.

A traffic mix of the codebook drivers (`drivers/prefill_codes.py`,
`drivers/decode_codes.py`) adds to the keys that `traffic.py` reads
`text_len`, the text states a request carries, which must equal the
configuration file's `text_len` (the yardstick counts the cross-attention
from the configuration). Codes of call `i` come from `traffic.prompts`'
stream of call `i`, as a token model's prompts do (one row a codebook);
text states from a stream of their own, so that the reference can draw
both again.
"""
from __future__ import annotations

import torch

from portbench import traffic
from portbench.weights import seed_of

TEXT_STREAM = 3 << 40            # + i: the text states of call i


def text_len(cell) -> int:
    """The traffic's text states a request, checked against the
    configuration's."""
    t, c = cell.traffic["text_len"], cell.config["text_len"]
    if t != c:
        raise ValueError(f"{cell.name}: traffic text_len {t} differs from "
                         f"the configuration's {c}")
    return t


def delayed(codes: torch.Tensor, pad: int) -> torch.Tensor:
    """codes [B, K, S] as the start of a delayed sequence: position 0 the
    start (all `pad`) and codebook k `pad` up to position k (its first
    frame comes k positions after codebook 0's)."""
    codes = codes.clone()
    for k in range(codes.shape[1]):
        codes[:, k, :k + 1] = pad
    return codes


def inputs(seed: int, call: int, batch: int, books: int, length: int,
           vocab: int, text: int, width: int, device):
    """(codes [batch, books, length] int64, delayed, the pad id `vocab`;
    text states [batch, text, width] float32, N(0, 1)) of call `call`."""
    codes = traffic.prompts(seed, call, batch * books, length, vocab,
                            device).view(batch, books, length)
    gen = torch.Generator(device).manual_seed(seed_of(seed,
                                                      TEXT_STREAM + call))
    states = torch.randn((batch, text, width), generator=gen,
                         device=device)
    return delayed(codes, vocab), states

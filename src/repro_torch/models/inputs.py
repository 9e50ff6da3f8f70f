"""`make_batch()`: a concrete random batch for the LM zoo.

Port of `repro.models.inputs.make_batch`. Its numbers come from numpy's
`default_rng(seed)`, drawn in the same order and shapes as the
reference's, so both packages get the same arrays from the same seed:
`tokens`; or musicgen's frame `embeddings` then `labels`; or llava's
`tokens` then `patch_embeds` (normals drawn in f64, cast to f32, then
to the model's dtype). The reference's ShapeDtypeStruct specs
(`input_specs`) serve its dry-run only and are not ported (ROADMAP.md
Queue 1 item 7).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.models.config import ModelConfig, ShapeSpec


def _emb_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def make_batch(cfg: ModelConfig, shape: ShapeSpec, seed: int = 0,
               device="cuda") -> dict:
    """A train or prefill shape gives `{"tokens": [B, S] int64}`; with
    frame embeddings `{"embeddings": [B, S, D], "labels": [B, S]}`; with
    a patch prefix of P positions (S counts them) `{"tokens": [B, S - P],
    "patch_embeds": [B, P, D]}`. A decode shape gives `{"tokens": [B, 1],
    "pos": S - 1}` for every arch."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    B, S, D = shape.global_batch, shape.seq_len, cfg.d_model

    def ints(size):
        return torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             size=size)).to(dev)

    def normals(size):
        x = rng.normal(0, 1, size=size).astype(np.float32)
        return torch.from_numpy(x).to(dev, _emb_dtype(cfg))

    if shape.kind not in ("train", "prefill"):
        return {"tokens": ints((B, 1)), "pos": S - 1}
    if cfg.embed_inputs:                          # musicgen frame embeddings
        return {"embeddings": normals((B, S, D)), "labels": ints((B, S))}
    if cfg.num_patch_tokens:                      # llava patch prefix
        P = cfg.num_patch_tokens
        if S - P <= 1:
            raise ValueError(f"seq_len {S} leaves no text after the "
                             f"{P} patch positions")
        tokens = ints((B, S - P))
        return {"tokens": tokens, "patch_embeds": normals((B, P, D))}
    return {"tokens": ints((B, S))}

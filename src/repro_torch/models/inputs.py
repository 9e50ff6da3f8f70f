"""`input_specs()`: meta-tensor stand-ins for every model input (shapes
and dtypes, no allocation), and `make_batch()`: a concrete random batch
of the same structure for the LM zoo.

Port of `repro.models.inputs`. The specs are the reference's
ShapeDtypeStructs as meta tensors, with one change of dtype: token ids
(`tokens`, `labels`) and decode's `pos` are int64 where the reference's
are int32, as `make_batch` gives them (`tokens` and `labels` are int64
tensors, `pos` a Python int). `make_batch`'s numbers come from numpy's
`default_rng(seed)`, drawn in the same order and shapes as the
reference's, so both packages get the same arrays from the same seed:
`tokens`; or musicgen's frame `embeddings` then `labels`; or llava's
`tokens` then `patch_embeds` (normals drawn in f64, cast to f32, then
to the model's dtype).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.models.config import ModelConfig, ShapeSpec


def _emb_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _spec(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """The batch of a train or prefill step: `{"tokens": [B, S]}`; with
    frame embeddings `{"embeddings": [B, S, D], "labels": [B, S]}`; with
    a patch prefix of P positions (S counts them) `{"tokens": [B, S - P],
    "patch_embeds": [B, P, D]}`."""
    B, S, D = shape.global_batch, shape.seq_len, cfg.d_model
    if cfg.embed_inputs:                          # musicgen frame embeddings
        return {"embeddings": _spec((B, S, D), _emb_dtype(cfg)),
                "labels": _spec((B, S), torch.int64)}
    if cfg.num_patch_tokens:                      # llava patch prefix
        P = cfg.num_patch_tokens
        if S - P <= 1:
            raise ValueError(f"seq_len {S} leaves no text after the "
                             f"{P} patch positions")
        return {"tokens": _spec((B, S - P), torch.int64),
                "patch_embeds": _spec((B, P, D), _emb_dtype(cfg))}
    return {"tokens": _spec((B, S), torch.int64)}


def decode_input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """A decode step: one new token a sequence, at position `pos`."""
    return {"tokens": _spec((shape.global_batch, 1), torch.int64),
            "pos": _spec((), torch.int64)}


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    if shape.kind in ("train", "prefill"):
        return train_input_specs(cfg, shape)
    return decode_input_specs(cfg, shape)


def make_batch(cfg: ModelConfig, shape: ShapeSpec, seed: int = 0,
               device="cuda") -> dict:
    """A concrete batch matching `input_specs`: token ids uniform over the
    vocabulary, embeddings N(0, 1) in the model's dtype, and for a
    decode shape `pos` = S - 1 (a Python int)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in input_specs(cfg, shape).items():
        if k in ("tokens", "labels"):
            out[k] = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, size=tuple(s.shape))).to(dev)
        elif k == "pos":
            out[k] = shape.seq_len - 1
        else:
            x = rng.normal(0, 1, size=tuple(s.shape)).astype(np.float32)
            out[k] = torch.from_numpy(x).to(dev, s.dtype)
    return out

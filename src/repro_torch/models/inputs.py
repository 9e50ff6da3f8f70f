"""`make_batch()`: a concrete random batch for the LM zoo.

Port of `repro.models.inputs.make_batch` for token inputs. Its numbers
come from numpy's `default_rng(seed)`, drawn in the same order and
shapes as the reference's, so both packages get the same tokens from the
same seed. The frame- and patch-embedding front ends wait with the
mixers (ROADMAP.md Queue 1 item 6) and raise; the reference's
ShapeDtypeStruct specs (`input_specs`) serve its dry-run only and are
not ported (ROADMAP.md Queue 1 item 7).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig, ShapeSpec


def make_batch(cfg: ModelConfig, shape: ShapeSpec, seed: int = 0,
               device="cuda") -> dict:
    """`{"tokens": [B, S] int64}` for a train or prefill shape;
    `{"tokens": [B, 1], "pos": S - 1}` for a decode shape."""
    dev = resolve_device(device)
    lm._embed_check(cfg)
    rng = np.random.default_rng(seed)
    B = shape.global_batch
    decode = shape.kind not in ("train", "prefill")
    size = (B, 1) if decode else (B, shape.seq_len)
    out = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, size=size)).to(dev)}
    if decode:
        out["pos"] = shape.seq_len - 1
    return out

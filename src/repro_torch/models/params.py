"""Carry the reference's LM parameters into the port.

`lm_from_jax_params(tree, cfg)` takes the tree that `repro.models.lm.
init_params` returns, with its leaves as numpy arrays (for example
`jax.tree_util.tree_map(np.asarray, params)`), and returns the port's
params (`repro_torch.models.lm`): the same keys, a list of stacks, each
a tuple of per-element dicts whose leaves keep their leading `[repeats]`
axis. Every leaf's shape and dtype is checked against `cfg`.

bf16 leaves arrive as numpy arrays of `ml_dtypes.bfloat16`, which
`torch.from_numpy` refuses; they cross as their 16-bit patterns
(`view(np.int16)` -> `view(torch.bfloat16)`), so the bits are kept
exactly, with no rounding through f32.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig


def _leaf(a, want: torch.Tensor, path: str, device) -> torch.Tensor:
    a = np.array(a)                 # a writable copy for torch
    if tuple(a.shape) != tuple(want.shape):
        raise ValueError(f"{path}: shape {tuple(a.shape)}, config wants "
                         f"{tuple(want.shape)}")
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)) \
            .view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if t.dtype != want.dtype:
        raise ValueError(f"{path}: dtype {a.dtype}, config wants "
                         f"{want.dtype}")
    return t.to(device)


def _convert(tree, want, path: str, device):
    if isinstance(want, dict):
        if not isinstance(tree, dict) or set(tree) != set(want):
            got = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"{path or 'params'}: keys {got}, config "
                             f"wants {sorted(want)}")
        return {k: _convert(tree[k], want[k], f"{path}/{k}", device)
                for k in want}
    if isinstance(want, (list, tuple)):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(want):
            raise ValueError(f"{path}: expected {len(want)} entries")
        return type(want)(_convert(t, w, f"{path}/{i}", device)
                          for i, (t, w) in enumerate(zip(tree, want)))
    return _leaf(tree, want, path, device)


def lm_from_jax_params(tree, cfg: ModelConfig, *, device="cuda") -> dict:
    """The reference's `lm.init_params` tree (numpy leaves) as the port's
    params on `device`, every shape and dtype checked against `cfg`."""
    dev = resolve_device(device)
    want = lm.init_params(None, cfg, device="meta")
    return _convert(tree, want, "", dev)

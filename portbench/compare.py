"""The numbers that decide `correct`, each a reading against the reference.

- `rel_err(a, ref)`: ||a - ref|| / ||ref|| over the whole tensor, in
  float64. A norm over a whole output, not its worst element, so that a
  token whose top-k experts tie within rounding moves it little, while a
  fault that touches a whole row or layer moves it a lot.
- `cache_err`: the largest `rel_err` over layers and cached tensors.
- `token_gap`: the widest gap by which a served token's logit lies below
  the reference's best at its position (valid for greedy tokens).

`verdict(readings, limits)` holds each reading to its limit: correct when
every reading is at or below its limit, and every limit has a reading.
"""
from __future__ import annotations

import torch


def rel_err(a: torch.Tensor, ref: torch.Tensor) -> float:
    ref = ref.double()
    return float(torch.linalg.vector_norm(a.double() - ref)
                 / torch.linalg.vector_norm(ref).clamp(min=1e-300))


def cache_err(program: list[dict], reference: list[dict]) -> float:
    """Largest rel_err over layers and the reference's cached tensors
    [batch, positions or state, ...]: the program's cache, which may be
    longer (its capacity), is read as far as the reference's extends on
    the second axis."""
    if len(program) != len(reference):
        return float("inf")
    return max(rel_err(p[k][:, :r[k].shape[1]], r[k])
               for p, r in zip(program, reference) for k in r)


def token_gap(ref_logits: torch.Tensor, served: torch.Tensor) -> float:
    """ref_logits [n, V] float32, served [n] ids."""
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(-1, served.long()[:, None])[:, 0]
    return float((best - got).max())


def verdict(readings: dict, limits: dict) -> bool:
    return (set(readings) == set(limits)
            and all(readings[k] <= limits[k] for k in limits))


def program_caches(caches) -> list[dict]:
    """The program's cache tree (stacks of per-element dicts with a leading
    [repeats] axis) as one dict per layer, in the order the layers run."""
    out = []
    for stack in caches:
        repeats = next(iter(stack[0].values())).shape[0]
        for i in range(repeats):
            for elem in stack:
                out.append({k: v[i] for k, v in elem.items()})
    return out

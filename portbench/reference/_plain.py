"""Plain building blocks of the benchmark's references, in float32.

Each configuration's reference (`reference/<config>.py`) is its forward
pass written from the published equations with these blocks. They import
nothing of the program: they take the parameter tree that the benchmark
made (`weights.py`) and the prompt ids, and work out everything else
again, routing and caches included. They read a configuration as the
program runs it (`as_run`): the published keys, with the departures
that the file states in their place. TF32 is switched off while a
reference runs (`no_tf32`), so that every float32 product is a float32
product.

`prec` selects the arithmetic of every matrix product: "f32", or "fp8",
the control that must fail the comparison: both operands of each product
rounded to float8 e4m3 with one scale a tensor (the usual tensorwise fp8
recipe), the rest in float32. The MoE router stays float32 in both, as
the program keeps it.
"""
from __future__ import annotations

import contextlib
import math

import torch

F8_MAX = 448.0                   # largest finite float8 e4m3 value
ROW_BLOCK = 8192                 # token rows per block of a large product
QUERY_BLOCK = 256                # query rows per block of attention


def as_run(cfg: dict) -> dict:
    """The configuration file's published keys, with each departure's
    value as the program runs it (`departures`: {key: {"runs", "why"}})
    in place of the published one."""
    return {**cfg, **{k: d["runs"]
                      for k, d in cfg.get("departures", {}).items()}}


@contextlib.contextmanager
def no_tf32():
    """Float32 products in float32 on the card (off on the CPU anyway)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def q8(x: torch.Tensor) -> torch.Tensor:
    """`x` rounded to float8 e4m3 with one scale for the tensor."""
    s = x.abs().amax().clamp(min=1e-30) / F8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def weight(w: torch.Tensor, prec: str) -> torch.Tensor:
    """A [K, N] weight as float32, rounded to fp8 under "fp8"."""
    w = w.float()
    return q8(w) if prec == "fp8" else w


def mm(a: torch.Tensor, w: torch.Tensor, prec: str) -> torch.Tensor:
    """a [..., K] float32 times a prepared weight [K, N], in row blocks."""
    lead = a.shape[:-1]
    a2 = a.reshape(-1, a.shape[-1])
    out = torch.empty((a2.shape[0], w.shape[1]), dtype=torch.float32,
                      device=a.device)
    for i in range(0, a2.shape[0], ROW_BLOCK):
        blk = a2[i:i + ROW_BLOCK]
        if prec == "fp8":
            blk = q8(blk)
        out[i:i + ROW_BLOCK] = blk @ w
    return out.reshape(*lead, w.shape[1])


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * scale.float()


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding over the last axis, its halves as the pair: x
    [B, S, H, d], positions [S]."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.float()[:, None] * freqs[None, :]
    cos = torch.cos(ang)[None, :, None, :]
    sin = torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor) -> torch.Tensor:
    """True where query position q may see key position k."""
    return k_pos[None, :] <= q_pos[:, None]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float, prec: str) -> torch.Tensor:
    """Causal softmax attention, one sequence and one block of queries at
    a time: q [B, S, H, d], k [B, S, KH, d], v [B, S, KH, dv], head h on
    kv head h // (H // KH). Returns [B, S, H, dv] float32."""
    B, S, H, _ = q.shape
    rep = H // k.shape[2]
    pos = torch.arange(S, device=q.device)
    out = torch.empty(q.shape[:3] + (v.shape[-1],), dtype=torch.float32,
                      device=q.device)
    for b in range(B):
        kb = k[b].repeat_interleave(rep, dim=1).transpose(0, 1)  # [H,S,d]
        vb = v[b].repeat_interleave(rep, dim=1).transpose(0, 1)
        if prec == "fp8":
            kb, vb = q8(kb), q8(vb)
        for i in range(0, S, QUERY_BLOCK):
            qb = q[b, i:i + QUERY_BLOCK].transpose(0, 1)          # [H,n,d]
            if prec == "fp8":
                qb = q8(qb)
            s = (qb @ kb.transpose(1, 2)) * scale
            s = s.masked_fill(~causal_mask(pos[i:i + QUERY_BLOCK], pos),
                              float("-inf"))
            p = torch.softmax(s, dim=-1)
            if prec == "fp8":
                p = q8(p)
            out[b, i:i + QUERY_BLOCK] = (p @ vb).transpose(0, 1)
    return out


def swiglu(x: torch.Tensor, w_gate, w_up, w_down, prec: str) -> torch.Tensor:
    """x [T, D] -> [T, D], in blocks of rows."""
    wg, wu, wd = (weight(w, prec) for w in (w_gate, w_up, w_down))
    out = torch.empty_like(x)
    for i in range(0, x.shape[0], ROW_BLOCK):
        blk = x[i:i + ROW_BLOCK]
        g = mm(blk, wg, prec)
        out[i:i + ROW_BLOCK] = mm(g * torch.sigmoid(g) * mm(blk, wu, prec),
                                  wd, prec)
    return out


def by_sequences(fn, h: torch.Tensor):
    """`fn(h_chunk) -> (y, cache dict)` over chunks of whole sequences of
    h [B, S, D], about ROW_BLOCK tokens each, joined along the batch."""
    n = max(1, ROW_BLOCK // h.shape[1])
    parts = [fn(h[b:b + n]) for b in range(0, h.shape[0], n)]
    return (torch.cat([y for y, _ in parts]),
            {k: torch.cat([c[k] for _, c in parts]) for k in parts[0][1]})


def capacity(tokens: int, top_k: int, experts: int,
             capacity_factor: float) -> int:
    """Slots per expert for a call of `tokens` tokens: ceil(T·K/E·cf),
    rounded up to a multiple of 8, at least 8."""
    cap = math.ceil(tokens * top_k / experts * capacity_factor)
    return max(8, -(-cap // 8) * 8)


def keep_within_capacity(ids: torch.Tensor, groups: list[torch.Tensor],
                         experts: int, top_k: int,
                         capacity_factor: float) -> torch.Tensor:
    """ids [T, K] -> keep [T, K]. Each group is the index set of one call,
    in the order the call holds its tokens; within its call each expert
    takes its (token, choice) pairs in that order until its `capacity`
    slots are full, and drops the rest."""
    T, K = ids.shape
    dev = ids.device
    gid = torch.zeros(T, dtype=torch.long, device=dev)
    order = torch.zeros(T, dtype=torch.long, device=dev)
    caps = torch.empty(len(groups), dtype=torch.long, device=dev)
    for i, g in enumerate(groups):
        gid[g] = i
        order[g] = torch.arange(len(g), device=dev)
        caps[i] = capacity(len(g), top_k, experts, capacity_factor)
    run = gid[:, None] * experts + ids                 # (call, expert)
    within = order[:, None] * K + torch.arange(K, device=dev)[None, :]
    key = (run * (T * K) + within).reshape(-1)
    sorted_key, perm = torch.sort(key)
    sorted_run = sorted_key // (T * K)
    idx = torch.arange(key.numel(), device=dev)
    start = torch.ones_like(sorted_run, dtype=torch.bool)
    start[1:] = sorted_run[1:] != sorted_run[:-1]
    first = torch.cummax(torch.where(start, idx, 0), 0).values
    rank = torch.empty_like(idx)
    rank[perm] = idx - first
    return (rank.reshape(T, K) < caps[gid][:, None])


def route(x: torch.Tensor, router: torch.Tensor, top_k: int, scoring: str,
          bias: torch.Tensor | None, normalize: bool, scaling: float):
    """x [T, D] -> (gates [T, K], ids [T, K]). softmax: the top k of the
    softmax; sigmoid: the top k of sigmoid + bias, gated by the sigmoid."""
    logits = x @ router.float()
    if scoring == "sigmoid":
        scores = torch.sigmoid(logits)
        sel = scores + bias.float()[None, :] if bias is not None else scores
        ids = torch.topk(sel, top_k, dim=-1).indices
        gates = torch.gather(scores, -1, ids)
    else:
        gates, ids = torch.topk(torch.softmax(logits, dim=-1), top_k, dim=-1)
    if normalize:
        gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    return gates * scaling, ids


def moe(x: torch.Tensor, p: dict, *, top_k: int, scoring: str,
        normalize: bool, scaling: float, capacity_factor: float,
        groups: list[torch.Tensor], prec: str) -> torch.Tensor:
    """Token-choice experts with a capacity per call. x [T, D] float32;
    `groups` are the index sets of the calls that the tokens were served
    in, each in the order the call holds its tokens: a pair past its
    expert's capacity within its call is dropped. Shared experts, where
    `p` has them, see every token."""
    E = p["w_gate"].shape[0]
    gates, ids = route(x, p["router"], top_k, scoring, p.get("e_bias"),
                       normalize, scaling)
    keep = keep_within_capacity(ids, groups, E, top_k, capacity_factor)
    out = torch.zeros_like(x)
    for e in range(E):
        tok, choice = torch.nonzero((ids == e) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        y = swiglu(x[tok], p["w_gate"][e], p["w_up"][e], p["w_down"][e],
                   prec)
        out.index_add_(0, tok, y * gates[tok, choice][:, None])
    if "shared" in p:
        s = p["shared"]
        out = out + swiglu(x, s["w_gate"], s["w_up"], s["w_down"], prec)
    return out


def layers(params: dict):
    """The layers of the parameter tree in the order they run: each stack
    of the tree, its repeats in turn, each element of its pattern."""
    for stack in params["stacks"]:
        repeats = next(iter(_leaves(stack[0]))).shape[0]
        for i in range(repeats):
            for elem in stack:
                yield _index(elem, i)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def logits_at(h: torch.Tensor, rows: torch.Tensor, head: torch.Tensor,
              prec: str, scale: float = 1.0) -> torch.Tensor:
    """Logits [n, V] of the flattened positions `rows` of the final hidden
    states h [B, S, D], with `head` [D, V]."""
    return mm(h.reshape(-1, h.shape[-1])[rows], weight(head, prec),
              prec) / scale


def moe_groups_of_prefill(batch: int, seq: int, device) -> list:
    """One prefill call over a [batch, seq] prompt: one group, batch-major."""
    return [torch.arange(batch * seq, device=device)]

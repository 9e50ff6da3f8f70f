"""The yardstick's peaks and its count of the work a step needs.

Counted from the configuration's shapes (`reference/<config>.py`
`shapes`), never from the program, so that the count stays the same
whatever implements the step. The least time of a piece of work is the
larger of its FLOPs over the bf16 tensor-core peak and its bytes over the
HBM bandwidth of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W; a card set below it reads lower).

- FLOPs: 2 per multiply-add of every weight matrix a token passes
  through: attention's projections, the MLP, the router, the `top_k`
  routed experts and the shared expert; the output head only at the
  positions whose logits the step returns; causal attention over the
  (query, key) pairs that the mask lets through, per head: for GQA
  2·hd for scores and 2·hd for values, for MLA in its plain prefill form
  2·(nope + rope) and 2·v_head_dim, and in decode's absorbed form
  2·(kv_lora + rope) and 2·kv_lora.
- Bytes: each weight that the step needs, read once at 2 bytes: every
  expert in a prefill whose tokens reach every expert, the least that
  any routing needs in a decode step (`top_k` experts); the token ids
  and their embedding rows read and the logits written (2 bytes); the
  cache written once by prefill and, in decode, read once and its new
  position written; a recurrent layer's fixed state a sequence written
  by prefill, read and written by a decode step.

A layer of `shapes` is a dict of its parts (attention, ffn, mixer), each
with its `kind`: "gqa", "mla", "mlp", "moe", or "counts" for a part whose
reference states its own counts (`_counts`).
"""
from __future__ import annotations

BF16_FLOPS = 989e12              # dense bf16 tensor-core FLOP/s
HBM_BYTES = 3.35e12              # HBM3 bytes/s
WEIGHT_BYTES = 2                 # bf16


ZERO = {"weights": 0, "token_weights": 0, "token_flops": 0,
        "pair_flops": 0, "ctx_flops": 0, "cache_width": 0,
        "state_bytes": 0}


def _counts(part: dict, d: int, experts_read) -> dict:
    """What one part of a layer needs, by the keys of `ZERO`: the weight
    elements read (`weights`; a MoE reads `experts_read(experts, top_k)`
    routed experts) and those a token passes through (`token_weights`);
    FLOPs a token beyond its weights (`token_flops`), a causal (query,
    key) pair in prefill (`pair_flops`) and an attended position in
    decode (`ctx_flops`); elements cached a position (`cache_width`) and
    bytes of fixed state a sequence (`state_bytes`). A part of kind
    "counts" states these numbers itself, so that a reference can describe
    a layer that this file does not know."""
    kind = part["kind"]
    if kind == "counts":
        return {**ZERO, **{k: v for k, v in part.items() if k != "kind"}}
    if kind == "gqa":
        H, KH, hd = part["heads"], part["kv_heads"], part["head_dim"]
        w = d * (H + 2 * KH) * hd + H * hd * d
        return {**ZERO, "weights": w, "token_weights": w,
                "pair_flops": 4 * hd * H, "ctx_flops": 4 * hd * H,
                "cache_width": 2 * KH * hd}
    if kind == "mla":
        H, rq, rkv = part["heads"], part["q_lora_rank"], part["kv_lora_rank"]
        nope, rope, dv = part["nope"], part["rope"], part["v_head_dim"]
        w = (d * rq + rq * H * (nope + rope) + d * (rkv + rope)
             + rkv * H * nope + rkv * H * dv + H * dv * d)
        return {**ZERO, "weights": w, "token_weights": w,
                "pair_flops": 2 * (nope + rope + dv) * H,
                "ctx_flops": 2 * (2 * rkv + rope) * H,
                "cache_width": rkv + rope}
    if kind == "mlp":
        w = 3 * d * part["d_ff"]
        return {**ZERO, "weights": w, "token_weights": w}
    if kind == "moe":
        E, k = part["experts"], part["top_k"]
        fixed = d * E + 3 * d * part["shared_d_ff"]
        expert = 3 * d * part["d_ff"]
        return {**ZERO, "weights": fixed + expert * experts_read(E, k),
                "token_weights": fixed + expert * k}
    raise ValueError(f"roofline: no count for a part of kind {kind!r}")


def _pairs_causal(seq: int) -> int:
    return seq * (seq + 1) // 2


def prefill(shapes: dict, batch: int, seq: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one prefill call of `batch` prompts of `seq`
    tokens that returns the last position's logits and the caches."""
    d, vocab = shapes["d_model"], shapes["vocab"]
    tokens = batch * seq
    flops = 2.0 * d * vocab * batch
    nbytes = ((d * vocab + tokens * d + batch * vocab) * WEIGHT_BYTES
              + tokens * 8)
    for layer in shapes["layers"]:
        for part in layer.values():
            c = _counts(part, d, lambda e, k: min(e, tokens * k))
            flops += (2.0 * tokens * c["token_weights"]
                      + float(c["token_flops"]) * tokens
                      + float(c["pair_flops"]) * batch * _pairs_causal(seq))
            nbytes += (WEIGHT_BYTES * (c["weights"]
                                       + tokens * c["cache_width"])
                       + batch * c["state_bytes"])
    return flops, float(nbytes)


def decode(shapes: dict, batch: int, pos: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one decode step of `batch` sequences whose new
    token sits at position `pos` (so `pos + 1` positions are attended)."""
    d, vocab = shapes["d_model"], shapes["vocab"]
    ctx = pos + 1
    flops = 2.0 * d * vocab * batch
    nbytes = (d * vocab + batch * d) * WEIGHT_BYTES + batch * 8 \
        + batch * vocab * WEIGHT_BYTES
    for layer in shapes["layers"]:
        for part in layer.values():
            c = _counts(part, d, lambda e, k: k)
            flops += (2.0 * batch * c["token_weights"]
                      + float(c["token_flops"]) * batch
                      + float(c["ctx_flops"]) * batch * ctx)
            nbytes += (WEIGHT_BYTES * (c["weights"]
                                       + batch * ctx * c["cache_width"])
                       + 2 * batch * c["state_bytes"])
    return flops, float(nbytes)


def least_seconds(shapes: dict, work: list[dict]) -> float:
    """The least time the published peaks allow for `work`: items
    {"kind": "prefill", "batch", "seq", "count"} and {"kind": "decode",
    "batch", "positions": [...]}, each call or step bound on its own."""
    total = 0.0
    for item in work:
        if item["kind"] == "prefill":
            f, b = prefill(shapes, item["batch"], item["seq"])
            total += item["count"] * max(f / BF16_FLOPS, b / HBM_BYTES)
        else:
            for pos in item["positions"]:
                f, b = decode(shapes, item["batch"], pos)
                total += max(f / BF16_FLOPS, b / HBM_BYTES)
    return total

"""Plain float32 reference of deepseek-v3-671b as the benchmark runs it.

The first `first_k_dense_replace` layers are multi-head latent attention
(MLA) with a dense SwiGLU MLP, the rest MLA with routed and shared SwiGLU
experts; pre-norm with RMSNorm, an untied output head. MLA as in the
DeepSeek-V3 report: the query through a low-rank down projection, its
RMSNorm and the per-head up projection, split into `qk_nope_head_dim`
columns and `qk_rope_head_dim` roped ones; one joint down projection of
the input to the KV latent (`kv_lora_rank`, RMSNorm'd) and the rope key
shared by every head; keys and values from the latent by per-head up
projections; softmax scale 1/sqrt(nope + rope). Attention is computed in
this plain (not absorbed) form. Routing: the top `num_experts_per_tok` of
sigmoid scores plus the per-expert bias, gated by the sigmoid scores,
renormalized (`norm_topk_prob`) and scaled by `routed_scaling_factor`,
with `capacity_factor` slots per expert and call (`_plain.moe`). The
configuration file holds the published values and, under `departures`,
what the program runs in their place (`_plain.as_run`): no YaRN, no
group limit, no multi-token prediction, no routed scaling, an embedding
multiplier. The two that this reference does not compute (YaRN, a
group limit under `n_group`) it refuses.

It takes the benchmark's parameter tree and prompt ids and imports
nothing of the program.
"""
from __future__ import annotations

import importlib.util
import math
import os

import torch

_spec = importlib.util.spec_from_file_location(
    "portbench_reference_plain",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "_plain.py"))
P = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(P)


def shapes(cfg: dict) -> dict:
    """The model's shapes for the yardstick's FLOP and byte counts."""
    mla = {"kind": "mla", "heads": cfg["num_attention_heads"],
           "q_lora_rank": cfg["q_lora_rank"],
           "kv_lora_rank": cfg["kv_lora_rank"],
           "nope": cfg["qk_nope_head_dim"], "rope": cfg["qk_rope_head_dim"],
           "v_head_dim": cfg["v_head_dim"]}
    dense = {"attn": mla, "ffn": {"kind": "mlp",
                                  "d_ff": cfg["intermediate_size"]}}
    sparse = {"attn": mla, "ffn": {
        "kind": "moe", "experts": cfg["n_routed_experts"],
        "top_k": cfg["num_experts_per_tok"],
        "d_ff": cfg["moe_intermediate_size"],
        "shared_d_ff": cfg["moe_intermediate_size"]
        * cfg["n_shared_experts"]}}
    k = cfg["first_k_dense_replace"]
    return {"d_model": cfg["hidden_size"], "vocab": cfg["vocab_size"],
            "tied": False,
            "layers": [dense] * k + [sparse] * (cfg["num_hidden_layers"] - k)}


def _mla(p: dict, cfg: dict, h: torch.Tensor, prec: str):
    B, S, D = h.shape
    H = cfg["num_attention_heads"]
    nope, rope_d = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    r_q, r_kv, dv = cfg["q_lora_rank"], cfg["kv_lora_rank"], \
        cfg["v_head_dim"]
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    pos = torch.arange(S, device=h.device)
    cq = P.rmsnorm(P.mm(h, P.weight(p["wdq"], prec), prec),
                   p["q_norm"]["scale"], eps)
    q = P.mm(cq, P.weight(p["wuq"].reshape(r_q, H * (nope + rope_d)), prec),
             prec).view(B, S, H, nope + rope_d)
    q = torch.cat([q[..., :nope], P.rope(q[..., nope:], pos, theta)], -1)
    dkv = P.mm(h, P.weight(p["wdkv"], prec), prec)
    ckv = P.rmsnorm(dkv[..., :r_kv], p["kv_norm"]["scale"], eps)
    krope = P.rope(dkv[..., None, r_kv:], pos, theta)           # [B,S,1,r]
    k_nope = P.mm(ckv, P.weight(p["wuk"].reshape(r_kv, H * nope), prec),
                  prec).view(B, S, H, nope)
    v = P.mm(ckv, P.weight(p["wuv"].reshape(r_kv, H * dv), prec),
             prec).view(B, S, H, dv)
    k = torch.cat([k_nope, krope.expand(B, S, H, rope_d)], -1)
    o = P.attention(q, k, v, 1.0 / math.sqrt(nope + rope_d), prec)
    y = P.mm(o.reshape(B, S, H * dv),
             P.weight(p["wo"].reshape(H * dv, D), prec), prec)
    return y, {"ckv": ckv, "krope": krope[:, :, 0]}


def forward(params: dict, cfg: dict, tokens: torch.Tensor,
            groups: list[torch.Tensor], rows: torch.Tensor,
            prec: str = "f32"):
    """tokens [B, S] -> (logits [len(rows), V] float32 at the flattened
    positions `rows`, the caches: one {"ckv" [B, S, kv_lora_rank], "krope"
    [B, S, qk_rope_head_dim]} per layer). `groups` are the MoE's calls
    (`_plain.moe`)."""
    cfg = P.as_run(cfg)
    if cfg["rope_scaling"] is not None or cfg["topk_group"] < cfg["n_group"]:
        raise ValueError("the reference computes neither YaRN nor "
                         "group-limited routing")
    with P.no_tf32():
        B, S = tokens.shape
        D, eps = cfg["hidden_size"], cfg["rms_norm_eps"]
        emb = params["embed"][tokens.long()].float()
        if prec == "fp8":
            emb = P.q8(emb)
        x = emb * cfg["embedding_multiplier"]
        caches = []
        for i, layer in enumerate(P.layers(params)):
            h = P.rmsnorm(x, layer["norm1"]["scale"], eps)
            y, cache = P.by_sequences(
                lambda c: _mla(layer["mixer"], cfg, c, prec), h)
            caches.append(cache)
            x = x + y
            h = P.rmsnorm(x, layer["norm2"]["scale"], eps).reshape(B * S, D)
            f = layer["ffn"]
            dense = i < cfg["first_k_dense_replace"]
            if dense != ("router" not in f):
                raise ValueError(f"layer {i}: the parameter tree's ffn does "
                                 "not match first_k_dense_replace")
            if dense:
                y = P.swiglu(h, f["w_gate"], f["w_up"], f["w_down"], prec)
            else:
                y = P.moe(h, f, top_k=cfg["num_experts_per_tok"],
                          scoring=cfg["scoring_func"],
                          normalize=cfg["norm_topk_prob"],
                          scaling=cfg["routed_scaling_factor"],
                          capacity_factor=cfg["capacity_factor"],
                          groups=groups, prec=prec)
            x = x + y.view(B, S, D)
        if len(caches) != cfg["num_hidden_layers"]:
            raise ValueError(f"{len(caches)} layers in the parameter tree, "
                             f"{cfg['num_hidden_layers']} in the config")
        h = P.rmsnorm(x, params["final_norm"]["scale"], eps)
        return P.logits_at(h, rows, params["lm_head"], prec), caches

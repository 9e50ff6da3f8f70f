"""Plain float32 reference of granite-moe-3b-a800m as the benchmark runs it.

Every layer is GQA attention with rotary embeddings followed by a
token-choice mixture of SwiGLU experts, pre-norm with RMSNorm; the output
head is the embedding, tied. The multipliers of the Granite family
(`embedding_multiplier`, `attention_multiplier`, `residual_multiplier`,
`logits_scaling`) are read as the program runs them: the configuration
file holds the published values and, under `departures`, the program's
(`_plain.as_run`). Routing: the top
`num_experts_per_tok` of the router's softmax, renormalized, with
`capacity_factor` slots per expert and call (`_plain.moe`).

It takes the benchmark's parameter tree and prompt ids and imports
nothing of the program.
"""
from __future__ import annotations

import importlib.util
import os

import torch

_spec = importlib.util.spec_from_file_location(
    "portbench_reference_plain",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "_plain.py"))
P = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(P)


def shapes(cfg: dict) -> dict:
    """The model's shapes for the yardstick's FLOP and byte counts."""
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    hd = cfg.get("head_dim") or D // H
    layer = {"attn": {"kind": "gqa", "heads": H,
                      "kv_heads": cfg["num_key_value_heads"], "head_dim": hd},
             "ffn": {"kind": "moe", "experts": cfg["num_local_experts"],
                     "top_k": cfg["num_experts_per_tok"],
                     "d_ff": cfg["intermediate_size"], "shared_d_ff": 0}}
    return {"d_model": D, "vocab": cfg["vocab_size"], "tied": True,
            "layers": [layer] * cfg["num_hidden_layers"]}


def _attention(p: dict, cfg: dict, h: torch.Tensor, prec: str):
    B, S, D = h.shape
    H, KH = p["wq"].shape[-2], p["wk"].shape[-2]
    hd = p["wq"].shape[-1]
    pos = torch.arange(S, device=h.device)
    q = P.mm(h, P.weight(p["wq"].reshape(D, H * hd), prec), prec)
    k = P.mm(h, P.weight(p["wk"].reshape(D, KH * hd), prec), prec)
    v = P.mm(h, P.weight(p["wv"].reshape(D, KH * hd), prec), prec)
    q = P.rope(q.view(B, S, H, hd), pos, cfg["rope_theta"])
    k = P.rope(k.view(B, S, KH, hd), pos, cfg["rope_theta"])
    v = v.view(B, S, KH, hd)
    o = P.attention(q, k, v, cfg["attention_multiplier"], prec)
    y = P.mm(o.reshape(B, S, H * hd),
             P.weight(p["wo"].reshape(H * hd, D), prec), prec)
    return y, {"k": k, "v": v}


def forward(params: dict, cfg: dict, tokens: torch.Tensor,
            groups: list[torch.Tensor], rows: torch.Tensor,
            prec: str = "f32"):
    """tokens [B, S] -> (logits [len(rows), V] float32 at the flattened
    positions `rows`, the caches: one {"k", "v"} [B, S, KH, hd] per layer,
    after rope). `groups` are the MoE's calls (`_plain.moe`)."""
    cfg = P.as_run(cfg)
    with P.no_tf32():
        B, S = tokens.shape
        D, eps = cfg["hidden_size"], cfg["rms_norm_eps"]
        res = cfg["residual_multiplier"]
        emb = params["embed"][tokens.long()].float()
        if prec == "fp8":
            emb = P.q8(emb)
        x = emb * cfg["embedding_multiplier"]
        caches = []
        for layer in P.layers(params):
            h = P.rmsnorm(x, layer["norm1"]["scale"], eps)
            y, cache = P.by_sequences(
                lambda c: _attention(layer["mixer"], cfg, c, prec), h)
            caches.append(cache)
            x = x + res * y
            h = P.rmsnorm(x, layer["norm2"]["scale"], eps).reshape(B * S, D)
            y = P.moe(h, layer["ffn"], top_k=cfg["num_experts_per_tok"],
                      scoring="softmax", normalize=True, scaling=1.0,
                      capacity_factor=cfg["capacity_factor"], groups=groups,
                      prec=prec)
            x = x + res * y.view(B, S, D)
        if len(caches) != cfg["num_hidden_layers"]:
            raise ValueError(f"{len(caches)} layers in the parameter tree, "
                             f"{cfg['num_hidden_layers']} in the config")
        h = P.rmsnorm(x, params["final_norm"]["scale"], eps)
        logits = P.logits_at(h, rows, params["embed"].T, prec,
                             cfg["logits_scaling"])
        return logits, caches

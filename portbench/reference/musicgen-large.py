"""Plain float32 reference of musicgen-large's decoder as the benchmark
runs it (arXiv:2306.05284; Hugging Face's `MusicgenForCausalLM`,
audiocraft's LM with `norm_first`).

    x0 = sum_k E_k[codes[:, k, t]] + PE(t)     PE: cos half then sin half
    h  = h + SelfAttn(LN1(h))                  causal MHA, q.k / sqrt(hd)
    h  = h + CrossAttn(LNx(h), C)              C = enc_to_dec(text), no mask
    h  = h + W2 GELU(W1 LN2(h))                exact GELU, no bias
    logits_k = LN_f(h) @ H_k                   one head a codebook

LayerNorm with weight and bias, eps `layer_norm_eps`; no bias in
attention or the MLP; `enc_to_dec` (768 -> 2048) has one. The T5 encoder
is not run: the text states are the benchmark's (`codes.py`), and
`enc_to_dec` is. Widths are read from the configuration and the parameter
tree the benchmark made (`weights.py`); nothing of the program is
imported. Matrix products go through `_plain.py` (`prec` "f32", or
"fp8", the control), TF32 off.
"""
from __future__ import annotations

import importlib.util
import math
import os

import torch
import torch.nn.functional as F

_spec = importlib.util.spec_from_file_location(
    "portbench_reference_plain",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "_plain.py"))
P = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(P)


def shapes(cfg: dict) -> dict:
    """The model's shapes for the yardstick's FLOP and byte counts. Self-
    attention is MHA; the cross-attention, the GELU MLP and the heads are
    counted here (`counts`):

    - cross-attention: its four matrices read; a position passes through
      the query and output ones and attends to `text_len` keys. Its keys
      and values are fixed a sequence (2 x text_len x d at 2 bytes, 4·T·d
      bytes a layer): prefill writes them, decode only reads them, and the
      yardstick counts fixed state once in prefill and twice (read and
      write) in decode, so `state_bytes` is half of them: decode's read
      exact, prefill's write counted half. The projection of the text
      states into keys and values (2·T·d·2d FLOPs a sequence and layer,
      under 2 % of a 2k-frame prefill) has no key in the yardstick and is
      left out: the count stays a lower bound.
    - the MLP: two matrices, no gate.
    - the heads: `vocab` = codebooks x codes, so that the yardstick's
      head (d x vocab) is the four heads; the embeddings count one row a
      position where a position reads four (a lower bound again)."""
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    hd, T = D // H, cfg["text_len"]
    layer = {"attn": {"kind": "gqa", "heads": H, "kv_heads": H,
                      "head_dim": hd},
             "xattn": {"kind": "counts", "weights": 4 * D * D,
                       "token_weights": 2 * D * D,
                       "token_flops": 4 * hd * H * T,
                       "state_bytes": 2 * T * D},
             "ffn": {"kind": "counts", "weights": 2 * D * cfg["ffn_dim"],
                     "token_weights": 2 * D * cfg["ffn_dim"]}}
    return {"d_model": D, "vocab": cfg["num_codebooks"] * cfg["vocab_size"],
            "tied": False, "layers": [layer] * cfg["num_hidden_layers"]}


def sinusoid(S: int, D: int, device) -> torch.Tensor:
    """[S, D]: cos(t w_i) then sin(t w_i), w_i = 10000^(-i/(D/2 - 1))."""
    half = D // 2
    w = torch.exp(torch.arange(half, dtype=torch.float32, device=device)
                  * -(math.log(10000.0) / (half - 1)))
    t = torch.arange(S, dtype=torch.float32, device=device)[:, None] * w
    return torch.cat([torch.cos(t), torch.sin(t)], dim=-1)


def layer_norm(x: torch.Tensor, p: dict, eps: float) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p["scale"].float(),
                        p["bias"].float(), eps)


def _proj(x: torch.Tensor, w: torch.Tensor, prec: str) -> torch.Tensor:
    """x [B, S, D] through w [D, H, hd] -> [B, S, H, hd]."""
    D, H, hd = w.shape
    return P.mm(x, P.weight(w.reshape(D, H * hd), prec), prec) \
        .view(*x.shape[:2], H, hd)


def _out(o: torch.Tensor, w: torch.Tensor, prec: str) -> torch.Tensor:
    """o [B, S, H, hd] through w [H, hd, D] -> [B, S, D]."""
    H, hd, D = w.shape
    return P.mm(o.reshape(*o.shape[:2], H * hd),
                P.weight(w.reshape(H * hd, D), prec), prec)


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    prec: str) -> torch.Tensor:
    """Unmasked softmax attention of q [B, S, H, d] over k, v [B, T, H, d],
    a sequence and a block of queries at a time; fp8 rounds both operands
    of each product, as `_plain.attention` does."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    out = torch.empty_like(q)
    for b in range(q.shape[0]):
        kb, vb = k[b].transpose(0, 1), v[b].transpose(0, 1)     # [H,T,d]
        if prec == "fp8":
            kb, vb = P.q8(kb), P.q8(vb)
        for i in range(0, q.shape[1], P.QUERY_BLOCK):
            qb = q[b, i:i + P.QUERY_BLOCK].transpose(0, 1)
            if prec == "fp8":
                qb = P.q8(qb)
            p = torch.softmax((qb @ kb.transpose(1, 2)) * scale, dim=-1)
            if prec == "fp8":
                p = P.q8(p)
            out[b, i:i + P.QUERY_BLOCK] = (p @ vb).transpose(0, 1)
    return out


def forward(params: dict, cfg: dict, codes: torch.Tensor,
            text: torch.Tensor, rows: torch.Tensor, prec: str = "f32"):
    """codes [B, K, S] (ids 0..V, V the pad and start id), text [B, T, Dx]
    -> (logits [len(rows), K, V] float32 at the flattened positions
    `rows` of [B, S], the caches: one {"k", "v"} [B, S, H, hd] and
    {"xk", "xv"} [B, T, H, hd] a layer)."""
    cfg = P.as_run(cfg)
    with P.no_tf32():
        B, K, S = codes.shape
        D, eps = cfg["hidden_size"], cfg["layer_norm_eps"]
        x = torch.zeros((B, S, D), dtype=torch.float32, device=codes.device)
        for k in range(K):
            e = params["embed"][k][codes[:, k].long()].float()
            x += P.q8(e) if prec == "fp8" else e
        x += sinusoid(S, D, codes.device)
        e2d = params["enc_to_dec"]
        c = P.mm(text.float(), P.weight(e2d["w"], prec), prec) \
            + e2d["b"].float()
        caches = []
        for layer in P.layers(params):
            h = layer_norm(x, layer["norm1"], eps)
            m = layer["mixer"]
            q, k, v = (_proj(h, m[w], prec) for w in ("wq", "wk", "wv"))
            x += _out(P.attention(q, k, v, 1.0 / math.sqrt(q.shape[-1]),
                                  prec), m["wo"], prec)
            h = layer_norm(x, layer["norm_x"], eps)
            xa = layer["xattn"]
            xk, xv = _proj(c, xa["wk"], prec), _proj(c, xa["wv"], prec)
            x += _out(cross_attention(_proj(h, xa["wq"], prec), xk, xv,
                                      prec), xa["wo"], prec)
            h = layer_norm(x, layer["norm2"], eps)
            f = layer["ffn"]
            x += P.mm(F.gelu(P.mm(h, P.weight(f["w_up"], prec), prec)),
                      P.weight(f["w_down"], prec), prec)
            caches.append({"k": k, "v": v, "xk": xk, "xv": xv})
        if len(caches) != cfg["num_hidden_layers"]:
            raise ValueError(f"{len(caches)} layers in the parameter tree, "
                             f"{cfg['num_hidden_layers']} in the config")
        h = layer_norm(x, params["final_norm"], eps)
        logits = torch.stack([P.logits_at(h, rows, params["lm_head"][k],
                                          prec) for k in range(K)], dim=1)
        return logits, caches

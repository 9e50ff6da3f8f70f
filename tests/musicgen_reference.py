"""Plain float32 reference of MusicGen's decoder (arXiv:2306.05284;
Hugging Face's `MusicgenForCausalLM`, audiocraft's LM with `norm_first`),
for the tests of the port's codebook and cross-attention config.

    x0 = sum_k E_k[codes[:, k, t]] + PE(t)     PE: cos half then sin half
    h  = h + SelfAttn(LN1(h))                  causal MHA, q.k / sqrt(hd)
    h  = h + CrossAttn(LNx(h), C)              C = text @ W + b, no mask
    h  = h + W2 GELU(W1 LN2(h))                exact GELU, no bias
    logits_k = LN_f(h) @ H_k                   K untied heads

Written from the equations with plain `torch` operations in float32 and
TF32 off (`no_tf32`): no cache, no kernel, no code of the port. It reads
the port's parameter tree (`embed` [K, V+1, D], `lm_head` [K, D, V],
`enc_to_dec` {w, b}, one stack of layers whose leaves carry a leading
[L] axis: `norm1`, `mixer`, `norm_x`, `xattn`, `norm2`, `ffn`) and
returns the logits at every position and, per layer, what a decoder
caches: the self-attention's keys and values and the cross-attention's.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def positions(S: int, D: int, device) -> torch.Tensor:
    """[S, D]: cos(t w_i) then sin(t w_i), w_i = 10000^(-i/(D/2 - 1))."""
    half = D // 2
    w = torch.exp(torch.arange(half, dtype=torch.float32, device=device)
                  * -(math.log(10000.0) / (half - 1)))
    t = torch.arange(S, dtype=torch.float32, device=device)[:, None] * w
    return torch.cat([torch.cos(t), torch.sin(t)], dim=-1)


def layer_norm(x, p, eps):
    return F.layer_norm(x, x.shape[-1:], p["scale"].float(),
                        p["bias"].float(), eps)


def heads(x, w):
    """x [B, S, D] @ w [D, H, hd] -> [B, S, H, hd]."""
    return torch.einsum("bsd,dhk->bshk", x, w.float())


def attention(q, k, v, causal: bool):
    """q [B, S, H, hd]; k, v [B, T, H, hd] -> [B, S, H, hd]."""
    s = torch.einsum("bshk,bthk->bhst", q, k) / math.sqrt(q.shape[-1])
    if causal:
        S, T = s.shape[-2:]
        keep = torch.ones(S, T, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return torch.einsum("bhst,bthk->bshk", torch.softmax(s, dim=-1), v)


def forward(params: dict, codes: torch.Tensor, text: torch.Tensor,
            eps: float = 1e-5):
    """codes [B, K, S] (ids 0..V, V the pad and start), text [B, T, Dx]
    -> (logits [B, S, K, V] float32, [{"k", "v", "xk", "xv"}] a layer)."""
    with no_tf32():
        K = codes.shape[1]
        D = params["embed"].shape[-1]
        x = sum(params["embed"][k].float()[codes[:, k].long()]
                for k in range(K))
        x = x + positions(codes.shape[2], D, codes.device)
        e2d = params["enc_to_dec"]
        c = text.float() @ e2d["w"].float() + e2d["b"].float()
        stack = params["stacks"][0][0]
        caches = []
        for i in range(stack["norm1"]["scale"].shape[0]):
            p = {g: {n: t[i] for n, t in v.items()}
                 for g, v in stack.items()}
            h = layer_norm(x, p["norm1"], eps)
            q, k, v = (heads(h, p["mixer"][w]) for w in ("wq", "wk", "wv"))
            x = x + torch.einsum("bshk,hkd->bsd", attention(q, k, v, True),
                                 p["mixer"]["wo"].float())
            h = layer_norm(x, p["norm_x"], eps)
            xq = heads(h, p["xattn"]["wq"])
            xk, xv = heads(c, p["xattn"]["wk"]), heads(c, p["xattn"]["wv"])
            x = x + torch.einsum("bshk,hkd->bsd",
                                 attention(xq, xk, xv, False),
                                 p["xattn"]["wo"].float())
            h = layer_norm(x, p["norm2"], eps)
            x = x + F.gelu(h @ p["ffn"]["w_up"].float()) \
                @ p["ffn"]["w_down"].float()
            caches.append({"k": k, "v": v, "xk": xk, "xv": xv})
        h = layer_norm(x, params["final_norm"], eps)
        logits = torch.einsum("bsd,kdv->bskv", h,
                              params["lm_head"].float())
        return logits, caches

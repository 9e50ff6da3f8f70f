"""Dense layers of the LM zoo: RMSNorm, rotary embedding, GQA attention
(full-causal or sliding-window, optional qk-norm) and the SwiGLU MLP.

Port of the dense part of `repro.models.layers`. Parameters are dicts of
tensors laid out as the reference's pytrees. Train and prefill attend
with `chunked_attention` (an online softmax over KV blocks) or, when
`cfg.use_pallas_attn` is set, with the hand-written flash-attention
kernel (`repro_torch.kernels.flash_attention`); decode attends over a
cache (a ring buffer for sliding-window layers) with `cache_attention`.
The reference's sharding annotations (`constrain`) have no counterpart
here and are dropped. The MoE, MLA, SSD and RG-LRU mixers are not ported
yet (ROADMAP.md Queue 1 item 6).

Scalars that the reference casts to the activations' dtype before a
multiply (`q * scale`, the embedding's `sqrt(d_model)`) are cast here
too, so that bf16 rounds at the same points.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.config import ModelConfig

NEG_INF = -1e30


def _dt(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """`value` rounded to `like`'s dtype, as `jnp.asarray(value, dtype)`
    or a weakly typed Python scalar in JAX."""
    return torch.tensor(value, dtype=like.dtype)


def _norm_init(dim: int, lead: tuple = (), device="cpu") -> dict:
    return {"scale": torch.ones(lead + (dim,), dtype=torch.float32,
                                device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps)
    return (y * params["scale"]).to(x.dtype)


def _winit(generator, shape, dtype, scale: float = 0.02,
           device="cpu") -> torch.Tensor:
    """N(0, 1) · scale drawn in f32 from `generator` (on its own device)
    and cast to `dtype` on `device`; shape-only on the meta device."""
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (w * scale).to(device=device, dtype=dtype)


# ----------------------------------------------------------------------------
# Rotary position embedding
# ----------------------------------------------------------------------------
def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: [B, S, H, hd] (hd even); positions: [S] absolute."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.float()[:, None] * freqs[None, :]          # [S, half]
    sin = torch.sin(ang)[None, :, None, :]
    cos = torch.cos(ang)[None, :, None, :]
    x1, x2 = torch.split(x.float(), half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------------
# Chunked online-softmax attention (train / prefill path)
# ----------------------------------------------------------------------------
def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int | None = None,
                      q_offset: int = 0, block_kv: int = 512) -> torch.Tensor:
    """q: [B,S,H,hd]; k,v: [B,T,KH,hd] with H % KH == 0. Returns [B,S,H,hd].

    Walks KV blocks with a running (max, normalizer, accumulator): memory
    bounded by one block of scores. q is scaled in its own dtype before
    the f32 cast, as the reference does."""
    B, S, H, hd = q.shape
    T, KH = k.shape[1], k.shape[2]
    rep = H // KH
    scale = 1.0 / math.sqrt(hd)
    qh = (q * _scalar(scale, q)).reshape(B, S, KH, rep, hd)
    qh = qh.float().permute(0, 2, 3, 1, 4)                 # [B,KH,rep,S,hd]

    blk = min(block_kv, T)
    nb = -(-T // blk)
    q_pos = q_offset + torch.arange(S, device=q.device)

    m = torch.full((B, KH, rep, S), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, KH, rep, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KH, rep, S, hd), dtype=torch.float32,
                      device=q.device)
    for bi in range(nb):
        # the last block may be ragged: the reference pads it with keys
        # that it masks, which changes no row that sees a key
        kq = k[:, bi * blk:(bi + 1) * blk].float()
        vq = v[:, bi * blk:(bi + 1) * blk].float()
        n = kq.shape[1]
        s = qh @ kq.permute(0, 2, 3, 1)[:, :, None]      # [B,KH,rep,S,n]
        k_pos = bi * blk + torch.arange(n, device=q.device)
        valid = torch.ones((S, n), dtype=torch.bool, device=q.device)
        if causal:
            valid = valid & (k_pos[None, :] <= q_pos[:, None])
        if window is not None:
            valid = valid & (q_pos[:, None] - k_pos[None, :] < window)
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        pv = p @ vq.permute(0, 2, 1, 3)[:, :, None]       # [B,KH,rep,S,hd]
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)
    return out.to(q.dtype)


def cache_attention(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, k_pos: torch.Tensor, pos: int, *,
                    window: int | None = None) -> torch.Tensor:
    """Decode: q [B,1,H,hd] over cache [B,C,KH,hd]; k_pos [B,C] absolute
    positions of cached keys (-1 = empty slot)."""
    B, _, H, hd = q.shape
    C, KH = k_cache.shape[1], k_cache.shape[2]
    rep = H // KH
    scale = 1.0 / math.sqrt(hd)
    qh = (q * _scalar(scale, q)).reshape(B, KH, rep, hd)
    s = torch.einsum("bgrd,btgd->bgrt", qh.float(), k_cache.float())
    valid = (k_pos >= 0) & (k_pos <= pos)
    if window is not None:
        valid = valid & (pos - k_pos < window)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrt,btgd->bgrd", p, v_cache.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


# ----------------------------------------------------------------------------
# GQA attention block (mixers 'attn' and 'swa')
# ----------------------------------------------------------------------------
def attn_init(generator, cfg: ModelConfig, lead: tuple = (),
              device="cpu") -> dict:
    """One attention layer's weights, each with the leading axes `lead`
    (the stacked layers of a stack)."""
    D, H, KH, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim
    H_pad = max(cfg.attn_pad_heads, H) if cfg.attn_pad_heads else H
    if H_pad % KH:
        raise ValueError(f"{H_pad} query heads do not split over {KH} "
                         "kv heads")
    dt = _dt(cfg)
    wq = _winit(generator, lead + (D, H_pad, hd), dt, device=device)
    wk = _winit(generator, lead + (D, KH, hd), dt, device=device)
    wv = _winit(generator, lead + (D, KH, hd), dt, device=device)
    wo = _winit(generator, lead + (H_pad, hd, D), dt,
                scale=0.02 / math.sqrt(2 * max(cfg.num_layers, 1)),
                device=device)
    if H_pad > H:
        # GQA maps head h -> kv group h // rep, so padding is PER GROUP
        # (last rep_pad - rep slots of each group), and the padded heads'
        # wo rows are zero: the function is the unpadded model's at init.
        rep, rep_pad = H // KH, H_pad // KH
        mask = torch.arange(H_pad, device=device) % rep_pad < rep
        wo = wo * mask[:, None, None].to(wo.dtype)
    p = {"wq": wq, "wk": wk, "wv": wv, "wo": wo}
    if cfg.qk_norm:
        p["q_norm"] = _norm_init(hd, lead, device)
        p["k_norm"] = _norm_init(hd, lead, device)
    return p


def attn_qkv(params: dict, cfg: ModelConfig, x: torch.Tensor,
             positions: torch.Tensor):
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_apply_train(params: dict, cfg: ModelConfig, x: torch.Tensor, *,
                     window: int | None, q_offset: int = 0) -> torch.Tensor:
    B, S, D = x.shape
    positions = q_offset + torch.arange(S, device=x.device)
    q, k, v = attn_qkv(params, cfg, x, positions)
    if cfg.use_pallas_attn:
        out = flash_attention(q, k, v, causal=True, window=window,
                              q_offset=int(q_offset))
    else:
        out = chunked_attention(q, k, v, causal=True, window=window,
                                q_offset=q_offset, block_kv=cfg.block_kv)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"])


def attn_cache_init(cfg: ModelConfig, batch: int, capacity: int, *,
                    window: int | None, lead: tuple = (),
                    device="cpu") -> dict:
    KH, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    C = min(capacity, window) if window is not None else capacity
    dt = _dt(cfg)
    return {
        "k": torch.zeros(lead + (batch, C, KH, hd), dtype=dt, device=device),
        "v": torch.zeros(lead + (batch, C, KH, hd), dtype=dt, device=device),
        "k_pos": torch.full(lead + (batch, C), -1, dtype=torch.int32,
                            device=device),
    }


def attn_apply_decode(params: dict, cfg: ModelConfig, x: torch.Tensor,
                      cache: dict, pos: int, *,
                      window: int | None) -> tuple[torch.Tensor, dict]:
    """x: [B,1,D]; pos: absolute position of this token. Writes the new
    key and value into `cache` in place (the reference returns an updated
    copy) and returns (y, cache)."""
    # on the device without a host copy, which would wait for the card
    positions = torch.full((1,), pos, device=x.device)
    q, k, v = attn_qkv(params, cfg, x, positions)
    C = cache["k"].shape[1]
    slot = pos % C if window is not None else pos
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    cache["k_pos"][:, slot] = pos
    out = cache_attention(q, cache["k"], cache["v"], cache["k_pos"], pos,
                          window=window)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"]), cache


def attn_make_cache_from_prefill(cfg: ModelConfig, k: torch.Tensor,
                                 v: torch.Tensor, *, window: int | None,
                                 capacity: int) -> dict:
    """Build a decode cache from prefill-computed k/v [B,S,KH,hd]."""
    B, S = k.shape[0], k.shape[1]
    pos = torch.arange(S, dtype=torch.int32, device=k.device)
    C = min(capacity, window) if window is not None else capacity
    kc = k.new_zeros((B, C) + k.shape[2:])
    vc = v.new_zeros((B, C) + v.shape[2:])
    kp = torch.full((B, C), -1, dtype=torch.int32, device=k.device)
    if window is not None:
        # keep the last C positions, placed at slot pos % C (ring layout)
        slots = (pos[-C:] % C).long()
        kc[:, slots] = k[:, -C:]
        vc[:, slots] = v[:, -C:]
        kp[:, slots] = pos[-C:]
    else:
        kc[:, :S] = k
        vc[:, :S] = v
        kp[:, :S] = pos
    return {"k": kc, "v": vc, "k_pos": kp}


# ----------------------------------------------------------------------------
# SwiGLU MLP
# ----------------------------------------------------------------------------
def mlp_init(generator, cfg: ModelConfig, d_ff: int | None = None,
             lead: tuple = (), device="cpu") -> dict:
    D = cfg.d_model
    F = d_ff or cfg.d_ff
    dt = _dt(cfg)
    return {
        "w_gate": _winit(generator, lead + (D, F), dt, device=device),
        "w_up": _winit(generator, lead + (D, F), dt, device=device),
        "w_down": _winit(generator, lead + (F, D), dt,
                         scale=0.02 / math.sqrt(2 * max(cfg.num_layers, 1)),
                         device=device),
    }


def mlp_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    g = x @ params["w_gate"]
    h = g * torch.sigmoid(g) * (x @ params["w_up"])     # silu, as jax.nn's
    return h @ params["w_down"]
